"""The pod tier: async compressed peer sync over collectives of a process
mesh, in PyTorch.

The counterpart of ``shared_tensor_tpu/parallel/ici.py``. One sync step, on
every rank of the (peer, shard) mesh (parallel/mesh.py):

  1. per-leaf scales of the local residual block: the per-leaf scale pass
     (``ops/codec_cuda.leaf_scales``) makes the block's leaf sums (max |r|,
     sum r^2, sum |r| in float64) and, with one shard, the scales by the
     host tier's rule; with more, one all-reduce SUM of those sums over the
     shard group, then the pass's rule alone (``codec_cuda.leaf_rule``);
  2. kernel A (``ops/codec_cuda.quantize_rows``): sign-quantize the block,
     pack 1 bit per element, error feedback, in place;
  3. one all-gather of the packed words and the scales over the peer group:
     1 bit per element on the wire;
  4. kernel B (``ops/codec_cuda.apply_rows_batch``) with K = ``n_peer``
     frames and N = 1 target: every OTHER peer's frame applied to the local
     replica block (split horizon: this peer's own column of scales is
     zeroed, and a zero-scale frame adds exactly nothing).

Where the JAX package holds ``values`` and ``residual`` as [n_peer, total]
arrays sharded over the mesh, here each rank holds only its own block,
``[total // n_shard]``, of its peer's replica and residual, and updates it
IN PLACE (as the TPU kernels' ``input_output_aliases`` do). The functions
that return a state return the same tensors.

Kernel B takes its K frames frame-major, ``words [K, rows*4]``, which is
what the all-gather produces, so the Pallas path's transpose to row-major
has no counterpart. Frames are summed in peer order k = 0..K-1 from 0.0, as
the Pallas kernel and the JAX package's XLA path sum them.

Leaf sums within a shard are the pass's fixed-order sums of per-tile
partials on the table's tile grid (a block that starts mid-tile has a
first tile of fewer rows), and the cross-shard sum is taken in float64
before the rule rounds to f32: deterministic on the GPU (no float
atomics). The sum of the blocks' maxima is above 0 exactly where their max
is, which is all the rule asks of max |r|, so one all-reduce replaces
JAX's pmax and psum. With one shard this is exactly ``ops/table.py``'s
scales (``_table_scales``). Against JAX's f32 arithmetic (each leaf
normalised by its max before squaring): POW2_RMS scales equal or one
octave apart at a power of two's edge, RMS and ABS_MEAN to a relative
1e-6.

The exact arm (``compressed=False``) sums the residuals over the peer group
with the backend's all-reduce (BASELINE config 4's comparison). Its
summation order is the backend's, not XLA's, so the sum differs from the
JAX package's by its rounding, at most about ``n_peer * eps *
max|residual|``; subtracting a peer's own residual keeps that absolute
error, which can be many ulps of a small result.

``impl`` selects the codec pass as in ``ops/table.py``: ``"auto"`` runs the
kernels on CUDA tensors and their plain versions on CPU tensors,
``"kernel"`` the kernels (raises off the GPU), ``"plain"`` the plain
versions anywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ScalePolicy
from ..ops import codec_cuda
from ..ops.codec import SAT
from ..ops.packing import BITS_PER_WORD, LANES
from ..ops.table import TableSpec, _apply_fn, _quantize_fn, _scales_fn, flatten, unflatten
from ..utils.timing import Spans
from .mesh import Mesh, all_gather, all_reduce_, broadcast_, rows_per_shard


class PeerSyncState(NamedTuple):
    """This rank's block of its peer's replica and of its one outgoing
    residual toward the group (fully connected: one residual per peer),
    f32[spec.total // n_shard] each, on the mesh's device."""

    values: torch.Tensor
    residual: torch.Tensor


def block_range(mesh: Mesh, spec: TableSpec) -> tuple[int, int]:
    """[lo, hi) of this rank's block in the flat padded table."""
    n = rows_per_shard(spec.total, mesh.n_shard) * LANES
    return mesh.shard * n, (mesh.shard + 1) * n


def init_state(mesh: Mesh, spec: TableSpec, template=None) -> PeerSyncState:
    """Every peer starts from the same seed (``template``, or zeros); the
    residual starts at zero."""
    lo, hi = block_range(mesh, spec)
    if template is not None:
        values = flatten(template, spec, mesh.device)[lo:hi].clone()
    else:
        values = torch.zeros(hi - lo, dtype=torch.float32, device=mesh.device)
    return PeerSyncState(values, torch.zeros_like(values))


def gather_replica(mesh: Mesh, block: torch.Tensor) -> torch.Tensor:
    """This peer's whole flat table from its shards' blocks (an all-gather
    over the shard group; the block itself with one shard)."""
    if mesh.n_shard == 1:
        return block
    return all_gather(mesh, block, mesh.shard_group).wait().reshape(-1)


def read_peer(state: PeerSyncState, spec: TableSpec, mesh: Mesh, peer: int):
    """Peer ``peer``'s replica as the caller's pytree of tensors, on every
    rank. Collective: every rank of the mesh calls it with the same
    ``peer``."""
    full = gather_replica(mesh, state.values).clone()
    broadcast_(mesh, full, mesh.rank_of(peer, mesh.shard), mesh.peer_group)
    return unflatten(full, spec)


def _sanitize(u: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(u.to(torch.float32), nan=0.0, posinf=3.0e38, neginf=-3.0e38)


def add_updates(state: PeerSyncState, updates: torch.Tensor) -> PeerSyncState:
    """This peer merges its own additive update (this rank's block,
    f32[total // n_shard]): replica and residual both receive it, so it is
    visible locally at once and queued for the group. Sanitized (NaN -> 0,
    +-inf -> +-3e38) and clamped to +-3e38. In place. (The JAX package's
    un-jitted ``add_updates_raw`` and jitted ``add_updates`` are this one
    eager function.)"""
    u = _sanitize(updates)
    state.values.add_(u).clamp_(-3.0e38, 3.0e38)
    state.residual.add_(u).clamp_(-3.0e38, 3.0e38)
    return state


def apply_external(state: PeerSyncState, delta: torch.Tensor, mesh: Mesh, spec: TableSpec) -> PeerSyncState:
    """Apply a delta that arrived from OUTSIDE the pod (flat [spec.total])
    to this rank's replica block: values only, residual untouched (split
    horizon at the pod boundary: every pod peer receives it directly, so
    queueing it would deliver it twice). In place."""
    lo, hi = block_range(mesh, spec)
    state.values.add_(_sanitize(delta.to(state.values.device)[lo:hi])).clamp_(-3.0e38, 3.0e38)
    return state


# --- the sync step ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _StepCtx:
    """This rank's static layout: its rows, their leaves and live lanes, and
    the leaf cuts of its block in the per-leaf scale pass's slots."""

    mesh: Mesh
    rows_local: int
    k: int
    row_leaf: torch.Tensor  # int64[rows_local]
    rowcount: torch.Tensor  # int32[rows_local]
    live: torch.Tensor  # bool[rows_local, 128]
    per_leaf: bool
    phase: int  # rows of the block's first tile that lie before the block
    leaf_slots: torch.Tensor  # int64[L + 1]: leaf l's slots of the pass, empty outside the block
    ns: torch.Tensor  # f64[L]: each leaf's live elements in the whole table
    impl: str


def _make_ctx(mesh: Mesh, spec: TableSpec, per_leaf: bool, impl: str = "auto") -> _StepCtx:
    rows_local = rows_per_shard(spec.total, mesh.n_shard)
    start = mesh.shard * rows_local
    if per_leaf:
        k = spec.num_leaves
        row_leaf = spec.row_leaf()
    else:
        # one global scale over the whole table (the reference's behaviour),
        # the pass's sum over the leaves
        k = 1
        row_leaf = np.zeros(spec.rows, np.int32)
    # the table's leaves are whole 8-row tiles: on the tile grid of the
    # block's first row, every slot of the pass lies in one leaf
    phase = start % codec_cuda.TILE_ROWS
    slots = codec_cuda.leaf_slot_count(rows_local, phase)
    cuts = np.clip(np.concatenate([[0], np.cumsum([p // LANES for p in spec.padded])]) - start, 0, rows_local)
    leaf_slots = np.where(cuts >= rows_local, slots, (cuts + phase) // codec_cuda.TILE_ROWS)
    dev = mesh.device
    rowcount = torch.from_numpy(spec.live_rowcount()[start : start + rows_local].copy()).to(dev)
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)
    return _StepCtx(
        mesh=mesh,
        rows_local=rows_local,
        k=k,
        row_leaf=torch.from_numpy(row_leaf[start : start + rows_local].astype(np.int64)).to(dev),
        rowcount=rowcount,
        live=lane[None, :] < rowcount[:, None],
        per_leaf=per_leaf,
        phase=int(phase),
        leaf_slots=torch.from_numpy(leaf_slots.astype(np.int64)).to(dev),
        ns=torch.tensor(spec.ns, dtype=torch.float64, device=dev),
        impl=impl,
    )


def _rule_fn(impl: str):
    return {"auto": codec_cuda.leaf_rule, "kernel": codec_cuda.leaf_rule_kernel,
            "plain": codec_cuda.leaf_rule_plain}[impl]


def _leaf_scales(ctx: _StepCtx, rows: torch.Tensor, policy: ScalePolicy) -> torch.Tensor:
    """Per-leaf scales f32[k] of this shard's rows, reduced over the shard
    group: the per-leaf scale pass over the block (its kernel on the card,
    its twin on the CPU), and with more than one shard one all-reduce SUM
    of its float64 leaf sums, then its rule alone."""
    mesh = ctx.mesh
    scales, sums = _scales_fn(ctx.impl)(rows.reshape(-1), ctx.rowcount, ctx.leaf_slots, ctx.ns, policy,
                                        ctx.per_leaf, ctx.phase)
    if mesh.n_shard > 1:
        all_reduce_(mesh, sums, dist.ReduceOp.SUM, mesh.shard_group)
        scales = _rule_fn(ctx.impl)(sums, ctx.ns, policy, ctx.per_leaf)
    return scales if ctx.per_leaf else scales[:1]


class Frames:
    """Every peer's frame of one sync step, gathered over the peer group
    (possibly still in flight): ``wait()`` gives ``(words_all
    int32[n_peer, rows_local*4], scales_all f32[n_peer, k])``, row p being
    what peer p sent."""

    def __init__(self, gathered, k: int):
        self._gathered = gathered
        self._k = k
        self._out = None

    def wait(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._out is None:
            buf = self._gathered.wait()  # int32[n_peer, k + words]
            # fresh copies: kernel B wants its words 16-byte aligned
            self._out = (buf[:, self._k :].clone(), buf[:, : self._k].clone().view(torch.float32))
            self._gathered = None
        return self._out


def _mark(spans: Optional[Spans], name: str) -> None:
    if spans is not None:
        spans.mark(name)


def _codec_send(ctx: _StepCtx, policy: ScalePolicy, quantize: Callable, residual: torch.Tensor,
                async_op: bool = False, spans: Optional[Spans] = None) -> Frames:
    """Sender half, on this rank's block: per-leaf scales (cross-shard
    reduction), kernel A (sign, pack, error feedback; the residual in
    place), then one all-gather of [scales | words] over the peer group.
    Returns the frames in flight."""
    scales = _leaf_scales(ctx, residual.view(ctx.rows_local, LANES), policy)
    _mark(spans, "scales")
    words = quantize(scales[ctx.row_leaf].contiguous(), ctx.rowcount, residual)
    _mark(spans, "quantize")
    packed = torch.cat([scales.view(torch.int32), words])
    gathered = all_gather(ctx.mesh, packed, ctx.mesh.peer_group, async_op=async_op)
    return Frames(gathered, ctx.k)


def _codec_apply(ctx: _StepCtx, apply: Callable, values: torch.Tensor, words_all: torch.Tensor,
                 scales_all: torch.Tensor) -> torch.Tensor:
    """Receiver half, on this rank's block: kernel B with K = n_peer frames
    and N = 1 target, this peer's own column of scales zeroed (split
    horizon). Clamped to +-SAT, padding lanes 0, in place."""
    s_all = scales_all[:, ctx.row_leaf]  # [n_peer, rows_local]
    s_all[ctx.mesh.peer] = 0.0
    apply(s_all.contiguous(), ctx.rowcount, words_all, (values,))
    return values


def build_sync_step(
    mesh: Mesh,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    compressed: bool = True,
    impl: str = "auto",
    spans: Optional[Spans] = None,
):
    """One pod sync step ``state -> (state, scales)``: the state's tensors
    updated in place, ``scales`` f32[n_peer, k] the per-frame step sizes
    each peer transmitted (rows of 0 = idle peers), on every rank.
    Collective: every rank of the mesh calls it once per step.

    ``compressed=False`` builds the exact arm: every pending residual is
    delivered in full f32 and residuals drop to exactly zero; the scales it
    reports are the ones the compressed arm would have sent.

    ``spans`` (utils/timing.Spans) receives a mark after each stage:
    ``scales``, ``quantize`` (kernel A), ``gather`` (the collective),
    ``apply`` (kernel B)."""
    ctx = _make_ctx(mesh, spec, per_leaf, impl)
    quantize, apply = _quantize_fn(impl), _apply_fn(impl)

    def compressed_step(state: PeerSyncState):
        frames = _codec_send(ctx, policy, quantize, state.residual, spans=spans)
        words_all, scales_all = frames.wait()
        _mark(spans, "gather")
        _codec_apply(ctx, apply, state.values, words_all, scales_all)
        _mark(spans, "apply")
        return state, scales_all

    def exact_step(state: PeerSyncState):
        values, residual = state
        scales = _leaf_scales(ctx, residual.view(ctx.rows_local, LANES), policy)
        _mark(spans, "scales")
        total = all_reduce_(mesh, residual.clone(), dist.ReduceOp.SUM, mesh.peer_group)
        scales_all = all_gather(mesh, scales, mesh.peer_group).wait()
        _mark(spans, "gather")
        v2 = torch.clamp(values + (total - residual), -SAT, SAT)
        values.copy_(torch.where(ctx.live.view(-1), v2, torch.zeros_like(v2)))
        residual.zero_()
        _mark(spans, "apply")
        return state, scales_all

    return compressed_step if compressed else exact_step


def build_sync_phases(
    mesh: Mesh,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    impl: str = "auto",
    spans: Optional[Spans] = None,
):
    """The sync step split in two halves, for the overlap training mode:

      ``send(residual) -> Frames`` quantizes the outgoing residual (error
      feedback applied, in place) and STARTS the all-gather of the frames
      over the peer group (``async_op=True``). Depends only on the residual.

      ``apply_gathered(values, frames) -> values`` waits for the gather and
      applies every OTHER peer's frame to the replica block (in place).

    Between the two the caller runs its grads; the collective proceeds
    meanwhile (with gloo, on the backend's own threads). Composing
    ``apply_gathered(values, send(residual))`` at once is bit for bit
    :func:`build_sync_step`. ``frames.wait()[1]`` is the scales
    f32[n_peer, k] that step returns."""
    ctx = _make_ctx(mesh, spec, per_leaf, impl)
    quantize, apply = _quantize_fn(impl), _apply_fn(impl)

    def send(residual: torch.Tensor) -> Frames:
        return _codec_send(ctx, policy, quantize, residual, async_op=True, spans=spans)

    def apply_gathered(values: torch.Tensor, frames: Frames) -> torch.Tensor:
        words_all, scales_all = frames.wait()
        _mark(spans, "gather")
        _codec_apply(ctx, apply, values, words_all, scales_all)
        _mark(spans, "apply")
        return values

    return send, apply_gathered


def frame_ici_bytes(spec: TableSpec, n_peer: int, compressed: bool = True) -> int:
    """Bytes each peer receives per sync step over the interconnect, the
    wire-cost model behind the >=10x-at-matched-error target. Compressed:
    1 bit per element plus the scales from each other peer; exact: a ring
    all-reduce moves about twice the f32 buffer through each link."""
    if compressed:
        per_frame = spec.total // BITS_PER_WORD * 4 + spec.num_leaves * 4
        return (n_peer - 1) * per_frame
    return 2 * spec.total * 4
