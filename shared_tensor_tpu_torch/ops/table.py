"""Table sync: the codec over a pytree ("table") of tensors with an
independent scale per leaf, in PyTorch.

The counterpart of ``shared_tensor_tpu/ops/table.py``, with the same layout:

- A pytree is flattened into ONE padded flat float32 buffer, each leaf
  padded to a multiple of 1024 so leaf boundaries are row-aligned in the
  (rows, 128) view. Dicts flatten in sorted key order and lists/tuples in
  index order, exactly as ``jax.tree.flatten`` does, so leaf ``i``, every
  row and every frame bit sit where the JAX package puts them.
- Quantization computes a scale per leaf (the per-leaf scale pass,
  ``codec_cuda.leaf_scales``: per-tile double partials and a fixed-order
  leaf reduction, then the host tier's rule), then runs the fused
  sign/pack/error-feedback pass with a per-row scale (kernel A,
  ``codec_cuda.quantize_rows``).
- The receive side unpacks K frames, sums their deltas and applies the sum
  to N arrays in one pass (kernel B, ``codec_cuda.apply_rows_batch``).
- A K-frame burst either re-measures the scales every frame
  (:func:`quantize_table_burst`, the JAX package's schedule) or runs the
  native engine's cascade (:func:`quantize_table_cascade`): rounds of one
  measurement and a pow2 ladder from each leaf's max |r| down to the policy
  scale, quantized in one pass (kernel A-cascade,
  ``codec_cuda.quantize_rows_cascade``), the measurement made on the device
  from that pass's partials (the finish kernel, ``codec_cuda.cascade_round``).
  The cascade is the port's own: the JAX package's Python plane has only the
  per-frame schedule.

Unlike the JAX functions, which return new arrays, the quantize, apply and
accumulate functions here update their target tensors IN PLACE (as the TPU
kernels' ``input_output_aliases`` do) and return them. Targets of one call
must not share storage; the kernel wrappers raise if they do.

``impl`` selects the codec pass: ``"auto"`` runs the kernel for a CUDA
tensor and the plain version for a CPU tensor, ``"kernel"`` runs the kernel
(raises off the GPU), ``"plain"`` runs the plain PyTorch version anywhere.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ..config import ScalePolicy
from . import codec_cuda
from .codec import CASCADE_EXTRA_LEVELS, CASCADE_MAX_LEVELS, pow2_floor
from .codec_cuda import WORDS_PER_ROW
from .packing import LANES, TILE, padded_len


class TableFrame(NamedTuple):
    """One codec frame for a table: per-leaf scales + packed sign bits.
    On the device: f32 scales and int32 words; at the host/wire boundary:
    numpy f32 scales and uint32 words (the same bits)."""

    scales: Any  # f32[num_leaves] (or [K, num_leaves] for a stack)
    words: Any  # 32-bit words [total // 32] (or [K, total // 32])


# -- pytrees -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """Structure of a pytree of dicts, lists, tuples and None, with leaves
    elsewhere. ``str()`` reproduces ``str(jax.tree.structure(tree))``."""

    kind: str  # "leaf" | "none" | "dict" | "list" | "tuple"
    keys: tuple = ()
    children: tuple = ()

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        parts = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in zip(self.keys, parts)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(parts) + "]"
        if len(parts) == 1:
            return f"({parts[0]},)"
        return "(" + ", ".join(parts) + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """Leaves in JAX order (dict keys sorted, lists/tuples by index; None has
    no leaves) and the structure."""
    leaves: list = []

    def walk(node) -> TreeDef:
        if node is None:
            return TreeDef("none")
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return TreeDef("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return TreeDef(kind, (), tuple(walk(c) for c in node))
        leaves.append(node)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves: Sequence) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        return kids if td.kind == "list" else tuple(kids)

    return build(treedef)


# -- layout ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static layout of a pytree flattened into one padded flat buffer.
    Leaf i occupies flat rows [sum(padded[:i])//128, ...+padded[i]//128)
    with ns[i] live elements."""

    treedef: TreeDef
    shapes: tuple[tuple[int, ...], ...]
    ns: tuple[int, ...]  # true element count per leaf
    padded: tuple[int, ...]  # padded length per leaf (tile multiple)

    @property
    def num_leaves(self) -> int:
        return len(self.ns)

    @property
    def total(self) -> int:
        return sum(self.padded)

    @property
    def total_n(self) -> int:
        return sum(self.ns)

    @property
    def rows(self) -> int:
        return self.total // LANES

    def layout_digest(self) -> bytes:
        """16-byte digest of the full layout; byte-identical to the JAX
        package's ``TableSpec.layout_digest`` for the same tree."""
        desc = repr((str(self.treedef), self.shapes, self.ns, self.padded))
        return hashlib.sha256(desc.encode()).digest()[:16]

    def row_leaf(self) -> np.ndarray:
        """int32[rows]: leaf index owning each 128-lane row."""
        return np.repeat(
            np.arange(self.num_leaves, dtype=np.int32),
            [p // LANES for p in self.padded],
        )

    def live_rowcount(self) -> np.ndarray:
        """int32[rows]: number of live lanes in each row (0..128)."""
        counts = []
        for n, p in zip(self.ns, self.padded):
            c = np.zeros(p // LANES, dtype=np.int32)
            full, rem = divmod(n, LANES)
            c[:full] = LANES
            if rem:
                c[full] = rem
            counts.append(c)
        return np.concatenate(counts)


def _leaf_shape(leaf) -> tuple[int, ...]:
    return tuple(int(d) for d in np.shape(leaf))


def make_spec(tree: Any) -> TableSpec:
    """Build the static layout for a pytree of arrays/tensors."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("a table needs at least one leaf")
    shapes = tuple(_leaf_shape(l) for l in leaves)
    ns = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    padded = tuple(padded_len(n, TILE) for n in ns)
    return TableSpec(treedef, shapes, ns, padded)


def _as_flat_f32(leaf, device) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().reshape(-1).to(device=device, dtype=torch.float32)
    arr = np.asarray(leaf, dtype=np.float32).reshape(-1)
    return torch.from_numpy(arr).to(device)


def flatten(tree: Any, spec: TableSpec, device=None) -> torch.Tensor:
    """Pytree -> a NEW padded flat float32 tensor (padding exactly 0) on
    ``device`` (default: the CPU)."""
    leaves, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        # a structural mismatch would merge deltas into the wrong leaves
        raise ValueError(f"tree structure {treedef} does not match spec {spec.treedef}")
    device = torch.device("cpu") if device is None else torch.device(device)
    out = torch.zeros(spec.total, dtype=torch.float32, device=device)
    off = 0
    for i, (leaf, n, p) in enumerate(zip(leaves, spec.ns, spec.padded)):
        flat = _as_flat_f32(leaf, device)
        if flat.shape[0] != n:
            raise ValueError(f"leaf {i} has {flat.shape[0]} elements, spec expects {n}")
        out[off : off + n] = flat
        off += p
    return out


def unflatten(flat: torch.Tensor, spec: TableSpec) -> Any:
    """Inverse of :func:`flatten`. The leaves are views into ``flat``."""
    leaves = []
    off = 0
    for shape, n, p in zip(spec.shapes, spec.ns, spec.padded):
        leaves.append(flat[off : off + n].reshape(shape))
        off += p
    return tree_unflatten(spec.treedef, leaves)


@functools.lru_cache(maxsize=32)
def _consts(spec: TableSpec, device: str):
    """Per-(layout, device) index tensors: row_leaf (int64[rows]), live
    lanes per row (int32[rows]), the live mask (bool[rows, 128]), leaf
    element counts (f32[L]) and each leaf's last row (int64[L])."""
    dev = torch.device(device)
    row_leaf = torch.from_numpy(spec.row_leaf().astype(np.int64)).to(dev)
    rowcount = torch.from_numpy(spec.live_rowcount()).to(dev)
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)
    live = lane[None, :] < rowcount[:, None]
    ns = torch.tensor(spec.ns, dtype=torch.float32, device=dev)
    last_row = torch.tensor(
        np.cumsum([p // LANES for p in spec.padded]) - 1, dtype=torch.int64, device=dev
    )
    return row_leaf, rowcount, live, ns, last_row


class CascadeConsts(NamedTuple):
    """Per-(layout, device) constants of the cascade's finish kernel and
    of the per-leaf scale pass (one partial slot a tile of the table)."""

    leaf_slots: torch.Tensor  # int64[L + 1]: leaf i owns partial slots [leaf_slots[i], leaf_slots[i + 1])
    ns: torch.Tensor  # f64[L]: live elements per leaf


@functools.lru_cache(maxsize=32)
def _cascade_consts(spec: TableSpec, device: str) -> CascadeConsts:
    slots = np.concatenate([[0], np.cumsum([codec_cuda.partial_slots(p // LANES) for p in spec.padded])])
    dev = torch.device(device)
    return CascadeConsts(torch.tensor(slots, dtype=torch.int64, device=dev),
                         torch.tensor(spec.ns, dtype=torch.float64, device=dev))


class CascadeBuffers(NamedTuple):
    """What one cascade burst writes: its frames and the rounds' state."""

    scales: torch.Tensor  # f32[K, L]
    words: torch.Tensor  # int32[K, W]
    state: torch.Tensor  # int32[3]: j0, kc, stop
    ladder: torch.Tensor  # f32[3, L]: measured scales, each leaf's max |r|, ladder top
    partials: torch.Tensor  # f64[3, tiles]: A-cascade's per-tile max |r|, sum r^2, sum |r|
    leaf_sums: torch.Tensor  # f64[3, L]: the same per leaf


def cascade_buffers(spec: TableSpec, k: int, device) -> CascadeBuffers:
    """Uninitialised buffers of a K-frame cascade burst: its first launch
    (A-cascade with ``begin``) zeroes the frames, and every later write
    precedes its read."""
    dev = torch.device(device)
    f32, f64 = torch.float32, torch.float64
    L = spec.num_leaves
    return CascadeBuffers(
        torch.empty((int(k), L), dtype=f32, device=dev),
        torch.empty((int(k), spec.rows * WORDS_PER_ROW), dtype=torch.int32, device=dev),
        torch.empty(3, dtype=torch.int32, device=dev),
        torch.empty((3, L), dtype=f32, device=dev),
        torch.empty((3, codec_cuda.partial_slots(spec.rows)), dtype=f64, device=dev),
        torch.empty((3, L), dtype=f64, device=dev),
    )


# -- scales ------------------------------------------------------------------


def leaf_amax(residual: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """f32[L]: each leaf's max |r| (padding lanes are 0 by invariant)."""
    row_leaf = _consts(spec, str(residual.device))[0]
    amax_row = torch.amax(torch.abs(residual.view(-1, LANES)), dim=1)
    amax = torch.zeros(spec.num_leaves, dtype=torch.float32, device=residual.device)
    return amax.scatter_reduce(0, row_leaf, amax_row, reduce="amax", include_self=True)


def compute_scales(
    residual: torch.Tensor,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    with_amax: bool = False,
):
    """Per-leaf step sizes as a chain of torch launches (overflow-safe
    segment RMS: each leaf is normalised by its own max|r| before
    squaring), the JAX package's arithmetic; with ``with_amax``, (scales,
    each leaf's max |r|), the normaliser it computed. No codec path calls
    it: :func:`quantize_table` takes its scales from the per-leaf scale
    pass (:func:`_table_scales`), and this chain stays as the golden and
    as the library call the pass is timed against.

    Leaf sums are taken as differences of a float64 running sum over the
    f32 row sums, which is deterministic on the GPU (an atomic segment sum
    is not) and at least as exact as the f32 sum it stands for. Against the
    JAX package: POW2_RMS scales are equal or one octave apart, RMS and
    ABS_MEAN agree to a relative 1e-6."""
    row_leaf, _, _, ns, last_row = _consts(spec, str(residual.device))
    rows = residual.view(-1, LANES)
    amax = leaf_amax(residual, spec)
    denom = torch.where(amax > 0, amax, torch.ones_like(amax))
    norm = rows / denom[row_leaf][:, None]
    if policy == ScalePolicy.ABS_MEAN:
        per_row = torch.sum(torch.abs(norm), dim=1)
    else:
        per_row = torch.sum(norm * norm, dim=1)
    run = torch.cumsum(per_row.to(torch.float64), dim=0)[last_row]
    seg = torch.diff(run, prepend=run.new_zeros(1)).to(torch.float32)
    if policy == ScalePolicy.ABS_MEAN:
        scales = amax * (seg / ns)
    else:
        rms = amax * torch.sqrt(seg / ns)
        scales = pow2_floor(rms) if policy == ScalePolicy.POW2_RMS else rms
    ok = (amax > 0) & torch.isfinite(scales)
    scales = torch.where(ok, scales, torch.zeros_like(scales))
    return (scales, amax) if with_amax else scales


def _scales_fn(impl: str):
    if impl == "auto":
        return codec_cuda.leaf_scales
    if impl == "kernel":
        return codec_cuda.leaf_scales_kernel
    if impl == "plain":
        return codec_cuda.leaf_scales_plain
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def _table_scales(
    residual: torch.Tensor, spec: TableSpec, policy: ScalePolicy, per_leaf: bool, with_amax: bool = False,
    impl: str = "auto",
):
    """Per-leaf scales by the per-leaf scale pass (``codec_cuda.leaf_scales``:
    its kernel on a CUDA residual, its twin on a CPU one; the host tier's
    rule on double sums); ``per_leaf=False`` computes ONE scale over the
    whole table (the reference's behaviour, needed for wire-compat with C
    peers), replicated to every leaf so the apply path is uniform.
    ``with_amax`` adds each leaf's own max |r| (f32), whatever
    ``per_leaf``. Padding lanes count as 0 whatever they hold. Against the
    JAX package's ``compute_scales``: POW2_RMS scales are equal or one octave
    apart at a power of two's edge, RMS and ABS_MEAN agree to a relative
    1e-6."""
    rowcount = _consts(spec, str(residual.device))[1]
    c = _cascade_consts(spec, str(residual.device))
    scales, sums = _scales_fn(impl)(residual, rowcount, c.leaf_slots, c.ns, policy, per_leaf)
    return (scales, sums[0].to(torch.float32)) if with_amax else scales


# -- the cascade schedule ---------------------------------------------------------


def _ilogb(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) of finite x > 0, subnormals included (C's ilogbf)."""
    return torch.frexp(x).exponent.to(torch.int64) - 1


def cascade_ladder(scales: torch.Tensor, amax: torch.Tensor, k_max) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of the native engine's cascade schedule
    (``native/stengine.cpp``'s send loop, 1-bit), on the device with no
    host sync: from the measured policy scales and each leaf's max |r|,
    the round's first row ``top`` (f32[L]) and its depth ``kc`` (an int64
    tensor; ``k_max`` caps it and may be one too).

    A live leaf's ladder top is pow2_floor(max |r|) where that exceeds its
    scale; the depth is the largest ilogb(top) - ilogb(scale) + 1 over the
    live leaves, plus 8 refinement levels when it exceeds 1. At depth 1 the
    row is exactly the measured scales. Every later row of the round halves
    the one before (:func:`cascade_schedule`, kernel A-cascade), and the
    round ends at its first all-zero row. kc is 0 when every scale is 0."""
    live = scales > 0
    st = pow2_floor(amax)  # subnormal max |r| -> 0
    up = live & (st > scales)
    d = torch.where(up, _ilogb(st) - _ilogb(scales) + 1, torch.ones_like(scales, dtype=torch.int64))
    maxd = d.max()
    maxd = torch.where(maxd > 1, maxd + CASCADE_EXTRA_LEVELS, maxd)
    kc = torch.minimum(maxd, k_max) if isinstance(k_max, torch.Tensor) else torch.clamp(maxd, max=int(k_max))
    kc = torch.where(live.any(), kc, torch.zeros_like(kc))
    top = torch.where((kc > 1) & live, torch.maximum(st, scales), scales)
    return top, kc


def cascade_schedule(scales: torch.Tensor, amax: torch.Tensor, k_max: int) -> tuple[torch.Tensor, int]:
    """The rows of one cascade round (f32[kreal, L], stopping before the
    first all-zero row) and its depth kc, on the host: the torch body of the
    schedule that ``codec_np.cascade_schedule_np`` also writes (tests hold
    both against the engine's rule). A round with fewer rows than kc hit
    the subnormal floor, which ends the engine's message."""
    top, kc = cascade_ladder(scales, amax, int(k_max))
    kc = int(kc)
    rows, row = [], top
    for j in range(kc):
        if j:
            row = row * 0.5
            if not bool(row.any()):
                break
        rows.append(row)
    out = torch.stack(rows) if rows else top.new_zeros((0, top.shape[0]))
    return out, kc


# -- sender ------------------------------------------------------------------


def _quantize_fn(impl: str):
    if impl == "auto":
        return codec_cuda.quantize_rows
    if impl == "kernel":
        return codec_cuda.quantize_rows_kernel
    if impl == "plain":
        return codec_cuda.quantize_rows_plain
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def _cascade_fn(impl: str):
    if impl == "auto":
        return codec_cuda.quantize_rows_cascade
    if impl == "kernel":
        return codec_cuda.quantize_rows_cascade_kernel
    if impl == "plain":
        return codec_cuda.quantize_rows_cascade_plain
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def _round_fn(impl: str):
    if impl == "auto":
        return codec_cuda.cascade_round
    if impl == "kernel":
        return codec_cuda.cascade_round_kernel
    if impl == "plain":
        return codec_cuda.cascade_round_plain
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def _apply_fn(impl: str):
    if impl == "auto":
        return codec_cuda.apply_rows_batch
    if impl == "kernel":
        return codec_cuda.apply_rows_batch_kernel
    if impl == "plain":
        return codec_cuda.apply_rows_batch_plain
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def quantize_table(
    residual: torch.Tensor,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    impl: str = "auto",
) -> tuple[TableFrame, torch.Tensor]:
    """Sender step over a table: per-leaf scales (the per-leaf scale pass),
    then the fused sign/pack/error-feedback pass. Bit set iff r <= 0; the
    residual moves by -+scale of its own leaf; leaves at scale 0 idle.
    ``residual`` is updated in place and returned with the frame."""
    fn = _quantize_fn(impl)
    scales = _table_scales(residual, spec, policy, per_leaf, impl=impl)
    row_leaf, rowcount, *_ = _consts(spec, str(residual.device))
    words = fn(scales[row_leaf], rowcount, residual)
    return TableFrame(scales, words), residual


def quantize_table_burst(
    residual: torch.Tensor,
    spec: TableSpec,
    k: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    impl: str = "auto",
) -> tuple[TableFrame, torch.Tensor]:
    """K successive sender steps on one residual (each frame quantizes what
    the previous one left): stacked (scales f32[K, L], words [K, W]) and the
    residual, updated in place. Once the residual quantizes to all-zero
    scales every later frame is an exact no-op, so the caller trims the
    zero tail after the fetch."""
    scales, words = [], []
    for _ in range(int(k)):
        frame, residual = quantize_table(residual, spec, policy, per_leaf, impl)
        scales.append(frame.scales)
        words.append(frame.words)
    return TableFrame(torch.stack(scales), torch.stack(words)), residual


def quantize_table_cascade(
    residual: torch.Tensor,
    spec: TableSpec,
    k: int,
    cascade: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    impl: str = "auto",
) -> tuple[TableFrame, torch.Tensor]:
    """K frames of one residual by the native engine's cascade: rounds of
    one measurement (each leaf's scale by the host tier's rule and its max
    |r|), one :func:`cascade_ladder` of depth at most min(``cascade``, 64,
    frames left), and one pass of kernel A-cascade that quantizes the whole
    round. Returns the stacked frame (scales f32[K, L], words [K, W]) and
    the residual, updated in place. ``cascade <= 1`` is
    :func:`quantize_table_burst`, bit for bit.

    As in the engine, each pass writes the partials of the residual it
    leaves (per-tile max |r|, sum r^2 and sum |r| in double), and the
    next round's measurement is made from them by the finish kernel
    (``codec_cuda.cascade_round``), with the stop rule and the round's
    start: the burst is one A-cascade launch that zeroes the frames and
    measures the residual as it finds it, then K rounds of (finish,
    A-cascade), 2K + 1 launches, none of which waits for the device, so one
    CUDA graph replays it. The scales are those of
    ``codec_np.compute_scales_np`` on the same residual (the sums' order
    aside), by the rule of :func:`quantize_table`'s per-leaf scale pass.

    A round past the last frame returns at once. Once a round yields no
    frame (every scale 0) or stops short of its depth at the subnormal floor
    (as the engine ends its message there), every later round does nothing.
    So the frames are a prefix of non-zero-scale frames followed by
    all-zero-scale ones, the invariant ``SharedTensor.finish_frame_burst``'s
    trim relies on: no frame the ledger holds is cut from the wire."""
    cascade = min(int(cascade), CASCADE_MAX_LEVELS)
    if cascade <= 1:
        return quantize_table_burst(residual, spec, k, policy, per_leaf, impl)
    quantize, finish = _cascade_fn(impl), _round_fn(impl)
    dev = residual.device
    row_leaf, rowcount, *_ = _consts(spec, str(dev))
    c = _cascade_consts(spec, str(dev))
    b = cascade_buffers(spec, k, dev)
    top = b.ladder[2]
    quantize(top, row_leaf, rowcount, b.state, residual, b.words, b.scales, b.partials, begin=True)
    for i in range(int(k)):
        finish(b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder, b.leaf_sums, k, cascade, policy,
               per_leaf, first=i == 0)
        if dev.type == "cpu" and int(b.state[2]):
            break  # stopped: every later round does nothing (the state is on the host here)
        quantize(top, row_leaf, rowcount, b.state, residual, b.words, b.scales, b.partials)
    return TableFrame(b.scales, b.words), residual


# -- receiver ----------------------------------------------------------------


def apply_table_many(
    arrays: Sequence[torch.Tensor],
    frame: TableFrame,
    spec: TableSpec,
    impl: str = "auto",
) -> tuple[torch.Tensor, ...]:
    """Receiver step over a table applied to several arrays (replica + other
    links' residuals: the flood) in one pass, in place."""
    stacked = TableFrame(frame.scales.reshape(1, -1), frame.words.reshape(1, -1))
    return apply_table_batch(arrays, stacked, spec, impl)


def apply_table_batch(
    arrays: Sequence[torch.Tensor],
    frames: TableFrame,
    spec: TableSpec,
    impl: str = "auto",
) -> tuple[torch.Tensor, ...]:
    """Apply a STACK of K frames (scales f32[K, L], words [K, W]) in one
    pass: their deltas are summed in frame order, masked, and added to every
    array, clamped to +/-SAT, in place. Equivalent to applying the frames
    one by one up to f32 summation order (codec deltas are pure adds);
    zero-scale frames contribute nothing, so callers may pad K."""
    fn = _apply_fn(impl)
    row_leaf, rowcount, *_ = _consts(spec, str(arrays[0].device))
    k = frames.scales.shape[0]
    s_rows = frames.scales[:, row_leaf].contiguous()  # [K, rows]
    words = frames.words.reshape(k, spec.rows * WORDS_PER_ROW).contiguous()
    return fn(s_rows, rowcount, words, tuple(arrays))


def frames_delta(frames: TableFrame, spec: TableSpec) -> torch.Tensor:
    """The first half of :func:`apply_table_batch` on the CPU: a stack of K
    frames' deltas summed in frame order and masked (f32[rows, 128];
    ``codec_cuda.frames_delta_plain``). With :func:`apply_delta` it is the
    plain kernel B bit for bit, split so that a caller computes the delta
    before it takes a lock and only adds it under the lock. Raises off the
    CPU: there kernel B applies in one launch."""
    if frames.scales.device.type != "cpu":
        raise ValueError("frames_delta is the CPU's split apply; on a GPU apply_table_batch launches kernel B")
    row_leaf, rowcount, *_ = _consts(spec, "cpu")
    k = frames.scales.shape[0]
    s_rows = frames.scales[:, row_leaf].contiguous()
    words = frames.words.reshape(k, spec.rows * WORDS_PER_ROW).contiguous()
    return codec_cuda.frames_delta_plain(s_rows, rowcount, words)


def apply_delta(arrays: Sequence[torch.Tensor], delta: torch.Tensor, spec: TableSpec) -> tuple[torch.Tensor, ...]:
    """The second half of the CPU's split apply (:func:`frames_delta`):
    ``delta`` added to every array, clamped to +/-SAT, in place."""
    if delta.device.type != "cpu":
        raise ValueError("apply_delta is the CPU's split apply; on a GPU apply_table_batch launches kernel B")
    codec_cuda.check_distinct(arrays)
    return codec_cuda.add_delta_plain(delta, _consts(spec, "cpu")[1], arrays)


def accumulate_table(
    arrays: Sequence[torch.Tensor], update: torch.Tensor, spec: TableSpec
) -> tuple[torch.Tensor, ...]:
    """values += u and each link residual += u, in place. The update is
    sanitised (padding masked, NaN -> 0, +/-inf -> +/-3e38) and each sum
    clamped to +/-3e38."""
    codec_cuda.check_distinct(arrays)
    live = _consts(spec, str(update.device))[2].view(-1)
    u = torch.where(live, update, torch.zeros_like(update))
    u = torch.nan_to_num(u, nan=0.0, posinf=3.0e38, neginf=-3.0e38)
    for a in arrays:
        a.add_(u).clamp_(-3.0e38, 3.0e38)
    return tuple(arrays)
