"""Table sync: the codec over a pytree ("table") of tensors with an
independent scale per leaf, in PyTorch.

The counterpart of ``shared_tensor_tpu/ops/table.py``, with the same layout:

- A pytree is flattened into ONE padded flat float32 buffer, each leaf
  padded to a multiple of 1024 so leaf boundaries are row-aligned in the
  (rows, 128) view. Dicts flatten in sorted key order and lists/tuples in
  index order, exactly as ``jax.tree.flatten`` does, so leaf ``i``, every
  row and every frame bit sit where the JAX package puts them.
- Quantization computes a scale per leaf (segment reductions in plain
  torch), then runs the fused sign/pack/error-feedback pass with a per-row
  scale (kernel A, ``codec_cuda.quantize_rows``).
- The receive side unpacks K frames, sums their deltas and applies the sum
  to N arrays in one pass (kernel B, ``codec_cuda.apply_rows_batch``).

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
from .codec import pow2_floor
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


# -- scales ------------------------------------------------------------------


def compute_scales(
    residual: torch.Tensor,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
) -> torch.Tensor:
    """Per-leaf step sizes (overflow-safe segment RMS: each leaf is
    normalised by its own max|r| before squaring).

    Leaf sums are taken as differences of a float64 running sum over the
    f32 row sums, which is deterministic on the GPU (an atomic segment sum
    is not) and at least as exact as the f32 sum it stands for. Against the
    JAX package: POW2_RMS scales are equal or one octave apart, RMS and
    ABS_MEAN agree to a relative 1e-6."""
    row_leaf, _, _, ns, last_row = _consts(spec, str(residual.device))
    rows = residual.view(-1, LANES)
    amax_row = torch.amax(torch.abs(rows), dim=1)
    amax = torch.zeros(spec.num_leaves, dtype=torch.float32, device=residual.device)
    amax = amax.scatter_reduce(0, row_leaf, amax_row, reduce="amax", include_self=True)
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
    return torch.where(ok, scales, torch.zeros_like(scales))


def _table_scales(
    residual: torch.Tensor, spec: TableSpec, policy: ScalePolicy, per_leaf: bool
) -> torch.Tensor:
    """Per-leaf scales; ``per_leaf=False`` computes ONE scale over the whole
    table (the reference's behaviour, needed for wire-compat with C peers),
    replicated to every leaf so the apply path is uniform."""
    if per_leaf:
        return compute_scales(residual, spec, policy)
    one_spec = dataclasses.replace(
        spec, shapes=((spec.total_n,),), ns=(spec.total_n,), padded=(spec.total,)
    )
    # valid because padding lanes are 0 by invariant
    s = compute_scales(residual, one_spec, policy)
    return s.expand(spec.num_leaves).contiguous()


# -- sender ------------------------------------------------------------------


def _quantize_fn(impl: str):
    if impl == "auto":
        return codec_cuda.quantize_rows
    if impl == "kernel":
        return codec_cuda.quantize_rows_kernel
    if impl == "plain":
        return codec_cuda.quantize_rows_plain
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
    """Sender step over a table: per-leaf scales, then the fused
    sign/pack/error-feedback pass. Bit set iff r <= 0; the residual moves by
    -+scale of its own leaf; leaves at scale 0 idle. ``residual`` is updated
    in place and returned with the frame."""
    fn = _quantize_fn(impl)
    scales = _table_scales(residual, spec, policy, per_leaf)
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
