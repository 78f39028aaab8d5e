"""Hand-written CUDA kernels for the codec's sender and receiver passes,
with their plain PyTorch versions beside them.

The counterpart of every TPU kernel in ``shared_tensor_tpu/ops/codec_pallas.py``:

- kernel A, :func:`quantize_rows` (``csrc/quantize_rows.cu``) replaces
  ``codec_pallas.quantize_rows`` / ``_quantize_rows_kernel``: sign bits of
  the live lanes packed LSB-first, error feedback ``r -= +-s`` where live and
  ``s > 0``, padding forced to 0, in place on the residual.
- kernel B, :func:`apply_rows_batch` (``csrc/apply_rows.cu``) replaces
  ``codec_pallas.apply_rows_batch`` / ``_apply_rows_kernel``: K frames
  unpacked and their ``s*(1-2b)`` deltas summed in frame order from 0.0,
  masked, then added to N arrays clamped to +/-SAT, in place.
- kernel C, :func:`quantize` (``csrc/quantize.cu``) replaces
  ``codec_pallas.quantize`` / ``_quantize_kernel``: A with one scalar scale
  and a flat live count, in kernel D's shape (a warp for two 128-element rows,
  16-byte lanes, each row's words from four ballots). Without a scale it runs
  first the scale pass :func:`frame_scale_kernel` (``csrc/frame_scale.cu``),
  which replaces the scale JAX computes in XLA before the Pallas kernel
  (``codec.compute_scale``): max |r|, sum r^2 and sum |r| over the whole
  padded buffer in one pass, in a fixed order, then the host tier's rule
  (``codec_np.compute_scales_np``), all on the device.
- kernel D, :func:`apply_frame_many` / :func:`apply_frame`
  (``csrc/apply_frame.cu``) replace ``codec_pallas.apply_frame_many`` /
  ``apply_frame`` / ``_apply_kernel``: one scalar-scale frame into K arrays,
  clamped, in place.
- the per-leaf scale pass, :func:`leaf_scales` (``csrc/leaf_scale.cu``),
  replaces the per-leaf scales JAX computes in XLA before kernel A's
  ``pallas_call`` (``table.compute_scales``, ``ici._leaf_scales``): each
  leaf's max |r|, sum r^2 and sum |r| in double from per-tile partials, in a
  fixed order (the finish kernel's leaf reduction, ``csrc/scale_common.cuh``),
  then the host tier's rule; :func:`leaf_rule` is its finish alone, on leaf
  sums a pod has reduced over its shard group.

Beside them, two kernels that port no TPU kernel but the native engine's
cascade round, for the device tier's K-frame burst
(``ops/table.quantize_table_cascade``):

- kernel A-cascade, :func:`quantize_rows_cascade`
  (``csrc/quantize_rows_cascade.cu``), the C pass ``stc_quantize_ef_cascade``
  (``native/stcodec.c``): kc frames of an amax-anchored halving ladder
  quantized in one pass, which also writes the per-tile partials (max
  |r|, sum r^2, sum |r| in double) of the residual it leaves, or, with
  ``begin``, only those of the residual as it finds it;
- the finish kernel, :func:`cascade_round` (``csrc/cascade_round.cu``):
  those partials reduced per leaf in a fixed order, then the next round's
  scales (the host tier's rule, ``codec_np.compute_scales_np``), ladder top
  and depth (``table.cascade_ladder``), the stop rule and j0's advance, all
  on the device.

C and D follow the Pallas kernels, not the golden ``ops/codec.py``, on the
padding: they set padding lanes to 0 even at scale 0, where the golden
leaves them as they were.

Layout: a flat f32 buffer viewed as (rows, 128); packed words are 32-bit
(int32 tensors holding the u32 bit patterns), 4 per row, flat bit i in word
i//32 at bit i%32. Kernel B takes its K frames frame-major (``s_rows``
f32[K, rows], ``words`` [K, rows*4]), the layout frames arrive in, where the
Pallas kernel wanted them row-major for its block specs.

Dispatch: each wrapper runs the kernel for CUDA tensors and the plain
version for CPU tensors, and nothing else: there is no fallback from a CUDA
tensor to the plain path. ``LAUNCHES`` counts the launches of A-D and
``ENGINE_LAUNCHES`` those of the kernels that port no TPU kernel:
A-cascade, the finish kernel, the scale pass (two a call) and the per-leaf
scale pass (two a call, one for its rule alone); plain calls count
nothing. A launch that a wrapper makes while its thread captures a CUDA
graph (:func:`capture_tally`) does not run then: it goes to the capture's
tally, and every replay of the graph adds that tally (:func:`count_replay`).

Kernels B and D share one design for Hopper (their bound is bytes: each
target is read and written once, the words read once):

- targets by value: the wrapper hands the C entry point a host array of at
  most :data:`MAX_TARGETS` (8) target pointers, which it passes to the
  kernel as one parameter, so no thread waits on a pointer load; a call with
  more targets is split by :func:`target_groups` into launches of at most
  8, each recomputing the same delta from the same frames in the same order
  (bit-equal), and each launch counts in ``LAUNCHES``;
- 16-byte lanes: a warp takes one 128-lane row, a lane 4 consecutive
  elements as one ``float4``, so every target and the words must be
  16-byte aligned; :func:`check_aligned` raises ``ValueError`` on a
  misaligned view (there is no scalar fallback);
- every load before any store (the frame's words and scales first, then
  every target's), and a grid with a warp for every row, as the card
  measured best (PERF.md).

The shared part of that design is ``csrc/apply_common.cuh``.

Build: ``nvcc`` compiles each source in ``csrc/`` (the kernels and the
host helper ``stream.cu`` of :func:`own_stream`) into its own shared
library (plain C interface, loaded with ctypes) under ``csrc/build/`` at
first use, for ``sm_90a``, without fast-math and without FTZ (subnormals
survive, as in the JAX package's host tier and the C reference). A
library's name carries a hash of its source, the shared headers and the
flags, so an edit to any of them rebuilds it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import operator
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..config import ScalePolicy
from .codec import CASCADE_MAX_LEVELS, SAT, Frame
from .packing import BITS_PER_WORD, LANES, pack_bits, unpack_bits

WORDS_PER_ROW = 4
#: Target arrays one launch of kernel B or D takes; more are split.
MAX_TARGETS = 8
#: Bytes of one kernel lane (a float4): targets and words are aligned to it.
LANE_BYTES = 16

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
SOURCES = {
    "quantize_rows": "quantize_rows.cu",
    "apply_rows_batch": "apply_rows.cu",
    "quantize": "quantize.cu",
    "apply_frame_many": "apply_frame.cu",
    "quantize_rows_cascade": "quantize_rows_cascade.cu",
    "cascade_round": "cascade_round.cu",
    "frame_scale": "frame_scale.cu",
    "leaf_scale": "leaf_scale.cu",
}
#: The kernels that port a TPU kernel (A-D); the others port the engine's C
#: passes and the scales that JAX computes in XLA before kernels C and A.
TPU_KERNELS = ("quantize_rows", "apply_rows_batch", "quantize", "apply_frame_many")
#: Host helpers built like the kernels; they launch nothing.
HELPERS = {"stream": "stream.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: Kernel launches per wrapper since the last :func:`reset_launches`: A-D
#: here, A-cascade, the finish kernel and the two scale passes in ``ENGINE_LAUNCHES``.
LAUNCHES = {name: 0 for name in TPU_KERNELS}
ENGINE_LAUNCHES = {name: 0 for name in SOURCES if name not in TPU_KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()


def reset_launches() -> None:
    for counts in (LAUNCHES, ENGINE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches() -> dict[str, int]:
    """Every kernel's launches since the last :func:`reset_launches`."""
    return {**LAUNCHES, **ENGINE_LAUNCHES}


def _counts(name: str) -> dict[str, int]:
    return LAUNCHES if name in LAUNCHES else ENGINE_LAUNCHES


_TALLY = threading.local()


def _count(name: str, launches: int = 1) -> None:
    """``launches`` launches of kernel ``name``; while this thread captures
    a CUDA graph under :func:`capture_tally`, the capture's tally takes them."""
    tally = getattr(_TALLY, "tally", None)
    if tally is None:
        _counts(name)[name] += launches
    else:
        tally[name] = tally.get(name, 0) + launches


@contextlib.contextmanager
def capture_tally():
    """Wrap a CUDA graph capture made in this thread: yields a dict that
    the wrappers fill with the launches they record into the graph, by
    kernel, instead of counting them in ``LAUNCHES`` (nothing runs until a
    replay). The caller keeps it for :func:`count_replay`."""
    prev = getattr(_TALLY, "tally", None)
    _TALLY.tally = tally = {}
    try:
        yield tally
    finally:
        _TALLY.tally = prev


def count_replay(tally: dict[str, int]) -> None:
    """One replay of a graph ran the launches its capture tallied."""
    for name, n in tally.items():
        _counts(name)[name] += n


# -- build -------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / {**SOURCES, **HELPERS}[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Sequence[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all, and the helpers) that are
    not built yet, one ``nvcc`` per source, all started together. Returns, per kernel, the
    seconds its compile took (0.0 if it was already built) and the
    compiler's report (``-Xptxas -v``: registers, spills). Raises on a
    failed compile."""
    names = [*SOURCES, *HELPERS] if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / {**SOURCES, **HELPERS}[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
_ARGTYPES = {
    # s_row, rowcount, resid, words, rows, stream
    "quantize_rows": ("st_quantize_rows", [_VP, _VP, _VP, _VP, _I64, _VP]),
    # s_rows, rowcount, words, targets (host array), n_targets <= 8, k_frames, rows, stream
    "apply_rows_batch": ("st_apply_rows_batch", [_VP, _VP, _VP, _PP, _I32, _I32, _I64, _VP]),
    # scale, resid, words, n_live, n_pad, stream
    "quantize": ("st_quantize", [_VP, _VP, _VP, _I64, _I64, _VP]),
    # resid, n_pad, n_live, policy, partials (f64), slots, scale, stream
    "frame_scale": ("st_frame_scale", [_VP, _I64, _I64, _I32, _VP, _I32, _VP, _VP]),
    # scale, words, targets (host array), n_targets <= 8, n_live, n_pad, stream
    "apply_frame_many": ("st_apply_frame_many", [_VP, _VP, _PP, _I32, _I64, _I64, _VP]),
    # top, row_leaf (int64), rowcount, state (j0, kc on the device), resid, words, scales,
    # partials (f64), rows, n_leaves, k_frames, begin, stream
    "quantize_rows_cascade": ("st_quantize_rows_cascade",
                              [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32, _VP]),
    # partials, leaf_slots (int64), ns (f64), scales, state (j0, kc, stop), ladder, leaf_sums,
    # slots, n_leaves, k_frames, cap, policy, per_leaf, first, stream
    "cascade_round": ("st_cascade_round",
                      [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _VP]),
    # resid (null: the rule alone on leaf_sums), rowcount, rows, phase, partials (f64), slots,
    # leaf_slots (int64), ns (f64), leaf_sums (f64), scales, n_leaves, policy, per_leaf, stream
    "leaf_scale": ("st_leaf_scales", [_VP, _VP, _I64, _I32, _VP, _I64, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _VP]),
    # device, out: the new stream's handle
    "stream": ("st_stream_create", [_I32, ctypes.POINTER(_VP)]),
}


def _fn(name: str):
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            sym, argtypes = _ARGTYPES[name]
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
            _LIBS[name] = lib
    return getattr(lib, _ARGTYPES[name][0])


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# -- side streams ------------------------------------------------------------

# device index -> handles of streams whose owner was collected
_SPARE_STREAMS: dict[int, list[int]] = {}
_SPARE_MU = threading.Lock()


def own_stream(owner: object, device: torch.device) -> torch.cuda.ExternalStream:
    """A non-blocking CUDA stream on ``device`` that no other live ``owner``
    holds: not one of PyTorch's pooled streams, which it hands out in turn
    to every caller. When ``owner`` is collected the stream is kept for the
    next owner, never destroyed, since the caching allocator may still
    record events on it for tensors it used."""
    index = torch.cuda.current_device() if device.index is None else device.index
    with _SPARE_MU:
        spare = _SPARE_STREAMS.setdefault(index, [])
        handle = spare.pop() if spare else None
    if handle is None:
        out = _VP()
        err = _fn("stream")(index, ctypes.byref(out))
        if err:
            raise RuntimeError(f"cudaStreamCreateWithFlags failed with error {err}")
        handle = out.value
    weakref.finalize(owner, _spare, index, handle)
    return torch.cuda.ExternalStream(handle, device=torch.device("cuda", index))


def _spare(index: int, handle: int) -> None:
    with _SPARE_MU:
        _SPARE_STREAMS[index].append(handle)


# -- argument checks ---------------------------------------------------------


def check_distinct(arrays: Sequence[torch.Tensor]) -> None:
    """Raise if two target arrays share storage: an in-place update would
    then add the delta to that memory twice."""
    seen = set()
    for a in arrays:
        key = (a.device, a.untyped_storage().data_ptr())
        if key in seen:
            raise ValueError("target arrays share storage; pass distinct tensors")
        seen.add(key)


def check_aligned(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise ``ValueError`` unless every tensor starts on a 16-byte boundary:
    kernels B, C and D and the scale pass move each lane's 4 elements as one
    16-byte access."""
    for i, t in enumerate(tensors):
        if t.data_ptr() % LANE_BYTES:
            raise ValueError(
                f"{what}[{i}] starts {t.data_ptr() % LANE_BYTES} bytes off a "
                f"{LANE_BYTES}-byte boundary; the kernel needs aligned tensors"
            )


def target_groups(arrays: Sequence[torch.Tensor]) -> list[tuple[torch.Tensor, ...]]:
    """The targets in order, in groups of at most :data:`MAX_TARGETS`: one
    launch each."""
    return [tuple(arrays[i : i + MAX_TARGETS]) for i in range(0, len(arrays), MAX_TARGETS)]


def _pointers(group: Sequence[torch.Tensor]):
    """A host ctypes array of the group's device addresses."""
    return (ctypes.c_void_p * len(group))(*(a.data_ptr() for a in group))


def _check(t: torch.Tensor, what: str, dtypes, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


_WORD_DTYPES = (torch.int32, torch.uint32)


def _check_quantize(s_row, rowcount, residual) -> int:
    if residual.dim() != 1 or residual.shape[0] % LANES:
        raise ValueError(f"residual must be flat with a multiple of {LANES} elements")
    rows = residual.shape[0] // LANES
    dev = residual.device
    _check(residual, "residual", (torch.float32,), (rows * LANES,), dev)
    _check(s_row, "s_row", (torch.float32,), (rows,), dev)
    _check(rowcount, "rowcount", (torch.int32,), (rows,), dev)
    return rows


def _check_apply(s_rows, rowcount, words, arrays) -> tuple[int, int]:
    if not arrays:
        raise ValueError("need at least one target array")
    a0 = arrays[0]
    if a0.dim() != 1 or a0.shape[0] % LANES:
        raise ValueError(f"arrays must be flat with a multiple of {LANES} elements")
    rows = a0.shape[0] // LANES
    dev = a0.device
    if s_rows.dim() != 2:
        raise ValueError("s_rows must be [K, rows]")
    k = s_rows.shape[0]
    if k < 1:
        raise ValueError("need at least one frame")
    _check(s_rows, "s_rows", (torch.float32,), (k, rows), dev)
    _check(rowcount, "rowcount", (torch.int32,), (rows,), dev)
    _check(words, "words", _WORD_DTYPES, (k, rows * WORDS_PER_ROW), dev)
    for i, a in enumerate(arrays):
        _check(a, f"arrays[{i}]", (torch.float32,), (rows * LANES,), dev)
    check_distinct(arrays)
    return rows, k


# -- kernel A: quantize_rows ---------------------------------------------------


def quantize_rows_plain(
    s_row: torch.Tensor, rowcount: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of kernel A. Returns int32 words [rows*4];
    updates ``residual`` in place."""
    _check_quantize(s_row, rowcount, residual)
    r = residual.view(-1, LANES)
    lane = torch.arange(LANES, dtype=torch.int32, device=r.device)
    live = lane[None, :] < rowcount[:, None]
    s = s_row[:, None]
    neg = r <= 0.0  # zero counts as negative
    words = pack_bits((live & neg).reshape(-1))
    sent = torch.where(neg, -s, s)
    zero = torch.zeros_like(r)
    r.copy_(torch.where(live & (s > 0.0), r - sent, torch.where(live, r, zero)))
    return words


def quantize_rows_kernel(
    s_row: torch.Tensor, rowcount: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """Kernel A on the GPU. Returns int32 words [rows*4]; updates
    ``residual`` in place. Raises for tensors that are not on a GPU."""
    if residual.device.type != "cuda":
        raise ValueError(f"quantize_rows kernel needs CUDA tensors, got {residual.device}")
    rows = _check_quantize(s_row, rowcount, residual)
    words = torch.empty(rows * WORDS_PER_ROW, dtype=torch.int32, device=residual.device)
    fn = _fn("quantize_rows")
    with torch.cuda.device(residual.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(s_row.data_ptr(), rowcount.data_ptr(), residual.data_ptr(),
                 words.data_ptr(), rows, stream)
    _check_launch("quantize_rows", err)
    _count("quantize_rows")
    return words


def quantize_rows(
    s_row: torch.Tensor, rowcount: torch.Tensor, residual: torch.Tensor
) -> torch.Tensor:
    """Kernel A for a CUDA residual, its plain version for a CPU one."""
    if residual.device.type == "cuda":
        return quantize_rows_kernel(s_row, rowcount, residual)
    if residual.device.type == "cpu":
        return quantize_rows_plain(s_row, rowcount, residual)
    raise ValueError(f"unsupported device {residual.device}")


# -- kernel A-cascade: quantize_rows_cascade --------------------------------------

#: Rows of one tile (1024 elements): the unit of a table's leaf padding,
#: and of kernel A-cascade's warps and partials.
TILE_ROWS = 8


def partial_slots(rows: int) -> int:
    """Kernel A-cascade's partial slots for a residual of ``rows`` rows: one
    a tile."""
    return rows // TILE_ROWS


def _check_cascade(top, row_leaf, rowcount, state, residual, words, scales, partials) -> tuple[int, int, int]:
    if not isinstance(residual, torch.Tensor) or residual.dim() != 1 or residual.shape[0] % LANES:
        raise ValueError(f"residual must be a flat tensor with a multiple of {LANES} elements")
    rows = residual.shape[0] // LANES
    if rows % TILE_ROWS:
        raise ValueError(f"residual must hold whole tiles of {TILE_ROWS} rows (a table's padding)")
    dev = residual.device
    _check(residual, "residual", (torch.float32,), (rows * LANES,), dev)
    if not isinstance(scales, torch.Tensor) or scales.dim() != 2:
        raise ValueError("scales must be [K, n_leaves]")
    k, n_leaves = scales.shape
    if k < 1 or n_leaves < 1:
        raise ValueError("need at least one frame and one leaf")
    _check(scales, "scales", (torch.float32,), (k, n_leaves), dev)
    _check(words, "words", _WORD_DTYPES, (k, rows * WORDS_PER_ROW), dev)
    _check(top, "top", (torch.float32,), (n_leaves,), dev)
    _check(row_leaf, "row_leaf", (torch.int64,), (rows,), dev)
    _check(rowcount, "rowcount", (torch.int32,), (rows,), dev)
    if not isinstance(state, torch.Tensor) or state.dim() != 1 or state.shape[0] not in (2, 3):
        raise ValueError("state must be int32 [j0, kc] or [j0, kc, stop]")
    _check(state, "state", (torch.int32,), (state.shape[0],), dev)
    _check(partials, "partials", (torch.float64,), (3, partial_slots(rows)), dev)
    check_distinct([residual, words, scales, partials])
    _check_disjoint([top, row_leaf, rowcount, state], [residual, words, scales, partials])
    return rows, n_leaves, k


def _partials_for(residual: torch.Tensor, partials: torch.Tensor | None) -> torch.Tensor:
    if partials is not None or not isinstance(residual, torch.Tensor) or residual.dim() != 1:
        return partials
    return torch.empty((3, partial_slots(residual.shape[0] // LANES)), dtype=torch.float64, device=residual.device)


def slot_partials_plain(v: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """A-cascade's partials of a residual ``v`` (flat f32, padding lanes 0)
    into ``partials`` f64[3, tiles]: each tile's max |r|, sum r^2 and sum
    |r|, in the kernel's order (each word's 32 values in turn, then a
    halving tree over the tile's 32 words), so the bits are the kernel's."""
    x = v.reshape(-1, BITS_PER_WORD)  # a row a word, a word a thread
    a = x.abs()
    amax = torch.where(a.isnan(), torch.zeros_like(a), a).amax(dim=1)  # a NaN never wins a max
    d = x.to(torch.float64)
    if v.device.type == "cpu":
        # the CPU's cumsum adds along a row in order: the loop below, bit
        # for bit, in two operations instead of 64
        ss, sabs = torch.cumsum(d * d, dim=1)[:, -1], torch.cumsum(d.abs(), dim=1)[:, -1]
    else:
        ss = torch.zeros(x.shape[0], dtype=torch.float64, device=v.device)
        sabs = torch.zeros_like(ss)
        for b in range(x.shape[1]):
            ss = ss + d[:, b] * d[:, b]
            sabs = sabs + d[:, b].abs()
    ss, sabs = ss.view(-1, 32), sabs.view(-1, 32)
    h = 16
    while h:
        ss, sabs = ss[:, :h] + ss[:, h : 2 * h], sabs[:, :h] + sabs[:, h : 2 * h]
        h //= 2
    partials[0] = amax.view(-1, 32).amax(dim=1).to(torch.float64)
    partials[1] = ss[:, 0]
    partials[2] = sabs[:, 0]
    return partials


def quantize_rows_cascade_plain(
    top: torch.Tensor,
    row_leaf: torch.Tensor,
    rowcount: torch.Tensor,
    state: torch.Tensor,
    residual: torch.Tensor,
    words: torch.Tensor,
    scales: torch.Tensor,
    partials: torch.Tensor | None = None,
    begin: bool = False,
) -> None:
    """Plain PyTorch version of kernel A-cascade: frames ``[j0, j0 + kc)``
    (``state``, int32 [j0, kc, ...]) of the halving ladder from ``top`` (f32
    per leaf), each level kernel A's step at its leaf's scale, written into
    rows j0.. of ``words`` [K, rows*4] and ``scales`` [K, L]; ``residual``
    updated in place, padding zeroed; then the partials of the residual left
    into ``partials`` f64[3, slots] (:func:`slot_partials_plain`). kc is
    clipped to the K - j0 frames left and to 64; kc <= 0 does nothing. With
    ``begin``: every frame's words and scales zeroed and the partials of
    ``residual`` as it is, the state ignored."""
    partials = _partials_for(residual, partials)
    _, _, k = _check_cascade(top, row_leaf, rowcount, state, residual, words, scales, partials)
    r = residual.view(-1, LANES)
    lane = torch.arange(LANES, dtype=torch.int32, device=r.device)
    live = lane[None, :] < rowcount[:, None]
    if begin:
        words.zero_()
        scales.zero_()
        slot_partials_plain(torch.where(live, r, torch.zeros_like(r)), partials)
        return
    j0, kc = (int(x) for x in state[:2].tolist())
    kc = min(kc, k - j0, CASCADE_MAX_LEVELS)
    if kc <= 0 or j0 < 0:
        return
    w32 = words.view(torch.int32)
    s_leaf = top.clone()
    v = r.clone()
    for j in range(kc):
        s = s_leaf[row_leaf][:, None]
        neg = v <= 0.0  # zero counts as negative
        w32[j0 + j] = pack_bits((live & neg).reshape(-1))
        scales[j0 + j] = s_leaf
        v = torch.where(live & (s > 0.0), v - torch.where(neg, -s, s), v)
        s_leaf = s_leaf * 0.5
    r.copy_(torch.where(live, v, torch.zeros_like(v)))
    slot_partials_plain(r, partials)


def quantize_rows_cascade_kernel(
    top: torch.Tensor,
    row_leaf: torch.Tensor,
    rowcount: torch.Tensor,
    state: torch.Tensor,
    residual: torch.Tensor,
    words: torch.Tensor,
    scales: torch.Tensor,
    partials: torch.Tensor | None = None,
    begin: bool = False,
) -> None:
    """Kernel A-cascade on the GPU, one launch; j0 and kc are read on the
    device, so the call never waits for it (a CUDA graph may replay it).
    Raises for tensors that are not on a GPU or a residual off a 16-byte
    boundary."""
    if not isinstance(residual, torch.Tensor) or residual.device.type != "cuda":
        raise ValueError("quantize_rows_cascade kernel needs CUDA tensors")
    partials = _partials_for(residual, partials)
    rows, n_leaves, k = _check_cascade(top, row_leaf, rowcount, state, residual, words, scales, partials)
    check_aligned([residual], "residual")
    fn = _fn("quantize_rows_cascade")
    with torch.cuda.device(residual.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(top.data_ptr(), row_leaf.data_ptr(), rowcount.data_ptr(), state.data_ptr(),
                 residual.data_ptr(), words.data_ptr(), scales.data_ptr(), partials.data_ptr(), rows, n_leaves,
                 k, int(bool(begin)), stream)
    _check_launch("quantize_rows_cascade", err)
    _count("quantize_rows_cascade")


def quantize_rows_cascade(
    top: torch.Tensor,
    row_leaf: torch.Tensor,
    rowcount: torch.Tensor,
    state: torch.Tensor,
    residual: torch.Tensor,
    words: torch.Tensor,
    scales: torch.Tensor,
    partials: torch.Tensor | None = None,
    begin: bool = False,
) -> None:
    """Kernel A-cascade for a CUDA residual, its plain version for a CPU one."""
    dev = residual.device if isinstance(residual, torch.Tensor) else None
    args = (top, row_leaf, rowcount, state, residual, words, scales, partials, begin)
    if dev is not None and dev.type == "cuda":
        return quantize_rows_cascade_kernel(*args)
    if dev is not None and dev.type == "cpu":
        return quantize_rows_cascade_plain(*args)
    raise ValueError(f"unsupported device {dev}")


# -- the cascade's finish kernel: cascade_round -------------------------------------

#: ``ScalePolicy`` as the finish kernel's ``policy`` argument
POLICY_CODES = {ScalePolicy.POW2_RMS: 0, ScalePolicy.RMS: 1, ScalePolicy.ABS_MEAN: 2}


def _check_round(partials, leaf_slots, ns, scales, state, ladder, leaf_sums, k, cap, policy) -> tuple[int, int]:
    if not isinstance(partials, torch.Tensor) or partials.dim() != 2 or partials.shape[0] != 3:
        raise ValueError("partials must be f64 [3, slots]")
    slots = partials.shape[1]
    dev = partials.device
    _check(partials, "partials", (torch.float64,), (3, slots), dev)
    if not isinstance(ns, torch.Tensor) or ns.dim() != 1 or ns.shape[0] < 1:
        raise ValueError("ns must be f64 [n_leaves]")
    n_leaves = ns.shape[0]
    _check(ns, "ns", (torch.float64,), (n_leaves,), dev)
    _check(leaf_slots, "leaf_slots", (torch.int64,), (n_leaves + 1,), dev)
    _check(scales, "scales", (torch.float32,), (int(k), n_leaves), dev)
    _check(state, "state", (torch.int32,), (3,), dev)
    _check(ladder, "ladder", (torch.float32,), (3, n_leaves), dev)
    _check(leaf_sums, "leaf_sums", (torch.float64,), (3, n_leaves), dev)
    if int(k) < 1 or not 1 <= int(cap) <= CASCADE_MAX_LEVELS:
        raise ValueError(f"need k >= 1 and a cap in [1, {CASCADE_MAX_LEVELS}], got {k}, {cap}")
    if slots >= 1 << 31:
        raise ValueError(f"the finish takes fewer than 2^31 slots, got {slots}")
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown scale policy {policy!r}")
    check_distinct([state, ladder, leaf_sums])
    _check_disjoint([partials, leaf_slots, ns, scales], [state, ladder, leaf_sums])
    return slots, n_leaves


#: the finish kernel's block: 512 threads for a table of at most
#: FINISH_FEW_LEAVES leaves, else 1024 (:func:`finish_threads`)
FINISH_FEW_LEAVES = 16


def finish_threads(n_leaves: int) -> int:
    """The finish kernel's block size for a table of ``n_leaves`` leaves: a
    warp closes its leaves' parts one after another, so many leaves want
    many warps, and few leaves fewer trees."""
    return 512 if n_leaves <= FINISH_FEW_LEAVES else 1024


def cascade_round_plain(
    partials: torch.Tensor,
    leaf_slots: torch.Tensor,
    ns: torch.Tensor,
    scales: torch.Tensor,
    state: torch.Tensor,
    ladder: torch.Tensor,
    leaf_sums: torch.Tensor,
    k: int,
    cap: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    first: bool = False,
) -> None:
    """Plain PyTorch version of the finish kernel: one cascade round's
    bookkeeping from A-cascade's per-tile ``partials`` (f64[3, tiles]) of
    the residual, in the kernel's order and arithmetic.

    ``state`` (int32 [j0, kc, stop]) holds the round just quantized (none
    when ``first``); once stopped nothing changes. j0 advances by kc; a
    round whose last row of ``scales`` (f32[K, L]) is all zero (the
    subnormal floor) stops, and so does a burst with no frame left, before
    anything is measured. Then each leaf's partials summed (its slots
    ``leaf_slots[l]`` to ``leaf_slots[l + 1]``) into ``leaf_sums``
    f64[3, L] in the kernel's order and the scales by the host tier's rule
    (``ns``: f64 live counts), both by the per-leaf scale pass's twin
    (:func:`_leaf_sums_np`, :func:`_leaf_rule_np`, on host copies), and
    each leaf's max |r| into ``ladder`` rows 0 and 1; the ladder top
    (row 2) and depth by :func:`..table.cascade_ladder` with the cap
    min(``cap``, K - j0); kc 0 stops."""
    from .table import cascade_ladder

    slots, _ = _check_round(partials, leaf_slots, ns, scales, state, ladder, leaf_sums, k, cap, policy)
    j0, kc_prev, stop = (0, 0, 0) if first else (int(x) for x in state.tolist())
    if stop:
        return
    floored = kc_prev > 0 and not bool(scales[j0 + kc_prev - 1].ne(0).any())
    j0 += kc_prev
    if floored or j0 >= int(k):
        state.copy_(torch.tensor([j0, 0, 1], dtype=torch.int32))
        return
    bounds = leaf_slots.tolist()
    if bounds[0] != 0 or bounds[-1] != slots:
        raise ValueError(f"leaf_slots must run from 0 to the partials' {slots} slots, got {bounds[0]}..{bounds[-1]}")
    sums = _leaf_sums_np(partials.cpu().numpy(), bounds)
    leaf_sums.copy_(torch.from_numpy(sums))
    s = torch.from_numpy(_leaf_rule_np(sums, ns.cpu().numpy(), policy, per_leaf)).to(partials.device)
    leaf_amax = leaf_sums[0].to(torch.float32)
    left = torch.tensor(min(int(cap), int(k) - j0), dtype=torch.int64, device=s.device)
    top, kc = cascade_ladder(s, leaf_amax, left)
    kc = max(int(kc), 0)
    ladder[0], ladder[1], ladder[2] = s, leaf_amax, top
    state.copy_(torch.tensor([j0, kc, int(kc == 0)], dtype=torch.int32))


def cascade_round_kernel(
    partials: torch.Tensor,
    leaf_slots: torch.Tensor,
    ns: torch.Tensor,
    scales: torch.Tensor,
    state: torch.Tensor,
    ladder: torch.Tensor,
    leaf_sums: torch.Tensor,
    k: int,
    cap: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    first: bool = False,
) -> None:
    """The finish kernel on the GPU, one launch of one block; everything it
    reads and writes stays on the device (a CUDA graph may replay it).
    Raises for tensors that are not on a GPU."""
    if not isinstance(partials, torch.Tensor) or partials.device.type != "cuda":
        raise ValueError("cascade_round kernel needs CUDA tensors")
    slots, n_leaves = _check_round(partials, leaf_slots, ns, scales, state, ladder, leaf_sums, k, cap, policy)
    fn = _fn("cascade_round")
    with torch.cuda.device(partials.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(partials.data_ptr(), leaf_slots.data_ptr(), ns.data_ptr(), scales.data_ptr(), state.data_ptr(),
                 ladder.data_ptr(), leaf_sums.data_ptr(), slots, n_leaves, int(k), int(cap), POLICY_CODES[policy],
                 int(bool(per_leaf)), int(bool(first)), stream)
    _check_launch("cascade_round", err)
    _count("cascade_round")


def cascade_round(
    partials: torch.Tensor,
    leaf_slots: torch.Tensor,
    ns: torch.Tensor,
    scales: torch.Tensor,
    state: torch.Tensor,
    ladder: torch.Tensor,
    leaf_sums: torch.Tensor,
    k: int,
    cap: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    first: bool = False,
) -> None:
    """The finish kernel for CUDA partials, its plain version for CPU ones."""
    dev = partials.device if isinstance(partials, torch.Tensor) else None
    args = (partials, leaf_slots, ns, scales, state, ladder, leaf_sums, k, cap, policy, per_leaf, first)
    if dev is not None and dev.type == "cuda":
        return cascade_round_kernel(*args)
    if dev is not None and dev.type == "cpu":
        return cascade_round_plain(*args)
    raise ValueError(f"unsupported device {dev}")


# -- the per-leaf scale pass: leaf_scales ---------------------------------------------


def leaf_slot_count(rows: int, phase: int = 0) -> int:
    """The per-leaf scale pass's partial slots for ``rows`` rows whose first
    lies ``phase`` rows into its 8-row tile: one a tile they touch."""
    return (rows + phase + TILE_ROWS - 1) // TILE_ROWS


def _check_leaf(residual, rowcount, leaf_slots, ns, policy, phase) -> tuple[int, int, int]:
    if not isinstance(residual, torch.Tensor) or residual.dim() != 1 or residual.shape[0] == 0 \
            or residual.shape[0] % LANES:
        raise ValueError(f"residual must be a flat tensor with a positive multiple of {LANES} elements")
    rows = residual.shape[0] // LANES
    dev = residual.device
    _check(residual, "residual", (torch.float32,), (rows * LANES,), dev)
    _check(rowcount, "rowcount", (torch.int32,), (rows,), dev)
    if not isinstance(ns, torch.Tensor) or ns.dim() != 1 or ns.shape[0] < 1:
        raise ValueError("ns must be f64 [n_leaves]")
    n_leaves = ns.shape[0]
    _check(ns, "ns", (torch.float64,), (n_leaves,), dev)
    _check(leaf_slots, "leaf_slots", (torch.int64,), (n_leaves + 1,), dev)
    if not 0 <= int(phase) < TILE_ROWS:
        raise ValueError(f"phase must lie in [0, {TILE_ROWS}), got {phase}")
    if rows >= 1 << 31:
        raise ValueError(f"the pass takes fewer than 2^31 rows, got {rows}")
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown scale policy {policy!r}")
    return rows, leaf_slot_count(rows, int(phase)), n_leaves


_LANE_INDEX = np.arange(LANES)[None, :]

#: slots the twin's partials take at once: their double copies (24 B an
#: element) stay at 6 MiB however large the table
LEAF_NP_SLOTS = 256


def _leaf_partials_np(r: np.ndarray, rowcount: np.ndarray, phase: int, slots: int) -> np.ndarray:
    """The per-leaf scale pass's partials (f64[3, slots]) of ``r`` (flat
    f32, live lanes by ``rowcount``, the rest 0, the tile grid shifted by
    ``phase`` rows): each slot's max |r|, sum r^2 and sum |r| in the
    kernel's order (lane i adds r^2 and |r| in double for the 4 elements of
    unit i of each of the slot's 8 rows in turn from 0.0, then the warp's
    tree over its 32 lanes; a NaN never wins the max), so the bits are the
    kernel's."""
    rows = r.shape[0] // LANES
    x = r.reshape(rows, LANES)
    if rowcount.min() < LANES:
        x = np.where(_LANE_INDEX < rowcount[:, None], x, np.float32(0.0))
    tail = slots * TILE_ROWS - rows - phase
    if phase or tail:  # rows off the block add nothing, as in the kernel
        x = np.concatenate([np.zeros((phase, LANES), np.float32), x, np.zeros((tail, LANES), np.float32)])
    x = x.reshape(slots, TILE_ROWS, BITS_PER_WORD, 4)  # [slot, row, lane, component]
    out = np.empty((3, slots))
    acc = np.empty((2, slots, BITS_PER_WORD))
    for lo in range(0, slots, LEAF_NP_SLOTS):
        hi = min(slots, lo + LEAF_NP_SLOTS)
        # [value, slot, lane]: a lane's 32 values, in its order, on the first axis
        out[0, lo:hi] = np.fmax(np.fmax.reduce(np.abs(x[lo:hi]).reshape(hi - lo, -1), axis=1), 0.0)
        d = x[lo:hi].transpose(1, 3, 0, 2).astype(np.float64).reshape(-1, hi - lo, BITS_PER_WORD)
        y = np.empty((d.shape[0], 2, hi - lo, BITS_PER_WORD))
        np.multiply(d, d, out=y[:, 0])
        np.abs(d, out=y[:, 1])
        a = acc[:, lo:hi]
        a[...] = y[0]  # 0.0 + v is v
        for m in range(1, d.shape[0]):
            a += y[m]
    out[1:] = _halve(acc, BITS_PER_WORD)
    return out


def _warp_sum_np(seq: np.ndarray) -> np.ndarray:
    """A warp's reduction of the columns of ``seq`` (f64[3 or 4, m], max |r|
    first, then sums): lane i takes columns i, i + 32, ... in turn from
    0.0, then the halving tree over the lanes."""
    pad = -seq.shape[1] % BITS_PER_WORD
    x = np.concatenate([seq, np.zeros((seq.shape[0], pad))], axis=1).reshape(seq.shape[0], -1, BITS_PER_WORD)
    acc = np.cumsum(x[1:], axis=1)[:, -1]  # lane i: its columns in turn
    return np.concatenate([[x[0].max()], _halve(acc, BITS_PER_WORD)])


@functools.lru_cache(maxsize=64)
def _leaf_plan(bounds: tuple) -> tuple:
    """The finish kernel's order for leaf bounds ``bounds`` (a layout's
    constant): every (range, leaf) part's slots as [part, row, lane]
    indices with a mask of those in the part, and each leaf's run of parts
    in range order."""
    n_leaves, n = len(bounds) - 1, bounds[-1]
    span = -(-n // finish_threads(n_leaves)) * BITS_PER_WORD
    parts = [(l, w, max(lo, w * span), min(hi, w * span + span))
             for l, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])) if lo < hi
             for w in range(lo // span, (hi - 1) // span + 1)]
    leaf, w, plo, phi = (np.asarray(c) for c in zip(*parts))
    idx = (w[:, None, None] * span + BITS_PER_WORD * np.arange(span // BITS_PER_WORD)[None, :, None]
           + np.arange(BITS_PER_WORD)[None, None, :])
    inside = (idx >= plo[:, None, None]) & (idx < phi[:, None, None])
    first = [i for i in range(len(parts)) if i == 0 or leaf[i] != leaf[i - 1]]
    runs = tuple((int(leaf[f]), f, z) for f, z in zip(first, first[1:] + [len(parts)]))
    return np.minimum(idx, n - 1), inside, runs


def _leaf_sums_np(partials: np.ndarray, bounds: list) -> np.ndarray:
    """Each leaf's partials (f64[3, n]) reduced into f64[3, L] in the finish
    kernel's order (``csrc/scale_common.cuh``, shared by the per-leaf scale
    pass and the cascade's finish): the slots split into one range of
    consecutive slots a warp (:func:`finish_threads` / 32 ranges, each a
    multiple of 32 long); every (range, leaf) part is a lane's sum of the
    leaf's slots wb + 32 m + i row by row, then the warp's tree; a leaf
    over several ranges is the :func:`_warp_sum_np` of its parts in range
    order."""
    out = np.zeros((3, len(bounds) - 1))
    if bounds[-1] == 0:
        return out
    idx, inside, runs = _leaf_plan(tuple(bounds))
    vals = np.where(inside, partials[:, idx], 0.0)  # [stat, part, row, lane]
    sums = np.empty((3, idx.shape[0]))
    sums[0] = vals[0].max(axis=(1, 2))
    sums[1:] = _halve(np.cumsum(vals[1:], axis=2)[:, :, -1], BITS_PER_WORD)  # a lane's rows in turn, then the tree
    for leaf, f, z in runs:
        out[:, leaf] = sums[:, f] if z - f == 1 else _warp_sum_np(sums[:, f:z])
    return out


def _scale_rule_np(amax, ss, sabs, n, policy: ScalePolicy) -> np.ndarray:
    """The host tier's rule on double sums (``scale_common.cuh``'s
    ``scale_rule``): POW2_RMS and RMS take sqrt(ss / n) rounded to f32,
    POW2_RMS then floored to a power of two, ABS_MEAN sabs / n; 0 where max
    |r| is not above 0 or the scale is not finite (n >= 1 and the sums >= 0
    or NaN: no division by 0 or root of a negative; an RMS never exceeds
    its max |r|, so only an inf rounds out of f32)."""
    if policy == ScalePolicy.ABS_MEAN:
        s = (sabs / n).astype(np.float32)
    else:
        s = np.sqrt(ss / n).astype(np.float32)
        if policy == ScalePolicy.POW2_RMS:
            s = (s.view(np.uint32) & np.uint32(0x7F800000)).view(np.float32)
    return np.where((amax > 0) & np.isfinite(s), s, np.float32(0.0))


def _leaf_rule_np(sums: np.ndarray, n: np.ndarray, policy: ScalePolicy, per_leaf: bool) -> np.ndarray:
    """f32[L] scales from leaf sums f64[3, L] and live counts ``n`` by the
    rule; without ``per_leaf`` one sum over the leaves (warp 0's
    :func:`_warp_sum_np`), replicated to every leaf."""
    if per_leaf or n.shape[0] == 1:  # one leaf: the sum over the leaves is its own (x + 0.0 = x)
        return _scale_rule_np(sums[0], sums[1], sums[2], n, policy)
    return np.repeat(_scale_rule_np(*_warp_sum_np(np.concatenate([sums, n[None]])), policy), n.shape[0])


def leaf_scales_plain(residual: torch.Tensor, rowcount: torch.Tensor, leaf_slots: torch.Tensor, ns: torch.Tensor,
                      policy: ScalePolicy = ScalePolicy.POW2_RMS, per_leaf: bool = True,
                      phase: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the per-leaf scale pass: ``(scales f32[L], leaf_sums
    f64[3, L])`` of ``residual`` (flat f32, live lanes by ``rowcount``),
    leaf l owning the partial slots ``leaf_slots[l]`` to ``leaf_slots[l +
    1]`` of a tile grid shifted by ``phase`` rows (:func:`leaf_slot_count`);
    ``ns`` holds each leaf's live count (f64). The partials
    (:func:`_leaf_partials_np`), each leaf's sum of them in the finish
    kernel's order (:func:`_leaf_sums_np`), then the host tier's rule, in
    numpy: the kernel's IEEE double arithmetic in its order, so the bits are
    the kernel's. A CUDA residual (a reference run) is read through a host
    copy and its results come back to its device."""
    _, slots, _ = _check_leaf(residual, rowcount, leaf_slots, ns, policy, phase)
    bounds = leaf_slots.tolist()
    if bounds[0] != 0 or bounds[-1] != slots:
        raise ValueError(f"leaf_slots must run from 0 to the pass's {slots} slots, got {bounds[0]}..{bounds[-1]}")
    sums = _leaf_sums_np(_leaf_partials_np(residual.cpu().numpy(), rowcount.cpu().numpy(), int(phase), slots),
                         bounds)
    s = _leaf_rule_np(sums, ns.cpu().numpy(), policy, per_leaf)
    return torch.from_numpy(s).to(residual.device), torch.from_numpy(sums).to(residual.device)


def leaf_rule_plain(leaf_sums: torch.Tensor, ns: torch.Tensor, policy: ScalePolicy = ScalePolicy.POW2_RMS,
                    per_leaf: bool = True) -> torch.Tensor:
    """Plain twin of the pass's rule alone: f32[L] scales from leaf sums
    f64[3, L] (max |r|, sum r^2, sum |r|) and live counts ``ns`` f64[L]
    (:func:`_leaf_rule_np` on host copies, on ``ns``' device)."""
    _check_rule(leaf_sums, ns, policy)
    s = _leaf_rule_np(leaf_sums.cpu().numpy(), ns.cpu().numpy(), policy, per_leaf)
    return torch.from_numpy(s).to(ns.device)


def leaf_scales_kernel(residual: torch.Tensor, rowcount: torch.Tensor, leaf_slots: torch.Tensor, ns: torch.Tensor,
                       policy: ScalePolicy = ScalePolicy.POW2_RMS, per_leaf: bool = True,
                       phase: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-leaf scale pass on the GPU: two launches (the partials into a
    workspace, then the one-block finish), both counted; the scales and
    the leaf sums stay on the device and nothing waits for it. The
    residual is only read. Raises for a residual that is not on a GPU or
    not 16-byte aligned."""
    if not isinstance(residual, torch.Tensor) or residual.device.type != "cuda":
        raise ValueError("leaf_scales kernel needs a CUDA residual")
    rows, slots, n_leaves = _check_leaf(residual, rowcount, leaf_slots, ns, policy, phase)
    check_aligned([residual], "residual")
    dev = residual.device
    partials = torch.empty((3, slots), dtype=torch.float64, device=dev)
    leaf_sums = torch.empty((3, n_leaves), dtype=torch.float64, device=dev)
    scales = torch.empty(n_leaves, dtype=torch.float32, device=dev)
    fn = _fn("leaf_scale")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(residual.data_ptr(), rowcount.data_ptr(), rows, int(phase), partials.data_ptr(), slots,
                 leaf_slots.data_ptr(), ns.data_ptr(), leaf_sums.data_ptr(), scales.data_ptr(), n_leaves,
                 POLICY_CODES[policy], int(bool(per_leaf)), stream)
    _check_launch("leaf_scale", err)
    _count("leaf_scale", 2)
    return scales, leaf_sums


def leaf_scales(residual: torch.Tensor, rowcount: torch.Tensor, leaf_slots: torch.Tensor, ns: torch.Tensor,
                policy: ScalePolicy = ScalePolicy.POW2_RMS, per_leaf: bool = True,
                phase: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-leaf scale pass for a CUDA residual, its plain twin for a CPU
    one: the scales JAX computes in XLA before kernel A's ``pallas_call``."""
    dev = residual.device if isinstance(residual, torch.Tensor) else None
    args = (residual, rowcount, leaf_slots, ns, policy, per_leaf, phase)
    if dev is not None and dev.type == "cuda":
        return leaf_scales_kernel(*args)
    if dev is not None and dev.type == "cpu":
        return leaf_scales_plain(*args)
    raise ValueError(f"unsupported device {dev}")


def _check_rule(leaf_sums, ns, policy) -> int:
    if not isinstance(ns, torch.Tensor) or ns.dim() != 1 or ns.shape[0] < 1:
        raise ValueError("ns must be f64 [n_leaves]")
    n_leaves = ns.shape[0]
    _check(ns, "ns", (torch.float64,), (n_leaves,), ns.device)
    _check(leaf_sums, "leaf_sums", (torch.float64,), (3, n_leaves), ns.device)
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown scale policy {policy!r}")
    return n_leaves


def leaf_rule_kernel(leaf_sums: torch.Tensor, ns: torch.Tensor, policy: ScalePolicy = ScalePolicy.POW2_RMS,
                     per_leaf: bool = True) -> torch.Tensor:
    """The pass's finish without its reduction, on the GPU: f32[L] scales
    from leaf sums as given (a pod block's, summed over its shard group),
    one launch of ``st_leaf_scales`` with no residual, counted under the
    pass's name. Raises off the GPU."""
    if not isinstance(ns, torch.Tensor) or ns.device.type != "cuda":
        raise ValueError("leaf_rule kernel needs CUDA tensors")
    n_leaves = _check_rule(leaf_sums, ns, policy)
    scales = torch.empty(n_leaves, dtype=torch.float32, device=ns.device)
    fn = _fn("leaf_scale")
    with torch.cuda.device(ns.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(None, None, 0, 0, None, 0, None, ns.data_ptr(), leaf_sums.data_ptr(), scales.data_ptr(), n_leaves,
                 POLICY_CODES[policy], int(bool(per_leaf)), stream)
    _check_launch("leaf_scale", err)
    _count("leaf_scale")
    return scales


def leaf_rule(leaf_sums: torch.Tensor, ns: torch.Tensor, policy: ScalePolicy = ScalePolicy.POW2_RMS,
              per_leaf: bool = True) -> torch.Tensor:
    """The pass's rule alone for CUDA leaf sums, its plain twin for CPU ones."""
    dev = ns.device if isinstance(ns, torch.Tensor) else None
    if dev is not None and dev.type == "cuda":
        return leaf_rule_kernel(leaf_sums, ns, policy, per_leaf)
    if dev is not None and dev.type == "cpu":
        return leaf_rule_plain(leaf_sums, ns, policy, per_leaf)
    raise ValueError(f"unsupported device {dev}")


# -- kernel B: apply_rows_batch ------------------------------------------------


#: the elements of frame deltas that the plain kernel B unpacks at once
APPLY_PLAIN_ELEMS = 1 << 22


def frames_delta_plain(s_rows: torch.Tensor, rowcount: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """The first half of plain kernel B: the K frames' ``s*(1-2b)`` deltas
    summed in frame order from 0.0 and masked, f32[rows, LANES]. The frames
    are unpacked a few at a time: few operations for a small table, bounded
    memory for a large one."""
    k, rows = s_rows.shape
    dev = s_rows.device
    live = torch.arange(LANES, dtype=torch.int32, device=dev)[None, :] < rowcount[:, None]
    delta = torch.zeros(rows, LANES, dtype=torch.float32, device=dev)
    w32 = words.view(torch.int32) if words.dtype != torch.int32 else words
    per = max(1, min(k, APPLY_PLAIN_ELEMS // (rows * LANES)))
    for lo in range(0, k, per):
        hi = min(k, lo + per)
        bits = unpack_bits(w32[lo:hi]).view(hi - lo, rows, LANES).to(torch.float32)
        for x in s_rows[lo:hi, :, None] * (1.0 - 2.0 * bits):
            delta = delta + x
    return torch.where(live, delta, torch.zeros_like(delta))


def add_delta_plain(delta: torch.Tensor, rowcount: torch.Tensor, arrays: Sequence[torch.Tensor]) -> tuple:
    """The second half of plain kernel B: ``delta`` (from
    :func:`frames_delta_plain`) added to each array, clamped to +/-SAT,
    padding zeroed, in place."""
    rows = delta.shape[0]
    live = torch.arange(LANES, dtype=torch.int32, device=delta.device)[None, :] < rowcount[:, None]
    for a in arrays:
        v = a.view(rows, LANES)
        v.copy_(torch.where(live, torch.clamp(v + delta, -SAT, SAT), torch.zeros_like(v)))
    return tuple(arrays)


def apply_rows_batch_plain(
    s_rows: torch.Tensor,
    rowcount: torch.Tensor,
    words: torch.Tensor,
    arrays: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel B (:func:`frames_delta_plain`, then
    :func:`add_delta_plain`): bit-equal to the kernel; updates ``arrays``
    in place."""
    _check_apply(s_rows, rowcount, words, arrays)
    return add_delta_plain(frames_delta_plain(s_rows, rowcount, words), rowcount, arrays)


def apply_rows_batch_kernel(
    s_rows: torch.Tensor,
    rowcount: torch.Tensor,
    words: torch.Tensor,
    arrays: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, ...]:
    """Kernel B on the GPU, one launch per group of at most 8 arrays;
    updates ``arrays`` in place. Raises for tensors that are not on a GPU
    or not 16-byte aligned."""
    if not arrays or arrays[0].device.type != "cuda":
        raise ValueError("apply_rows_batch kernel needs CUDA tensors")
    rows, k = _check_apply(s_rows, rowcount, words, arrays)
    check_aligned(arrays, "arrays")
    check_aligned([words], "words")
    fn = _fn("apply_rows_batch")
    with torch.cuda.device(arrays[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for group in target_groups(arrays):
            err = fn(s_rows.data_ptr(), rowcount.data_ptr(), words.data_ptr(),
                     _pointers(group), len(group), k, rows, stream)
            _check_launch("apply_rows_batch", err)
            _count("apply_rows_batch")
    return tuple(arrays)


def apply_rows_batch(
    s_rows: torch.Tensor,
    rowcount: torch.Tensor,
    words: torch.Tensor,
    arrays: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, ...]:
    """Kernel B for CUDA arrays, its plain version for CPU ones."""
    dev = arrays[0].device if arrays else None
    if dev is not None and dev.type == "cuda":
        return apply_rows_batch_kernel(s_rows, rowcount, words, arrays)
    if dev is not None and dev.type == "cpu":
        return apply_rows_batch_plain(s_rows, rowcount, words, arrays)
    raise ValueError(f"unsupported device {dev}")


# -- kernels C and D: the scalar codec ----------------------------------------------


def _check_flat(t: torch.Tensor, what: str) -> int:
    """A flat f32 buffer of a positive multiple of 128 elements; its length."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.dim() != 1 or t.shape[0] == 0 or t.shape[0] % LANES:
        raise ValueError(f"{what} must be flat with a positive multiple of {LANES} elements")
    _check(t, what, (torch.float32,), (t.shape[0],), t.device)
    return t.shape[0]


def _check_live(n: int, n_pad: int) -> int:
    n = operator.index(n)
    if not 0 <= n <= n_pad:
        raise ValueError(f"live count {n} is outside [0, {n_pad}]")
    return n


def _check_disjoint(inputs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor]) -> None:
    """Raise if an input shares storage with a target the kernel writes."""
    written = {(t.device, t.untyped_storage().data_ptr()) for t in targets}
    for t in inputs:
        if (t.device, t.untyped_storage().data_ptr()) in written:
            raise ValueError("an input shares storage with an array updated in place")


def _check_quantize_flat(residual, n, scale) -> tuple[int, int]:
    n_pad = _check_flat(residual, "residual")
    n = _check_live(n, n_pad)
    if scale is not None:
        _check(scale, "scale", (torch.float32,), (), residual.device)
        _check_disjoint([scale], [residual])
    return n, n_pad


def _check_apply_frame(arrays, frame: Frame, n) -> tuple[int, int]:
    if not arrays:
        raise ValueError("need at least one target array")
    n_pad = _check_flat(arrays[0], "arrays[0]")
    dev = arrays[0].device
    for i, a in enumerate(arrays):
        _check(a, f"arrays[{i}]", (torch.float32,), (n_pad,), dev)
    n = _check_live(n, n_pad)
    _check(frame.scale, "frame.scale", (torch.float32,), (), dev)
    _check(frame.words, "frame.words", _WORD_DTYPES, (n_pad // BITS_PER_WORD,), dev)
    check_distinct(arrays)
    _check_disjoint([frame.scale, frame.words], arrays)
    return n, n_pad


# -- the scale pass: frame_scale ---------------------------------------------------

#: The scale pass's threads a block and blocks at most (``csrc/frame_scale.cu``):
#: they fix its order, which the plain twin repeats.
SCALE_THREADS = 512
SCALE_BLOCKS = 264


def scale_slots(n_pad: int) -> int:
    """The scale pass's partial slots (its first launch's blocks) for
    ``n_pad`` elements."""
    return min(-(-(n_pad // 4) // SCALE_THREADS), SCALE_BLOCKS)


def _check_scale(residual, n, policy) -> tuple[int, int]:
    n_pad = _check_flat(residual, "residual")
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown scale policy {policy!r}")
    return _check_live(n, n_pad), n_pad


def _halve(acc, lanes: int):
    """A shuffle tree's sums over the last axis (``lanes``, a power of two)
    of ``acc`` (a tensor or a numpy array): lane i adds lane i + h for
    h = lanes / 2, ..., 1. Returns what lane 0 holds."""
    h = lanes // 2
    while h:
        acc = acc[..., :h] + acc[..., h : 2 * h]
        h //= 2
    return acc[..., 0]


def frame_scale_plain(residual: torch.Tensor, n: int, policy: ScalePolicy = ScalePolicy.POW2_RMS) -> torch.Tensor:
    """Plain twin of the scale pass: the frame's scale (0-d f32) from the
    whole padded ``residual`` and the live count ``n``, in the kernel's
    order and arithmetic, so the bits are the kernel's on any device: each
    thread's units in turn (x, y, z, w each), its warp's tree, the block's
    tree over its 16 warps, then the finish warp (lane i over slots i,
    i + 32, ... in turn, then its tree); then the rule of
    ``codec_np.compute_scales_np``. Max |r| only decides whether the scale
    is 0, and a max is exact in any order, so it is one reduction here. A
    CPU residual is reduced through numpy: the same IEEE double arithmetic,
    at a fraction of torch's cost a call on the tree's small arrays."""
    n, n_pad = _check_scale(residual, n, policy)
    cpu = residual.device.type == "cpu"
    slots = scale_slots(n_pad)
    threads = slots * SCALE_THREADS
    k = -(-(n_pad // 4) // threads)
    x = residual.numpy() if cpu else residual
    live = bool((abs(x) > 0).any()) if cpu else (x.abs() > 0).any()  # max |r| > 0: a NaN never wins a max
    d = x.astype(np.float64) if cpu else x.to(torch.float64)
    tail = k * threads * 4 - n_pad
    if tail:  # zeros past the buffer add nothing, as in the kernel
        d = np.concatenate([d, np.zeros(tail)]) if cpu else torch.cat([d, d.new_zeros(tail)])
    # each thread's units in turn, each unit's components in order
    d = d.reshape(k, threads, 4)
    ss, sabs = d[0, :, 0] * d[0, :, 0], abs(d[0, :, 0])
    for i in range(1, 4 * k):
        v = d[i // 4, :, i % 4]
        ss, sabs = ss + v * v, sabs + abs(v)
    acc = (np.stack if cpu else torch.stack)([ss, sabs])
    acc = _halve(acc.reshape(2, slots, SCALE_THREADS // BITS_PER_WORD, BITS_PER_WORD), BITS_PER_WORD)
    # warp 0 over the block's warps (lanes past them hold 0, which adds nothing)
    acc = _halve(acc, SCALE_THREADS // BITS_PER_WORD)
    # the finish warp: lane i takes slots i, i + 32, ... in turn
    width = -(-slots // BITS_PER_WORD) * BITS_PER_WORD
    cols = np.zeros((2, width)) if cpu else acc.new_zeros((2, width))
    cols[:, :slots] = acc
    cols = cols.reshape(2, -1, BITS_PER_WORD)
    lane = cols[:, 0]
    for m in range(1, cols.shape[1]):
        lane = lane + cols[:, m]
    ss, sabs = _halve(lane, BITS_PER_WORD)
    if cpu:
        s = np.float32(sabs / n if policy == ScalePolicy.ABS_MEAN else np.sqrt(ss / n))
        if policy == ScalePolicy.POW2_RMS:
            s = (s.view(np.uint32) & np.uint32(0x7F800000)).view(np.float32)
        return torch.tensor(s if live and np.isfinite(s) else np.float32(0.0))
    s = (sabs / n if policy == ScalePolicy.ABS_MEAN else torch.sqrt(ss / n)).to(torch.float32)
    if policy == ScalePolicy.POW2_RMS:
        s = (s.view(torch.int32) & 0x7F800000).view(torch.float32)
    return torch.where(live & torch.isfinite(s), s, torch.zeros_like(s))


def frame_scale_kernel(residual: torch.Tensor, n: int, policy: ScalePolicy = ScalePolicy.POW2_RMS) -> torch.Tensor:
    """The scale pass on the GPU: two launches (the partials into a
    workspace of f64[3, :func:`scale_slots`], then the finish warp), both
    counted; the scale (0-d f32) stays on the device.
    Raises for a residual that is not on a GPU or not 16-byte aligned."""
    if not isinstance(residual, torch.Tensor) or residual.device.type != "cuda":
        raise ValueError("frame_scale kernel needs a CUDA residual")
    n, n_pad = _check_scale(residual, n, policy)
    check_aligned([residual], "residual")
    slots = scale_slots(n_pad)
    partials = torch.empty((3, slots), dtype=torch.float64, device=residual.device)
    scale = torch.empty((), dtype=torch.float32, device=residual.device)
    fn = _fn("frame_scale")
    with torch.cuda.device(residual.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(residual.data_ptr(), n_pad, n, POLICY_CODES[policy], partials.data_ptr(), slots,
                 scale.data_ptr(), stream)
    _check_launch("frame_scale", err)
    _count("frame_scale", 2)
    return scale


# -- kernel C: quantize ------------------------------------------------------------


def quantize_plain(
    residual: torch.Tensor,
    n: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    scale: torch.Tensor | None = None,
) -> tuple[Frame, torch.Tensor]:
    """Plain PyTorch version of kernel C. Returns ``(Frame, residual)``
    with ``residual`` updated in place; ``scale`` (a 0-d f32 tensor)
    defaults to the scale pass's twin, ``frame_scale_plain(residual, n,
    policy)``."""
    n, n_pad = _check_quantize_flat(residual, n, scale)
    if scale is None:
        scale = frame_scale_plain(residual, n, policy)
    live = torch.arange(n_pad, device=residual.device) < n
    neg = residual <= 0.0  # zero counts as negative
    words = pack_bits(live & neg)
    sent = torch.where(neg, -scale, scale)
    zero = torch.zeros_like(residual)
    residual.copy_(torch.where(live & (scale > 0.0), residual - sent, torch.where(live, residual, zero)))
    return Frame(scale, words), residual


def quantize_kernel(
    residual: torch.Tensor,
    n: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    scale: torch.Tensor | None = None,
) -> tuple[Frame, torch.Tensor]:
    """Kernel C on the GPU: without ``scale``, the scale pass first
    (:func:`frame_scale_kernel`, where JAX computes the scale in XLA outside
    the Pallas kernel), then one launch; nothing waits for the device.
    Returns ``(Frame, residual)`` with ``residual`` updated in place. Raises
    for tensors that are not on a GPU or a residual off a 16-byte boundary."""
    if not isinstance(residual, torch.Tensor) or residual.device.type != "cuda":
        raise ValueError("quantize kernel needs a CUDA residual")
    n, n_pad = _check_quantize_flat(residual, n, scale)
    check_aligned([residual], "residual")
    if scale is None:
        scale = frame_scale_kernel(residual, n, policy)
    words = torch.empty(n_pad // BITS_PER_WORD, dtype=torch.int32, device=residual.device)
    fn = _fn("quantize")
    with torch.cuda.device(residual.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(scale.data_ptr(), residual.data_ptr(), words.data_ptr(), n, n_pad, stream)
    _check_launch("quantize", err)
    _count("quantize")
    return Frame(scale, words), residual


def quantize(
    residual: torch.Tensor,
    n: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    scale: torch.Tensor | None = None,
) -> tuple[Frame, torch.Tensor]:
    """Kernel C for a CUDA residual, its plain version for a CPU one: the
    counterpart of ``codec_pallas.quantize`` (whose donated residual is
    this in-place update)."""
    dev = residual.device if isinstance(residual, torch.Tensor) else None
    if dev is not None and dev.type == "cuda":
        return quantize_kernel(residual, n, policy, scale)
    if dev is not None and dev.type == "cpu":
        return quantize_plain(residual, n, policy, scale)
    raise ValueError(f"unsupported device {dev}")


# -- kernel D: apply_frame_many ------------------------------------------------------


def apply_frame_many_plain(
    arrays: Sequence[torch.Tensor], frame: Frame, n: int
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel D; updates ``arrays`` in place."""
    n, n_pad = _check_apply_frame(arrays, frame, n)
    live = torch.arange(n_pad, device=arrays[0].device) < n
    w32 = frame.words.view(torch.int32) if frame.words.dtype != torch.int32 else frame.words
    delta = torch.where(unpack_bits(w32) != 0, -frame.scale, frame.scale)
    for a in arrays:
        a.copy_(torch.where(live, torch.clamp(a + delta, -SAT, SAT), torch.zeros_like(a)))
    return tuple(arrays)


def apply_frame_many_kernel(
    arrays: Sequence[torch.Tensor], frame: Frame, n: int
) -> tuple[torch.Tensor, ...]:
    """Kernel D on the GPU, one launch per group of at most 8 arrays;
    updates them in place. Raises for tensors that are not on a GPU or not
    16-byte aligned."""
    if not arrays or not isinstance(arrays[0], torch.Tensor) or arrays[0].device.type != "cuda":
        raise ValueError("apply_frame_many kernel needs CUDA tensors")
    n, n_pad = _check_apply_frame(arrays, frame, n)
    check_aligned(arrays, "arrays")
    check_aligned([frame.words], "frame.words")
    fn = _fn("apply_frame_many")
    with torch.cuda.device(arrays[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for group in target_groups(arrays):
            err = fn(frame.scale.data_ptr(), frame.words.data_ptr(), _pointers(group),
                     len(group), n, n_pad, stream)
            _check_launch("apply_frame_many", err)
            _count("apply_frame_many")
    return tuple(arrays)


def apply_frame_many(
    arrays: Sequence[torch.Tensor], frame: Frame, n: int
) -> tuple[torch.Tensor, ...]:
    """Kernel D for CUDA arrays, its plain version for CPU ones: the
    counterpart of ``codec_pallas.apply_frame_many`` (donated arrays are
    this in-place update)."""
    dev = arrays[0].device if arrays and isinstance(arrays[0], torch.Tensor) else None
    if dev is not None and dev.type == "cuda":
        return apply_frame_many_kernel(arrays, frame, n)
    if dev is not None and dev.type == "cpu":
        return apply_frame_many_plain(arrays, frame, n)
    raise ValueError(f"unsupported device {dev}")


def apply_frame(values: torch.Tensor, frame: Frame, n: int) -> torch.Tensor:
    """Kernel D with one target array (``codec_pallas.apply_frame``)."""
    return apply_frame_many((values,), frame, n)[0]
