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
  (from :func:`..codec.compute_scale`, on the device) and a flat live count.
- kernel D, :func:`apply_frame_many` / :func:`apply_frame`
  (``csrc/apply_frame.cu``) replace ``codec_pallas.apply_frame_many`` /
  ``apply_frame`` / ``_apply_kernel``: one scalar-scale frame into K arrays,
  clamped, in place.

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
``ENGINE_LAUNCHES`` those of A-cascade and the finish kernel (not plain
calls). A launch that a wrapper makes while its thread captures a CUDA
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

import torch

from ..config import ScalePolicy
from .codec import CASCADE_MAX_LEVELS, SAT, Frame, compute_scale
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
}
#: The kernels that port a TPU kernel (A-D); the others port the engine's C passes.
TPU_KERNELS = ("quantize_rows", "apply_rows_batch", "quantize", "apply_frame_many")
#: Host helpers built like the kernels; they launch nothing.
HELPERS = {"stream": "stream.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: Kernel launches per wrapper since the last :func:`reset_launches`: A-D
#: here, A-cascade and the finish kernel in ``ENGINE_LAUNCHES``.
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


def _count(name: str) -> None:
    """One launch of kernel ``name``; while this thread captures a CUDA
    graph under :func:`capture_tally`, the capture's tally takes it."""
    tally = getattr(_TALLY, "tally", None)
    if tally is None:
        _counts(name)[name] += 1
    else:
        tally[name] = tally.get(name, 0) + 1


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
    kernels B and D move each lane's 4 elements as one 16-byte access."""
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


def _max_into(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``if (x > acc) acc = x`` on row 0 (max |r|), elementwise."""
    return torch.where(x > acc, x, acc)


def _tree(acc: torch.Tensor) -> torch.Tensor:
    """A warp's shuffle tree over the lanes (the last axis, 32) of ``acc``
    (f64[3 or 4, ..., 32]: max |r|, then sums): the lanes halve five times.
    Returns what lane 0 holds."""
    h = BITS_PER_WORD // 2
    while h:
        acc = torch.cat([_max_into(acc[:1, ..., :h], acc[:1, ..., h : 2 * h]), acc[1:, ..., :h] + acc[1:, ..., h : 2 * h]])
        h //= 2
    return acc[..., 0]


def _warp_sum(seq: torch.Tensor) -> torch.Tensor:
    """A warp's reduction of the columns of ``seq`` (f64[3 or 4, m]): lane
    i takes columns i, i + 32, ... in turn from 0, then :func:`_tree`."""
    pad = -seq.shape[1] % BITS_PER_WORD
    seq = torch.cat([seq, seq.new_zeros((seq.shape[0], pad))], dim=1).view(seq.shape[0], -1, BITS_PER_WORD)
    acc = seq.new_zeros((seq.shape[0], BITS_PER_WORD))
    for m in range(seq.shape[1]):
        acc = torch.cat([_max_into(acc[:1], seq[:1, m]), acc[1:] + seq[1:, m]])
    return _tree(acc)


def _finish_leaf_sums(partials: torch.Tensor, bounds: list, leaf_sums: torch.Tensor) -> None:
    """Each leaf's partials reduced into ``leaf_sums`` in the finish
    kernel's order (``csrc/cascade_round.cu``, step 2): each warp's range
    of consecutive slots (:func:`finish_threads` / 32 ranges, each a
    multiple of 32 long) in rows of 32, lane i summing the slots wb + 32 m
    + i of a leaf in turn, closed by :func:`_tree`; a leaf over several
    ranges is the :func:`_warp_sum` of its first part and the later ranges'
    parts."""
    n_leaves, n = len(bounds) - 1, bounds[-1]
    leaf_sums.zero_()
    threads = finish_threads(n_leaves)
    span = -(-n // threads) * BITS_PER_WORD
    warps, rows = threads // BITS_PER_WORD, span // BITS_PER_WORD
    dev = partials.device
    # every (range, leaf) pair with slots in common, in range order
    pairs = []
    for w in range(warps):
        wb, we = min(w * span, n), min(w * span + span, n)
        pairs += [(w, l) for l in range(n_leaves) if bounds[l] < min(bounds[l + 1], we) and bounds[l + 1] > wb]
    if not pairs:
        return
    pw, pl = (torch.tensor(c, dtype=torch.int64, device=dev) for c in zip(*pairs))
    bt = torch.tensor(bounds, dtype=torch.int64, device=dev)
    x = torch.cat([partials[:, :n], partials.new_zeros((3, warps * span - n))], dim=1)
    x = x.view(3, warps, rows, BITS_PER_WORD)[:, pw]
    slot = torch.arange(warps * span, device=dev).view(warps, rows, BITS_PER_WORD)[pw]
    mask = (slot >= bt[pl, None, None]) & (slot < bt[pl + 1, None, None])
    acc = partials.new_zeros((3, len(pairs), BITS_PER_WORD))
    for m in range(rows):  # lane i: its slots of the leaf in row order, from 0
        xm = torch.where(mask[:, m], x[:, :, m], torch.zeros_like(x[:, :, m]))
        acc = torch.cat([torch.where(mask[:, m] & (xm[:1] > acc[:1]), xm[:1], acc[:1]), acc[1:] + xm[1:]])
    part = _tree(acc)
    head = bt[pl] < torch.clamp(pw * span, max=n)  # the range's part of a leaf begun before it
    heads = partials.new_zeros((3, warps))
    heads[:, pw[head]] = part[:, head]
    leaf_sums[:, pl[~head]] = part[:, ~head]
    for l in range(n_leaves):
        lo, hi = bounds[l], bounds[l + 1]
        if lo == hi:
            continue
        wa, wz = lo // span, (hi - 1) // span
        if wa < wz:
            leaf_sums[:, l] = _warp_sum(torch.cat([leaf_sums[:, l : l + 1], heads[:, wa + 1 : wz + 1]], dim=1))


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
    f64[3, L] in the kernel's order (:func:`_finish_leaf_sums`; without
    ``per_leaf`` their sum over the leaves is :func:`_warp_sum`'s); the scales by the host tier's rule (``ns``: f64 live counts)
    and each leaf's max |r| into ``ladder`` rows 0 and 1; the ladder top
    (row 2) and depth by :func:`..table.cascade_ladder` with the cap
    min(``cap``, K - j0); kc 0 stops."""
    from .table import cascade_ladder

    slots, n_leaves = _check_round(partials, leaf_slots, ns, scales, state, ladder, leaf_sums, k, cap, policy)
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
    _finish_leaf_sums(partials, bounds, leaf_sums)
    amax, ss, sabs = leaf_sums[0], leaf_sums[1], leaf_sums[2]
    n = ns
    if not per_leaf:  # warp 0: lanes strided over the leaves, then its tree
        tot = _warp_sum(torch.cat([leaf_sums, ns.view(1, -1)]))
        amax, ss, sabs, n = (x.expand(n_leaves) for x in tot)
    if policy == ScalePolicy.ABS_MEAN:
        s = (sabs / n).to(torch.float32)
    else:
        s = torch.sqrt(ss / n).to(torch.float32)
        if policy == ScalePolicy.POW2_RMS:
            s = (s.view(torch.int32) & 0x7F800000).view(torch.float32)
    s = torch.where((amax > 0) & torch.isfinite(s), s, torch.zeros_like(s))
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


# -- kernel B: apply_rows_batch ------------------------------------------------


def apply_rows_batch_plain(
    s_rows: torch.Tensor,
    rowcount: torch.Tensor,
    words: torch.Tensor,
    arrays: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of kernel B; updates ``arrays`` in place."""
    rows, k = _check_apply(s_rows, rowcount, words, arrays)
    dev = arrays[0].device
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)
    live = lane[None, :] < rowcount[:, None]
    delta = torch.zeros(rows, LANES, dtype=torch.float32, device=dev)
    w32 = words.view(torch.int32) if words.dtype != torch.int32 else words
    for kf in range(k):  # frame order, from 0.0: bit-equal to the kernel
        bits = unpack_bits(w32[kf]).view(rows, LANES).to(torch.float32)
        delta = delta + s_rows[kf][:, None] * (1.0 - 2.0 * bits)
    delta = torch.where(live, delta, torch.zeros_like(delta))
    for a in arrays:
        v = a.view(rows, LANES)
        v.copy_(torch.where(live, torch.clamp(v + delta, -SAT, SAT), torch.zeros_like(v)))
    return tuple(arrays)


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


# -- kernel C: quantize ------------------------------------------------------------


def quantize_plain(
    residual: torch.Tensor,
    n: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    scale: torch.Tensor | None = None,
) -> tuple[Frame, torch.Tensor]:
    """Plain PyTorch version of kernel C. Returns ``(Frame, residual)``
    with ``residual`` updated in place; ``scale`` (a 0-d f32 tensor)
    defaults to ``compute_scale(residual, n, policy)``."""
    n, n_pad = _check_quantize_flat(residual, n, scale)
    if scale is None:
        scale = compute_scale(residual, n, policy)
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
    """Kernel C on the GPU: the scale in plain torch on the device (as JAX
    computes it in XLA outside the Pallas kernel), then one launch. Returns
    ``(Frame, residual)`` with ``residual`` updated in place. Raises for
    tensors that are not on a GPU."""
    if not isinstance(residual, torch.Tensor) or residual.device.type != "cuda":
        raise ValueError("quantize kernel needs a CUDA residual")
    n, n_pad = _check_quantize_flat(residual, n, scale)
    if scale is None:
        scale = compute_scale(residual, n, policy)
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
