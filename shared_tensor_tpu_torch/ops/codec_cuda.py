"""Hand-written CUDA kernels for the table codec's two row passes, with
their plain PyTorch versions beside them.

The counterpart of ``shared_tensor_tpu/ops/codec_pallas.py``'s row-granular
primitives (the two TPU kernels on the per-frame path):

- kernel A, :func:`quantize_rows` (``csrc/quantize_rows.cu``) replaces
  ``codec_pallas.quantize_rows`` / ``_quantize_rows_kernel``: sign bits of
  the live lanes packed LSB-first, error feedback ``r -= +-s`` where live and
  ``s > 0``, padding forced to 0, in place on the residual.
- kernel B, :func:`apply_rows_batch` (``csrc/apply_rows.cu``) replaces
  ``codec_pallas.apply_rows_batch`` / ``_apply_rows_kernel``: K frames
  unpacked and their ``s*(1-2b)`` deltas summed in frame order from 0.0,
  masked, then added to N arrays clamped to +/-SAT, in place.

Layout: a flat f32 buffer viewed as (rows, 128); packed words are 32-bit
(int32 tensors holding the u32 bit patterns), 4 per row, flat bit i in word
i//32 at bit i%32. Kernel B takes its K frames frame-major (``s_rows``
f32[K, rows], ``words`` [K, rows*4]), the layout frames arrive in, where the
Pallas kernel wanted them row-major for its block specs.

Dispatch: the wrappers :func:`quantize_rows` / :func:`apply_rows_batch` run
the kernel for CUDA tensors and the plain version for CPU tensors, and
nothing else: there is no fallback from a CUDA tensor to the plain path.
``LAUNCHES`` counts kernel launches (not plain calls).

Build: ``nvcc`` compiles each source in ``csrc/`` into its own shared
library (plain C interface, loaded with ctypes) under ``csrc/build/`` at
first use, for ``sm_90a``, without fast-math (subnormal residuals must
survive, as in the JAX golden).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

from .codec import SAT
from .packing import LANES, pack_bits, unpack_bits

WORDS_PER_ROW = 4

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
SOURCES = {"quantize_rows": "quantize_rows.cu", "apply_rows_batch": "apply_rows.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {name: 0 for name in SOURCES}

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()
_PTR_CACHE: dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Sequence[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns, per kernel, the
    seconds its compile took (0.0 if it was already built) and the
    compiler's report (``-Xptxas -v``: registers, spills). Raises on a
    failed compile."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
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
_ARGTYPES = {
    # s_row, rowcount, resid, words, rows, stream
    "quantize_rows": ("st_quantize_rows", [_VP, _VP, _VP, _VP, _I64, _VP]),
    # s_rows, rowcount, words, array_ptrs, n_arrays, k_frames, rows, stream
    "apply_rows_batch": ("st_apply_rows_batch", [_VP, _VP, _VP, _VP, _I32, _I32, _I64, _VP]),
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
    LAUNCHES["quantize_rows"] += 1
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


def _pointer_array(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """A device int64 tensor of the arrays' addresses, cached by address
    tuple (a SharedTensor's buffers keep their addresses across frames)."""
    key = (arrays[0].device, tuple(a.data_ptr() for a in arrays))
    ptrs = _PTR_CACHE.get(key)
    if ptrs is None:
        if len(_PTR_CACHE) >= 256:
            _PTR_CACHE.clear()
        ptrs = torch.tensor(key[1], dtype=torch.int64).to(arrays[0].device)
        _PTR_CACHE[key] = ptrs
    return ptrs


def apply_rows_batch_kernel(
    s_rows: torch.Tensor,
    rowcount: torch.Tensor,
    words: torch.Tensor,
    arrays: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, ...]:
    """Kernel B on the GPU; updates ``arrays`` in place. Raises for
    tensors that are not on a GPU."""
    if not arrays or arrays[0].device.type != "cuda":
        raise ValueError("apply_rows_batch kernel needs CUDA tensors")
    rows, k = _check_apply(s_rows, rowcount, words, arrays)
    ptrs = _pointer_array(arrays)
    fn = _fn("apply_rows_batch")
    with torch.cuda.device(arrays[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(s_rows.data_ptr(), rowcount.data_ptr(), words.data_ptr(),
                 ptrs.data_ptr(), len(arrays), k, rows, stream)
    _check_launch("apply_rows_batch", err)
    LAUNCHES["apply_rows_batch"] += 1
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
