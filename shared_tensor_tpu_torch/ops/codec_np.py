"""The host codec: the table codec as synchronous host work over numpy
arrays, for host-tier peers.

The counterpart of ``shared_tensor_tpu/ops/codec_np.py``. The per-element
loops are the C loops of ``native/stcodec.c`` (AVX-512 where the CPU has
it, chosen at run time), compiled by the port (``_build.build_codec``) and
bound here with ctypes. ``ctypes.CDLL`` releases the GIL for the length of
every loop call, so a peer's threads and the caller's own work run beside
them. Where the JAX package falls back to numpy when the library is
missing, this module raises: a failed build is an error, never a silent
change of tier.

The ``*_plain`` functions beside them are the port's copy of the JAX
package's numpy loops, the semantic reference of the C loops; the tests
and ``chip_smoke.py`` hold the two against each other, and nothing on the
main path calls them. Sign bits and error feedback are bit-identical given
the same scales. The C scale pass sums in double over a fixed chunking
and the numpy one in float32 over a normalised copy, so a scale may land
one octave off at an exact octave boundary (POW2_RMS) or differ in its
last bits (RMS, ABS_MEAN); the scale rides the wire, so either is a valid
codec step.

Arrays are flat padded float32 buffers (``ops/table.py``'s layout) and
uint32 words. The C loops take only C-contiguous, naturally aligned
arrays, and a view that is not fails loudly at the call. The port's words
are int32 bit patterns on the device; they reach the C loops as
``.numpy().view(np.uint32)`` of contiguous CPU tensors.

``inplace=True`` (apply, accumulate) and ``out=`` (quantize) write the
result into the given arrays, as the port's device codec does; otherwise
each call returns new arrays, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import _build
from ..config import ScalePolicy
from .codec import CASCADE_EXTRA_LEVELS, CASCADE_MAX_LEVELS, SAT
from .table import TableSpec, tree_flatten, tree_unflatten

_LIB: Optional[ctypes.CDLL] = None
_LIB_MU = threading.Lock()

# ALIGNED: the C loops (and their AVX paths) assume natural alignment; a
# misaligned view (an offset np.frombuffer) must fail here, not reach the
# library as undefined behaviour.
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C,ALIGNED")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C,ALIGNED")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C,ALIGNED")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
_f64p_opt = ctypes.POINTER(ctypes.c_double)
_I64, _I32 = ctypes.c_int64, ctypes.c_int32

_SIGNATURES = {
    "stc_scale_partials": [_f32p, _i64p, _i64p, _I64, _f64p, _f64p, _f64p],
    "stc_quantize": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _f32p, _u32p],
    "stc_apply_frame": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _f32p, _u32p],
    "stc_apply_frames": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _I64, _I32, _f32p, _u32p,
                         _f64p_opt, _f64p_opt, _f64p_opt],
    "stc_accumulate_update_to": [_f32p, _f32p, _f32p, _i64p, _i64p, _i64p, _I64],
    # K 1-bit frames of a given schedule in one pass (row stride in words),
    # with the final residual's scale partials
    "stc_quantize_ef_cascade": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _I32, _f32p, _u32p, _I64,
                                _f64p, _f64p, _f64p],
    # sign2: K frames of [sign words][magnitude words] per pass (row stride
    # in words), with the next frame's scale partials; and the K-frame apply
    "stc_quantize2_ef_cascade": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _I32, _f32p, _u32p, _I64, _I64,
                                 _f64p, _f64p, _f64p],
    "stc_apply_frames2": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _I64, _I32, _f32p, _u32p,
                          _f64p_opt, _f64p_opt, _f64p_opt],
    "stc_apply_frame2": [_f32p, _f32p, _i64p, _i64p, _i64p, _I64, _I64, _f32p, _u32p],
}


def native() -> ctypes.CDLL:
    """The port's ``libstcodec``, built on first use. Raises if it cannot
    be built."""
    global _LIB
    with _LIB_MU:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build.build_codec()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = argtypes
            _LIB = lib
    return _LIB


_layout_cache: dict = {}


def _leaf_slices(spec: TableSpec):
    off = 0
    for n, p in zip(spec.ns, spec.padded):
        yield off, n, p
        off += p


def _layout(spec: TableSpec):
    """(offsets, ns, padded) as int64 arrays, cached per spec. Keyed by the
    spec's value (a frozen dataclass): an id() key could alias a collected
    spec whose id was reused and hand the C loops another layout."""
    hit = _layout_cache.get(spec)
    if hit is None:
        hit = (
            np.asarray([off for off, _, _ in _leaf_slices(spec)], np.int64),
            np.asarray(spec.ns, np.int64),
            np.asarray(spec.padded, np.int64),
        )
        if len(_layout_cache) > 256:
            _layout_cache.clear()
        _layout_cache[spec] = hit
    return hit


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, np.float32)


def _u32(w) -> np.ndarray:
    """Packed words as contiguous uint32 (int32 words are viewed, not
    converted: the bits are the same)."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.ascontiguousarray(w)
    if w.dtype == np.int32:
        return w.view(np.uint32)
    if w.dtype != np.uint32:
        raise TypeError(f"packed words must be uint32 or int32, got {w.dtype}")
    return w


def _target(a) -> np.ndarray:
    """An array the C loops may write in place: C-contiguous float32."""
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    if a.dtype != np.float32 or not a.flags.c_contiguous or not a.flags.writeable:
        raise ValueError("in-place targets must be writable C-contiguous float32 arrays")
    return a


# -- layout --------------------------------------------------------------------


def flatten_np(tree: Any, spec: TableSpec) -> np.ndarray:
    """Pytree (numpy arrays or tensors) -> a NEW padded flat float32 numpy
    buffer, padding exactly 0. The numpy twin of ``table.flatten``."""
    leaves, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        raise ValueError(f"tree structure {treedef} does not match spec {spec.treedef}")
    out = np.zeros(spec.total, np.float32)
    for (off, n, _), leaf in zip(_leaf_slices(spec), leaves):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        flat = np.ravel(np.asarray(leaf)).astype(np.float32, copy=False)
        if flat.shape[0] != n:
            raise ValueError(f"leaf has {flat.shape[0]} elements, spec expects {n}")
        out[off : off + n] = flat
    return out


def unflatten_np(flat, spec: TableSpec) -> Any:
    """Inverse of :func:`flatten_np`. The leaves are copies, never views of
    ``flat``: an edit of a read() result must not reach the replica."""
    flat = np.asarray(flat)
    leaves = [flat[off : off + n].copy().reshape(shape) for (off, n, _), shape in zip(_leaf_slices(spec), spec.shapes)]
    return tree_unflatten(spec.treedef, leaves)


# -- the C loops ---------------------------------------------------------------


def _pow2_floor(x: np.ndarray) -> np.ndarray:
    """2^floor(log2(x)) by clearing the f32 mantissa (exact)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0x7F800000)).view(np.float32)


def compute_scales_np(
    residual, spec: TableSpec, policy: ScalePolicy = ScalePolicy.POW2_RMS, per_leaf: bool = True,
    with_amax: bool = False,
):
    """Per-leaf scales from one fused C pass of per-leaf max |r|, sum of
    squares and sum of |r| in double (overflow-safe without normalising);
    a leaf whose max is 0 or whose scale is not finite gets 0. With
    ``with_amax``, (scales, each leaf's own max |r| as f32), whatever
    ``per_leaf``."""
    r = _f32(residual)
    offs, ns_arr, _ = _layout(spec)
    L = spec.num_leaves
    amax, ss, sabs = np.zeros(L), np.zeros(L), np.zeros(L)
    native().stc_scale_partials(r, offs, ns_arr, L, amax, ss, sabs)
    leaf_amax = amax.astype(np.float32)
    ns = np.asarray(spec.ns, np.float64)
    if not per_leaf:
        amax = np.full(L, amax.max())
        ss = np.full(L, ss.sum())
        sabs = np.full(L, sabs.sum())
        ns = np.full(L, float(spec.total_n))
    if policy == ScalePolicy.ABS_MEAN:
        s = (sabs / ns).astype(np.float32)
    else:
        rms = np.sqrt(ss / ns).astype(np.float32)
        s = _pow2_floor(rms) if policy == ScalePolicy.POW2_RMS else rms
    s = np.where((amax > 0) & np.isfinite(s), s, 0.0).astype(np.float32)
    return (s, leaf_amax) if with_amax else s


# -- the cascade: the native engine's schedule, through stc_quantize_ef_cascade ----


def cascade_schedule_np(scales, amax, k_max: int) -> tuple[np.ndarray, int]:
    """One round of the native engine's cascade schedule (1-bit; the numpy
    body of ``table.cascade_schedule``): the rows (f32[kreal, L]) that one
    ``stc_quantize_ef_cascade`` pass quantizes, and the round's depth kc.

    A live leaf's ladder top is pow2_floor(max |r|) where that exceeds its
    measured scale s; kc is min(k_max, depth), the depth being the largest
    ilogb(top) - ilogb(s) + 1 over the live leaves, plus 8 when above 1.
    With kc = 1 the one row is exactly the measured scales; every later row
    halves the one before, and the rows stop before the first all-zero one
    (kreal < kc: the subnormal floor, where the engine ends its message)."""
    s = np.asarray(scales, np.float32)
    live = s > 0
    if not live.any() or k_max < 1:
        return np.zeros((0, s.shape[0]), np.float32), 0
    st = _pow2_floor(np.asarray(amax, np.float32))
    up = live & (st > s)
    d = np.frexp(st[up])[1].astype(np.int64) - np.frexp(s[up])[1].astype(np.int64) + 1
    maxd = max(1, int(d.max()) if d.size else 1)
    if maxd > 1:
        maxd += CASCADE_EXTRA_LEVELS
    kc = min(maxd, int(k_max))
    row = np.where(live, np.maximum(st, s), s).astype(np.float32) if kc > 1 else s.copy()
    rows = [row]
    for _ in range(1, kc):
        row = row * np.float32(0.5)
        if not row.any():
            break
        rows.append(row)
    return np.stack(rows), kc


def quantize_cascade_np(residual, spec: TableSpec, sched, out: Optional[np.ndarray] = None):
    """``stc_quantize_ef_cascade``: K frames at the given schedule (f32[K, L])
    in one pass. Returns (words u32[K, total // 32], the new residual);
    ``out`` (may be ``residual`` itself) receives the residual."""
    r = _f32(residual)
    sched = np.ascontiguousarray(np.asarray(sched, np.float32).reshape(-1, spec.num_leaves))
    k, w, L = sched.shape[0], spec.total // 32, spec.num_leaves
    if not 1 <= k <= CASCADE_MAX_LEVELS:
        raise ValueError(f"a cascade pass quantizes 1..{CASCADE_MAX_LEVELS} frames, got {k}")
    offs, ns, padded = _layout(spec)
    new_r = np.empty(spec.total, np.float32) if out is None else _target(out)
    words = np.empty((k, w), np.uint32)  # the C loop writes every word of every plane
    amax, ss, sabs = np.zeros(L), np.zeros(L), np.zeros(L)
    native().stc_quantize_ef_cascade(r, new_r, offs, ns, padded, L, k, sched, words.reshape(-1), w,
                                     amax, ss, sabs)
    return words, new_r


def quantize_table_cascade_np(
    residual,
    spec: TableSpec,
    k: int,
    cascade: int,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Up to ``k`` frames by the native engine's cascade (the host body of
    ``table.quantize_table_cascade``): rounds of one measurement
    (:func:`compute_scales_np`), one :func:`cascade_schedule_np` of depth at
    most min(``cascade``, 64, frames left) and one
    ``stc_quantize_ef_cascade`` pass, ending at an idle measurement or a
    round cut short by the subnormal floor. Returns (scales f32[n, L],
    words u32[n, total // 32], the new residual), n <= k frames, every one
    with a non-zero scale; ``out`` (may be ``residual``) receives the
    residual."""
    src = _f32(residual)
    r = np.array(src) if out is None else _target(out)
    if out is not None and not np.may_share_memory(r, src):
        np.copyto(r, src)
    kcmax = max(1, min(int(cascade), CASCADE_MAX_LEVELS))
    scales, words = [], []
    n = 0
    while n < k:
        s, amax = compute_scales_np(r, spec, policy, per_leaf, with_amax=True)
        sched, kc = cascade_schedule_np(s, amax, min(kcmax, k - n))
        if kc == 0:
            break  # idle: nothing left the codec can express
        w, _ = quantize_cascade_np(r, spec, sched, out=r)
        scales.append(sched)
        words.append(w)
        n += sched.shape[0]
        if sched.shape[0] < kc:
            break
    if not scales:
        return np.zeros((0, spec.num_leaves), np.float32), np.zeros((0, spec.total // 32), np.uint32), r
    return np.concatenate(scales), np.concatenate(words), r


def quantize_table_np(
    residual,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    out: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sender step: (scales f32[L], words u32[total // 32], new residual).
    A bit is set iff r <= 0; the residual moves by -+ its leaf's scale on
    live lanes of leaves with a nonzero scale; padding stays 0. ``out`` (may
    be ``residual`` itself) receives the new residual."""
    r = _f32(residual)
    scales = compute_scales_np(r, spec, policy, per_leaf)
    offs, ns, padded = _layout(spec)
    new_r = np.empty(spec.total, np.float32) if out is None else _target(out)
    words = np.empty(spec.total // 32, np.uint32)  # the C loop writes every word
    native().stc_quantize(r, new_r, offs, ns, padded, spec.num_leaves, scales, words)
    return scales, words, new_r


def apply_table_batch_np(
    arrays, scales, words, spec: TableSpec, inplace: bool = False
) -> tuple[np.ndarray, ...]:
    """Receiver step: K stacked frames (scales f32[K, L], words u32[K, W])
    applied to every array (the replica and the other links' residuals), in
    one pass over each: clip(a + sum over k of s_k * (1 - 2 * bit_k)) on live
    lanes, padding copied. K = 1 takes the single-frame loop."""
    srows = np.ascontiguousarray(scales, np.float32).reshape(-1, spec.num_leaves)
    wrows = _u32(words).reshape(srows.shape[0], -1)
    k = srows.shape[0]
    offs, ns, padded = _layout(spec)
    lib = native()
    out = []
    for a in arrays:
        if inplace:
            src = dst = _target(a)
        else:
            src, dst = _f32(a), np.empty(spec.total, np.float32)
        if k == 1:
            lib.stc_apply_frame(src, dst, offs, ns, padded, spec.num_leaves, srows[0], wrows[0])
        else:
            lib.stc_apply_frames(src, dst, offs, ns, padded, spec.num_leaves, spec.total // 32, k,
                                 srows, wrows, None, None, None)
        out.append(dst)
    return tuple(out)


def apply_table_many_np(arrays, scales, words, spec: TableSpec, inplace: bool = False) -> tuple[np.ndarray, ...]:
    """One frame (scales f32[L], words u32[W]) applied to every array."""
    return apply_table_batch_np(arrays, np.reshape(scales, (1, -1)), _u32(words).reshape(1, -1), spec, inplace)


def accumulate_table_np(arrays, update, spec: TableSpec, inplace: bool = False) -> tuple[np.ndarray, ...]:
    """a += u into the replica and every link residual, in one pass each:
    clip(a + u) on live lanes with u's NaN taken as 0 and its infinities
    as +-3e38, padding copied from a."""
    offs, ns, padded = _layout(spec)
    u = _f32(update)
    lib = native()
    out = []
    for a in arrays:
        if inplace:
            src = dst = _target(a)
        else:
            src, dst = _f32(a), np.empty(spec.total, np.float32)
        lib.stc_accumulate_update_to(dst, src, u, offs, ns, padded, spec.num_leaves)
        out.append(dst)
    return tuple(out)


# -- sign2 (2-bit) frames: the native engine's codec between capable engines --------
#
# A sign2 frame is [scales L*f32][sign words W*u32][magnitude words W*u32]:
# bit neg = r <= 0, bit big = |r| > 2s, and the element moves by +-s, or
# +-3s where big. The engine runs these loops itself; the wrappers below
# hold them against their plain versions (tests, chip_smoke).


def quantize2_table_np(residual, spec: TableSpec, scales) -> tuple[np.ndarray, np.ndarray]:
    """K sign2 frames in one pass at the given scales (f32[K, L], the
    engine's cascade schedule): returns (words u32[K, 2W], the residual
    after the K frames)."""
    r = _f32(residual)
    sched = np.ascontiguousarray(np.asarray(scales, np.float32).reshape(-1, spec.num_leaves))
    k, w = sched.shape[0], spec.total // 32
    offs, ns, padded = _layout(spec)
    L = spec.num_leaves
    words = np.empty((k, 2 * w), np.uint32)
    out = np.empty_like(r)
    amax, ss, sabs = np.zeros(L), np.zeros(L), np.zeros(L)
    native().stc_quantize2_ef_cascade(r, out, offs, ns, padded, L, k, sched, words.reshape(-1), 2 * w, w,
                                      amax, ss, sabs)
    return words, out


def apply2_table_np(arrays, scales, words, spec: TableSpec) -> tuple[np.ndarray, ...]:
    """K sign2 frames (scales f32[K, L], words u32[K, 2W]) applied to each
    array in one fused pass, clipped to +-SAT; new arrays."""
    sched = np.ascontiguousarray(np.asarray(scales, np.float32).reshape(-1, spec.num_leaves))
    wds = np.ascontiguousarray(_u32(words).reshape(sched.shape[0], -1))
    offs, ns, padded = _layout(spec)
    out = []
    for a in arrays:
        v = _f32(a)
        o = np.empty_like(v)
        native().stc_apply_frames2(v, o, offs, ns, padded, spec.num_leaves, spec.total // 32, sched.shape[0],
                                   sched.reshape(-1), wds.reshape(-1), None, None, None)
        out.append(o)
    return tuple(out)


def apply2_frame_np(array, scales, words, spec: TableSpec) -> np.ndarray:
    """One sign2 frame applied through ``stc_apply_frame2`` (the ledger's
    rollback loop); a new array."""
    v = _f32(array)
    o = np.empty_like(v)
    offs, ns, padded = _layout(spec)
    native().stc_apply_frame2(v, o, offs, ns, padded, spec.num_leaves, spec.total // 32,
                              np.ascontiguousarray(scales, np.float32).reshape(-1), _u32(words).reshape(-1))
    return o


# -- the plain numpy versions (tests and chip_smoke only) --------------------------


def _scale_per_element(scales, spec: TableSpec) -> np.ndarray:
    s = np.empty(spec.total, np.float32)
    for i, (off, _, p) in enumerate(_leaf_slices(spec)):
        s[off : off + p] = scales[i]
    return s


def _live_mask(spec: TableSpec) -> np.ndarray:
    m = np.zeros(spec.total, bool)
    for off, n, _ in _leaf_slices(spec):
        m[off : off + n] = True
    return m


def compute_scales_plain(
    residual, spec: TableSpec, policy: ScalePolicy = ScalePolicy.POW2_RMS, per_leaf: bool = True
) -> np.ndarray:
    """The numpy scale pass: each leaf normalised by its max |r| before the
    float32 sums (overflow-safe)."""
    residual = np.asarray(residual, np.float32)
    segs = list(_leaf_slices(spec)) if per_leaf else [(0, spec.total_n, None)]
    out = np.zeros(len(segs), np.float32)
    for i, (off, n, _) in enumerate(segs):
        live = residual[off : off + n] if per_leaf else residual  # padding is 0
        amax = np.float32(np.max(np.abs(live))) if live.size else np.float32(0)
        if not (amax > 0) or not np.isfinite(amax):
            continue
        norm = live.astype(np.float32) / amax
        if policy == ScalePolicy.ABS_MEAN:
            s = amax * np.float32(np.sum(np.abs(norm), dtype=np.float32) / np.float32(n))
        else:
            rms = amax * np.float32(np.sqrt(np.sum(norm * norm, dtype=np.float32) / np.float32(n)))
            s = _pow2_floor(rms)[()] if policy == ScalePolicy.POW2_RMS else rms
        out[i] = s if np.isfinite(s) else 0.0
    if not per_leaf:
        out = np.full(spec.num_leaves, out[0], np.float32)
    return out


def quantize_table_plain(
    residual,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    scales: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy sender step; ``scales`` quantizes at given scales (to hold
    the C loop's bits against this one's when the scale passes differ)."""
    r = np.asarray(residual, np.float32)
    if scales is None:
        scales = compute_scales_plain(r, spec, policy, per_leaf)
    scales = np.asarray(scales, np.float32)
    live = _live_mask(spec)
    s_el = _scale_per_element(scales, spec)
    neg = r <= 0
    words = np.packbits(neg & live, bitorder="little").view("<u4").astype(np.uint32)
    sent = np.where(neg, -s_el, s_el)
    new_r = np.where(live & (s_el > 0), r - sent, np.where(live, r, 0.0)).astype(np.float32)
    return scales, words, new_r


def apply_table_batch_plain(arrays, scales, words, spec: TableSpec) -> tuple[np.ndarray, ...]:
    """The numpy receiver step: the K frames' deltas summed in one float32
    buffer in frame order, then clip(a + delta) per array, padding 0."""
    scales = np.asarray(scales, np.float32).reshape(-1, spec.num_leaves)
    words = _u32(words).reshape(scales.shape[0], -1)
    delta = np.zeros(spec.total, np.float32)
    live = _live_mask(spec)
    for row, wrow in zip(scales, words):
        if not row.any():
            continue  # a zero-scale frame contributes nothing
        bits = np.unpackbits(np.ascontiguousarray(wrow).view(np.uint8), bitorder="little")[: spec.total]
        delta += _scale_per_element(row, spec) * (1.0 - 2.0 * bits.astype(np.float32))
    delta[~live] = 0.0
    out = []
    for a in arrays:
        v = np.clip(np.asarray(a, np.float32) + delta, -SAT, SAT)
        v[~live] = 0.0
        out.append(v)
    return tuple(out)


def apply_table_many_plain(arrays, scales, words, spec: TableSpec) -> tuple[np.ndarray, ...]:
    return apply_table_batch_plain(arrays, np.reshape(scales, (1, -1)), _u32(words).reshape(1, -1), spec)


def accumulate_table_plain(arrays, update, spec: TableSpec) -> tuple[np.ndarray, ...]:
    """The numpy add: sanitised u (padding 0, NaN 0, infinities +-3e38)
    added to each array, clipped to +-3e38."""
    live = _live_mask(spec)
    u = np.asarray(update, np.float32).copy()
    u[~live] = 0.0
    np.nan_to_num(u, copy=False, nan=0.0, posinf=SAT, neginf=-SAT)
    return tuple(np.clip(np.asarray(a, np.float32) + u, -SAT, SAT) for a in arrays)


def quantize2_table_plain(
    residual,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    scales: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One sign2 sender frame in numpy: (scales f32[L], sign words, magnitude
    words, the new residual). ``scales`` quantizes at given scales."""
    r = np.asarray(residual, np.float32)
    if scales is None:
        scales = compute_scales_plain(r, spec, policy, per_leaf)
    scales = np.asarray(scales, np.float32)
    live = _live_mask(spec)
    s_el = _scale_per_element(scales, spec)
    neg = r <= 0
    big = np.abs(r) > np.float32(2.0) * s_el
    sign_words = np.packbits(neg & live, bitorder="little").view("<u4").astype(np.uint32)
    mag_words = np.packbits(big & live, bitorder="little").view("<u4").astype(np.uint32)
    mag = np.where(big, np.float32(3.0) * s_el, s_el)
    sent = np.where(neg, -mag, mag)
    new_r = np.where(live & (s_el > 0), r - sent, np.where(live, r, 0.0)).astype(np.float32)
    return scales, sign_words, mag_words, new_r


def apply2_table_plain(arrays, scales, words, spec: TableSpec) -> tuple[np.ndarray, ...]:
    """The numpy sign2 receiver for K frames (scales f32[K, L], words
    u32[K, 2W]: the sign plane, then the magnitude plane): the deltas
    s*(1-2neg)*(1+2big) summed over frames, then clipped once."""
    scales = np.asarray(scales, np.float32).reshape(-1, spec.num_leaves)
    words = _u32(words).reshape(scales.shape[0], -1)
    w = spec.total // 32
    live = _live_mask(spec)
    delta = np.zeros(spec.total, np.float32)
    for row, wrow in zip(scales, words):
        if not row.any():
            continue
        neg = np.unpackbits(np.ascontiguousarray(wrow[:w]).view(np.uint8), bitorder="little")[: spec.total]
        big = np.unpackbits(np.ascontiguousarray(wrow[w:]).view(np.uint8), bitorder="little")[: spec.total]
        delta += _scale_per_element(row, spec) * (1.0 - 2.0 * neg.astype(np.float32)) * (
            1.0 + 2.0 * big.astype(np.float32))
    delta[~live] = 0.0
    out = []
    for a in arrays:
        v = np.clip(np.asarray(a, np.float32) + delta, -SAT, SAT)
        v[~live] = 0.0
        out.append(v)
    return tuple(out)
