"""The approximate-delta codec on one flat buffer: 1-bit sign quantization
with error feedback, in plain PyTorch.

  sender, per frame over a link with residual ``r``:
    1. ``s = 2^floor(log2(rms(r)))``      (power-of-2 floor; s=0 -> idle)
    2. ``b_i = [r_i <= 0]``; ``r_i -= (1 - 2*b_i) * s``   (error feedback)
    3. transmit ``(s, bits)``
  receiver:  ``x_i += (1 - 2*b_i) * s`` on its replica AND on the residuals
  of its other links (split-horizon flood).

This is the port's scalar golden (the counterpart of
``shared_tensor_tpu/ops/codec.py``). Layout: flat float32 zero-padded to a
multiple of 1024; padding lanes are always exactly 0. Functions return new
tensors and leave their inputs alone.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..config import ScalePolicy
from .packing import pack_bits, padded_len, unpack_bits

#: Saturation bound for every state-mutating path (accumulate and apply):
#: no reachable state is non-finite, so an overflow can never turn into a
#: NaN that floods the tree.
SAT = 3.0e38

#: The native engine's cascade (``stc_quantize_ef_cascade``): most levels
#: one pass quantizes, and the refinement levels a round adds below the
#: policy scale when its ladder is deeper than one level (``maxd += 8``).
CASCADE_MAX_LEVELS = 64
CASCADE_EXTRA_LEVELS = 8


def pow2_floor(x: torch.Tensor) -> torch.Tensor:
    """2^floor(log2(x)) computed exactly by clearing the f32 mantissa (never
    through log2/exp2, which are approximate on accelerators). Subnormal
    input maps to 0; inf stays inf; NaN maps to inf (callers zero non-finite
    scales)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return (bits & 0x7F800000).view(torch.float32)


class Frame(NamedTuple):
    """One codec frame: the step size and the LSB-first packed sign bits
    (int32 words holding the u32 bit patterns). A set bit means ``-scale``."""

    scale: torch.Tensor  # f32 scalar
    words: torch.Tensor  # int32[n_padded // 32]


_DIVISORS: dict[tuple[int, torch.device], torch.Tensor] = {}


def _f32_count(n: int, device: torch.device) -> torch.Tensor:
    """``f32(n)`` as a 0-d tensor on ``device``, made once per ``(n, device)``
    so that a frame copies nothing from the host. A tensor, not a Python
    float: CUDA divides by a host scalar as a multiply by its reciprocal,
    which is not bit-equal to JAX's ``sum / f32(n)``."""
    key = (n, device)
    nf = _DIVISORS.get(key)
    if nf is None:
        if len(_DIVISORS) >= 256:
            _DIVISORS.clear()
        nf = _DIVISORS[key] = torch.tensor(float(n), dtype=torch.float32, device=device)
    return nf


def compute_scale(
    residual: torch.Tensor, n: int, policy: ScalePolicy = ScalePolicy.POW2_RMS
) -> torch.Tensor:
    """Per-frame step size from the residual; ``n`` is the live element count
    (the zero padding only affects the divisor). 0.0 for an all-zero or
    non-finite residual.

    Overflow-safe RMS: the residual is normalised by max|r| before squaring,
    so |r| ~ 1e20 does not overflow the sum of squares."""
    amax = torch.max(torch.abs(residual))
    norm = residual / torch.where(amax > 0, amax, torch.ones_like(amax))
    nf = _f32_count(n, residual.device)
    rms = amax * torch.sqrt(torch.sum(norm * norm) / nf)
    if policy == ScalePolicy.RMS:
        scale = rms
    elif policy == ScalePolicy.ABS_MEAN:
        scale = amax * (torch.sum(torch.abs(norm)) / nf)
    else:
        scale = pow2_floor(rms)
    ok = (rms > 0) & torch.isfinite(rms)
    return torch.where(ok, scale, torch.zeros_like(scale))


def _live(n_pad: int, n: int, device) -> torch.Tensor:
    return torch.arange(n_pad, dtype=torch.int32, device=device) < n


def quantize(
    residual: torch.Tensor, n: int, policy: ScalePolicy = ScalePolicy.POW2_RMS
) -> tuple[Frame, torch.Tensor]:
    """One sender step: residual -> (frame, new_residual). ``r <= 0`` sends
    ``-s`` (zero counts as negative); padding lanes get bit 0 and residual 0;
    at scale 0 the residual is returned unchanged."""
    scale = compute_scale(residual, n, policy)
    live = _live(residual.shape[0], n, residual.device)
    neg = residual <= 0
    bits = live & neg
    sent = torch.where(neg, -scale, scale)
    new = torch.where(live, residual - sent, torch.zeros_like(residual))
    new = torch.where(scale > 0, new, residual)
    return Frame(scale, pack_bits(bits)), new


def apply_frame(values: torch.Tensor, frame: Frame, n: int) -> torch.Tensor:
    """One receiver step: ``values += scale * (1 - 2*bit)``, clamped to
    +/-SAT, padding kept at 0."""
    live = _live(values.shape[0], n, values.device)
    delta = frame.scale * (1.0 - 2.0 * unpack_bits(frame.words).to(torch.float32))
    out = torch.clamp(values + delta, -SAT, SAT)
    return torch.where(live, out, torch.zeros_like(out))


def apply_frame_many(
    arrays: Sequence[torch.Tensor], frame: Frame, n: int
) -> tuple[torch.Tensor, ...]:
    """Apply one frame to several arrays: the receive-side flood (replica
    plus every other link's residual)."""
    live = _live(arrays[0].shape[0], n, arrays[0].device)
    bits = unpack_bits(frame.words).to(torch.float32)
    delta = torch.where(live, frame.scale * (1.0 - 2.0 * bits), torch.zeros_like(bits))
    return tuple(torch.clamp(a + delta, -SAT, SAT) for a in arrays)


def accumulate(
    arrays: Sequence[torch.Tensor], update: torch.Tensor, n: int
) -> tuple[torch.Tensor, ...]:
    """The local additive update: every array ``+= u``. The update is
    sanitised at this boundary (NaN -> 0, +/-inf -> +/-3e38) and the sums
    clamped, so bad values never enter the shared state."""
    live = _live(arrays[0].shape[0], n, arrays[0].device)
    u = torch.where(live, update, torch.zeros_like(update))
    u = torch.nan_to_num(u, nan=0.0, posinf=3.0e38, neginf=-3.0e38)
    return tuple(torch.clamp(a + u, -3.0e38, 3.0e38) for a in arrays)


def pad_flat(x, n_pad: int | None = None) -> torch.Tensor:
    """Flatten to 1-D float32 and zero-pad to a tile multiple."""
    flat = torch.as_tensor(x).reshape(-1).to(torch.float32)
    n = flat.shape[0]
    n_pad = padded_len(n) if n_pad is None else n_pad
    return torch.nn.functional.pad(flat, (0, n_pad - n))


def unpad(flat: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Undo :func:`pad_flat` back to the caller's shape."""
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape))
