"""The device twins of the codec lab's two winners, in plain PyTorch.

The counterpart of ``shared_tensor_tpu/ops/codec_lab_jax.py`` (``jnp``
under XLA there, with no Pallas kernel; plain torch here, on the device of
the input, with no hand-written kernel either). The layout is the
production codec's (``ops/codec.py``): a flat f32 buffer padded to the
1024-element tile, pad lanes pinned to zero, LSB-first bit packing from
``ops/packing.py``, so that packed codes serialize to the bytes the numpy
lab (``ops/codec_lab.py``) produces.

``sign2_quantize`` / ``sign2_apply``
    The 2-bit sign-magnitude quantizer (``+-s``, ``+-3s`` where
    ``|r| > 2s``; ``codec_lab.Sign2``). Codes interleave per element as
    flat bits ``[sign_0, mag_0, sign_1, mag_1, ...]`` packed into 32-bit
    words: the numpy lab's ``packbits(..., bitorder="little")`` layout.

``topk_quantize`` / ``topk_apply``
    Sparse exact transfer through ``torch.topk`` of ``|r|`` at a fixed
    ``k``. A coordinate whose residual is exactly zero may still fill a
    slot, with value 0: a no-op on both ends (the numpy lab drops it from
    its payload instead).

Packed words are int32 tensors holding the u32 bit patterns (as in
``ops/packing.py``); top-k indices are int64 (torch's index dtype: torch
has no general u32 arithmetic). On the wire both are u32.

Scales carry the caveat of every cross-tier scale comparison in the repo:
the RMS sums differ in order and precision between tiers, and the
power-of-two floor absorbs that except where the true RMS sits at an
octave boundary, where two tiers may pick adjacent octaves. Scales ride
the wire, so this matters only to same-trajectory comparisons.
"""

from __future__ import annotations

import torch

from ..config import ScalePolicy
from .codec import SAT, _live, compute_scale
from .packing import pack_bits, unpack_bits


def sign2_quantize(
    residual: torch.Tensor, n: int, policy: ScalePolicy = ScalePolicy.POW2_RMS
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One 2-bit sender step: residual -> (scale f32 scalar, packed codes
    int32[2 * n_pad / 32], new residual). ``r <= 0`` sets the sign bit (zero
    counts as negative, as in the production codec); ``|r| > 2s`` sets the
    magnitude bit and sends ``+-3s`` for ``+-s``. At scale 0 the residual
    comes back untouched (an idle frame). Pad lanes get both bits 0 and
    residual 0."""
    n_pad = residual.shape[0]
    scale = compute_scale(residual, n, policy)
    live = _live(n_pad, n, residual.device)
    neg = residual <= 0
    big = residual.abs() > 2.0 * scale
    mag = torch.where(big, 3.0 * scale, scale)
    sent = torch.where(neg, -mag, mag)
    zero = torch.zeros_like(residual)
    new = torch.where(live, residual - sent, zero)
    new = torch.where(scale > 0, new, residual)
    codes = torch.stack([live & neg, live & big], dim=-1).reshape(2 * n_pad)
    return scale, pack_bits(codes), new


def sign2_apply(values: torch.Tensor, scale: torch.Tensor, words: torch.Tensor, n: int) -> torch.Tensor:
    """One 2-bit receiver step: ``values + (1 - 2 neg) * s * (1 + 2 big)``,
    clamped to +-SAT, pad lanes 0. A frame of scale 0 (idle) is a no-op
    whatever its bits say. A new tensor."""
    n_pad = values.shape[0]
    codes = unpack_bits(words).reshape(n_pad, 2)
    neg = codes[:, 0].to(torch.float32)
    big = codes[:, 1].to(torch.float32)
    mag = scale * (1.0 + 2.0 * big)
    delta = (1.0 - 2.0 * neg) * mag
    live = _live(n_pad, n, values.device)
    zero = torch.zeros_like(values)
    delta = torch.where(live & (scale > 0), delta, zero)
    return torch.where(live, torch.clamp(values + delta, -SAT, SAT), zero)


def topk_quantize(residual: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sparse sender step: residual -> (indices int64[k], values f32[k], new
    residual). The k largest ``|r|`` ship as exact f32 copies and are zeroed
    in the residual (exact conservation). A new residual; the input stays."""
    _, idx = torch.topk(residual.abs(), k)
    return idx, residual[idx], residual.index_fill(0, idx, 0.0)


def topk_apply(values: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Sparse receiver step: ``values[idx] += vals`` on a copy, clamped to
    +-SAT, pad lanes 0. The indices are distinct (``torch.topk``), so each
    coordinate takes one addition and the result is deterministic on CUDA
    too; zero-valued slots are no-ops."""
    out = values.clone().index_add_(0, idx.to(torch.int64), vals)
    live = _live(values.shape[0], n, values.device)
    return torch.where(live, torch.clamp(out, -SAT, SAT), torch.zeros_like(out))
