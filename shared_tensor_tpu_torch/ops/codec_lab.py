"""The codec lab: alternative delta codecs under the production codec's
error-feedback frame contract, on host (numpy) trajectories.

The counterpart of ``shared_tensor_tpu/ops/codec_lab.py``, frames,
residuals and ``payload_bytes`` bit for bit. The production planes
(``ops/codec*.py``, the native engine) keep the reference's 1-bit sign
codec; the lab compares other methods on the same residual trajectories:

    encode(residual)  -> (frame, new_residual)   # residual -= decode(frame)
    decode(frame)     -> dense delta             # receiver: values += delta

Every method keeps the two invariants the framework rests on:

- **conservation**: ``residual_in == decode(frame) + residual_out`` to
  within 1 ulp of the sent magnitude (the f32 subtraction rounds when the
  exponents differ); TopK ships f32 copies and is exact;
- **boundedness**: an all-zero residual encodes to an idle frame
  (``scale == 0`` or an empty payload) that decodes to zero.

Methods:

``Sign1``
    The production codec (1 bit per element and a 4-byte scale) in the
    lab's interface: the baseline.
``Sign2``
    Two-bit sign-magnitude: ``+-s``, or ``+-3s`` where ``|r| > 2s``.
``TopK``
    The k largest ``|r|`` ship exactly as ``(u32 index, f32 value)``
    pairs, 8 bytes each.

The lab is numpy on the host by design: it compares policies. The device
twins of Sign2 and TopK are ``ops/codec_lab_torch.py``; the pod step of
Sign2 is ``parallel/ici_lab.py``. Neither is wired into the production
dispatch (``ops/table.py``) or the trainer.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np

from .codec_np import _pow2_floor


def _rms_scale(residual: np.ndarray) -> float:
    """The reference scale rule on a numpy residual: the power-of-two floor
    of the overflow-safe RMS (normalised by max |r| first), 0.0 for an
    all-zero or non-finite residual."""
    amax = float(np.max(np.abs(residual))) if residual.size else 0.0
    if not (amax > 0.0) or not np.isfinite(amax):
        return 0.0
    norm = residual.astype(np.float64) / amax
    rms = amax * float(np.sqrt(np.mean(norm * norm)))
    s = float(_pow2_floor(np.float32(rms))[()])
    return s if np.isfinite(s) and s > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class LabFrame:
    """One lab frame: a payload and its wire cost. ``payload_bytes`` counts
    what a wire message would carry (the 4-byte scale or count header and
    the packed element data), so that the bytes axis compares methods."""

    kind: str
    scale: float
    data: np.ndarray  # kind-specific: packed codes or (idx, val) pairs
    payload_bytes: int


class LabCodec(Protocol):
    name: str

    def encode(self, residual: np.ndarray) -> tuple[LabFrame, np.ndarray]: ...

    def decode(self, frame: LabFrame, n: int) -> np.ndarray: ...


class Sign1:
    """The production 1-bit codec in the lab's interface (the baseline)."""

    name = "sign1"

    def encode(self, residual: np.ndarray) -> tuple[LabFrame, np.ndarray]:
        s = _rms_scale(residual)
        if s == 0.0:
            return LabFrame(self.name, 0.0, np.zeros(0, np.uint8), 4), residual
        neg = residual <= 0  # bit set: -scale (zero counts as negative)
        sent = np.where(neg, -s, s).astype(np.float32)
        new_r = (residual - sent).astype(np.float32)
        bits = np.packbits(neg.astype(np.uint8), bitorder="little")
        return LabFrame(self.name, s, bits, 4 + bits.nbytes), new_r

    def decode(self, frame: LabFrame, n: int) -> np.ndarray:
        if frame.scale == 0.0:
            return np.zeros(n, np.float32)
        neg = np.unpackbits(frame.data, count=n, bitorder="little")
        return np.where(neg, -frame.scale, frame.scale).astype(np.float32)


class Sign2:
    """2-bit sign-magnitude at the reference's power-of-two RMS step: a
    sign bit and a magnitude bit choosing ``+-s`` or ``+-3s`` (set where
    ``|r| > 2s``).

    On a uniform residual ``|r|`` never exceeds ``2s``: the magnitude bit
    stays idle and the trajectory is Sign1's bit for bit, so it drains to
    exact zero. On a gaussian one the ``+-3s`` level moves the tails three
    times as fast (RMS decay about 0.79 a frame against Sign1's 0.85 over
    20 frames). Both magnitudes are exact f32 multiples of the power-of-two
    scale, which keeps the 1-ulp conservation bound. Codes are interleaved
    per element, ``[sign_0, mag_0, sign_1, mag_1, ...]``, packed LSB-first."""

    name = "sign2"

    def encode(self, residual: np.ndarray) -> tuple[LabFrame, np.ndarray]:
        s = _rms_scale(residual)
        if s == 0.0:
            return LabFrame(self.name, 0.0, np.zeros(0, np.uint8), 4), residual
        neg = (residual <= 0).astype(np.uint8)
        big = (np.abs(residual) > np.float32(2.0 * s)).astype(np.uint8)
        mag = np.where(big, np.float32(3.0 * s), np.float32(s))
        sent = np.where(neg, -mag, mag).astype(np.float32)
        new_r = (residual - sent).astype(np.float32)
        codes = neg | (big << 1)  # 2 bits per element
        packed = np.packbits(np.stack([codes & 1, codes >> 1], axis=1).reshape(-1), bitorder="little")
        return LabFrame(self.name, s, packed, 4 + packed.nbytes), new_r

    def decode(self, frame: LabFrame, n: int) -> np.ndarray:
        if frame.scale == 0.0:
            return np.zeros(n, np.float32)
        flat = np.unpackbits(frame.data, count=2 * n, bitorder="little")
        codes = flat.reshape(n, 2)
        neg, big = codes[:, 0], codes[:, 1]
        mag = np.where(big, np.float32(3.0 * frame.scale), np.float32(frame.scale))
        return np.where(neg, -mag, mag).astype(np.float32)


class TopK:
    """Sparse exact transfer of the k largest-``|residual|`` coordinates."""

    name = "topk"

    def __init__(self, k: int):
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        self.k = k
        self.name = f"topk{k}"

    def encode(self, residual: np.ndarray) -> tuple[LabFrame, np.ndarray]:
        n = residual.shape[0]
        k = min(self.k, n)
        absr = np.abs(residual)
        if not absr.any():
            empty = np.zeros((0, 2), np.float32)
            return LabFrame(self.name, 0.0, empty, 4), residual
        idx = np.argpartition(absr, n - k)[n - k :]
        idx = idx[absr[idx] > 0]  # never ship a zero coordinate
        vals = residual[idx].astype(np.float32)
        new_r = residual.copy()
        new_r[idx] = 0.0  # exact subtraction: r - r == 0
        # an index rides as its u32 bit pattern viewed as f32, exact at any
        # n (an f32 conversion would lose indices past 2^24)
        pairs = np.stack([idx.astype(np.uint32).view(np.float32), vals], axis=1)
        # wire cost: a 4-byte count header and a u32 index and an f32 value each
        return LabFrame(self.name, 1.0, pairs, 4 + 8 * len(idx)), new_r

    def decode(self, frame: LabFrame, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        if frame.data.size:
            idx = frame.data[:, 0].view(np.uint32).astype(np.int64)
            out[idx] = frame.data[:, 1]  # the indices are distinct
        return out


def standard_lab(n: int) -> list:
    """The comparison set of the bench and the tests: the baseline, the
    2-bit variant, and top-k at 1/32 density (8 B x n/32 = n/4 bytes a
    frame, Sign2's wire cost, so that the two compare directly)."""
    return [Sign1(), Sign2(), TopK(max(1, n // 32))]
