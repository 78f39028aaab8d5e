"""Sign-bit packing: bool tensors <-> 32-bit words <-> reference wire bytes.

Layout contract (shared with the JAX package and the reference wire format):
flat bit ``i`` lives in word ``i // 32`` at bit position ``i % 32``
(LSB-first), so little-endian words are the reference's bitmask bytes.

PyTorch on the CPU implements neither shifts nor sums on ``uint32``, so the
port keeps packed words as ``int32`` tensors holding the same 32 bits; only
the wire boundary (:func:`words_to_wire` / :func:`wire_to_words`, numpy)
sees them as unsigned.
"""

from __future__ import annotations

import numpy as np
import torch

#: Lanes of one row; flat buffers are viewed as (rows, 128).
LANES = 128
SUBLANES = 8
#: Leaves are padded to a multiple of this (the JAX layout's (8, 128) tile),
#: so leaf boundaries fall on row boundaries.
TILE = LANES * SUBLANES  # 1024
BITS_PER_WORD = 32


def padded_len(n: int, multiple: int = TILE) -> int:
    """Smallest multiple of ``multiple`` >= n (and >= 1 tile)."""
    if n <= 0:
        raise ValueError(f"need a positive element count, got {n}")
    return ((n + multiple - 1) // multiple) * multiple


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a flat bool/int tensor (length divisible by 32) into int32 words
    holding the LSB-first u32 bit patterns: ``word[j] = sum_b bits[32j+b] << b``."""
    n = bits.shape[-1]
    if n % BITS_PER_WORD:
        raise ValueError(f"bit count {n} is not a multiple of {BITS_PER_WORD}")
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], -1, BITS_PER_WORD)
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int64, device=bits.device)
    w = torch.sum(b << shifts, dim=-1)  # 0 .. 2^32-1, exact in int64
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words -> flat int32 0/1 tensor.
    (``& 1`` discards the sign extension of the arithmetic shift.)"""
    shifts = torch.arange(BITS_PER_WORD, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)


def words_to_host(words: torch.Tensor) -> np.ndarray:
    """Device int32 words -> host numpy uint32 with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def words_from_host(words, device) -> torch.Tensor:
    """Host uint32 (or int32) words -> int32 tensor on ``device``, same bits."""
    if isinstance(words, torch.Tensor):
        return words.to(device=device, dtype=torch.int32)
    arr = np.ascontiguousarray(np.asarray(words))
    if arr.dtype not in (np.uint32, np.int32):
        raise TypeError(f"packed words must be uint32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def words_to_wire(words: np.ndarray, n: int) -> bytes:
    """Serialize packed words to the reference's bitmask wire bytes:
    little-endian words truncated to ``ceil(n/8)`` bytes."""
    raw = np.asarray(words).astype("<u4", copy=False).tobytes()
    return raw[: (n + 7) // 8]


def wire_to_words(payload: bytes, n_padded: int) -> np.ndarray:
    """Parse reference bitmask wire bytes into ``n_padded/32`` uint32 words
    (zero-filled past the wire payload)."""
    nwords = n_padded // BITS_PER_WORD
    buf = np.zeros(nwords * 4, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf.view("<u4").astype(np.uint32)
