"""Port parity: shared_tensor_tpu_torch.ops.packing vs shared_tensor_tpu.ops.packing.

Packed words must be bit-identical to the JAX layout (flat bit i -> word
i//32, bit i%32), and the wire helpers byte-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shared_tensor_tpu.ops import packing as JP
from shared_tensor_tpu_torch.ops import packing as TP


@pytest.mark.parametrize("n", [32, 1024, 4096 + 96])
def test_pack_bits_matches_jax(n):
    bits = np.random.default_rng(n).integers(0, 2, n).astype(bool)
    want = np.asarray(JP.pack_bits(jnp.asarray(bits)))
    got = TP.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_pack_bits_high_bit_and_layout():
    """Bit 31 set (the word's sign bit in int32) and LSB-first order."""
    bits = torch.zeros(64, dtype=torch.bool)
    bits[31] = True
    bits[32] = True
    words = TP.pack_bits(bits).numpy().view(np.uint32)
    np.testing.assert_array_equal(words, np.array([1 << 31, 1], np.uint32))


def test_unpack_bits_matches_jax():
    words = np.random.default_rng(3).integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    want = np.asarray(JP.unpack_bits(jnp.asarray(words)))
    got = TP.unpack_bits(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TP.pack_bits(got).numpy().view(np.uint32), words)


def test_wire_roundtrip_matches_jax():
    n_pad = 2048
    words = np.random.default_rng(4).integers(0, 2**32, n_pad // 32, dtype=np.uint64).astype(np.uint32)
    for n in (1, 7, 1000, 2048):
        payload = TP.words_to_wire(words, n)
        assert payload == JP.words_to_wire(words, n)
        np.testing.assert_array_equal(
            TP.wire_to_words(payload, n_pad), JP.wire_to_words(payload, n_pad)
        )


def test_host_device_word_views():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = TP.words_from_host(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(TP.words_to_host(t), words)
    with pytest.raises(TypeError):
        TP.words_from_host(words.astype(np.float32), "cpu")


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
def test_padded_len_matches_jax(n):
    assert TP.padded_len(n) == JP.padded_len(n)
    assert TP.padded_len(n, 128) == JP.padded_len(n, 128)
    with pytest.raises(ValueError):
        TP.padded_len(0)
