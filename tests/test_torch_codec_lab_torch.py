"""The device twins of the codec lab (shared_tensor_tpu_torch.ops.codec_lab_torch),
on CPU tensors: the five cases of tests/test_codec_lab_jax.py against the
port's numpy lab, and the twins against the JAX package's jitted ones
(shared_tensor_tpu.ops.codec_lab_jax) on the same numpy inputs.

Tolerances: codes, residuals and applied values bit for bit; scales equal,
except where the true RMS sits at an octave boundary, where the tiers may
pick adjacent octaves (their f32 sums differ in order; codec_lab_torch's
docstring); top-k index sets equal (the order of equal-rank slots is each
library's own); under RMS the scales to a relative 1e-6 (the ops/codec
tolerance of test_torch_codec.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import codec_lab_jax as JL
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec_lab_torch as lt
from shared_tensor_tpu_torch.ops.codec import pad_flat
from shared_tensor_tpu_torch.ops.codec_lab import Sign2, TopK
from shared_tensor_tpu_torch.ops.packing import padded_len, unpack_bits, wire_to_words, words_to_host, words_to_wire

N = 4096  # == padded_len(N): no pad lanes, so numpy-lab arrays align 1:1


def _r(seed, n=N):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# -- tests/test_codec_lab_jax.py on the port -------------------------------------------


def test_sign2_parity_with_numpy_lab():
    r = _r(0)
    frame, new_np = Sign2().encode(r.copy())
    scale, words, new_t = lt.sign2_quantize(_t(r), N)
    assert float(scale) == frame.scale
    # the same wire bytes: LSB-first interleaved [sign, mag] bits
    assert words_to_wire(words_to_host(words), 2 * N) == frame.data.tobytes()
    np.testing.assert_array_equal(_bits(new_t.numpy()), _bits(new_np))


def test_sign2_apply_parity_with_numpy_lab():
    r = _r(1)
    frame, _ = Sign2().encode(r.copy())
    delta_np = Sign2().decode(frame, N)
    vals = _r(2)
    words = _t(wire_to_words(frame.data.tobytes(), 2 * N).view(np.int32))
    out = lt.sign2_apply(_t(vals), torch.tensor(frame.scale, dtype=torch.float32), words, N)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(vals + delta_np))


def test_sign2_padding_and_idle_invariants():
    n = 1000
    n_pad = padded_len(n)
    r = pad_flat(_t(_r(3, n)), n_pad)
    scale, words, new_r = lt.sign2_quantize(r, n)
    assert float(scale) > 0
    np.testing.assert_array_equal(new_r.numpy()[n:], 0.0)  # pad lanes stay 0
    bits = unpack_bits(words).numpy().reshape(n_pad, 2)
    np.testing.assert_array_equal(bits[n:], 0)  # both bits 0
    z = torch.zeros(n_pad, dtype=torch.float32)
    s0, w0, nr0 = lt.sign2_quantize(z, n)
    assert float(s0) == 0.0
    np.testing.assert_array_equal(nr0.numpy(), 0.0)
    vals = pad_flat(_t(_r(4, n)), n_pad)
    out = lt.sign2_apply(vals, s0, w0, n)  # an idle frame is a no-op
    np.testing.assert_array_equal(out.numpy(), vals.numpy())


def test_topk_parity_with_numpy_lab():
    k = N // 32
    r = _r(5)
    frame, new_np = TopK(k).encode(r.copy())
    idx, vals, new_t = lt.topk_quantize(_t(r), k)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(_bits(new_t.numpy()), _bits(new_np))
    np_idx = frame.data[:, 0].view(np.uint32)
    assert set(idx.tolist()) == set(np_idx.tolist())
    out = lt.topk_apply(new_t, idx, vals, N)  # exact conservation
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(r))


def test_topk_zero_residual_noop():
    z = torch.zeros(N, dtype=torch.float32)
    idx, vals, new_r = lt.topk_quantize(z, 8)
    np.testing.assert_array_equal(vals.numpy(), 0.0)
    np.testing.assert_array_equal(new_r.numpy(), 0.0)
    out = lt.topk_apply(_t(_r(6)), idx, vals, N)
    np.testing.assert_array_equal(out.numpy(), _r(6))


# -- against the JAX package's jitted twins ------------------------------------------------


def _residual(kind, seed, n):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        r = rng.uniform(-1.0, 1.0, n)
    elif kind == "gaussian":
        r = rng.standard_normal(n)
    else:
        r = rng.standard_t(1.2, n) * 1e-3
        r[rng.integers(0, n, 8)] += rng.choice([-100.0, 100.0], 8)
    out = np.zeros(padded_len(n), np.float32)
    out[:n] = r
    out[:2] = [0.0, -0.0]  # zero and negative zero (XLA on the CPU flushes subnormals)
    return out


def _scale_agrees(got: float, want: float, r: np.ndarray, n: int) -> bool:
    """True when the scales are equal; else they must be adjacent octaves
    with the true RMS within 1e-6 of the octave between them (then the
    frames legally differ and are not compared)."""
    if got == want:
        return True
    assert max(got, want) == 2 * min(got, want), (got, want)
    rms = float(np.sqrt(np.mean(r[:n].astype(np.float64) ** 2)))
    assert abs(rms / max(got, want) - 1.0) < 1e-6, (got, want, rms)
    return False


@pytest.mark.parametrize("n", [1000, N, 3 * 1024 + 17])
@pytest.mark.parametrize("kind", ["uniform", "gaussian", "heavy_tail"])
def test_sign2_matches_jax(kind, n):
    """Five frames of the 2-bit quantizer from the same residual, each
    applied to the same values: scales, words, residuals and applied values
    equal to JAX's."""
    r = _residual(kind, n, n)
    vals = _residual("gaussian", n + 1, n)
    r_t, r_j = _t(r), jnp.asarray(r)
    for _ in range(5):
        s_t, w_t, r_t = lt.sign2_quantize(r_t, n)
        s_j, w_j, r_j = JL.sign2_quantize(r_j, n)
        if not _scale_agrees(float(s_t), float(s_j), np.asarray(r_j), n):
            return
        np.testing.assert_array_equal(words_to_host(w_t), np.asarray(w_j))
        np.testing.assert_array_equal(_bits(r_t.numpy()), _bits(np.asarray(r_j)))
        v_t = lt.sign2_apply(_t(vals), s_t, w_t, n)
        v_j = JL.sign2_apply(jnp.asarray(vals), s_j, w_j, n)
        np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(np.asarray(v_j)))


def test_sign2_rms_policy_scale_matches_jax():
    r = _residual("gaussian", 21, N)
    s_t, _, _ = lt.sign2_quantize(_t(r), N, ScalePolicy.RMS)
    s_j, _, _ = JL.sign2_quantize(jnp.asarray(r), N, JPolicy.RMS)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [1, N // 32, N])
@pytest.mark.parametrize("kind", ["gaussian", "heavy_tail"])
def test_topk_matches_jax(kind, k):
    """The same index set, values and residual as JAX's ``lax.top_k``, and
    the same applied values."""
    r = _residual(kind, 30 + k, N)
    vals = _residual("gaussian", 31, N)
    i_t, x_t, r_t = lt.topk_quantize(_t(r), k)
    i_j, x_j, r_j = JL.topk_quantize(jnp.asarray(r), k)
    i_j = np.asarray(i_j)
    assert sorted(i_t.tolist()) == sorted(i_j.tolist())
    order_t, order_j = np.argsort(i_t.numpy()), np.argsort(i_j)
    np.testing.assert_array_equal(_bits(x_t.numpy()[order_t]), _bits(np.asarray(x_j)[order_j]))
    np.testing.assert_array_equal(_bits(r_t.numpy()), _bits(np.asarray(r_j)))
    v_t = lt.topk_apply(_t(vals), i_t, x_t, N)
    v_j = JL.topk_apply(jnp.asarray(vals), jnp.asarray(i_j), x_j, N)
    np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(np.asarray(v_j)))
