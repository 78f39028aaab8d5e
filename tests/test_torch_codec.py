"""Port parity: the scalar golden codec (shared_tensor_tpu_torch.ops.codec)
vs shared_tensor_tpu.ops.codec on the same numpy inputs.

Tolerances: bit-exact frames, residuals and replicas given equal scales;
POW2_RMS scales equal or one octave apart; RMS / ABS_MEAN scales to a
relative 1e-6 (the sums run in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import codec as JC
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec as TC


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_pow2_floor_special_values():
    x = np.array(
        [1.0, 1.5, 3.0, 0.75, 1e-30, 1e30, 0.0, -0.0,
         np.float32(1e-45), np.float32(1e-40), np.float32(1.17e-38),
         np.inf, -np.inf, np.nan, 3.4e38, -2.5],
        np.float32,
    )
    want = np.asarray(JC.pow2_floor(jnp.asarray(x)))
    got = TC.pow2_floor(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[8] == 0.0 and got[9] == 0.0  # subnormals idle
    assert np.isinf(got[11])


def _resid(seed, n, n_pad):
    r = np.zeros(n_pad, np.float32)
    r[:n] = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    return r


def _scale_ok(got, want, policy):
    got, want = float(got), float(want)
    if policy == ScalePolicy.POW2_RMS:
        assert got == want or (want != 0 and got / want in (0.5, 2.0)), (got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("policy", list(ScalePolicy))
def test_compute_scale_and_quantize(policy):
    n, n_pad = 1000, 1024
    r = _resid(1, n, n_pad)
    jpol = JPolicy(policy.value)
    jf, jr = JC.quantize(jnp.asarray(r), n, jpol)
    tf, tr = TC.quantize(torch.from_numpy(r.copy()), n, policy)
    _scale_ok(tf.scale, jf.scale, policy)
    np.testing.assert_array_equal(tf.words.numpy().view(np.uint32), np.asarray(jf.words))
    if float(tf.scale) == float(jf.scale):
        np.testing.assert_array_equal(_bits(tr.numpy()), _bits(np.asarray(jr)))


def test_compute_scale_overflow_safe_and_idle():
    r = np.zeros(1024, np.float32)
    assert float(TC.compute_scale(torch.from_numpy(r), 1000)) == 0.0
    r[:3] = [1e30, -1e30, 3e38]
    want = float(JC.compute_scale(jnp.asarray(r), 1000))
    got = float(TC.compute_scale(torch.from_numpy(r), 1000))
    assert got == want and np.isfinite(got) and got > 0


@pytest.mark.parametrize("policy", [ScalePolicy.RMS, ScalePolicy.ABS_MEAN], ids=lambda p: p.name)
def test_compute_scale_divides_by_f32_of_n(policy):
    """At n = 2^24 + 1, whose f32 is 2^24, the divisor is f32(n) as in JAX:
    the scale is bit-equal to JAX's (the sums here are exact in any order)
    and differs from a division by the exact n."""
    n = 2**24 + 1
    r = np.zeros(1024, np.float32)
    r[:3] = [1.0, -1.0, 0.5]
    want = np.float32(JC.compute_scale(jnp.asarray(r), n, JPolicy(policy.value)))
    got = TC.compute_scale(torch.from_numpy(r), n, policy).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    total = 2.25 if policy == ScalePolicy.RMS else 2.5  # sum of norm^2 or |norm|
    exact = np.float32(total / n)
    mean = np.float32(np.float32(total) / np.float32(n))
    assert exact != mean
    expect = np.sqrt(mean) if policy == ScalePolicy.RMS else mean
    assert got == expect


def test_compute_scale_makes_no_host_tensor_per_call(monkeypatch):
    """The divisor is made once per (n, device); later frames copy nothing
    from the host."""
    r = torch.from_numpy(_resid(5, 1000, 1024))
    first = TC.compute_scale(r, 1000)

    def no_host_tensor(*args, **kwargs):
        raise AssertionError("compute_scale made a host tensor")

    monkeypatch.setattr(torch, "tensor", no_host_tensor)
    assert torch.equal(TC.compute_scale(r, 1000), first)


def test_apply_frame_and_many_match_jax():
    n, n_pad = 900, 1024
    r = _resid(2, n, n_pad)
    frame, _ = JC.quantize(jnp.asarray(r), n)
    tframe = TC.Frame(
        torch.tensor(float(frame.scale)),
        torch.from_numpy(np.asarray(frame.words).view(np.int32).copy()),
    )
    vals = [_resid(10 + i, n, n_pad) for i in range(3)]
    want = np.asarray(JC.apply_frame(jnp.asarray(vals[0]), frame, n))
    got = TC.apply_frame(torch.from_numpy(vals[0]), tframe, n).numpy()
    np.testing.assert_array_equal(got, want)
    wants = JC.apply_frame_many(tuple(jnp.asarray(v) for v in vals), frame, n)
    gots = TC.apply_frame_many([torch.from_numpy(v) for v in vals], tframe, n)
    for g, w in zip(gots, wants):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_apply_frame_clamps_to_sat():
    vals = np.full(1024, 3.0e38, np.float32)
    frame = TC.Frame(torch.tensor(2.0**127), torch.zeros(32, dtype=torch.int32))
    out = TC.apply_frame(torch.from_numpy(vals), frame, 1024).numpy()
    assert np.all(out == np.float32(TC.SAT))


def test_accumulate_sanitises_like_jax():
    n, n_pad = 1000, 1024
    u = _resid(3, n, n_pad)
    u[:4] = [np.nan, np.inf, -np.inf, 1e38]
    u[1010] = 5.0  # padding lane: masked
    arrays = [_resid(4, n, n_pad), np.full(n_pad, 3e38, np.float32)]
    wants = JC.accumulate(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(u), n)
    gots = TC.accumulate([torch.from_numpy(a) for a in arrays], torch.from_numpy(u), n)
    for g, w in zip(gots, wants):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert np.all(np.isfinite(g.numpy()))


def test_pad_flat_unpad():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = TC.pad_flat(x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JC.pad_flat(jnp.asarray(x))))
    np.testing.assert_array_equal(TC.unpad(got, (3, 4)).numpy(), x)
