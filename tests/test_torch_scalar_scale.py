"""The frame's scale pass (shared_tensor_tpu_torch.ops.codec_cuda.frame_scale,
``csrc/quantize.cu``) through its plain twin on the CPU, against the JAX
package's scale: ``codec.compute_scale`` and the scale that
``codec_pallas.quantize`` (run by the Pallas interpreter) puts in its frame,
on the same numpy inputs. The kernel against the twin, bit for bit, is in
tests/test_torch_cuda.py.

The twin takes the port's rule for scales from partials
(``codec_np.compute_scales_np``): max |r|, sum r^2 and sum |r| in double,
no normalising pass, over the whole padded buffer. JAX normalises by max
|r| and sums in f32.

Tolerances: POW2_RMS scales equal, and equal to 2^floor(log2 RMS) from
the RMS in double, unless that RMS lies within EDGE_ULPS f32 ulps of a
power of two, where they may be one octave apart (JAX's f32 RMS lay within
1.05 ulps of the double one on these inputs); RMS and ABS_MEAN to a
relative 1e-6 (the sums run in another order and precision); 0 exactly
where JAX gives 0, apart from the pinned divergence on subnormal residuals
(XLA on the CPU flushes them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import codec as JC
from shared_tensor_tpu.ops import codec_pallas
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.ops import codec_np
from shared_tensor_tpu_torch.ops.packing import padded_len
from shared_tensor_tpu_torch.ops.table import make_spec

POLICIES = list(ScalePolicy)
#: live counts: inside a tile, a tile, several; past one pass of the grid
#: (2 x 264 x 512 float4 units), with a ragged second pass
SIZES = [17, 240, 1024, 40000, 600_000]
#: an RMS this close to a power of two may floor to either side of it
EDGE_ULPS = 4


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _resid(seed, n, garbage="normal"):
    """``n`` live normal values (5% zeros), padded to a tile multiple, with
    ``garbage`` in the padding: ``normal``, ``inf`` (inf and -3.0), ``nan``
    or ``none`` (zeros)."""
    rng = np.random.default_rng(seed)
    n_pad = padded_len(n)
    r = rng.normal(size=n_pad).astype(np.float32)
    r[rng.random(n_pad) < 0.05] = 0.0
    if garbage == "none":
        r[n:] = 0.0
    elif garbage == "inf":
        r[n:] = np.where(rng.random(n_pad - n) < 0.5, np.inf, -3.0)
    elif garbage == "nan":
        r[n:] = np.nan
    return r


def _rms64(r, n):
    """The RMS of the whole padded buffer over ``n``, in double."""
    return float(np.sqrt(np.sum(r.astype(np.float64) ** 2) / n))


def _near_pow2(x):
    """``x`` within EDGE_ULPS f32 ulps of a power of two."""
    m, _ = np.frexp(x)  # x = m * 2^e, 0.5 <= m < 1
    return min(2 * m - 1, 1 - m) < EDGE_ULPS * 2.0**-23


def _pow2_floor(x):
    """POW2_RMS's scale for an RMS of ``x`` (a normal f32 once rounded),
    computed apart from the bit mask: 2^floor(log2 f32(x))."""
    return float(2.0 ** np.floor(np.log2(np.float32(x))))


def _scale_ok(got, want, policy, r, n):
    """``got`` against ``want`` for the residual ``r`` of ``n`` live values."""
    got, want = float(got), float(want)
    if policy != ScalePolicy.POW2_RMS:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        return
    rms = _rms64(r, n)
    if _near_pow2(rms):
        assert got == want or (want != 0 and got / want in (0.5, 2.0)), (got, want, rms)
    else:
        assert got == want == _pow2_floor(rms), (got, want, rms)


def _twin(r, n, policy):
    return CC.frame_scale_plain(torch.from_numpy(r.copy()), n, policy)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
@pytest.mark.parametrize("n", SIZES)
def test_twin_matches_jax_compute_scale_and_the_pallas_frame(n, policy):
    r = _resid(n, n)
    got = _twin(r, n, policy)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) > 0
    want = JC.compute_scale(jnp.asarray(r), n, JPolicy(policy.value))
    _scale_ok(got, want, policy, r, n)
    jf, _ = codec_pallas.quantize(jnp.asarray(r), n, JPolicy(policy.value))
    _scale_ok(got, jf.scale, policy, r, n)
    # the plain kernel C makes its frame with the twin's scale
    frame, _ = CC.quantize(torch.from_numpy(r.copy()), n, policy)
    assert _bits(frame.scale.numpy()) == _bits(got.numpy())


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
@pytest.mark.parametrize("n", [240, 40000, 600_000])
def test_twin_is_the_host_tiers_rule_on_one_leaf(n, policy):
    """With zeros in the padding, the twin's scale is compute_scales_np's
    for a one-leaf table of ``n`` live elements: the same rule, the sums in
    another order (under POW2_RMS equal unless at a power of two's edge,
    1e-12 otherwise)."""
    r = _resid(n + 1, n, garbage="none")
    spec = make_spec({"x": np.zeros(n, np.float32)})
    want = codec_np.compute_scales_np(r[: spec.total], spec, policy)[0]
    got = float(_twin(r, n, policy))
    if policy == ScalePolicy.POW2_RMS:
        _scale_ok(got, want, policy, r, n)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
@pytest.mark.parametrize("case", ["zero", "inf_padding", "nan_padding", "nan_live", "inf_live"])
def test_twin_gives_zero_where_jax_does(case, policy):
    """An all-zero residual, and non-finite values anywhere in the padded
    buffer (garbage past n included, as JAX's whole-buffer reductions read
    it): scale 0."""
    n = 1000
    if case == "zero":
        r = np.zeros(padded_len(n), np.float32)
    else:
        r = _resid(5, n, garbage={"inf_padding": "inf", "nan_padding": "nan"}.get(case, "none"))
        if case == "nan_live":
            r[7] = np.nan
        elif case == "inf_live":
            r[7] = -np.inf
    want = float(JC.compute_scale(jnp.asarray(r), n, JPolicy(policy.value)))
    assert want == 0.0
    assert float(_twin(r, n, policy)) == 0.0


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
@pytest.mark.parametrize("mag", [1e30, 3e38])
def test_twin_is_finite_near_the_top_of_f32(mag, policy):
    """|r| near 1e30 and 3e38: the double sums neither overflow nor lose
    the scale; JAX's (which normalises by max |r|) within the tolerances
    above."""
    n = 4000
    r = _resid(6, n, garbage="none")
    r[:n] = np.clip(r[:n], -1, 1) * np.float32(mag)
    r[:2] = [np.float32(mag), -np.float32(mag)]
    got = _twin(r, n, policy)
    assert torch.isfinite(got) and float(got) > 0
    _scale_ok(got, JC.compute_scale(jnp.asarray(r), n, JPolicy(policy.value)), policy, r, n)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_subnormal_residual_keeps_ieee_where_xla_flushes(policy):
    """A divergence pinned, not a tolerance: XLA on the CPU reads subnormals
    as 0, so a residual of subnormals gets scale 0 from JAX; the twin keeps
    IEEE subnormals, so RMS and ABS_MEAN give their subnormal scale and
    POW2_RMS, whose floor clears a subnormal's mantissa, gives 0 like JAX."""
    n = 1000
    r = np.zeros(padded_len(n), np.float32)
    r[:n:3] = np.float32(1e-40)
    r[1:n:3] = np.float32(-2e-39)
    assert float(JC.compute_scale(jnp.asarray(r), n, JPolicy(policy.value))) == 0.0
    got = float(_twin(r, n, policy))
    if policy == ScalePolicy.POW2_RMS:
        assert got == 0.0
    else:
        sq = np.mean(r[:n].astype(np.float64) ** 2) if policy == ScalePolicy.RMS else None
        want = np.sqrt(sq) if sq is not None else np.abs(r[:n].astype(np.float64)).mean()
        assert 0.0 < got < np.finfo(np.float32).tiny
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_twin_divides_by_the_live_count(policy):
    """The padding's values count in the sums, the divisor is n: the same
    buffer with a smaller n gives a larger scale, by sqrt(n1 / n2) (RMS) or
    n1 / n2 (ABS_MEAN); each scale is the rule's from sums in double taken
    here (POW2_RMS exactly, the others to 1e-6)."""
    r = _resid(8, 4096, garbage="none")
    s1, s2 = float(_twin(r, 4096, policy)), float(_twin(r, 1024, policy))
    ratio = {ScalePolicy.RMS: 2.0, ScalePolicy.ABS_MEAN: 4.0, ScalePolicy.POW2_RMS: 2.0}[policy]
    np.testing.assert_allclose(s2 / s1, ratio, rtol=1e-6 if policy != ScalePolicy.POW2_RMS else 0)
    for n, got in ((4096, s1), (1024, s2)):
        if policy == ScalePolicy.ABS_MEAN:
            np.testing.assert_allclose(got, np.sum(np.abs(r.astype(np.float64))) / n, rtol=1e-6)
        elif policy == ScalePolicy.RMS:
            np.testing.assert_allclose(got, _rms64(r, n), rtol=1e-6)
        else:
            assert not _near_pow2(_rms64(r, n)) and got == _pow2_floor(_rms64(r, n))


@pytest.mark.parametrize("side", ["below", "above", "at"])
@pytest.mark.parametrize("n", [1024, 600_000])
def test_pow2_rms_next_to_a_power_of_two(n, side):
    """An RMS 1e-4 below or above 2^-3 floors to 2^-4 or 2^-3 in the twin,
    in JAX's compute_scale and in the Pallas frame alike; one within a few
    ulps below it may floor to either, and each of them gives one of the
    two."""
    r = _resid(11, n, garbage="none")
    target = 0.125 * {"below": 1 - 1e-4, "above": 1 + 1e-4, "at": 1 - 2.0**-23}[side]
    r = (r * np.float32(target / _rms64(r, n))).astype(np.float32)
    rms = _rms64(r, n)
    assert abs(rms / target - 1) < 1e-6
    got = _twin(r, n, ScalePolicy.POW2_RMS)
    want = JC.compute_scale(jnp.asarray(r), n, JPolicy.POW2_RMS)
    jf, _ = codec_pallas.quantize(jnp.asarray(r), n, JPolicy.POW2_RMS)
    if side == "at":
        assert _near_pow2(rms)
        assert {float(got), float(want), float(jf.scale)} <= {0.0625, 0.125}
    else:
        assert float(got) == float(want) == float(jf.scale) == {"below": 0.0625, "above": 0.125}[side]


def test_twins_bits_depend_on_the_input_alone():
    """The same bits for the same input, whatever the intra-op thread count,
    the call, or where the tensor's storage starts."""
    n = 600_000
    r = _resid(9, n)
    threads = torch.get_num_threads()
    try:
        outs = []
        for t in (1, max(2, threads)):
            torch.set_num_threads(t)
            for pol in POLICIES:
                outs.append([_bits(_twin(r, n, pol).numpy()) for _ in range(2)])
        big = torch.zeros(padded_len(n) + 64)
        big[64:].copy_(torch.from_numpy(r))
        view = CC.frame_scale_plain(big[64:], n, ScalePolicy.RMS)
    finally:
        torch.set_num_threads(threads)
    per_policy = len(POLICIES)
    for i, pair in enumerate(outs):
        assert pair[0] == pair[1] == outs[i % per_policy][0]
    assert _bits(view.numpy()) == outs[1][0]


@pytest.mark.parametrize("n_pad", [128, 1024, 4 * 512 * 264, 4 * 512 * 264 + 128, 2**20 + 1024])
def test_scale_slots_follow_the_grid(n_pad):
    """One slot a block of 512 threads over the float4 units, at most 264."""
    units = n_pad // 4
    assert CC.scale_slots(n_pad) == min(-(-units // 512), 264)


def test_scale_pass_launch_count_and_rejects():
    """Plain calls count no launch; the scale pass has a source and a
    counter of its own (``ENGINE_LAUNCHES``, as a kernel that ports no
    Pallas call); the kernel refuses a CPU residual and every wrapper
    malformed input."""
    r = torch.from_numpy(_resid(10, 1000))
    CC.reset_launches()
    CC.quantize(r.clone(), 1000)
    CC.frame_scale_plain(r, 1000)
    assert CC.SOURCES["frame_scale"] == "frame_scale.cu" and "frame_scale" not in CC.TPU_KERNELS
    assert CC.ENGINE_LAUNCHES["frame_scale"] == 0 and not any(CC.launches().values())
    with pytest.raises(ValueError, match="CUDA"):
        CC.frame_scale_kernel(r, 1000)
    with pytest.raises(ValueError):
        CC.frame_scale_plain(r, 1025)
    with pytest.raises(ValueError):
        CC.frame_scale_plain(torch.zeros(1000), 10)
    with pytest.raises(TypeError):
        CC.frame_scale_plain(r.double(), 10)
    with pytest.raises(ValueError):
        CC.frame_scale_plain(r, 10, "POW2")


def test_scalar_codec_bench_needs_a_gpu(capsys):
    """The card's bench of the frame across trees refuses to run without a
    CUDA device (no plain stand-in)."""
    from shared_tensor_tpu_torch.benchmarks import scalar_codec

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert scalar_codec.main(["--trees", "."]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
