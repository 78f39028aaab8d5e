"""Port parity: the plain versions of kernels C and D
(shared_tensor_tpu_torch.ops.codec_cuda.quantize / apply_frame_many) vs the
Pallas TPU kernels codec_pallas.quantize / apply_frame_many, run by the
Pallas interpreter on the CPU, on the same numpy inputs. The CUDA kernels
vs their plain versions on a GPU are in tests/test_torch_cuda.py.

Tolerances: bit-exact words, residuals and applied arrays given equal
scales; POW2_RMS scales equal or one octave apart; RMS and ABS_MEAN scales
to a relative 1e-6 (the sums run in another order).

Both kernels follow the Pallas kernels on the padding lanes, which they set
to 0 even at scale 0; the golden ops/codec.py leaves them alone at scale 0
(quantize) or always (apply_frame_many). Garbage in the padding shows it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import codec as JC
from shared_tensor_tpu.ops import codec_pallas
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec as TC
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.ops.packing import padded_len


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _resid(seed, n, garbage="normal"):
    """A residual of ``n`` live normal values (5% zeros, which count as
    negative), padded to a tile multiple, with ``garbage`` in the padding:
    ``normal`` values (scale > 0), ``inf`` (a non-finite RMS: scale 0) or
    ``none`` (zeros)."""
    rng = np.random.default_rng(seed)
    n_pad = padded_len(n)
    r = rng.normal(size=n_pad).astype(np.float32)
    r[rng.random(n_pad) < 0.05] = 0.0
    if garbage == "none":
        r[n:] = 0.0
    elif garbage == "inf":
        r[n:] = np.where(rng.random(n_pad - n) < 0.5, np.inf, -3.0)
    return r


def _scale_ok(got, want, policy):
    got, want = float(got), float(want)
    if policy == ScalePolicy.POW2_RMS:
        assert got == want or (want != 0 and got / want in (0.5, 2.0)), (got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _check_quantize(r, n, policy):
    jf, jr = codec_pallas.quantize(jnp.asarray(r), n, JPolicy(policy.value))
    t = torch.from_numpy(r.copy())
    frame, out = CC.quantize(t, n, policy)
    assert out is t  # in place, the counterpart of the donated residual
    assert frame.words.dtype == torch.int32 and frame.words.shape == (r.shape[0] // 32,)
    _scale_ok(frame.scale, jf.scale, policy)
    np.testing.assert_array_equal(frame.words.numpy().view(np.uint32), np.asarray(jf.words))
    if float(frame.scale) == float(jf.scale):
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(jr))
    return frame, out


@pytest.mark.parametrize("policy", list(ScalePolicy), ids=lambda p: p.name)
@pytest.mark.parametrize("n", [17, 240, 1024, 40000])
def test_quantize_plain_matches_pallas(n, policy):
    r = _resid(n, n)
    frame, out = _check_quantize(r, n, policy)
    assert float(frame.scale) > 0
    assert np.all(out.numpy()[n:] == 0.0)  # garbage in the padding is gone


@pytest.mark.parametrize(
    "case,policy",
    [("zero", ScalePolicy.POW2_RMS), ("inf_padding", ScalePolicy.POW2_RMS),
     ("inf_padding", ScalePolicy.RMS), ("tiny", ScalePolicy.POW2_RMS)],
)
def test_quantize_plain_at_scale_zero_matches_pallas(case, policy):
    """Scale 0 with and without garbage in the padding: live lanes keep
    their values, padding lanes become 0, as in the Pallas kernel."""
    n = 1000
    if case == "zero":
        r = np.zeros(padded_len(n), np.float32)
    elif case == "inf_padding":
        r = _resid(3, n, garbage="inf")
    else:  # normal values whose RMS is subnormal, so POW2 gives 0; finite garbage
        r = np.zeros(padded_len(n), np.float32)
        r[:n:7] = np.float32(2e-38)
        r[n:] = np.float32(-3e-38)
    frame, out = _check_quantize(r, n, policy)
    assert float(frame.scale) == 0.0
    np.testing.assert_array_equal(_bits(out.numpy()[:n]), _bits(r[:n]))
    assert np.all(out.numpy()[n:] == 0.0)


def test_quantize_plain_differs_from_golden_only_in_padding_at_scale_zero():
    """The trap: at scale 0 the golden returns the residual untouched, the
    Pallas kernel (and the port's kernel C) zero the padding."""
    n = 1000
    r = _resid(4, n, garbage="inf")
    _, golden = JC.quantize(jnp.asarray(r), n)
    _, plain = CC.quantize(torch.from_numpy(r.copy()), n)
    golden, plain = np.asarray(golden), plain.numpy()
    np.testing.assert_array_equal(_bits(plain[:n]), _bits(golden[:n]))
    np.testing.assert_array_equal(_bits(golden[n:]), _bits(r[n:]))
    assert np.all(plain[n:] == 0.0)


def test_subnormal_residual_keeps_ieee_where_xla_flushes():
    """A divergence pinned, not a tolerance: XLA on the CPU compares and
    subtracts with subnormals read as 0, so a positive subnormal sends
    -scale there; the port keeps IEEE subnormals (no FTZ), so it sends
    +scale. Every normal element agrees bit for bit."""
    n = 1024
    r = _resid(12, n, garbage="none")
    r[:4] = [1e-40, -1e-40, 1e-39, np.float32(1e-45)]  # positive ones differ
    jf, jr = codec_pallas.quantize(jnp.asarray(r), n)
    frame, out = CC.quantize(torch.from_numpy(r.copy()), n)
    assert float(frame.scale) == float(jf.scale)
    jbits = np.unpackbits(np.asarray(jf.words).view(np.uint8), bitorder="little")
    tbits = np.unpackbits(frame.words.numpy().view(np.uint8), bitorder="little")
    assert list(jbits[:4]) == [1, 1, 1, 1] and list(tbits[:4]) == [0, 1, 0, 0]
    np.testing.assert_array_equal(tbits[4:], jbits[4:])
    np.testing.assert_array_equal(_bits(out.numpy()[4:]), _bits(np.asarray(jr)[4:]))


def _frame(seed, n, policy):
    """A real frame from the JAX golden (scale and words) in both forms."""
    r = _resid(seed, n, garbage="none")
    jf, _ = JC.quantize(jnp.asarray(r), n, JPolicy(policy.value))
    tf = TC.Frame(
        torch.tensor(float(jf.scale), dtype=torch.float32),
        torch.from_numpy(np.asarray(jf.words).view(np.int32).copy()),
    )
    return jf, tf


@pytest.mark.parametrize("policy", [ScalePolicy.POW2_RMS, ScalePolicy.RMS], ids=lambda p: p.name)
@pytest.mark.parametrize("k", [1, 3])
def test_apply_frame_many_plain_matches_pallas(k, policy):
    n = 40000
    jf, tf = _frame(20 + k, n, policy)
    arrays = [_resid(30 + i, n) for i in range(k)]  # garbage in the padding
    arrays[0][:6] = [3e38, -3e38, 1e-40, -0.0, 2.9e38, np.float32(1e-45)]
    want = codec_pallas.apply_frame_many(tuple(jnp.asarray(a) for a in arrays), jf, n)
    got = [torch.from_numpy(a.copy()) for a in arrays]
    out = CC.apply_frame_many(got, tf, n)
    assert all(o is g for o, g in zip(out, got))  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
        assert np.all(g.numpy()[n:] == 0.0)


def test_apply_frame_many_plain_differs_from_golden_only_in_padding():
    n = 1000
    jf, tf = _frame(5, n, ScalePolicy.POW2_RMS)
    a = _resid(6, n)
    golden = np.asarray(JC.apply_frame_many((jnp.asarray(a),), jf, n)[0])
    plain = CC.apply_frame_many([torch.from_numpy(a.copy())], tf, n)[0].numpy()
    np.testing.assert_array_equal(_bits(plain[:n]), _bits(golden[:n]))
    np.testing.assert_array_equal(_bits(golden[n:]), _bits(a[n:]))
    assert np.all(plain[n:] == 0.0)


def test_apply_frame_is_many_with_one_array():
    n = 4000
    jf, tf = _frame(7, n, ScalePolicy.RMS)
    a = _resid(8, n)
    want = codec_pallas.apply_frame(jnp.asarray(a), jf, n)
    t = torch.from_numpy(a.copy())
    got = CC.apply_frame(t, tf, n)
    assert got is t
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    again = CC.apply_frame_many([torch.from_numpy(a.copy())], tf, n)[0]
    np.testing.assert_array_equal(_bits(again.numpy()), _bits(got.numpy()))


def _bad_quantize_calls():
    r = torch.zeros(1024)
    return {
        "float64": lambda: CC.quantize(r.double(), 10),
        "not_multiple_of_128": lambda: CC.quantize(torch.zeros(1000), 10),
        "2d": lambda: CC.quantize(r.view(8, 128), 10),
        "n_too_large": lambda: CC.quantize(r, 1025),
        "n_negative": lambda: CC.quantize(r, -1),
        "n_float": lambda: CC.quantize(r, 10.0),
        "scale_aliases_residual": lambda: CC.quantize(r, 10, scale=r[5]),
        "scale_not_scalar": lambda: CC.quantize(r, 10, scale=torch.zeros(1)),
        "not_contiguous": lambda: CC.quantize(torch.zeros(2048)[::2], 10),
        "kernel_on_cpu": lambda: CC.quantize_kernel(r, 10),
    }


def _bad_apply_calls():
    a, b = torch.zeros(1024), torch.zeros(1024)
    f = TC.Frame(torch.tensor(0.5), torch.zeros(32, dtype=torch.int32))
    return {
        "aliased_targets": lambda: CC.apply_frame_many((a, a), f, 10),
        "aliased_view": lambda: CC.apply_frame_many((a, a[0:]), f, 10),
        "words_alias_target": lambda: CC.apply_frame_many((a,), TC.Frame(f.scale, a[:32].view(torch.int32)), 10),
        "short_words": lambda: CC.apply_frame_many((a,), TC.Frame(f.scale, f.words[:31]), 10),
        "float64_scale": lambda: CC.apply_frame_many((a,), TC.Frame(f.scale.double(), f.words), 10),
        "mismatched_lengths": lambda: CC.apply_frame_many((a, torch.zeros(2048)), f, 10),
        "no_arrays": lambda: CC.apply_frame_many((), f, 10),
        "n_too_large": lambda: CC.apply_frame(b, f, 2000),
        "kernel_on_cpu": lambda: CC.apply_frame_many_kernel((a,), f, 10),
    }


@pytest.mark.parametrize("case", sorted(_bad_quantize_calls()))
def test_quantize_wrapper_rejects(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_quantize_calls()[case]()


@pytest.mark.parametrize("case", sorted(_bad_apply_calls()))
def test_apply_frame_wrapper_rejects(case):
    with pytest.raises((TypeError, ValueError)):
        _bad_apply_calls()[case]()


def test_scalar_plain_calls_do_not_count_as_launches():
    CC.reset_launches()
    n = 1000
    r = torch.from_numpy(_resid(11, n))
    frame, r = CC.quantize(r, n)
    CC.apply_frame_many([torch.zeros_like(r), torch.zeros_like(r)], frame, n)
    assert CC.LAUNCHES["quantize"] == 0 and CC.LAUNCHES["apply_frame_many"] == 0
