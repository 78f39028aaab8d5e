"""The port's codec lab (shared_tensor_tpu_torch.ops.codec_lab) against the
JAX package's (shared_tensor_tpu.ops.codec_lab): every case of
tests/test_codec_lab.py on the port's lab; each method's frames, residuals
and payload bytes bit-equal to JAX's over 20 frames on uniform, gaussian
and heavy-tailed residuals; and the port's bench rows equal to the root
benchmarks/codec_lab.py's at a small N, every field but the encode rate
(which is a host time). Tolerance: none, bit for bit (both are numpy)."""

import importlib.util
import pathlib

import numpy as np
import pytest

from shared_tensor_tpu.ops import codec_lab as J
from shared_tensor_tpu_torch.benchmarks import codec_lab as bench
from shared_tensor_tpu_torch.ops.codec_lab import Sign1, Sign2, TopK, standard_lab

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 4096


def _codecs():
    return standard_lab(N)


# -- tests/test_codec_lab.py on the port ------------------------------------------------


@pytest.mark.parametrize("codec", _codecs(), ids=lambda c: c.name)
def test_conservation(codec):
    rng = np.random.default_rng(0)
    r = rng.standard_normal(N).astype(np.float32)
    frame, new_r = codec.encode(r)
    delta = codec.decode(frame, N)
    if codec.name.startswith("topk"):
        np.testing.assert_array_equal(delta + new_r, r)
    else:
        bound = frame.scale * 2.0**-22  # ulp(1.5 * scale)
        np.testing.assert_allclose(delta + new_r, r, rtol=0, atol=bound)


@pytest.mark.parametrize("codec", _codecs(), ids=lambda c: c.name)
def test_idle_on_zero_residual(codec):
    r = np.zeros(N, np.float32)
    frame, new_r = codec.encode(r)
    np.testing.assert_array_equal(new_r, r)
    np.testing.assert_array_equal(codec.decode(frame, N), np.zeros(N, np.float32))
    assert frame.payload_bytes <= 4


@pytest.mark.parametrize("codec", _codecs(), ids=lambda c: c.name)
def test_payload_bytes_honest(codec):
    rng = np.random.default_rng(1)
    r = rng.standard_normal(N).astype(np.float32)
    frame, _ = codec.encode(r)
    assert frame.payload_bytes == 4 + frame.data.nbytes


def _frames_to_drain(codec, r, max_frames=200):
    for i in range(max_frames):
        if not r.any():
            return i
        frame, r = codec.encode(r)
        if frame.payload_bytes <= 4 and r.any():
            pytest.fail(f"{codec.name} idled on a nonzero residual")
    return max_frames


def test_sign1_exact_convergence_unchanged():
    rng = np.random.default_rng(2)
    r = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    frames = _frames_to_drain(Sign1(), r)
    assert 20 <= frames <= 35, frames


def test_sign2_uniform_trajectory_identical_to_sign1():
    rng = np.random.default_rng(3)
    r1 = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    r2 = r1.copy()
    s1, s2 = Sign1(), Sign2()
    for _ in range(30):
        if not r1.any():
            break
        f1, r1 = s1.encode(r1)
        f2, r2 = s2.encode(r2)
        assert f1.scale == f2.scale
        np.testing.assert_array_equal(r1, r2)
    assert not r1.any() and not r2.any()


def _rms(r):
    return float(np.sqrt(np.mean(r.astype(np.float64) ** 2)))


def test_sign2_faster_per_frame_on_gaussian():
    rng = np.random.default_rng(7)
    r0 = rng.standard_normal(1 << 14).astype(np.float32)

    def decay(codec, frames=20):
        r = r0.copy()
        for _ in range(frames):
            _, r = codec.encode(r)
        return (_rms(r) / _rms(r0)) ** (1.0 / frames)

    d1, d2 = decay(Sign1()), decay(Sign2())
    assert d2 < d1 - 0.02, (d2, d1)


def test_topk_full_k_converges_in_one_frame():
    rng = np.random.default_rng(4)
    r = rng.standard_normal(N).astype(np.float32)
    frame, new_r = TopK(N).encode(r)
    assert not new_r.any()
    np.testing.assert_array_equal(TopK(N).decode(frame, N), r)


def test_topk_wins_on_heavy_tailed_residuals_per_byte():
    def rms_after_budget(codec, r, byte_budget):
        spent = 0
        while spent < byte_budget:
            frame, r = codec.encode(r)
            spent += frame.payload_bytes
            if frame.payload_bytes <= 4:
                break
        return _rms(r)

    rng = np.random.default_rng(5)
    heavy = (rng.standard_t(1.2, N) * 1e-3).astype(np.float32)
    heavy[rng.integers(0, N, 8)] += rng.choice([-100.0, 100.0], 8).astype(np.float32)
    budget = 3 * (4 + N // 8)  # three sign1 frames' worth of bytes
    r_sign = rms_after_budget(Sign1(), heavy.copy(), budget)
    r_topk = rms_after_budget(TopK(N // 32), heavy.copy(), budget)
    assert r_topk < r_sign, (r_topk, r_sign)


def test_topk_indices_exact_past_2_24():
    n = (1 << 24) + 64
    r = np.zeros(n, np.float32)
    r[-1] = 5.0  # index 2^24 + 63: not representable in f32
    frame, new_r = TopK(1).encode(r)
    assert not new_r.any()
    delta = TopK(1).decode(frame, n)
    assert delta[-1] == 5.0
    assert np.count_nonzero(delta) == 1


def test_topk_rejects_nonpositive_k():
    with pytest.raises(ValueError):
        TopK(0)


# -- against the JAX package's lab ---------------------------------------------------------


def _residual(dist, seed):
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return rng.uniform(-1.0, 1.0, N).astype(np.float32)
    if dist == "gaussian":
        return rng.standard_normal(N).astype(np.float32)
    heavy = (rng.standard_t(1.2, N) * 1e-3).astype(np.float32)
    heavy[rng.integers(0, N, 8)] += rng.choice([-100.0, 100.0], 8).astype(np.float32)
    return heavy


@pytest.mark.parametrize("dist", ["uniform", "gaussian", "heavy_tail"])
@pytest.mark.parametrize("index", range(3), ids=["sign1", "sign2", "topk"])
def test_trajectory_matches_jax(dist, index):
    """20 frames of one method from the same residual: every frame's kind,
    scale, payload bytes and data, every residual and every decode equal to
    JAX's bit for bit."""
    port, jax_lab = standard_lab(N)[index], J.standard_lab(N)[index]
    assert port.name == jax_lab.name
    r_p = r_j = _residual(dist, 10 + index)
    for _ in range(20):
        f_p, r_p = port.encode(r_p)
        f_j, r_j = jax_lab.encode(r_j)
        assert (f_p.kind, f_p.scale, f_p.payload_bytes) == (f_j.kind, f_j.scale, f_j.payload_bytes)
        assert f_p.data.dtype == f_j.data.dtype
        np.testing.assert_array_equal(f_p.data.view(np.uint8), f_j.data.view(np.uint8))
        np.testing.assert_array_equal(r_p.view(np.uint32), r_j.view(np.uint32))
        np.testing.assert_array_equal(port.decode(f_p, N).view(np.uint32), jax_lab.decode(f_j, N).view(np.uint32))


@pytest.mark.parametrize("seed", range(4))
def test_rms_scale_matches_jax(seed):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal(N) * 10.0 ** rng.uniform(-30, 30)).astype(np.float32)
    from shared_tensor_tpu_torch.ops.codec_lab import _rms_scale

    assert _rms_scale(r) == J._rms_scale(r)


# -- the bench ----------------------------------------------------------------------------


def _root_bench(n):
    spec = importlib.util.spec_from_file_location("root_codec_lab_bench", ROOT / "benchmarks" / "codec_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N = n
    return mod


def test_bench_rows_match_the_root_bench():
    n = 1 << 12
    root = _root_bench(n)
    want = []
    for dist_name, r0 in root.distributions(np.random.default_rng(0)).items():
        for codec in J.standard_lab(n):
            want.append(root.run(codec, r0) | {"dist": dist_name})
    got = bench.rows(n)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g["encode_Melem_s"] > 0
        assert {k: v for k, v in g.items() if k != "encode_Melem_s"} == {
            k: v for k, v in w.items() if k != "encode_Melem_s"
        }
