"""The codec lab's pod step on the port (shared_tensor_tpu_torch.parallel.ici_lab,
plain torch on the CPU, one gloo rank per mesh cell): every case of
tests/test_ici_lab.py, and the step against the JAX package's
build_sign2_sync_step on the 8 virtual CPU devices.

All port-side work runs in ONE mesh of 8 ranks (tests/test_torch_pod_jobs.run_jobs).

Tolerances (tests/test_torch_ici.py's): under POW2_RMS, values, residuals
and scales bit-exact against JAX over 3 steps at (n_peer, n_shard) in
{(2,1), (4,1), (2,2), (4,2)}; under RMS the scales to a relative 1e-6 (the
port sums a leaf in float64, JAX in f32) and values and residuals to what
that moves (2e-6 of the largest scale). The test_ici_lab.py cases keep
their bars: agreement within rtol 1e-4 / atol 1e-5 of the sum, the uniform
trajectory bit-equal to the production step's frame by frame, gaussian
decay per frame at least 0.02 under the production step's over 20 frames,
and the char-RNN A/B's tail losses under half the first loss with a gap
inside max(10% of the loss, 2 sigma of the tail)."""

import jax.numpy as jnp
import numpy as np
import pytest

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import table as JT
from shared_tensor_tpu.parallel import add_updates as j_add, init_state as j_init
from shared_tensor_tpu.parallel.ici_lab import build_sign2_sync_step as j_sign2
from tests import test_torch_pod_jobs as P
from tests._mesh import make_mesh as j_mesh
from tests.test_torch_ici import SHAPES, STEPS, template, updates

TPL = template()
UPS = {n: updates(TPL, n) for n in (2, 4)}
N = 4096
CHAR_STEPS, CHAR_TAIL = 160, 30


def _lab_ups(n_peer, seed, dist):
    """tests/test_ici_lab.py's _mk draws: one row per peer over the table."""
    rng = np.random.default_rng(seed)
    draw = rng.standard_normal if dist == "normal" else (lambda size: rng.uniform(-1.0, 1.0, size))
    return np.stack([draw(size=N) for _ in range(n_peer)]).astype(np.float32)


LAB_TPL = {"w": np.zeros(N, np.float32)}


def _jobs():
    jobs = []
    for n_peer, n_shard in SHAPES:
        for policy in ("POW2_RMS", "RMS"):
            jobs.append((f"parity-{policy}-{n_peer}x{n_shard}", "sync", n_peer, n_shard,
                         dict(tpl=TPL, ups=UPS[n_peer], policy=policy, steps=STEPS, sign2=True)))
    jobs.append(("agree", "sync", 4, 2, dict(tpl=LAB_TPL, ups=_lab_ups(4, 0, "uniform"), steps=40, sign2=True)))
    jobs.append(("uniform", "sign2_ab", 4, 2, dict(tpl=LAB_TPL, ups=_lab_ups(4, 0, "uniform"), steps=30)))
    jobs.append(("gaussian", "sign2_ab", 4, 2, dict(tpl=LAB_TPL, ups=_lab_ups(4, 0, "normal"), steps=20)))
    jobs.append(("idle", "sync", 4, 2, dict(tpl=LAB_TPL, ups=None, sign2=True)))
    jobs.append(("char", "sign2_char_ab", 4, 1, dict(cfg_kw=dict(hidden=64, layers=1), steps=CHAR_STEPS)))
    return jobs


@pytest.fixture(scope="module")
def port():
    return P.run_on_mesh(_jobs())


def _rms(residual):
    r = np.asarray(residual, np.float64)
    return float(np.sqrt(np.mean(r * r)))


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


# -- tests/test_ici_lab.py on the port ----------------------------------------------------


def test_sign2_step_reaches_agreement(port):
    got = P.result(port, "agree")
    expect = got["before"][1].sum(axis=0)
    assert not got["residual"].any(), "did not drain"
    for p in range(4):
        np.testing.assert_allclose(got["values"][p], expect, rtol=1e-4, atol=1e-5)


def test_sign2_uniform_trajectory_matches_production_step(port):
    got = P.result(port, "uniform")
    assert all(got["equal"]), got["equal"]
    assert got["drained"]
    for a, b in zip(got["prod"], got["sign2"]):
        _bits_equal(a, b)


def test_sign2_decays_faster_on_gaussian(port):
    got = P.result(port, "gaussian")
    assert len(got["equal"]) == 20
    rms0 = _rms(got["before"][1])
    d1 = (_rms(got["prod"][1]) / rms0) ** (1.0 / 20)
    d2 = (_rms(got["sign2"][1]) / rms0) ** (1.0 / 20)
    assert d2 < d1 - 0.02, (d2, d1)


def test_sign2_trains_char_rnn_comparably(port):
    curves = P.result(port, "char")
    assert curves["sign1_finite"] and curves["sign2_finite"]
    t1 = float(np.mean(curves["sign1"][-CHAR_TAIL:]))
    t2 = float(np.mean(curves["sign2"][-CHAR_TAIL:]))
    first = curves["sign1"][0]
    assert t1 < first * 0.5, (first, t1)
    assert t2 < first * 0.5, (first, t2)
    noise = max(float(np.std(curves["sign1"][-CHAR_TAIL:])), float(np.std(curves["sign2"][-CHAR_TAIL:])), 1e-9)
    assert abs(t1 - t2) <= max(0.1 * t1, 2.0 * noise) + 1e-6, (t1, t2, noise)


def test_sign2_idle_state_stays_idle(port):
    got = P.result(port, "idle")
    assert not np.any(got["scales"] != 0.0)
    np.testing.assert_array_equal(got["values"], 0.0)
    np.testing.assert_array_equal(got["residual"], 0.0)


# -- against the JAX package's sign2 step --------------------------------------------------


def jax_sign2(n_peer, n_shard, policy):
    mesh = j_mesh(n_peer, n_shard)
    spec = JT.make_spec(TPL)
    state = j_add(j_init(mesh, spec, TPL), jnp.asarray(UPS[n_peer]))
    step = j_sign2(mesh, spec, policy=policy)
    scales = []
    for _ in range(STEPS):
        state, s = step(state)
        scales.append(np.asarray(s))
    return np.asarray(state.values), np.asarray(state.residual), np.stack(scales)


@pytest.mark.parametrize("n_peer,n_shard", SHAPES)
def test_sign2_step_matches_jax_pow2(port, n_peer, n_shard):
    got = P.result(port, f"parity-POW2_RMS-{n_peer}x{n_shard}")
    v, r, s = jax_sign2(n_peer, n_shard, JPolicy.POW2_RMS)
    _bits_equal(got["scales"], s)
    _bits_equal(got["values"], v)
    _bits_equal(got["residual"], r)
    assert np.all(s[0] > 0)  # every peer sent every leaf


@pytest.mark.parametrize("n_peer,n_shard", SHAPES)
def test_sign2_step_matches_jax_rms(port, n_peer, n_shard):
    got = P.result(port, f"parity-RMS-{n_peer}x{n_shard}")
    v, r, s = jax_sign2(n_peer, n_shard, JPolicy.RMS)
    np.testing.assert_allclose(got["scales"], s, rtol=1e-6, atol=0)
    tol = 2e-6 * float(s.max())
    np.testing.assert_allclose(got["values"], v, rtol=0, atol=tol)
    np.testing.assert_allclose(got["residual"], r, rtol=0, atol=tol)
