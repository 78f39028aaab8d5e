"""Port parity: the pod tier (shared_tensor_tpu_torch.parallel, plain codec
on the CPU, one gloo rank per mesh cell) vs shared_tensor_tpu.parallel on
the 8 virtual CPU devices; and every case of tests/test_ici.py on the port.

All port-side work runs in ONE mesh of 8 ranks (tests/test_torch_pod_jobs.run_jobs),
each job on the sub-mesh its case needs; the JAX side runs here.

Tolerances: under POW2_RMS, values, residuals and scales bit-exact against
both JAX tiers (Pallas in interpret mode and XLA), over 3 steps, at
(n_peer, n_shard) in {(2,1), (4,1), (2,2), (4,2)}; under RMS the scales to
a relative 1e-6 (the port sums a leaf in float64, JAX in f32: the tolerance
of test_torch_table.py) and values and residuals to what that moves (2e-6
of the largest scale); the exact arm within n_peer * eps * max|residual|
plus 1 ulp per element (its all-reduce sums the peers in the backend's
order, XLA's psum in peer order: the two sums round differently, and
subtracting a peer's own residual keeps that absolute error; measured up
to 5,120 ulps of a small result); the composed phases equal the fused
step bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import table as JT
from shared_tensor_tpu.parallel import add_updates as j_add, build_sync_step as j_step, init_state as j_init
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import table as TT
from shared_tensor_tpu_torch.parallel import frame_ici_bytes, rows_per_shard
from tests import test_torch_pod_jobs as P
from tests._mesh import make_mesh as j_mesh

SHAPES = [(2, 1), (4, 1), (2, 2), (4, 2)]
STEPS = 3


def template(seed=0):
    """Three leaves of mixed magnitude, 40 rows: with 2 or 4 shards a leaf
    spans a shard cut."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(40, 64)).astype(np.float32),
        "b": (rng.normal(size=(64,)) * 1e-3).astype(np.float32),
        "m": (rng.normal(size=(3, 5, 7)) * 100).astype(np.float32),
    }


def small_template(seed=0):
    """tests/test_ici.py's template shape: w (40, 64) and b (64,)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(40, 64)).astype(np.float32),
            "b": (rng.normal(size=(64,)) * 1e-3).astype(np.float32)}


def flat(tree):
    return np.asarray(JT.flatten(tree, JT.make_spec(tree)))


def updates(tpl, n_peer, seed=1):
    """A distinct update per peer, each leaf its own magnitude (padding 0)."""
    rng = np.random.default_rng(seed)
    return np.stack([
        flat({k: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-2, 2)).astype(np.float32) for k, v in tpl.items()})
        for _ in range(n_peer)
    ])


def live_mask(tpl):
    spec = JT.make_spec(tpl)
    return (np.arange(128)[None, :] < spec.live_rowcount()[:, None]).reshape(-1)


TPL = template()
UPS = {n: updates(TPL, n) for n in (1, 2, 4)}


def _scaled_ups(tpl, factors):
    return np.stack([flat({k: f * v for k, v in tpl.items()}) for f in factors])


def _jobs():
    jobs = []
    for n_peer, n_shard in SHAPES:
        for policy in ("POW2_RMS", "RMS"):
            jobs.append((f"sync-{policy}-{n_peer}x{n_shard}", "sync", n_peer, n_shard,
                         dict(tpl=TPL, ups=UPS[n_peer], policy=policy, steps=STEPS)))
        jobs.append((f"exact-{n_peer}x{n_shard}", "sync", n_peer, n_shard,
                     dict(tpl=TPL, ups=UPS[n_peer], compressed=False)))
    for n_peer, n_shard in [(1, 1)] + SHAPES:
        ups = UPS[n_peer]
        for phases in (False, True):
            jobs.append((f"compose-{phases}-{n_peer}x{n_shard}", "sync", n_peer, n_shard,
                         dict(tpl=TPL, ups=ups, steps=STEPS, phases=phases)))
    # ports of tests/test_ici.py
    tpl0 = small_template(0)
    jobs.append(("golden", "sync", 2, 1, dict(tpl=tpl0, ups=_scaled_ups(tpl0, (0.1, -0.3)))))
    tpl3 = small_template(3)
    ups3 = _scaled_ups(tpl3, (0.05, 0.10))
    for ns in (1, 2, 4):
        jobs.append((f"sharded-{ns}", "sync", 2, ns, dict(tpl=tpl3, ups=ups3)))
    tpl1 = small_template(1)
    rng = np.random.default_rng(7)
    ups1 = (rng.normal(size=(4, JT.make_spec(tpl1).total)) * np.arange(1, 5)[:, None]).astype(np.float32)
    jobs.append(("conservation", "sync", 4, 2, dict(tpl=tpl1, ups=ups1 * live_mask(tpl1), steps=3)))
    tpl2 = small_template(2)
    rng = np.random.default_rng(11)
    ups2 = rng.uniform(-1, 1, size=(4, JT.make_spec(tpl2).total)).astype(np.float32) * live_mask(tpl2)
    jobs.append(("eventual", "sync", 4, 1, dict(tpl=tpl2, ups=ups2, steps=64)))
    tpl4 = small_template(4)
    jobs.append(("exact-arm", "sync", 4, 2, dict(tpl=tpl4, ups=_scaled_ups(tpl4, [0.2 * (p + 1) for p in range(4)]),
                                                 compressed=False)))
    jobs.append(("idle", "sync", 2, 1, dict(tpl=small_template(5), ups=None)))
    tpl6 = small_template(6)
    jobs.append(("nan", "sync", 2, 1, dict(tpl=tpl6, ups=np.full((2, JT.make_spec(tpl6).total), np.nan, np.float32))))
    jobs.append(("read", "read", 2, 2, dict(tpl=small_template(8), peer=1)))
    tpl10 = small_template(10)
    jobs.append(("global", "sync", 2, 1, dict(tpl=tpl10, ups=_scaled_ups(tpl10, (0.1, 0.2)), per_leaf=False)))
    rng = np.random.default_rng(12)
    delta = rng.normal(size=JT.make_spec(TPL).total).astype(np.float32) * live_mask(TPL)
    jobs.append(("external", "external", 4, 2, dict(tpl=TPL, ups=UPS[4], delta=delta)))
    jobs.append(("convert", "convert_roundtrip", 4, 2, dict(values=UPS[4], residual=2 * UPS[4])))
    jobs.append(("facts", "mesh_facts", 4, 2, {}))
    return jobs


@pytest.fixture(scope="module")
def port():
    return P.run_on_mesh(_jobs())


def jax_sync(n_peer, n_shard, tpl, ups, policy=JPolicy.POW2_RMS, compressed=True, impl="xla", steps=1,
             per_leaf=True):
    mesh = j_mesh(n_peer, n_shard)
    spec = JT.make_spec(tpl)
    state = j_add(j_init(mesh, spec, tpl), jnp.asarray(ups))
    step = j_step(mesh, spec, policy=policy, per_leaf=per_leaf, compressed=compressed, impl=impl)
    scales = []
    for _ in range(steps):
        state, s = step(state)
        scales.append(np.asarray(s))
    return np.asarray(state.values), np.asarray(state.residual), np.stack(scales)


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


# -- parity with the JAX pod step -------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("n_peer,n_shard", SHAPES)
def test_sync_step_matches_jax_pow2(port, n_peer, n_shard, impl):
    got = P.result(port, f"sync-POW2_RMS-{n_peer}x{n_shard}")
    v, r, s = jax_sync(n_peer, n_shard, TPL, UPS[n_peer], impl=impl, steps=STEPS)
    _bits_equal(got["scales"], s)
    _bits_equal(got["values"], v)
    _bits_equal(got["residual"], r)
    assert np.all(s[0] > 0)  # every peer sent every leaf


@pytest.mark.parametrize("n_peer,n_shard", SHAPES)
def test_sync_step_matches_jax_rms(port, n_peer, n_shard):
    got = P.result(port, f"sync-RMS-{n_peer}x{n_shard}")
    v, r, s = jax_sync(n_peer, n_shard, TPL, UPS[n_peer], policy=JPolicy.RMS, steps=STEPS)
    np.testing.assert_allclose(got["scales"], s, rtol=1e-6, atol=0)
    tol = 2e-6 * float(s.max())
    np.testing.assert_allclose(got["values"], v, rtol=0, atol=tol)
    np.testing.assert_allclose(got["residual"], r, rtol=0, atol=tol)


@pytest.mark.parametrize("n_peer,n_shard", SHAPES)
def test_exact_arm_matches_jax(port, n_peer, n_shard):
    got = P.result(port, f"exact-{n_peer}x{n_shard}")
    v, r, s = jax_sync(n_peer, n_shard, TPL, UPS[n_peer], compressed=False)
    eps = float(np.finfo(np.float32).eps)
    atol = n_peer * eps * float(np.abs(got["before"][1]).max())
    err = np.abs(got["values"].astype(np.float64) - v)
    assert np.all(err <= atol + eps * np.abs(v)), (float(err.max()), atol)
    assert not got["residual"].any() and not r.any()
    _bits_equal(got["scales"], s)


@pytest.mark.parametrize("n_peer,n_shard", [(1, 1)] + SHAPES)
def test_sync_phases_compose_to_sync_step(port, n_peer, n_shard):
    fused = P.result(port, f"compose-False-{n_peer}x{n_shard}")
    composed = P.result(port, f"compose-True-{n_peer}x{n_shard}")
    for key in ("values", "residual", "scales"):
        _bits_equal(composed[key], fused[key])


# -- tests/test_ici.py on the port -------------------------------------------------------


def test_mesh_shapes(port):
    assert rows_per_shard(2048, 4) == 4
    with pytest.raises(ValueError):
        rows_per_shard(1024, 3)  # 8 rows not divisible by 3
    facts = P.result(port, "facts")
    assert "needs 64 ranks, have 8" in facts["oversized"]  # more ranks than exist
    assert facts["shape"] == {"peer": 4, "shard": 2}


def test_parity_with_golden_codec(port):
    """One pod step == each peer's table quantize + the other peer's frame
    applied, bit for bit (n_shard=1), with the port's own table codec."""
    got = P.result(port, "golden")
    spec = TT.make_spec(small_template(0))
    v0, r0 = got["before"]
    frames, resids = [], []
    import torch

    for p in range(2):
        f, r2 = TT.quantize_table(torch.from_numpy(r0[p].copy()), spec)
        frames.append(f)
        resids.append(r2.numpy())
    for p in range(2):
        (v,) = TT.apply_table_many([torch.from_numpy(v0[p].copy())], frames[1 - p], spec)
        _bits_equal(got["values"][p], v.numpy())
        _bits_equal(got["residual"][p], resids[p])
        _bits_equal(got["scales"][0][p], frames[p].scales.numpy())


@pytest.mark.parametrize("n_shard", [2, 4])
def test_sharded_matches_unsharded(port, n_shard):
    one, many = P.result(port, "sharded-1"), P.result(port, f"sharded-{n_shard}")
    for key in ("scales", "values", "residual"):
        _bits_equal(many[key], one[key])


def test_conservation_invariant(port):
    """values_p + sum_{q != p} residual_q is invariant under sync steps."""
    got = P.result(port, "conservation")

    def ledger(v, r):
        return np.stack([v[p] + r.sum(0) - r[p] for p in range(4)])

    np.testing.assert_allclose(ledger(got["values"], got["residual"]), ledger(*got["before"]), rtol=0, atol=1e-4)


def test_eventual_consistency_convergence(port):
    got = P.result(port, "eventual")
    tpl = small_template(2)
    v0, r0 = got["before"]
    expect = flat(tpl) + r0.sum(0)
    for p in range(4):
        np.testing.assert_allclose(got["values"][p], expect, rtol=0, atol=1e-5)
    assert float(np.abs(got["residual"]).max()) < 1e-6


def test_exact_allreduce_arm(port):
    got = P.result(port, "exact-arm")
    tpl = small_template(4)
    expect = flat(tpl) + _scaled_ups(tpl, [0.2 * (p + 1) for p in range(4)]).sum(0)
    for p in range(4):
        np.testing.assert_allclose(got["values"][p], expect, rtol=1e-6, atol=1e-5)
    assert np.all(got["residual"] == 0)


def test_idle_peers_send_nothing(port):
    got = P.result(port, "idle")
    assert np.all(got["scales"] == 0)
    _bits_equal(got["values"], got["before"][0])


def test_add_updates_sanitizes(port):
    got = P.result(port, "nan")
    assert np.isfinite(got["before"][0]).all()
    assert np.isfinite(got["values"]).all()


def test_read_peer_roundtrip(port):
    """Every rank reads peer 1's replica (the seed + 1: each peer's differs)."""
    tpl = small_template(8)
    leaves = [tpl["b"], tpl["w"]]  # sorted key order
    for rank_out in port[:4]:
        for got, want in zip(rank_out["read"], leaves):
            np.testing.assert_array_equal(got, want + np.float32(1.0))


def test_frame_ici_bytes_model():
    spec = TT.make_spec(small_template(9))
    comp = frame_ici_bytes(spec, 8, compressed=True)
    exact = frame_ici_bytes(spec, 8, compressed=False)
    assert exact / comp > 8
    from shared_tensor_tpu.parallel import frame_ici_bytes as j_bytes

    jspec = JT.make_spec(small_template(9))
    assert (comp, exact) == (j_bytes(jspec, 8, True), j_bytes(jspec, 8, False))


def test_global_scale_mode(port):
    """per_leaf=False reproduces the reference's single global scale."""
    import torch

    got = P.result(port, "global")
    spec = TT.make_spec(small_template(10))
    for p in range(2):
        f, _ = TT.quantize_table(torch.from_numpy(got["before"][1][p].copy()), spec, ScalePolicy.POW2_RMS, False)
        _bits_equal(got["scales"][0][p], f.scales.numpy()[:1])


# -- beyond tests/test_ici.py --------------------------------------------------------------


def test_apply_external_touches_values_only(port):
    v, r = P.result(port, "external")
    ups = UPS[4]
    base = flat(TPL)
    rng = np.random.default_rng(12)
    delta = rng.normal(size=base.shape[0]).astype(np.float32) * live_mask(TPL)
    for p in range(4):
        _bits_equal(v[p], (base + ups[p]) + delta)
        _bits_equal(r[p], ups[p])


def test_pod_state_numpy_roundtrip(port):
    v, r = P.result(port, "convert")
    _bits_equal(v, UPS[4])
    _bits_equal(r, 2 * UPS[4])
