"""The port's pod trainer (shared_tensor_tpu_torch.train.PodTrainer): every
case of tests/test_trainer.py on a mesh of gloo ranks (CPU, plain codec),
and the per-step losses against the JAX PodTrainer on the same parameters
and batches.

All port-side work runs in ONE mesh of 8 ranks (tests/test_torch_pod_jobs.run_jobs),
each job on the sub-mesh its case needs.

Parity tolerance: 4 peers, 10 compressed steps at lr 0.3 from JAX's own
initial parameters and JAX's batches: every peer's loss at every step
within 3e-4 of JAX's, on losses near 4 (measured on the CPU: 5.7e-6 at the
first step, growing to 1.2e-4 by the tenth, and the same in the exact arm).
The first step's loss already differs in the f32 rounding, since XLA fuses
the vmapped forward of the whole step differently from the stand-alone
forward that tests/test_torch_char_rnn.py matches to 1e-7; each update then
carries the f32 differences of the grads into the next step's replica."""

import jax
import numpy as np
import pytest

from shared_tensor_tpu.models import char_rnn as jm
from shared_tensor_tpu.train import PodTrainer as JPodTrainer
from tests import test_torch_pod_jobs as P
from tests._mesh import make_mesh as j_mesh

CFG = dict(vocab=64, embed=16, hidden=32, layers=1)
J_CFG = jm.CharRNNConfig(**CFG)
PARITY_STEPS = 10


def _jax_params():
    return jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), J_CFG))


def _jax_batches(n):
    return [tuple(np.asarray(a) for a in jm.make_batches(P.CHAR_TEXT, batch=4, seq=16, key=jax.random.key(i),
                                                           n_peer=4, vocab=J_CFG.vocab))
            for i in range(n)]


def _jobs():
    J = lambda name, n_peer, n_shard, **kw: (name, "char_train", n_peer, n_shard, kw)
    return [
        J("parity", 4, 1, params=_jax_params(), batches=_jax_batches(PARITY_STEPS), steps=PARITY_STEPS),
        J("loss-decreases", 4, 1, steps=80),
        J("consistent", 4, 1, steps=10, quiesce=60),
        J("exact", 4, 1, steps=5, trainer_kw=dict(compressed=False), values=True),
        J("tracks-compressed", 4, 1, steps=25),
        J("tracks-exact", 4, 1, steps=25, trainer_kw=dict(compressed=False)),
        J("sharded", 4, 2, steps=15),
        J("read", 2, 1, steps=0),
        J("no-sync", 4, 1, steps=5, trainer_kw=dict(sync=False)),
        J("momentum", 4, 1, steps=40, trainer_kw=dict(momentum=(0.3, 0.9))),
        J("overlap", 4, 1, steps=80, drain=40, trainer_kw=dict(overlap=True)),
        J("ab-fused", 4, 1, steps=240),
        J("ab-overlap", 4, 1, steps=240, trainer_kw=dict(overlap=True)),
        J("overlap-exact", 2, 1, steps=0, trainer_kw=dict(overlap=True, compressed=False)),
        J("sync-every", 4, 1, steps=60, trainer_kw=dict(sync_every=2)),
    ]


@pytest.fixture(scope="module")
def port():
    return P.run_on_mesh(_jobs())


def _means(res):
    return res["losses"].mean(axis=1)


def test_losses_match_jax_pod_trainer(port):
    mesh = j_mesh(4, 1)
    tr = JPodTrainer(mesh, jm.init_params(jax.random.key(0), J_CFG), lambda p, b: jm.loss_fn(p, b, J_CFG))
    want = []
    for b in _jax_batches(PARITY_STEPS):
        losses, _ = tr.step(tr.shard_batch(b), lr=0.3)
        want.append(np.asarray(losses))
    got = P.result(port, "parity")["losses"]
    np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=3e-4)


# -- tests/test_trainer.py on the port ---------------------------------------------------


def test_train_step_runs_and_loss_decreases(port):
    res = P.result(port, "loss-decreases")
    assert res["losses"].shape == (80, 4)
    assert res["scales"].shape[1] == 4
    first, last = _means(res)[0], _means(res)[-1]
    assert last < first * 0.7, (first, last)


def test_peers_stay_consistent_under_compression(port):
    res = P.result(port, "consistent")
    floor = float(res["quiesce_scales"].max())
    spread = res["spread"]
    assert spread <= max(8 * (4 - 1) * floor, 1e-6), (spread, floor)
    assert spread < 0.02, spread


def test_exact_arm_keeps_replicas_identical(port):
    res = P.result(port, "exact")
    v = res["values"]
    np.testing.assert_allclose(v[0], v[1], atol=1e-5)
    np.testing.assert_allclose(v[0], v[3], atol=1e-5)
    assert res["residual_max"] == 0.0


def test_compressed_tracks_exact_training(port):
    lc = _means(P.result(port, "tracks-compressed"))[-1]
    le = _means(P.result(port, "tracks-exact"))[-1]
    assert lc < le * 1.35 + 0.1, (lc, le)


def test_sharded_table_trains(port):
    means = _means(P.result(port, "sharded"))
    assert means[-1] < means[0], means


def test_read_returns_template_structure(port):
    res = P.result(port, "read")
    assert res["read_keys"] == ["embed", "lstm", "proj"]
    assert res["read_embed_shape"] == (CFG["vocab"], CFG["embed"])


def test_no_sync_arm_diverges_replicas(port):
    assert P.result(port, "no-sync")["spread"] > 1e-4


def test_optax_optimizer_trains(port):
    """optax.sgd(0.3, momentum=0.9)'s update rule (tests/test_torch_pod_jobs.Momentum)
    per peer: loss decreases and the optimizer state is carried."""
    res = P.result(port, "momentum")
    means = _means(res)
    assert means[-1] < means[0] * 0.8, (means[0], means[-1])
    assert res["opt_state"]


def test_overlap_trainer_trains_and_stays_consistent(port):
    res = P.result(port, "overlap")
    means = _means(res)
    assert means[-1] < means[0] * 0.9, (means[0], means[-1])
    assert res["spread_drained"] < 0.05 and res["spread_drained"] < res["spread"], (res["spread"], res["spread_drained"])
    assert res["finite"]


def test_overlap_vs_fused_convergence_ab(port):
    tail = 40
    curves = {False: _means(P.result(port, "ab-fused")), True: _means(P.result(port, "ab-overlap"))}
    assert P.result(port, "ab-fused")["finite"] and P.result(port, "ab-overlap")["finite"]
    fused_tail = float(np.mean(curves[False][-tail:]))
    over_tail = float(np.mean(curves[True][-tail:]))
    first = curves[False][0]
    assert fused_tail < first * 0.5, (first, fused_tail)
    assert over_tail < first * 0.5, (first, over_tail)
    gap = abs(fused_tail - over_tail)
    noise = max(float(np.std(curves[False][-tail:])), float(np.std(curves[True][-tail:])), 1e-9)
    assert gap <= 0.1 * fused_tail + 1e-6, (fused_tail, over_tail)
    assert gap <= 3.0 * noise, (gap, noise)


def test_overlap_requires_compressed_sync(port):
    assert "overlap=True requires" in P.result(port, "overlap-exact")["raised"]


def test_sync_every_paces_exchanges(port):
    res = P.result(port, "sync-every")
    means = _means(res)
    assert means[-1] < means[0] * 0.9, (means[0], means[-1])
    beats = res["scales"][1::2].max(axis=(1, 2))  # steps 2, 4, ...
    off = res["scales"][0::2].max(axis=(1, 2))
    assert np.all(off == 0.0)
    assert np.any(beats > 0.0)
    assert res["finite"]
