"""Checkpoint / resume on the port (shared_tensor_tpu_torch.utils.checkpoint):
the nine cases of tests/test_checkpoint.py that need no native engine, and
round trips of every file format between the JAX package and the port
(save_shared, save_pod, save_trainer with optax Adam leaves, and
save_pod_sharded across different shard counts).

The port's pod cases run in ONE mesh of 8 CPU ranks over gloo
(tests/test_torch_bridge_jobs.run_jobs), each job on the meshes it needs.
Tolerance: none. A checkpoint moves f32 bits and computes nothing, so every
comparison is bit for bit, and a resumed run equals the uninterrupted one
bit for bit (the CPU's plain codec and gloo are deterministic).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from shared_tensor_tpu.core import SharedTensor as JSharedTensor
from shared_tensor_tpu.models import char_rnn as jm
from shared_tensor_tpu.ops.table import make_spec as j_make_spec
from shared_tensor_tpu.parallel.ici import add_updates as j_add_updates
from shared_tensor_tpu.parallel.ici import init_state as j_init_state
from shared_tensor_tpu.train import PodTrainer as JPodTrainer
from shared_tensor_tpu.utils import checkpoint as jckpt
from shared_tensor_tpu_torch.comm.peer import CARRY_LINK
from shared_tensor_tpu_torch.core import SharedTensor
from shared_tensor_tpu_torch.utils import checkpoint as ckpt
from tests import test_torch_bridge_jobs as B
from tests._mesh import make_mesh as j_mesh

SMALL = jm.CharRNNConfig(**B.SMALL)
POD_TPL = {"a": np.zeros(3000, np.float32), "b": np.zeros((5, 7), np.float32)}


def _template():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.float32)}


def _j_state(n_peer, n_shard, seed):
    """A JAX pod state with distinct values and residuals on every peer."""
    mesh = j_mesh(n_peer, n_shard)
    spec = j_make_spec(jax.tree.map(jnp.asarray, POD_TPL))
    state = j_init_state(mesh, spec, jax.tree.map(jnp.asarray, POD_TPL))
    upd = np.random.default_rng(seed).normal(size=state.values.shape).astype(np.float32)
    return mesh, spec, j_add_updates(state, jnp.asarray(upd))


def _j_trainer(n_peer):
    params = jm.init_params(jax.random.key(0), SMALL)
    return JPodTrainer(j_mesh(n_peer, 1), params, lambda p, b: jm.loss_fn(p, b, SMALL), optimizer=optax.adam(3e-3))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX side's files, then every port job in one mesh of 8 ranks."""
    d = tmp_path_factory.mktemp("ckpt")
    out = {"dir": d}
    # JAX writes: a (4, 1) pod file, a (2, 4) sharded directory of 8 device
    # shards, and an optax-Adam trainer of 2 peers after 3 steps
    _, spec, st41 = _j_state(4, 1, 0)
    jckpt.save_pod(st41, spec, str(d / "jax_pod.npz"))
    out["jax_pod"] = tuple(np.asarray(x) for x in st41)
    _, spec, st24 = _j_state(2, 4, 1)
    jckpt.save_pod_sharded(st24, spec, str(d / "jax_sharded"))
    out["jax_sharded"] = tuple(np.asarray(jax.device_get(x)) for x in st24)
    tr = _j_trainer(2)
    for i in range(3):
        tr.step(tr.shard_batch(jm.make_batches(B.CHAR_TEXT, 4, 16, jax.random.key(i), n_peer=2, vocab=64)))
    jckpt.save_trainer(tr, str(d / "jax_trainer.npz"))
    # the port's own state to save for JAX: 2 peers x 2 shards
    rng = np.random.default_rng(2)
    total = out["jax_sharded"][0].shape[1]
    port_state = tuple(rng.normal(size=(2, total)).astype(np.float32) for _ in range(2))
    for x in port_state:  # padding lanes stay 0, as in any real state
        x[:, 3000:3072] = 0.0
        x[:, 3072 + 35 :] = 0.0
    out["port_state"] = port_state
    J = lambda name, fn, **kw: (name, fn, kw)
    jobs = [
        J("resume", "pod_roundtrip_resumes", path=str(d / "resume.npz")),
        J("peers", "pod_peer_count_mismatch", path=str(d / "peers.npz")),
        J("adam", "trainer_adam_resume", path=str(d / "adam.npz")),
        J("optimizer", "trainer_optimizer_mismatch", path=str(d / "opt.npz")),
        J("sharded_io", "pod_sharded_io", path=str(d / "sharded_io")),
        J("sharded_layout", "pod_sharded_wrong_layout", path=str(d / "sharded_layout")),
        J("sharded_resume", "pod_sharded_resume", path=str(d / "sharded_resume")),
        J("jax_pod_41", "load_pod_file", path=str(d / "jax_pod.npz"), n_peer=4, n_shard=1, tpl=POD_TPL),
        J("jax_pod_42", "load_pod_file", path=str(d / "jax_pod.npz"), n_peer=4, n_shard=2, tpl=POD_TPL),
        J("jax_sharded_22", "load_sharded_dir", path=str(d / "jax_sharded"), n_peer=2, n_shard=2, tpl=POD_TPL),
        J("jax_sharded_21", "load_sharded_dir", path=str(d / "jax_sharded"), n_peer=2, n_shard=1, tpl=POD_TPL),
        J("port_save", "save_pod_files", path=str(d / "port_pod.npz"), sharded_path=str(d / "port_sharded"),
          n_peer=2, n_shard=2, tpl=POD_TPL, values=port_state[0], residual=port_state[1]),
        J("trainer", "trainer_across", load_path=str(d / "jax_trainer.npz"), save_path=str(d / "port_trainer.npz"),
          n_peer=2),
    ]
    out["ranks"] = B.run_on_mesh(jobs)
    return out


def _res(files, name):
    return B.first(files["ranks"], name)


# -- tests/test_checkpoint.py on the port ---------------------------------------------


def test_shared_roundtrip(tmp_path):
    st = SharedTensor(_template(), seed_values=True, device="cpu")
    st.new_link(1)
    st.add({"a": np.full((2, 3), 0.5, np.float32), "b": np.zeros(4, np.float32)})
    path = str(tmp_path / "st.npz")
    ckpt.save_shared(st, path)
    st2 = SharedTensor(_template(), device="cpu")
    st2.new_link(1, seed=False)
    ckpt.load_shared(st2, path)
    np.testing.assert_array_equal(st2.snapshot_flat().numpy(), st.snapshot_flat().numpy())
    np.testing.assert_array_equal(st2._links[1].numpy(), st._links[1].numpy())
    np.testing.assert_allclose(st2.read()["a"].numpy(), np.arange(6).reshape(2, 3) + 0.5)


def test_shared_layout_mismatch_rejected(tmp_path):
    st = SharedTensor(_template(), seed_values=True, device="cpu")
    path = str(tmp_path / "st.npz")
    ckpt.save_shared(st, path)
    other = SharedTensor({"x": np.zeros(5, np.float32)}, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        ckpt.load_shared(other, path)


def test_pod_roundtrip_resumes_training(files):
    res = _res(files, "resume")
    assert res["equal"]
    # resumed loss is near the trained loss, far below a fresh model's
    assert res["resumed"] < res["fresh"] * 0.8, res


def test_pod_peer_count_mismatch_rejected(files):
    assert "peers" in _res(files, "peers")["raised"]


def test_trainer_adam_resume_bit_equal(files):
    """2k steps straight against k, save_trainer, restore into a FRESH
    trainer, k more: state, Adam's moments and count bit for bit."""
    res = _res(files, "adam")
    assert res["steps"] == 5 and res["n_leaves"] == 3
    assert res["state_equal"] and res["opt_equal"]


def test_trainer_optimizer_mismatch_rejected(files):
    assert "optimizer" in _res(files, "optimizer")["raised"]


def test_pod_sharded_roundtrip_per_shard_io(files):
    res = _res(files, "sharded_io")
    assert len(res["files"]) == 8, res["files"]  # one per rank of the 4 x 2 mesh
    for f, sz in zip(res["files"], res["sizes"]):
        # 2 arrays of total / 8 f32s each (plus npz framing): far under the
        # full table
        assert sz < res["full_bytes"] // 2, (f, sz)
    assert res["equal"] and res["device"] == "cpu" and res["block"] == (1 << 20) // 2
    # stale-shard immunity: the (4, 1) save left the 4 x 2 files in place
    assert res["files_after"] > 4 and res["equal2"]


def test_pod_sharded_rejects_wrong_layout(files):
    assert "layout" in _res(files, "sharded_layout")["raised"]


def test_pod_sharded_training_resume_bit_equal(files):
    assert _res(files, "sharded_resume")["equal"]


# -- the carry, and files across the packages ----------------------------------------


def test_load_shared_recreates_the_carry(tmp_path):
    """The carry pseudo-slot comes back even where the tensor has no such
    link (JAX checkpoint.py's rule); an unknown positive link does not."""
    st = SharedTensor(_template(), seed_values=True, device="cpu")
    st.new_link(CARRY_LINK, residual=st.snapshot_flat() * 0.25)
    st.new_link(7)
    path = str(tmp_path / "st.npz")
    ckpt.save_shared(st, path)
    st2 = SharedTensor(_template(), device="cpu")
    ckpt.load_shared(st2, path)
    assert st2.link_ids == (CARRY_LINK,)
    np.testing.assert_array_equal(st2._links[CARRY_LINK].numpy(), st._links[CARRY_LINK].numpy())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_shared_across_packages(tmp_path, direction):
    """One save_shared file, written by one package and loaded by the other:
    replica and link residual bit for bit."""
    path = str(tmp_path / "st.npz")
    delta = {"a": np.full((2, 3), 0.5, np.float32), "b": np.linspace(-1, 1, 4).astype(np.float32)}
    jst = JSharedTensor(jax.tree.map(jnp.asarray, _template()), seed_values=True)
    pst = SharedTensor(_template(), seed_values=True, device="cpu")
    if direction == "jax_to_port":
        jst.new_link(1)
        jst.add(jax.tree.map(jnp.asarray, delta))
        jckpt.save_shared(jst, path)
        dst = SharedTensor(_template(), device="cpu")
        dst.new_link(1, seed=False)
        ckpt.load_shared(dst, path)
        src_v, src_l = (np.asarray(x) for x in (jst.snapshot_flat(), jst._links[1]))
        got_v, got_l = dst.snapshot_flat().numpy(), dst._links[1].numpy()
    else:
        pst.new_link(1)
        pst.add(delta)
        ckpt.save_shared(pst, path)
        dst = JSharedTensor(jax.tree.map(jnp.asarray, _template()))
        dst.new_link(1, seed=False)
        jckpt.load_shared(dst, path)
        src_v, src_l = pst.snapshot_flat().numpy(), pst._links[1].numpy()
        got_v, got_l = (np.asarray(x) for x in (dst.snapshot_flat(), dst._links[1]))
    np.testing.assert_array_equal(got_v, src_v)
    np.testing.assert_array_equal(got_l, src_l)


@pytest.mark.parametrize("shape", ["41", "42"])
def test_pod_jax_to_port(files, shape):
    """A JAX save_pod file of 4 peers onto port meshes of 4 x 1 and 4 x 2."""
    v, r = _res(files, f"jax_pod_{shape}")
    np.testing.assert_array_equal(v, files["jax_pod"][0])
    np.testing.assert_array_equal(r, files["jax_pod"][1])


def test_pod_port_to_jax(files):
    """A port save_pod file of a 2 x 2 mesh onto a JAX mesh of 2 x 1."""
    assert _res(files, "port_save")
    spec = j_make_spec(jax.tree.map(jnp.asarray, POD_TPL))
    st = jckpt.load_pod(str(files["dir"] / "port_pod.npz"), j_mesh(2, 1), spec)
    np.testing.assert_array_equal(np.asarray(st.values), files["port_state"][0])
    np.testing.assert_array_equal(np.asarray(st.residual), files["port_state"][1])


@pytest.mark.parametrize("shape", ["22", "21"])
def test_pod_sharded_jax_to_port(files, shape):
    """JAX's directory of 8 device shards (2 peers x 4 shards) onto port
    meshes of 2 x 2 and 2 x 1: each port block joins several saved shards."""
    v, r = _res(files, f"jax_sharded_{shape}")
    np.testing.assert_array_equal(v, files["jax_sharded"][0])
    np.testing.assert_array_equal(r, files["jax_sharded"][1])


@pytest.mark.parametrize("n_shard", [2, 4])
def test_pod_sharded_port_to_jax(files, n_shard):
    """The port's directory of 4 rank files (2 x 2) onto JAX meshes of 2 x 2
    and 2 x 4 (JAX's loader slices the one saved shard covering each
    device's index)."""
    assert _res(files, "port_save")
    spec = j_make_spec(jax.tree.map(jnp.asarray, POD_TPL))
    st = jckpt.load_pod_sharded(str(files["dir"] / "port_sharded"), j_mesh(2, n_shard), spec)
    np.testing.assert_array_equal(np.asarray(jax.device_get(st.values)), files["port_state"][0])
    np.testing.assert_array_equal(np.asarray(jax.device_get(st.residual)), files["port_state"][1])
    names = sorted(os.listdir(files["dir"] / "port_sharded"))
    assert "shard_p3_1-2_2048-4096.npz" in names and "manifest_p3.npz" in names and "meta.npz" in names


def test_trainer_adam_jax_to_port(files):
    """A JAX optax.adam save_trainer file into a port trainer with an
    optax-shaped Adam: state, step count, and the (count, mu, nu) leaves as
    every peer's rows."""
    res = _res(files, "trainer")["loaded"]
    with np.load(files["dir"] / "jax_trainer.npz") as z:
        assert res["steps"] == 3
        np.testing.assert_array_equal(res["state"][0], z["values"])
        np.testing.assert_array_equal(res["state"][1], z["residual"])
        assert len(res["leaves"]) == 3
        for i, got in enumerate(res["leaves"]):
            np.testing.assert_array_equal(got, z[f"opt_{i}"].reshape(2, -1))


def test_trainer_adam_port_to_jax(files):
    """The port trainer's save_trainer file (3 more Adam steps) into a JAX
    PodTrainer with optax.adam: state, step count and optimizer leaves bit
    for bit, and the JAX trainer steps on from there."""
    res = _res(files, "trainer")["saved"]
    tr = _j_trainer(2)
    jckpt.load_trainer(tr, str(files["dir"] / "port_trainer.npz"))
    assert tr.steps == res["steps"] == 6
    np.testing.assert_array_equal(np.asarray(tr.state.values), res["state"][0])
    np.testing.assert_array_equal(np.asarray(tr.state.residual), res["state"][1])
    leaves = jax.tree.leaves(tr.opt_state)
    assert len(leaves) == 3
    for got, want in zip(leaves, res["leaves"]):
        np.testing.assert_array_equal(np.asarray(got).reshape(2, -1), want)
    losses, _ = tr.step(tr.shard_batch(jm.make_batches(B.CHAR_TEXT, 4, 16, jax.random.key(9), n_peer=2, vocab=64)))
    assert np.isfinite(np.asarray(losses)).all()


def test_engine_snapshot_roundtrip_sign2_cascade_inflight(tmp_path, monkeypatch):
    """test_checkpoint.py's sign2 case on a port engine pair pinned to sign2
    (ST_SIGN2=2): the joiner's uplink stalls (ST_FAULT_PLAN around its
    creation) so cascade-quantized sign2 messages sit ledgered, in flight,
    with their error feedback already taken from the residual. Then
    snapshot_ex, restore_ex, snapshot_ex round-trips the replica, every
    residual and each link's aux (seqs, precision, the sign2 capability)
    bit for bit; a crafted precision and governor sample survive a
    restore; and save_shared / load_shared round-trip the same state into
    the live engine bit for bit."""
    import time

    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.comm import faults
    from shared_tensor_tpu_torch.config import FaultConfig
    from tests._ports import free_port

    monkeypatch.setenv("ST_SIGN2", "2")
    port = free_port()
    seed = np.zeros(2048, np.float32)
    # ack_timeout 0: the stalled link keeps its ledger (no go-back-N teardown)
    cfg = Config(transport=TransportConfig(ack_timeout_sec=0.0))
    master = create_or_fetch("127.0.0.1", port, seed, cfg, host_tier=True)
    env = faults.to_env(FaultConfig(enabled=True, seed=3, stall_after_frames=0, only_link=1))
    monkeypatch.setenv("ST_FAULT_PLAN", env["ST_FAULT_PLAN"])
    child = create_or_fetch("127.0.0.1", port, seed, cfg, host_tier=True)
    monkeypatch.delenv("ST_FAULT_PLAN")
    try:
        eng = child._engine
        assert eng is not None
        rng = np.random.default_rng(2)
        for _ in range(40):
            child.add(rng.uniform(-1, 1, 2048).astype(np.float32))
            time.sleep(0.01)  # a message or more per add, not one burst for all
        deadline = time.time() + 20.0
        while time.time() < deadline and eng.inflight_total() < 8:
            time.sleep(0.05)
        last = -1
        while time.time() < deadline:  # the sender quiescent (window shut or residual drained)
            cur = eng.frames_out
            if cur == last:
                break
            last = cur
            time.sleep(0.3)
        inflight = eng.inflight_total()
        assert inflight >= 8, f"no in-flight ledger built up ({inflight})"
        assert child.metrics()["st_frames2_out_total"] > 0, "the stalled messages are not sign2"
        v1, l1, a1 = eng.snapshot_ex()
        assert a1[1]["sign2"], "the peer's sign2 capability is missing from the aux"
        assert a1[1]["tx_seq"] >= inflight and a1[1]["rx_count"] == 0
        eng.restore_ex(v1, l1, a1)
        v2, l2, a2 = eng.snapshot_ex()
        np.testing.assert_array_equal(v1.numpy(), v2.numpy())
        assert set(l1) == set(l2)
        for lid in l1:
            np.testing.assert_array_equal(l1[lid].numpy(), l2[lid].numpy())
        assert a1 == a2
        eng.restore_ex(v1, l1, {1: dict(a1[1], prec=2, gov_prev=0.25)})
        assert eng.link_precision(1) == 2
        _, _, a3 = eng.snapshot_ex()
        assert a3[1]["prec"] == 2 and a3[1]["gov_prev"] == pytest.approx(0.25)
        path = str(tmp_path / "engine.npz")
        ckpt.save_shared(eng, path)
        ckpt.load_shared(eng, path)
        v4, l4, _ = eng.snapshot_ex()
        np.testing.assert_array_equal(v4.numpy(), v1.numpy())
        for lid in l1:
            np.testing.assert_array_equal(l4[lid].numpy(), l1[lid].numpy())
    finally:
        child.close()
        master.close()
