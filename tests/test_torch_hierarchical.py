"""The hierarchical tier on the port (shared_tensor_tpu_torch.train.
HierarchicalTrainer): the four cases of tests/test_hierarchical.py on port
pods (2-rank meshes over gloo on the CPU, bridged over loopback TCP), a JAX
pod and a port pod bridged in one tree, and the exchange's bookkeeping
against the JAX HierarchicalTrainer's on the same seeded inputs.

The port pods run in ONE mesh of 8 CPU ranks (tests/test_torch_bridge_jobs);
the mixed tree spawns its own 2 ranks beside the JAX pod of this process.

Tolerances: the training cases keep test_hierarchical.py's (pods agree
within 0.05; a live pod stays under 1.6 of the mixture's 0; B sees A's
+2 within 0.05). The churn case waits for agreement AT QUIESCENCE: every
survivor's pod residual, and its bridge's link residuals, within 1e-6 RMS,
no carry and nothing unacknowledged, never for a momentary agreement. The
exchange against JAX: bit for bit with 2 peers (a sum of two is exact
whatever the order); with 4 peers the pod mean's sum is the backend's
all-reduce, whose order is not XLA's, so every quantity that carries the
mean is held within n_peer * eps(f32) * max|value|.
"""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shared_tensor_tpu.ops import table as jtable
from shared_tensor_tpu.parallel.ici import PeerSyncState, state_sharding
from shared_tensor_tpu.train import HierarchicalTrainer as JHierarchicalTrainer
from shared_tensor_tpu.train import PodTrainer as JPodTrainer
from tests import test_torch_bridge_jobs as B
from tests._mesh import make_mesh as j_mesh
from tests._ports import free_port

EXCHANGE_CASES = ((2, 1), (2, 2), (4, 1))
EX_TPL = {"a": np.zeros(3000, np.float32), "b": np.zeros((5, 7), np.float32)}


def _exchange_inputs(n_peer, seed):
    """Seeded pod values, the record of what the pod has seen, two rounds
    of per-peer updates and two peer snapshots, all with 0 padding lanes."""
    spec = jtable.make_spec(jax.tree.map(jnp.asarray, EX_TPL))
    rng = np.random.default_rng(seed)
    live = np.asarray(jtable.flatten(jax.tree.map(lambda x: jnp.ones_like(x), EX_TPL), spec)) > 0

    def flat(*shape):
        return (rng.normal(size=(*shape, spec.total)) * live).astype(np.float32)

    return dict(values=flat(n_peer), seen=flat(), updates=[flat(n_peer) * 0.1 for _ in range(2)],
                snaps=[flat() for _ in range(2)])


def _jax_exchange(n_peer, n_shard, inp):
    """The same rounds through the JAX HierarchicalTrainer with a stub peer."""
    mesh = j_mesh(n_peer, n_shard)
    pod = JPodTrainer(mesh, jax.tree.map(jnp.asarray, EX_TPL), lambda p, b: jnp.mean(p["a"]))
    sh = state_sharding(mesh)
    pod.state = PeerSyncState(jax.device_put(inp["values"], sh), jax.device_put(np.zeros_like(inp["values"]), sh))
    added, snap = [], {}
    st = types.SimpleNamespace(spec=pod.spec, snapshot_flat=lambda: jnp.asarray(snap["now"]))
    peer = types.SimpleNamespace(st=st, add=lambda tree: added.append(np.asarray(jtable.flatten(tree, pod.spec))))
    tr = JHierarchicalTrainer(pod, peer, _peer_seen=jnp.asarray(inp["seen"]))
    rounds = []
    for u, s in zip(inp["updates"], inp["snaps"]):
        pod.add(jnp.asarray(u))
        snap["now"] = s
        tr.exchange()
        rounds.append({"values": np.asarray(pod.state.values), "outgoing": added[-1],
                       "seen": np.asarray(tr._peer_seen), "pushed": np.asarray(tr._pod_pushed)})
    return rounds


@pytest.fixture(scope="module")
def port():
    jobs = [
        ("add", "add_propagates", dict(port=free_port())),
        ("mixture", "converge_to_mixture", dict(port=free_port())),
        ("layout", "layout_mismatch", dict(port=free_port())),
        ("churn", "churn", dict(port=free_port())),
    ]
    inputs = {}
    for n_peer, n_shard in EXCHANGE_CASES:
        inputs[n_peer, n_shard] = inp = _exchange_inputs(n_peer, seed=n_peer * 10 + n_shard)
        jobs.append((f"exchange_{n_peer}{n_shard}", "exchange_bookkeeping",
                     dict(n_peer=n_peer, n_shard=n_shard, tpl=EX_TPL, **inp)))
    return {"ranks": B.run_on_mesh(jobs), "inputs": inputs}


def _res(port, name):
    return B.first(port["ranks"], name)


# -- tests/test_hierarchical.py on the port -------------------------------------------


def test_add_propagates_between_pods(port):
    """Pod A's mesh peers each add 1s; pod B reads ~2.0 (2 peers x +1)."""
    res = [r["add"] for r in port["ranks"] if r["add"] is not None]
    assert len(res) == 4 and all(r["ok"] for r in res), res
    for r in res:
        np.testing.assert_allclose(r["w"], 2.0, atol=0.05)


def test_two_pod_training_converges_to_mixture(port):
    """Pod A (fused sync) trains toward +2, pod B (overlap sync) toward -2:
    during live training both sit near the mixture (0), and once updates
    stop both pods agree."""
    res = _res(port, "mixture")
    assert np.all(np.abs(res["live"]) < 1.6), res["live"]
    assert res["ok"], res["final"]
    assert abs(res["final"][0] - res["final"][-1]) < 0.05


def test_layout_mismatch_rejected(port):
    raised = [r["layout"]["raised"] for r in port["ranks"] if r["layout"] is not None]
    assert len(raised) == 2 and all(r is not None and "layout" in r for r in raised), raised


def test_pod_bridge_churn_mid_training(port):
    """Four pods of 2 form the tree; the mid-tree parent pod closes while
    every pod trains; its orphan re-grafts under live trainers and the
    survivors agree at quiescence (nothing owed anywhere)."""
    res = [r["churn"] for r in port["ranks"]]
    dead = res[0]["dead"]
    assert dead > 0, "no mid-tree parent pod"
    survivors = [r for r in res if not r.get("closed")]
    assert len(survivors) == 6, res
    bridges = [r for r in survivors if "master" in r]
    info = {r["pod"]: (r["links"], r["master"], r["err"]) for r in bridges}
    assert all(r["ok"] for r in survivors), (survivors[0]["means"], info)
    means = survivors[0]["means"]
    assert means.max() - means.min() < 0.05, means
    assert all(r["alive"] and r["err"] == "None" for r in bridges), info


# -- across the packages -------------------------------------------------------------


@pytest.mark.parametrize("n_peer,n_shard", EXCHANGE_CASES)
def test_exchange_matches_jax(port, n_peer, n_shard):
    """Two exchanges on seeded inputs (pod values, what the pod has seen,
    updates, peer snapshots) through the port's and JAX's bookkeeping: the
    push (outgoing), the pod's values after the pull (incoming), and
    ``_peer_seen`` / ``_pod_pushed``."""
    inp = port["inputs"][n_peer, n_shard]
    want = _jax_exchange(n_peer, n_shard, inp)
    got = _res(port, f"exchange_{n_peer}{n_shard}")
    mag = max(float(np.abs(inp["values"]).max()), float(np.abs(inp["snaps"]).max()))
    atol = 0.0 if n_peer == 2 else n_peer * np.finfo(np.float32).eps * mag
    for g, w in zip(got, want):
        for key in ("outgoing", "values", "seen", "pushed"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=atol, err_msg=key)


def test_mixed_tree_jax_pod_and_port_pod():
    """A JAX pod (2 virtual CPU devices, the tree's master, training toward
    +2) and a port pod (2 gloo ranks, training toward -2) bridged at one
    port: both settle near the mixture and agree once the updates stop.
    The port pod's ranks wait their turn on the test meshes' lock: the
    test is timed, and other files' meshes beside it slow its steps."""
    import tempfile

    from shared_tensor_tpu_torch.parallel import run_mesh
    from tests.test_torch_pod_jobs import mesh_lock

    devs = jax.devices()
    mesh = j_mesh(2, 1, devices=devs[:2])
    port_no = free_port()
    steps, period = 100, 0.01
    a = JHierarchicalTrainer.create(mesh, "127.0.0.1", port_no, {"w": jnp.zeros((8,), jnp.float32)},
                                    lambda p, b: jnp.mean((p["w"] - b) ** 2))
    with mesh_lock(), tempfile.TemporaryDirectory() as tmp:
        out = {}

        def run_port():
            try:
                out["res"] = run_mesh(B.mixed_pod, 2, 1, port_no, tmp, steps, period, device="cpu", timeout_s=240)
            except BaseException as e:  # reported by the test below
                out["err"] = e

        th = threading.Thread(target=run_port, daemon=True)
        th.start()
        import pathlib

        d = pathlib.Path(tmp)
        try:
            deadline = time.time() + 120
            while not (d / "joined").exists() and time.time() < deadline and th.is_alive():
                time.sleep(0.05)
            assert (d / "joined").exists(), out.get("err")
            (d / "go").touch()
            ta = jnp.full((2, 8), 2.0)
            for _ in range(steps):
                t0 = time.time()
                a.step(ta, lr=0.05)
                time.sleep(max(0.0, period - (time.time() - t0)))
            live_a = float(jnp.mean(a.read(0)["w"]))
            # agreement at quiescence: both pods quiescing, and the port
            # pod's mean within 0.05 of ours on 5 reads in a row
            streak, last, deadline = 0, -1, time.time() + 60
            while streak < 5 and time.time() < deadline:
                a.step(ta, lr=0.0)
                time.sleep(0.05)
                try:
                    i, mean_b = np.load(d / "mean.npy")
                except (FileNotFoundError, ValueError, EOFError):
                    continue
                if i == last:
                    continue
                last = i
                agree = abs(float(jnp.mean(a.read(0)["w"])) - mean_b) < 0.05
                streak = streak + 1 if agree else 0
            final_a = float(jnp.mean(a.read(0)["w"]))
        finally:
            (d / "stop").touch()
            th.join(timeout=120)
            a.close()
        assert not th.is_alive() and "err" not in out, out.get("err")
    final_b = out["res"][0]["mean"]
    assert abs(live_a) < 1.6, live_a
    assert streak >= 5, (final_a, final_b)
    assert abs(final_a - final_b) < 0.05 and abs(final_b) < 1.6, (final_a, final_b)
    assert out["res"][0]["exchanges"] >= steps
