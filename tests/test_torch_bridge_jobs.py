"""Rank-side jobs of tests/test_torch_hierarchical.py and
tests/test_torch_checkpoint.py. It holds no tests itself.

They run inside ``shared_tensor_tpu_torch.parallel.run_mesh`` ranks, so this
module imports torch and the port only: a rank never loads jax. Each test
file makes ONE mesh of 8 CPU ranks and hands it a list of jobs
(:func:`run_jobs`). A job is ``fn(world, **kw)`` on every rank: it builds the
meshes it needs (every rank creates every group, in the same order) and
returns None on the ranks it leaves out. Inputs and results are numpy.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
import time

import numpy as np
import torch

from shared_tensor_tpu_torch.config import Config, TransportConfig
from shared_tensor_tpu_torch.convert import pod_state_from_numpy, pod_state_to_numpy, table_from_numpy
from shared_tensor_tpu_torch.ops.table import make_spec, tree_flatten
from shared_tensor_tpu_torch.parallel import make_mesh
from shared_tensor_tpu_torch.parallel.mesh import all_gather, all_true, broadcast_
from shared_tensor_tpu_torch.train import HierarchicalTrainer, PodTrainer
from shared_tensor_tpu_torch.utils import checkpoint as ckpt
from shared_tensor_tpu_torch.utils.timing import Spans

from tests.test_torch_pod_jobs import CHAR_TEXT, _np_tree

CPU = "cpu"


def run_on_mesh(jobs, timeout_s: float = 300.0):
    """Run ``jobs`` on one mesh of 8 CPU ranks; each rank's {name: result}.
    Takes the pod tests' lock file, so that under pytest-xdist the test
    files' meshes start one at a time."""
    from shared_tensor_tpu_torch.parallel import run_mesh

    with open(os.path.join(tempfile.gettempdir(), "st_torch_pod_tests.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return run_mesh(run_jobs, 8, 1, jobs, device=CPU, timeout_s=timeout_s)


def run_jobs(world, jobs):
    """``jobs``: (name, function name, kwargs) each, run in order on every
    rank. Returns {name: result}."""
    return {name: globals()[fn](world, **kw) for name, fn, kw in jobs}


def first(results, name):
    """The first non-None result of a job over the ranks."""
    return next(r[name] for r in results if r[name] is not None)


def pods(n_pods: int, n_peer: int = 2, n_shard: int = 1):
    """``n_pods`` meshes of (n_peer, n_shard) over consecutive ranks and a
    (size, 1) mesh over all their ranks. Returns (this rank's pod mesh,
    its pod index, the joint mesh), or Nones outside them."""
    size = n_peer * n_shard
    mine, index = None, None
    for i in range(n_pods):
        m = make_mesh(n_peer, n_shard, device=CPU, ranks=range(i * size, (i + 1) * size))
        if m is not None:
            mine, index = m, i
    both = make_mesh(n_pods * size, 1, device=CPU, ranks=range(n_pods * size))
    return mine, index, both


def per_rank(both, value: float) -> np.ndarray:
    """Every rank's ``value`` over the joint mesh, in rank order (collective)."""
    return all_gather(both, torch.tensor([float(value)], dtype=torch.float64), both.peer_group).wait().numpy()[:, 0]


def settle(both, pump, cond, timeout: float) -> bool:
    """``pump()`` then ``cond()`` until ``cond`` holds on every rank of the
    joint mesh or rank 0's clock passes ``timeout``. Collective."""
    deadline = time.time() + timeout
    while True:
        pump()
        if all_true(both, bool(cond())):
            return True
        late = torch.tensor([int(time.time() > deadline)], dtype=torch.int32)
        if broadcast_(both, late, both.rank_of(0, 0), both.peer_group).item():
            return False
        time.sleep(0.05)


def _create_in_turn(pod, index, both, n_pods, make):
    """Each pod creates its trainer after the pods before it (the first is
    the tree's master)."""
    tr = None
    for i in range(n_pods):
        if index == i:
            tr = make()
        all_true(both, True)
    return tr


def _quad_loss(p, b):
    return torch.mean((p["w"] - b) ** 2)


def _template():
    return {"w": np.zeros(8, np.float32)}


# -- tests/test_hierarchical.py ----------------------------------------------------


def add_propagates(world, port):
    pod, index, both = pods(2)
    if pod is None:
        return None
    tr = _create_in_turn(pod, index, both, 2, lambda: HierarchicalTrainer.create(
        pod, "127.0.0.1", port, table_from_numpy(_template()), _quad_loss))
    try:
        if index == 0:  # pod A: every mesh peer adds 1s
            tr.pod.add(torch.ones(tr.pod.spec.total))
        batch = tr.pod.shard_batch(np.zeros((2, 8), np.float32))

        def b_sees_two():
            w = tr.read(0)["w"].numpy()
            return index == 0 or np.allclose(w, 2.0, atol=0.05)

        ok = settle(both, lambda: tr.step(batch, lr=0.0), b_sees_two, 15.0)
        return {"ok": ok, "w": tr.read(0)["w"].numpy(), "pod": index}
    finally:
        tr.close()


def converge_to_mixture(world, port, steps=150):
    """Pod A trains toward +2 (fused sync), pod B toward -2 (overlap sync)."""
    pod, index, both = pods(2)
    if pod is None:
        return None
    kw = dict(overlap=True) if index == 1 else {}
    tr = _create_in_turn(pod, index, both, 2, lambda: HierarchicalTrainer.create(
        pod, "127.0.0.1", port, table_from_numpy(_template()), _quad_loss, **kw))
    try:
        target = tr.pod.shard_batch(np.full((2, 8), 2.0 if index == 0 else -2.0, np.float32))
        for _ in range(steps):
            tr.step(target, lr=0.05)
            time.sleep(0.002)
        live = per_rank(both, tr.read(0)["w"].mean())

        def agreed():
            m = per_rank(both, tr.read(0)["w"].mean())
            return abs(m[0] - m[-1]) < 0.05

        ok = settle(both, lambda: tr.step(target, lr=0.0), agreed, 15.0)
        return {"live": live, "ok": ok, "final": per_rank(both, tr.read(0)["w"].mean())}
    finally:
        tr.close()


def layout_mismatch(world, port):
    from shared_tensor_tpu_torch import create_or_fetch

    pod = make_mesh(2, 1, device=CPU, ranks=[0, 1])
    if pod is None:
        return None
    bridge = pod.peer == 0 and pod.shard == 0
    peer = create_or_fetch("127.0.0.1", port, table_from_numpy(_template()), device=CPU) if bridge else None
    try:
        tr = PodTrainer(pod, table_from_numpy({"x": np.zeros((3, 3), np.float32)}), _quad_loss)
        try:
            HierarchicalTrainer(tr, peer)
        except ValueError as e:
            return {"raised": str(e)}
        return {"raised": None}
    finally:
        if peer is not None:
            peer.close()


def _bridge_quiet(tr, tol: float) -> bool:
    """Nothing owed on this pod's side: the pod's residual block, and on
    the bridge rank every link residual, within ``tol`` RMS, no carry (the
    re-graft is complete) and nothing unacknowledged."""
    from shared_tensor_tpu_torch.comm.peer import CARRY_LINK

    r = tr.pod.state.residual
    if float(torch.sqrt(torch.mean(r * r))) > tol:
        return False
    if tr.peer is None:
        return True
    st = tr.peer.st
    links = st.link_ids
    return CARRY_LINK not in links and st.inflight_total() == 0 and all(st.residual_rms(l) <= tol for l in links)


def churn(world, port, train_steps=30, timeout=120.0, quiet_tol=1e-6):
    """Four pods of 2 form the tree; the mid-tree parent pod (a non-master
    bridge with a child link) closes while every pod trains; the survivors
    train on, then must agree AT QUIESCENCE: pod means within 0.05 with
    nothing owed anywhere (no carry, nothing in flight, residuals drained),
    never a momentary agreement while mass is still in flight."""
    pod, index, both = pods(4)
    if pod is None:
        return None
    cfg = Config(transport=TransportConfig(peer_timeout_sec=5.0, max_rejoin_attempts=16))
    tr = _create_in_turn(pod, index, both, 4, lambda: HierarchicalTrainer.create(
        pod, "127.0.0.1", port, table_from_numpy(_template()), _quad_loss, peer_config=cfg))
    target = tr.pod.shard_batch(np.full((2, 8), (2.0, -2.0, 1.0, -1.0)[index], np.float32))
    for _ in range(train_steps):
        tr.step(target, lr=0.05)
        time.sleep(0.002)
    parent = tr.peer is not None and not tr.peer.is_master and len(tr.peer.node.links) > 1
    flags = per_rank(both, parent)
    dead = int(np.flatnonzero(flags)[0]) // 2 if flags.any() else -1
    if index == dead:
        tr.close()
    # the survivors' joint mesh (every rank builds it, the dead pod's too)
    alive = [r for r in range(8) if dead < 0 or r // 2 != dead]
    surv = make_mesh(len(alive), 1, device=CPU, ranks=alive)
    if index == dead:
        return {"dead": dead, "closed": True}
    try:
        for _ in range(train_steps):
            tr.step(target, lr=0.05)
            time.sleep(0.002)
        t0 = time.time()

        def agreed_at_quiescence():
            means = per_rank(surv, tr.read(0)["w"].mean())
            quiet = all_true(surv, _bridge_quiet(tr, quiet_tol))
            return quiet and means.max() - means.min() < 0.05

        ok = settle(surv, lambda: tr.step(target, lr=0.0), agreed_at_quiescence, timeout)
        info = {"ok": ok, "dead": dead, "seconds": time.time() - t0,
                "means": per_rank(surv, tr.read(0)["w"].mean()), "pod": index}
        if tr.peer is not None:
            info.update(master=tr.peer.is_master, links=list(tr.peer.node.links), err=repr(tr.peer._error),
                        alive=tr.peer.threads_alive())
        return info
    finally:
        tr.close()


class _StubSt:
    def __init__(self, spec):
        self.spec = spec
        self.snap = None

    def snapshot_flat(self):
        return self.snap.clone()


class _StubPeer:
    """The bridge's view of a peer, with a snapshot set by the test and
    every add recorded: the exchange's bookkeeping without a tree."""

    def __init__(self, spec):
        self.st = _StubSt(spec)
        self.added = []

    def add(self, delta):
        from shared_tensor_tpu_torch.ops.table import flatten

        self.added.append(flatten(delta, self.st.spec).numpy().copy())

    def close(self):
        pass


def exchange_bookkeeping(world, n_peer, n_shard, tpl, values, seen, updates, snaps):
    """The exchange on seeded inputs: the pod at ``values`` [n_peer, total]
    with ``seen`` as what it has of the tree; per round, the pod adds
    ``updates[i]`` [n_peer, total], the peer's replica reads ``snaps[i]``,
    and the pod exchanges. Returns each round's push, pod values and the
    bridge's ``_peer_seen`` / ``_pod_pushed``."""
    mesh = make_mesh(n_peer, n_shard, device=CPU, ranks=range(n_peer * n_shard))
    if mesh is None:
        return None
    pod = PodTrainer(mesh, table_from_numpy(tpl), _quad_loss)
    pod.state = pod_state_from_numpy(values, np.zeros_like(values), mesh)
    bridge = mesh.peer == 0 and mesh.shard == 0
    peer = _StubPeer(pod.spec) if bridge else None
    tr = HierarchicalTrainer(pod, peer, _peer_seen=torch.from_numpy(seen.copy()) if bridge else None)
    rounds = []
    for u, s in zip(updates, snaps):
        pod.add(torch.from_numpy(u[mesh.peer].copy()))
        if bridge:
            peer.st.snap = torch.from_numpy(s.copy())
        tr.exchange()
        v, _ = pod_state_to_numpy(pod.state, mesh)
        rounds.append({"values": v} | ({} if not bridge else {
            "outgoing": peer.added[-1], "seen": tr._peer_seen.numpy().copy(), "pushed": tr._pod_pushed.numpy().copy()}))
    return rounds if bridge else None


def mixed_pod(world, port, tmp, steps, period):
    """A port pod joining a JAX pod's tree (tests/test_torch_hierarchical.py
    drives the JAX side in the test process): files under ``tmp`` say
    ``joined``, ``go`` and ``stop``; the bridge writes the pod's mean to
    ``mean_<i>.npy`` as it quiesces. Trains toward -2. Besides the mean
    and the exchange count, returns the live steps' seconds and median ms,
    the bridge stages' seconds over them (``utils/timing.Spans``) and, on
    the bridge rank, the state lock's table by call site (empty unless
    ``ST_LOCK_TRACE=1``)."""
    import pathlib

    tmp = pathlib.Path(tmp)
    pod = world
    tr = HierarchicalTrainer.create(pod, "127.0.0.1", port, table_from_numpy(_template()), _quad_loss, timeout=60.0)
    try:
        if tr.is_bridge:
            (tmp / "joined").touch()
        deadline = time.time() + 120
        while not all_true(pod, not tr.is_bridge or (tmp / "go").exists() or time.time() > deadline):
            time.sleep(0.02)
        target = tr.pod.shard_batch(np.full((2, 8), -2.0, np.float32))
        tr.spans = Spans()
        step_s, t_live = [], time.perf_counter()
        for _ in range(steps):
            t0 = time.time()
            tr.step(target, lr=0.05)
            step_s.append(time.time() - t0)
            time.sleep(max(0.0, period - (time.time() - t0)))
        live = {"live_s": time.perf_counter() - t_live, "steps_s": float(sum(step_s)),
                "median_step_ms": 1e3 * float(np.median(step_s)),
                "stage_s": dict(tr.spans.totals),
                "lock": tr.peer.st.lock_stats() if tr.is_bridge else {}}
        tr.spans = None
        i = 0
        while not all_true(pod, not tr.is_bridge or (tmp / "stop").exists() or time.time() > deadline):
            tr.step(target, lr=0.0)
            mean = float(tr.read(0)["w"].mean())
            if tr.is_bridge:
                np.save(tmp / "mean.tmp.npy", np.asarray([i, mean]))
                os.replace(tmp / "mean.tmp.npy", tmp / "mean.npy")
            i += 1
            time.sleep(0.02)
        return {"mean": float(tr.read(0)["w"].mean()), "exchanges": tr.exchanges} | live
    finally:
        tr.close()


# -- tests/test_checkpoint.py ------------------------------------------------------


class Adam:
    """optax.adam(lr) in optax's shape, elementwise on a flat buffer: the
    state is ((count, mu, nu), ()), whose leaves come in optax's order
    (``ScaleByAdamState(count, mu, nu)``, then the learning-rate scaling's
    empty state), count an int32 scalar."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, flat):
        return ((torch.zeros((), dtype=torch.int32), torch.zeros_like(flat), torch.zeros_like(flat)), ())

    def update(self, g, state, flat):
        (count, mu, nu), empty = state
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * g * g + self.b2 * nu
        count = count + 1
        mu_hat = mu / (1 - self.b1 ** count.item())
        nu_hat = nu / (1 - self.b2 ** count.item())
        return -self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps), ((count, mu, nu), empty)


def _char(cfg_kw, text=CHAR_TEXT):
    from shared_tensor_tpu_torch.models import char_rnn as m

    cfg = m.CharRNNConfig(**cfg_kw)
    params = _np_tree(m.init_params(torch.Generator().manual_seed(0), cfg, device=CPU))
    data = m.encode_corpus(text, device=CPU)
    return m, cfg, params, (lambda p, b: m.loss_fn(p, b, cfg)), data


SMALL = dict(vocab=64, embed=16, hidden=32, layers=1)


def _batches(m, data, cfg, n_peer, batch=4, seq=16):
    return lambda i: m.make_batches(data, batch, seq, torch.Generator().manual_seed(i), n_peer=n_peer, vocab=cfg.vocab)


def _opt_leaves(tr):
    return [] if tr.opt_state is None else tree_flatten(tr.opt_state)[0]


def _equal_on_every_rank(mesh, pairs) -> bool:
    return all_true(mesh, all(torch.equal(a, b) for a, b in pairs))


def pod_roundtrip_resumes(world, path):
    """Save mid-training, restore onto a fresh trainer, continue: the loss
    continues from the checkpoint."""
    mesh = make_mesh(4, 1, device=CPU, ranks=range(4))
    if mesh is None:
        return None
    m, cfg, params, loss, data = _char(SMALL, b"abcdefgh" * 200)  # test_checkpoint.py's corpus
    batch = _batches(m, data, cfg, 4)
    tr = PodTrainer(mesh, table_from_numpy(params), loss)
    for i in range(10):
        tr.step(tr.shard_batch(batch(i)), lr=0.3)
    ckpt.save_pod(tr.state, tr.spec, path, mesh)
    tr2 = PodTrainer(mesh, table_from_numpy(params), loss)
    tr2.state = ckpt.load_pod(path, mesh, tr2.spec)
    equal = _equal_on_every_rank(mesh, zip(tr2.state, tr.state))
    l2, _ = tr2.step(tr2.shard_batch(batch(99)), lr=0.3)
    fresh = PodTrainer(mesh, table_from_numpy(params), loss)
    l0, _ = fresh.step(fresh.shard_batch(batch(99)), lr=0.0)
    return {"equal": equal, "resumed": float(l2.mean()), "fresh": float(l0.mean())}


def pod_peer_count_mismatch(world, path):
    from shared_tensor_tpu_torch.parallel import init_state

    mesh4 = make_mesh(4, 1, device=CPU, ranks=range(4))
    mesh2 = make_mesh(2, 1, device=CPU, ranks=range(2))
    tpl = table_from_numpy({"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.float32)})
    spec = make_spec(tpl)
    if mesh4 is not None:
        ckpt.save_pod(init_state(mesh4, spec, tpl), spec, path, mesh4)
    all_true(world, True)
    if mesh2 is None:
        return None
    try:
        ckpt.load_pod(path, mesh2, spec)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def trainer_adam_resume(world, path, k=5):
    """2k steps straight against k, save_trainer, restore into a fresh
    trainer, k more: state, moments and step count bit for bit."""
    mesh = make_mesh(4, 1, device=CPU, ranks=range(4))
    if mesh is None:
        return None
    m, cfg, params, loss, data = _char(SMALL)
    batch = _batches(m, data, cfg, 4)
    make = lambda: PodTrainer(mesh, table_from_numpy(params), loss, optimizer=Adam(3e-3))
    ref = make()
    for i in range(2 * k):
        ref.step(ref.shard_batch(batch(i)))
    tr = make()
    for i in range(k):
        tr.step(tr.shard_batch(batch(i)))
    ckpt.save_trainer(tr, path)
    tr2 = make()
    ckpt.load_trainer(tr2, path)
    steps = tr2.steps
    for i in range(k, 2 * k):
        tr2.step(tr2.shard_batch(batch(i)))
    return {
        "steps": steps, "n_leaves": len(_opt_leaves(tr2)),
        "state_equal": _equal_on_every_rank(mesh, zip(tr2.state, ref.state)),
        "opt_equal": _equal_on_every_rank(mesh, zip(_opt_leaves(tr2), _opt_leaves(ref))),
    }


def trainer_optimizer_mismatch(world, path):
    mesh = make_mesh(2, 1, device=CPU, ranks=range(2))
    if mesh is None:
        return None
    tpl = table_from_numpy({"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.ones(4, np.float32)})
    zero = lambda p, b: p["b"].sum() * 0
    ckpt.save_trainer(PodTrainer(mesh, tpl, zero, optimizer=Adam(1e-3)), path)
    try:
        ckpt.load_trainer(PodTrainer(mesh, tpl, zero), path)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _random_state(mesh, spec, tpl, seed):
    from shared_tensor_tpu_torch.parallel import add_updates, init_state
    from shared_tensor_tpu_torch.parallel.ici import block_range

    state = init_state(mesh, spec, tpl)
    upd = np.random.default_rng(seed).normal(size=(mesh.n_peer, spec.total)).astype(np.float32)
    lo, hi = block_range(mesh, spec)
    return add_updates(state, torch.from_numpy(upd[mesh.peer, lo:hi].copy()))


def pod_sharded_io(world, path):
    """save_pod_sharded writes one file per rank, each far under the full
    table, and load_pod_sharded restores it; a second save of another state
    on a coarser mesh into the same directory leaves the old files there,
    and the load serves only the manifested ones."""
    mesh42 = make_mesh(4, 2, device=CPU)
    mesh41 = make_mesh(4, 1, device=CPU, ranks=range(4))
    tpl = table_from_numpy({"w": np.zeros(1 << 20, np.float32)})  # 4 MiB a peer
    spec = make_spec(tpl)
    state = _random_state(mesh42, spec, tpl, 0)
    ckpt.save_pod_sharded(state, spec, path, mesh42)
    files = sorted(f for f in os.listdir(path) if f.startswith("shard_"))
    sizes = [os.path.getsize(os.path.join(path, f)) for f in files]
    restored = ckpt.load_pod_sharded(path, mesh42, spec)
    out = {"files": files, "sizes": sizes, "full_bytes": 4 * mesh42.n_peer * spec.total,
           "equal": _equal_on_every_rank(mesh42, zip(restored, state)),
           "device": str(restored.values.device), "block": restored.values.numel()}
    if mesh41 is not None:
        state2 = _random_state(mesh41, spec, tpl, 1)
        ckpt.save_pod_sharded(state2, spec, path, mesh41)
        out["files_after"] = len([f for f in os.listdir(path) if f.startswith("shard_")])
        out["equal2"] = _equal_on_every_rank(mesh41, zip(ckpt.load_pod_sharded(path, mesh41, spec), state2))
    return out if world.peer == 0 else None


def pod_sharded_wrong_layout(world, path):
    from shared_tensor_tpu_torch.parallel import init_state

    mesh = make_mesh(4, 2, device=CPU)
    spec = make_spec(table_from_numpy({"w": np.zeros(1 << 14, np.float32)}))
    ckpt.save_pod_sharded(init_state(mesh, spec), spec, path, mesh)
    other = make_spec(table_from_numpy({"w": np.zeros(1 << 13, np.float32)}))
    try:
        ckpt.load_pod_sharded(path, mesh, other)
    except ValueError as e:
        return {"raised": str(e)} if world.peer == 0 else None
    return {"raised": None}


def pod_sharded_resume(world, path):
    """Resume from a sharded checkpoint mid-training: bit for bit the
    uninterrupted run."""
    mesh = make_mesh(4, 2, device=CPU)
    m, cfg, params, loss, data = _char(SMALL)
    batch = _batches(m, data, cfg, 4, batch=2, seq=8)
    tr = PodTrainer(mesh, table_from_numpy(params), loss)
    for i in range(3):
        tr.step(tr.shard_batch(batch(i)), lr=0.2)
    ckpt.save_pod_sharded(tr.state, tr.spec, path, mesh)
    for i in range(3, 6):
        tr.step(tr.shard_batch(batch(i)), lr=0.2)
    tr2 = PodTrainer(mesh, table_from_numpy(params), loss)
    tr2.state = ckpt.load_pod_sharded(path, mesh, tr2.spec)
    for i in range(3, 6):
        tr2.step(tr2.shard_batch(batch(i)), lr=0.2)
    equal = _equal_on_every_rank(mesh, zip(tr2.state, tr.state))
    return {"equal": equal} if world.peer == 0 else None


# -- across the packages: files the JAX side wrote or reads ----------------------


def load_pod_file(world, path, n_peer, n_shard, tpl):
    """The pod state of a save_pod file (JAX's or the port's) on a port
    mesh, as [n_peer, total] arrays."""
    mesh = make_mesh(n_peer, n_shard, device=CPU, ranks=range(n_peer * n_shard))
    if mesh is None:
        return None
    out = pod_state_to_numpy(ckpt.load_pod(path, mesh, make_spec(table_from_numpy(tpl))), mesh)
    return out if mesh.peer == 0 and mesh.shard == 0 else None


def load_sharded_dir(world, path, n_peer, n_shard, tpl):
    mesh = make_mesh(n_peer, n_shard, device=CPU, ranks=range(n_peer * n_shard))
    if mesh is None:
        return None
    out = pod_state_to_numpy(ckpt.load_pod_sharded(path, mesh, make_spec(table_from_numpy(tpl))), mesh)
    return out if mesh.peer == 0 and mesh.shard == 0 else None


def save_pod_files(world, path, sharded_path, n_peer, n_shard, tpl, values, residual):
    """save_pod and save_pod_sharded of the given [n_peer, total] state
    from a port mesh (for the JAX side to load)."""
    mesh = make_mesh(n_peer, n_shard, device=CPU, ranks=range(n_peer * n_shard))
    if mesh is None:
        return None
    spec = make_spec(table_from_numpy(tpl))
    state = pod_state_from_numpy(values, residual, mesh)
    ckpt.save_pod(state, spec, path, mesh)
    ckpt.save_pod_sharded(state, spec, sharded_path, mesh)
    return True


def trainer_across(world, load_path, save_path, n_peer, steps=3):
    """Load a JAX optax-Adam save_trainer file into a port trainer with
    the optax-shaped Adam (its leaves and step count as every peer's rows),
    then train ``steps`` and save_trainer for the JAX side to load."""
    mesh = make_mesh(n_peer, 1, device=CPU, ranks=range(n_peer))
    if mesh is None:
        return None
    m, cfg, params, loss, data = _char(SMALL)
    tr = PodTrainer(mesh, table_from_numpy(params), loss, optimizer=Adam(3e-3))
    ckpt.load_trainer(tr, load_path)
    loaded = {"steps": tr.steps, "state": pod_state_to_numpy(tr.state, mesh),
              "leaves": [all_gather(mesh, torch.as_tensor(l).reshape(-1), mesh.peer_group).wait().numpy()
                         for l in _opt_leaves(tr)]}
    batch = _batches(m, data, cfg, n_peer)
    for i in range(steps):
        tr.step(tr.shard_batch(batch(i)))
    ckpt.save_trainer(tr, save_path)
    saved = {"steps": tr.steps, "state": pod_state_to_numpy(tr.state, mesh),
             "leaves": [all_gather(mesh, torch.as_tensor(l).reshape(-1), mesh.peer_group).wait().numpy()
                        for l in _opt_leaves(tr)]}
    return {"loaded": loaded, "saved": saved} if mesh.peer == 0 else None
