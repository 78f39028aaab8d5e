"""The cluster lifecycle on the port's peer: the cases of tests/test_lifecycle.py
on port peers, then mixed trees of JAX and port peers.

The barrier: the root pauses its own production and floods a SNAP marker
down the tree; each node pauses, forwards it once every frame it sent is
acknowledged, waits for its children's SNAP_ACKs and its own empty ledgers,
writes (or loads) its shard and acks up; the root writes MANIFEST.json and
releases the tree with RESUME. The snapshot and in-place restore cases run
on each tier of the port's peer: the device tier (device="cpu"), the Python
host tier and the native engine; the others each run on one tier. The
mixed cases snapshot and restore in place a tree with a JAX root and port
children (one on the engine, one on the device tier) and the reverse, hold
each package's ``verify_manifest`` against the other's snapshot, restart
port nodes from shards JAX wrote beside JAX nodes restarted from the
port's, and compare ``encode_lifecycle``'s bytes.

Tolerances are test_lifecycle.py's: replicas within atol 1e-4 of the sum
of the adds (1e-3 for the subscriber). Every wait has its own deadline."""

import json
import os
import threading
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu.comm import wire as jwire
from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import LifecycleConfig as JLifecycleConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu.utils import checkpoint as jckpt
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, obs
from shared_tensor_tpu_torch.benchmarks import conformance
from shared_tensor_tpu_torch.benchmarks import lifecycle as lc_bench
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.config import FaultConfig, LifecycleConfig, ObsConfig
from shared_tensor_tpu_torch.utils import checkpoint as ckpt
from tests._ports import free_port

N = 2048
TIERS = ("device", "host", "engine")


@pytest.fixture(scope="module", autouse=True)
def _built():
    build_native()


def _cfg(name: str, tier: str = "device", restore: str = "", transport=None, obs=None, **lc) -> Config:
    return Config(
        lifecycle=LifecycleConfig(node_name=name, restore_path=restore, **lc),
        transport=transport or TransportConfig(peer_timeout_sec=20.0),
        obs=obs or ObsConfig(),
        native_engine=tier != "host",
    )


def _peer(port, cfg: Config, tier: str, template=None):
    """A port peer on ``tier``: device (device="cpu"), host (the Python
    host tier: the config says native_engine=False) or engine."""
    seed = np.zeros((N,), np.float32) if template is None else template
    kw = {"device": "cpu"} if tier == "device" else {"host_tier": True}
    return create_or_fetch("127.0.0.1", port, seed, cfg, timeout=45.0, **kw)


def _tree(port, names, tier="device", cfgs=None):
    peers = []
    try:
        for i, name in enumerate(names):
            peers.append(_peer(port, cfgs[i] if cfgs else _cfg(name, tier), tier))
    except BaseException:
        _close(peers)
        raise
    return peers


def _close(peers):
    for p in reversed(peers):
        p.close()


def _read(p) -> np.ndarray:
    return np.asarray(p.read())


def _converged(peers, total, deadline_sec=30.0, atol=1e-4) -> bool:
    deadline = time.time() + deadline_sec
    while time.time() < deadline:
        if all(np.allclose(_read(p), total, atol=atol) for p in peers):
            return True
        time.sleep(0.05)
    return False


def _add(peers, rng, total, rounds=6):
    for i in range(rounds):
        d = rng.uniform(-1, 1, N).astype(np.float32)
        peers[i % len(peers)].add(d)
        total += d


def _tier_of(p) -> str:
    if p._engine is not None:
        return "engine"
    return "host" if p.st.host_tier else "device"


@pytest.mark.parametrize("tier", TIERS)
def test_snapshot_barrier_manifest_and_telemetry(tier, tmp_path):
    """A root-initiated consistent cut: every node's shard lands with a
    matching sha256 in the manifest (the JAX package's audit passes it
    too), the lifecycle telemetry moved, and the tree resumes."""
    peers = _tree(free_port(), ["n0", "n1", "n2"], tier)
    total = np.zeros(N)
    try:
        assert {_tier_of(p) for p in peers} == {tier}
        _add(peers, np.random.default_rng(0), total, rounds=9)
        time.sleep(0.3)
        res = peers[0].snapshot_cluster(str(tmp_path))
        assert res["ok"] and res["nodes"] == 3
        assert res["duration_sec"] < 30.0
        assert ckpt.verify_manifest(str(tmp_path)) == []
        assert jckpt.verify_manifest(str(tmp_path)) == []
        doc = ckpt.load_manifest(str(tmp_path))
        assert {e["node"] for e in doc["nodes"]} == {"n0", "n1", "n2"}
        for name in ("n0", "n1", "n2"):
            shard = ckpt.load_cluster_shard(os.path.join(str(tmp_path), ckpt.shard_filename(name)))
            assert shard["layout"] == peers[0].st.spec.layout_digest()
            assert shard["meta"]["snap_id"] == res["id"]
        for p in peers:
            m = p.metrics()
            assert m["st_snapshot_total"] == 1
            assert m["st_lifecycle_paused"] == 0
            assert m["st_snapshot_in_progress"] == 0
        assert _converged(peers, total)
        _add(peers, np.random.default_rng(1), total, rounds=3)
        assert _converged(peers, total)
    finally:
        _close(peers)


def test_kill_restore_restart_converges_to_same_mass(tmp_path):
    """Snapshot, close every node, restart each from its shard
    (``restore_path``) on a new port: the restored tree converges to the
    mass of the uninterrupted run, and keeps working; and the run's
    timeline replays through the protocol model (the chaos benches'
    conformance gate: no violation, at least one routed event)."""
    hub = obs.hub()
    lc_bench.capture(hub)
    peers = _tree(free_port(), ["n0", "n1", "n2"], "engine")
    total = np.zeros(N)
    rng = np.random.default_rng(2)
    try:
        _add(peers, rng, total, rounds=9)
        time.sleep(0.3)
        assert peers[0].snapshot_cluster(str(tmp_path))["ok"]
        assert lc_bench.released(peers, lc_bench.RELEASE_S)  # the kill comes after the release
    finally:
        _close(peers)
    cfgs = [_cfg(f"n{i}", "engine", restore=os.path.join(str(tmp_path), f"shard_n{i}.npz")) for i in range(3)]
    peers = _tree(free_port(), ["n0", "n1", "n2"], "engine", cfgs)
    try:
        assert all(p._restored_from for p in peers)
        for p in peers:
            assert p.metrics()["st_restore_total"] == 1
        assert _converged(peers, total)
        _add(peers, rng, total, rounds=6)
        assert _converged(peers, total)
    finally:
        _close(peers)
    report = conformance(hub)
    assert report["violations"] == [], report["violations"]
    assert report["pass"] and report["routed_events"] >= 1


@pytest.mark.parametrize("tier", TIERS)
def test_inplace_restore_rolls_back_to_the_cut(tier, tmp_path):
    """restore_cluster on a live tree rolls state back to the cut (the adds
    after it vanish), with no storm of re-sends, and the tree keeps
    working."""
    peers = _tree(free_port(), ["n0", "n1", "n2"], tier)
    a = np.zeros(N)
    rng = np.random.default_rng(3)
    try:
        _add(peers, rng, a, rounds=6)
        time.sleep(0.3)
        assert peers[0].snapshot_cluster(str(tmp_path))["ok"]
        b = np.zeros(N)
        _add(peers, rng, b, rounds=4)
        assert _converged(peers, a + b)
        res = peers[0].restore_cluster(str(tmp_path))
        assert res["ok"] and res["nodes"] == 3
        assert _converged(peers, a)
        for p in peers:
            assert p.metrics()["st_retransmit_msgs_total"] <= 2
            assert p.metrics()["st_restore_total"] == 1
        c = np.zeros(N)
        _add(peers, rng, c, rounds=3)
        assert _converged(peers, a + c)
    finally:
        _close(peers)


def test_inplace_restore_under_drop_chaos_loses_nothing(monkeypatch, tmp_path):
    """Markers flood only once every ledger is empty, so a dropped frame's
    re-send never arrives past its receiver's capture: a snapshot taken
    mid-stream under 25% drops on the chaotic engine's uplink, more writes,
    then an in-place restore rolls the tree back to exactly the cut."""
    from shared_tensor_tpu_torch.comm import faults

    def cfg(name):
        return _cfg(name, "engine", transport=TransportConfig(peer_timeout_sec=20.0, ack_timeout_sec=0.4))

    port = free_port()
    env = faults.to_env(FaultConfig(enabled=True, seed=11, drop_pct=0.25, only_link=1))
    root = _peer(port, cfg("n0"), "engine")
    monkeypatch.setenv("ST_FAULT_PLAN", env["ST_FAULT_PLAN"])
    try:
        chaotic = _peer(port, cfg("n1"), "engine")
    except BaseException:
        root.close()
        raise
    monkeypatch.delenv("ST_FAULT_PLAN")
    peers = [root, chaotic]
    a = np.zeros(N)
    rng = np.random.default_rng(12)
    try:
        # paced adds from the chaotic node, no settle: mass and dropped
        # frames are in flight when the barrier starts
        for _ in range(14):
            d = rng.uniform(-1, 1, N).astype(np.float32)
            chaotic.add(d)
            a += d
            time.sleep(0.01)
        res = root.snapshot_cluster(str(tmp_path))
        assert res["ok"] and res["nodes"] == 2
        b = np.zeros(N)
        _add(peers, rng, b, rounds=4)
        assert _converged(peers, a + b, deadline_sec=60.0)
        assert root.restore_cluster(str(tmp_path))["ok"]
        assert _converged(peers, a, deadline_sec=60.0)
        assert sum(p.metrics()["st_retransmit_msgs_total"] for p in peers) >= 1, "drop chaos never fired"
    finally:
        _close(peers)


def test_drain_node_routed_migration_zero_loss():
    """A chain n0 - n1 - n2 (max_children 1), the interior drained through
    the root's routed CTL: n1 seals, drains and closes, n2 re-grafts, no
    mass is lost and the survivors keep converging."""
    t = TransportConfig(peer_timeout_sec=20.0, max_children=1)
    peers = _tree(free_port(), ["n0", "n1", "n2"], "device", [_cfg(n, transport=t) for n in ("n0", "n1", "n2")])
    total = np.zeros(N)
    rng = np.random.default_rng(4)
    try:
        assert len(peers[1].node.links) == 2  # the chain
        _add(peers, rng, total, rounds=6)
        assert _converged(peers, total)
        peers[0].drain_node("n1")
        deadline = time.time() + 30.0
        while time.time() < deadline and not peers[1]._stop.is_set():
            time.sleep(0.1)
        assert peers[1]._stop.is_set(), "drain target never left"
        assert peers[1].metrics()["st_drain_total"] == 1
        d = rng.uniform(-1, 1, N).astype(np.float32)
        peers[2].add(d)
        total += d
        assert _converged([peers[0], peers[2]], total, deadline_sec=60.0)
    finally:
        _close(peers)


def test_snapshot_and_restore_with_subscriber_no_false_fresh(tmp_path):
    """With a read-only subscriber attached, a snapshot keeps the read
    contract (every read verifies its bound or raises, and the subscriber
    converges after the barrier), and an in-place restore re-seeds the
    subscriber from the restored replica, so its reads come back to the
    cut. On the engine, JAX's default tier, as in JAX's case: on the device
    tier a subscriber link of this data (sums of adds whose bound is no
    power of two) never drains to the exact zero a FRESH mark needs, in
    both packages."""
    from shared_tensor_tpu_torch import serve
    from shared_tensor_tpu_torch.serve import StalenessError

    port = free_port()
    peers = _tree(port, ["n0", "n1"], "engine")
    sub = serve.subscribe("127.0.0.1", port, np.zeros((N,), np.float32), Config(), timeout=45.0)
    a = np.zeros(N)
    rng = np.random.default_rng(5)
    try:
        _add(peers, rng, a, rounds=6)
        time.sleep(0.5)
        assert peers[0].snapshot_cluster(str(tmp_path))["ok"]

        def back_to(want) -> tuple[bool, int]:
            ok_reads = 0
            deadline = time.time() + 30.0
            while time.time() < deadline:
                try:
                    v = np.asarray(sub.read(max_staleness=1.0))
                    ok_reads += 1
                    if np.allclose(v, want, atol=1e-3):
                        return True, ok_reads
                except StalenessError:
                    pass
                time.sleep(0.05)
            return False, ok_reads

        converged, ok_reads = back_to(a)
        assert converged and ok_reads >= 1
        b = np.zeros(N)
        _add(peers, rng, b, rounds=4)
        assert _converged(peers, a + b)
        assert peers[0].restore_cluster(str(tmp_path))["ok"]
        assert back_to(a)[0], "subscriber never re-seeded to the restored cut"
    finally:
        sub.close()
        _close(peers)


def test_rolling_upgrade_version_skew_interop(monkeypatch):
    """An 'old' node (v1 emission) interoperates with a v2 root under drop
    chaos on its uplink; the root's cluster view shows both wire versions
    (the names ride the digest); then the old node drains out and rejoins
    upgraded, and the skew is gone."""
    from shared_tensor_tpu_torch.comm import faults

    port = free_port()
    t = TransportConfig(ack_timeout_sec=0.4)
    new_cfg = _cfg("root", "engine", transport=t, obs=ObsConfig(digest_interval_sec=0.2))
    old_cfg = _cfg("old", "engine", transport=t, obs=ObsConfig(digest_interval_sec=0.2, trace_wire=False))
    root = _peer(port, new_cfg, "engine")
    env = faults.to_env(FaultConfig(enabled=True, seed=7, drop_pct=0.25, only_link=1))
    monkeypatch.setenv("ST_FAULT_PLAN", env["ST_FAULT_PLAN"])
    try:
        old = _peer(port, old_cfg, "engine")
    except BaseException:
        root.close()
        raise
    monkeypatch.delenv("ST_FAULT_PLAN")
    total = np.zeros(N)
    rng = np.random.default_rng(6)
    try:
        assert old._wire_version == 1 and root._wire_version == 2
        for i in range(8):
            d = rng.uniform(-1, 1, N).astype(np.float32)
            (root if i % 2 else old).add(d)
            total += d
            time.sleep(0.01)
        assert _converged([root, old], total, deadline_sec=60.0)
        old.push_digest()
        time.sleep(0.3)
        nodes = root.metrics(cluster=True)["nodes"]
        assert {int(e["m"].get("st_wire_version", 0)) for e in nodes.values()} == {1, 2}
        assert {e.get("name") for e in nodes.values()} == {"root", "old"}
        assert sum(p.metrics()["st_retransmit_msgs_total"] for p in (root, old)) >= 1, \
            "drop chaos never exercised the skewed link"
        assert old.leave(timeout=30.0)
        upgraded = _peer(port, _cfg("old", "engine", obs=ObsConfig(digest_interval_sec=0.2)), "engine")
        try:
            d = rng.uniform(-1, 1, N).astype(np.float32)
            upgraded.add(d)
            total += d
            assert _converged([root, upgraded], total, deadline_sec=60.0)
            upgraded.push_digest()
            time.sleep(0.3)
            live = {int(e["m"].get("st_wire_version", 0)) for e in root.metrics(cluster=True)["nodes"].values()
                    if e.get("name") in ("root", "old")}
            assert live == {2}, live
        finally:
            upgraded.close()
    finally:
        old.close()
        root.close()


def test_barrier_auto_resume_when_root_dies(tmp_path):
    """A node whose barrier RESUME never comes (a bare SNAP marker injected
    past the root's barrier) resumes by itself after
    ``pause_timeout_sec`` and counts the error; it still works after."""
    cfgs = [_cfg("n0", "host"), _cfg("n1", "host", pause_timeout_sec=2.0)]
    peers = _tree(free_port(), ["n0", "n1"], "host", cfgs)
    try:
        child_link = [l for l in peers[0].st.link_ids if l >= 0 and l != peers[0]._uplink][0]
        peers[0]._send_blocking(
            child_link, wire.encode_lifecycle(wire.SNAP, {"op": "save", "id": "orphan", "dir": str(tmp_path)})
        )
        deadline = time.time() + 5.0
        while time.time() < deadline and not peers[1]._paused:
            time.sleep(0.02)
        assert peers[1]._paused, "child never entered the barrier"
        deadline = time.time() + 10.0
        while time.time() < deadline and peers[1]._paused:
            time.sleep(0.05)
        assert not peers[1]._paused, "child stayed paused past the deadline"
        assert peers[1].metrics()["st_lifecycle_errors_total"] >= 1
        total = np.zeros(N)
        _add(peers, np.random.default_rng(8), total, rounds=3)
        assert _converged(peers, total)
    finally:
        _close(peers)


def test_ctl_cli_end_to_end(tmp_path, capsys):
    """The operator surface over the root's files, no socket into the
    cluster: ``status`` and ``versions`` off the digest JSON, ``snapshot``,
    the offline ``verify``, an in-place ``restore`` and ``drain`` through
    the root's command directory."""
    from shared_tensor_tpu_torch import ctl

    ctl_dir, cj, snapdir = str(tmp_path / "ctl"), str(tmp_path / "cluster.json"), str(tmp_path / "snap")
    port = free_port()
    root = _peer(port, _cfg("root", ctl_dir=ctl_dir, obs=ObsConfig(digest_interval_sec=0.2, cluster_json_path=cj)),
                 "device")
    try:
        child = _peer(port, _cfg("child", "engine", obs=ObsConfig(digest_interval_sec=0.2)), "engine")
    except BaseException:
        root.close()
        raise
    try:
        root.add(np.ones((N,), np.float32))
        assert _converged([root, child], np.ones(N))
        child.push_digest()
        deadline = time.time() + 10.0
        while time.time() < deadline:
            try:
                with open(cj) as f:
                    if len(json.load(f)["nodes"]) == 2:
                        break
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.1)
        assert ctl.main(["--file", cj, "status"]) == 0
        assert ctl.main(["--file", cj, "versions"]) == 0
        assert "wire v2: 2 node(s)" in capsys.readouterr().out
        assert ctl.main(["--ctl-dir", ctl_dir, "--timeout", "60", "snapshot", "--dir", snapdir]) == 0
        assert ctl.main(["verify", "--dir", snapdir]) == 0
        assert jckpt.verify_manifest(snapdir) == []
        with open(os.path.join(ctl_dir, "result.json")) as f:
            assert json.load(f)["ok"]
        child.add(np.ones((N,), np.float32))
        assert _converged([root, child], 2 * np.ones(N))
        assert ctl.main(["--ctl-dir", ctl_dir, "--timeout", "60", "restore", "--dir", snapdir]) == 0
        assert _converged([root, child], np.ones(N))
        assert ctl.main(["--ctl-dir", ctl_dir, "--timeout", "60", "drain", "child"]) == 0
        deadline = time.time() + 30.0
        while time.time() < deadline and not child._stop.is_set():
            time.sleep(0.1)
        assert child._stop.is_set(), "ctl drain never reached the child"
    finally:
        child.close()
        root.close()


def test_obs_top_renders_lifecycle_rows():
    """The port's obs.top renders the lifecycle gauges as rows (snapshot,
    pause and drain state, mixed wire versions) while something is
    happening, and none on an idle digest."""
    from shared_tensor_tpu_torch.obs import top

    def node(m):
        return {"t_ns": 1, "m": m}

    busy = {
        "v": 1, "counters": {}, "hists": {}, "gmax": {}, "gmin": {}, "truncated": 0,
        "nodes": {
            "1": node({"st_wire_version": 2, "st_snapshot_in_progress": 1, "st_snapshot_shards_acked": 3}),
            "2": node({"st_wire_version": 1, "st_lifecycle_paused": 1}),
            "3": node({"st_wire_version": 2, "st_drain_in_progress": 1}),
        },
    }
    frame = top.render(busy, None, 0.0)
    assert "lifecycle:" in frame
    assert "snapshotting (acks 3)" in frame
    assert "paused (barrier)" in frame
    assert "draining" in frame
    assert "MIXED wire versions [1, 2]" in frame
    idle = dict(busy, nodes={"1": node({"st_wire_version": 2})})
    assert "lifecycle:" not in top.render(idle, None, 0.0)


def test_wire_compat_lifecycle_refused(tmp_path):
    """The reference wire has no typed control plane: the barrier and the
    drain refuse loudly there."""
    cfg = Config(transport=TransportConfig(wire_compat=True))
    m = create_or_fetch("127.0.0.1", free_port(), np.zeros((64,), np.float32), cfg, timeout=30.0, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="native protocol"):
            m.snapshot_cluster(str(tmp_path / "nope"))
        with pytest.raises(RuntimeError, match="control plane"):
            m.drain_node("whoever")
    finally:
        m.close()


# -- the pause and the marker ------------------------------------------------------


@pytest.mark.parametrize("tier", ["device", "host"])
def test_no_data_follows_a_snap_marker_on_its_link(tier, tmp_path):
    """The pause waits out the send pass in flight: on every link of a chain
    n0 - n1 - n2 that keeps adding through the barrier, no DATA or BURST is
    sent between the SNAP marker and the RESUME, and when a marker goes out
    the sender's ledger is empty and (the device tier) no frame it
    dispatched is still in its send pipeline."""
    t = TransportConfig(peer_timeout_sec=20.0, max_children=1)
    peers = _tree(free_port(), ["n0", "n1", "n2"], tier, [_cfg(n, tier, transport=t) for n in ("n0", "n1", "n2")])
    sent, bad, mu = {}, [], threading.Lock()
    pending = [set(), set(), set()]  # each node's dispatched, unfinished bursts

    def watch(i, p):
        send = p.node.send

        def recording_send(link, payload, timeout=0.1):
            kind = payload[0]
            if kind == wire.SNAP and (p.st.inflight_total() != 0 or pending[i]):
                bad.append((i, link, p.st.inflight_total(), len(pending[i])))
            ok = send(link, payload, timeout=timeout)
            if ok:
                with mu:
                    sent.setdefault((i, link), []).append(kind)
            return ok

        p.node.send = recording_send
        if tier == "device":
            begin, finish = p.st.begin_frame_burst_device, p.st.finish_frame_burst

            def counting_begin(link, k):
                out = begin(link, k)
                if out is not None:
                    pending[i].add(id(out[1]))
                return out

            def counting_finish(df):
                pending[i].discard(id(df))
                return finish(df)

            p.st.begin_frame_burst_device, p.st.finish_frame_burst = counting_begin, counting_finish

    stop = threading.Event()
    total = np.zeros(N)

    def writer():
        rng = np.random.default_rng(13)
        i = 0
        while not stop.is_set():
            d = rng.uniform(-1, 1, N).astype(np.float32)
            peers[i % 3].add(d)
            total[:] += d
            i += 1
            time.sleep(0.05)

    try:
        assert len(peers[1].node.links) == 2
        if tier == "device":
            assert all(p._burst_device > 1 for p in peers)
        for i, p in enumerate(peers):
            watch(i, p)
        th = threading.Thread(target=writer)
        th.start()
        try:
            time.sleep(0.2)
            for _ in range(3):
                assert peers[0].snapshot_cluster(str(tmp_path))["ok"]
        finally:
            stop.set()
            th.join()
        assert not bad, f"a SNAP marker left with frames in flight: {bad}"
        marked = 0
        for (i, link), kinds in sent.items():
            inside = False
            for kind in kinds:
                if kind == wire.SNAP:
                    inside, marked = True, marked + 1
                elif kind == wire.RESUME:
                    inside = False
                elif inside:
                    assert kind not in (wire.DATA, wire.BURST), f"data after SNAP on node {i} link {link}: {kinds}"
        assert marked == 6  # two markers (n0's, n1's) a barrier
        assert _converged(peers, total, deadline_sec=60.0)
    finally:
        _close(peers)


def test_public_pause_is_synchronous_and_does_not_expire():
    """pause() returns once the Python send loop's pass in flight is over,
    and a user's pause is not lifted by the lifecycle's safety deadline."""
    cfgs = [_cfg(n, "host", pause_timeout_sec=0.5) for n in ("n0", "n1")]
    peers = _tree(free_port(), ["n0", "n1"], "host", cfgs)
    try:
        g0 = peers[0]._send_pass
        peers[0].pause()
        assert peers[0]._send_pass >= g0 + 2
        d = np.ones(N, np.float32)
        peers[0].add(d)
        time.sleep(1.0)
        assert peers[0]._paused and np.allclose(_read(peers[1]), 0.0)
        assert peers[0].metrics()["st_lifecycle_errors_total"] == 0
        peers[0].pause(False)
        assert _converged(peers, d)
    finally:
        _close(peers)


# -- mixed trees of JAX and port peers -----------------------------------------------


def _jax_cfg(name: str, restore: str = "", max_children: int = 2) -> JConfig:
    return JConfig(
        lifecycle=JLifecycleConfig(node_name=name, restore_path=restore),
        transport=JTransportConfig(peer_timeout_sec=20.0, max_children=max_children),
    )


def _jax_peer(port, cfg):
    return jax_create_or_fetch("127.0.0.1", port, np.zeros((N,), np.float32), cfg, timeout=45.0)


def _mixed_tree(port, jax_root: bool) -> list:
    """A JAX root (the engine) with port children on the engine and the
    device tier, or a port root (the device tier) with a JAX child and a
    port engine child."""
    peers = []
    try:
        if jax_root:
            peers.append(_jax_peer(port, _jax_cfg("r")))
            peers.append(_peer(port, _cfg("a", "engine"), "engine"))
            peers.append(_peer(port, _cfg("b", "device"), "device"))
        else:
            peers.append(_peer(port, _cfg("r", "device"), "device"))
            peers.append(_jax_peer(port, _jax_cfg("a")))
            peers.append(_peer(port, _cfg("b", "engine"), "engine"))
        assert len(peers[0].node.links) == 2
    except BaseException:
        _close(peers)
        raise
    return peers


@pytest.mark.parametrize("root", ["jax", "port"])
def test_mixed_tree_snapshot_and_inplace_restore(root, tmp_path):
    """A JAX root snapshots and restores in place a tree with port children
    (one on the engine, one on the device tier), and a port root a tree
    with a JAX child: both barriers complete (no child is silent), both
    packages' verify_manifest accept the snapshot, each shard loads in the
    other package, and the tree rolls back to the cut."""
    peers = _mixed_tree(free_port(), root == "jax")
    a = np.zeros(N)
    rng = np.random.default_rng(21)
    try:
        _add(peers, rng, a, rounds=6)
        res = peers[0].snapshot_cluster(str(tmp_path), timeout=30.0)
        assert res["ok"] and res["nodes"] == 3, res
        assert ckpt.verify_manifest(str(tmp_path)) == [] and jckpt.verify_manifest(str(tmp_path)) == []
        assert {e["node"] for e in ckpt.load_manifest(str(tmp_path))["nodes"]} == {"r", "a", "b"}
        for name in ("r", "a", "b"):
            path = os.path.join(str(tmp_path), ckpt.shard_filename(name))
            mine, theirs = ckpt.load_cluster_shard(path), jckpt.load_cluster_shard(path)
            np.testing.assert_array_equal(mine["values"], theirs["values"])
            assert mine["meta"] == theirs["meta"] and mine["layout"] == theirs["layout"]
        assert _converged(peers, a)
        b = np.zeros(N)
        _add(peers, rng, b, rounds=4)
        assert _converged(peers, a + b)
        res = peers[0].restore_cluster(str(tmp_path), timeout=30.0)
        assert res["ok"] and res["nodes"] == 3, res
        assert _converged(peers, a)
        _add(peers, rng, a, rounds=3)
        assert _converged(peers, a)
    finally:
        _close(peers)


def test_snapshot_returns_after_release_under_a_jax_child(tmp_path):
    """A port root whose port child has a JAX child and a port child, and
    a port node below the JAX child: snapshot_cluster and restore_cluster
    return within their budget, with every port node outside the JAX
    subtree already resumed (its release confirmed up the tree); the JAX
    child and the port node below it are not waited for, and resume as
    JAX's release reaches them."""
    port = free_port()
    tp = lambda k: TransportConfig(peer_timeout_sec=20.0, max_children=k)  # noqa: E731
    peers = []
    try:
        peers.append(_peer(port, _cfg("r", "engine", transport=tp(1)), "engine"))
        peers.append(_peer(port, _cfg("p1", "engine", transport=tp(2)), "engine"))
        peers.append(_jax_peer(port, _jax_cfg("a", max_children=1)))
        peers.append(_peer(port, _cfg("p2", "device", transport=tp(2)), "device"))
        peers.append(_peer(port, _cfg("p3", "engine", transport=tp(2)), "engine"))  # below a, p1's first slot
        r, p1, a, p2, p3 = peers
        assert len(p1.node.links) == 3 and len(a.node.links) == 2, (p1.node.links, a.node.links)
        total = np.zeros(N)
        _add(peers, np.random.default_rng(24), total, rounds=5)
        assert _converged(peers, total)
        budget = 20.0
        for call in (lambda: r.snapshot_cluster(str(tmp_path), timeout=budget),
                     lambda: r.restore_cluster(str(tmp_path), timeout=budget)):
            t0 = time.monotonic()
            res = call()
            took = time.monotonic() - t0
            paused = {p.node_name: p.metrics()["st_lifecycle_paused"] for p in (r, p1, p2)}
            in_progress = {p.node_name: p.metrics()["st_snapshot_in_progress"] for p in (r, p1, p2)}
            assert res["ok"] and res["nodes"] == 5, res
            assert took < budget, took
            assert paused == {"r": 0, "p1": 0, "p2": 0}, paused
            assert in_progress == {"r": 0, "p1": 0, "p2": 0}, in_progress
            assert "unreleased" not in res, res
            assert lc_bench.released([a, p3], lc_bench.RELEASE_S)
        _add(peers, np.random.default_rng(25), total, rounds=3)
        assert _converged(peers, total)
    finally:
        _close(peers)


def test_a_child_dead_mid_release_is_named_not_waited_for(tmp_path):
    """A port child whose link dies between its RESUME and its release
    confirmation: the root's snapshot_cluster returns well inside its
    budget, ok, with that child named in ``unreleased``."""
    peers = _tree(free_port(), ["n0", "n1"], "engine")
    try:
        root, child = peers
        _add(peers, np.random.default_rng(26), np.zeros(N), rounds=2)
        # dies instead of confirming: its uplink goes down once resumed
        child._lc_release = lambda op, result=None: child.node.drop_link(child.node.uplink)
        budget = 20.0
        t0 = time.monotonic()
        res = root.snapshot_cluster(str(tmp_path), timeout=budget)
        assert time.monotonic() - t0 < budget / 2
        assert res["ok"] and res["nodes"] == 2, res
        assert res["unreleased"] == ["n1"], res
    finally:
        _close(peers)


def test_mixed_restart_from_the_other_packages_shards(tmp_path):
    """A JAX root with port children snapshots; the tree is closed and
    restarted with the packages swapped: the root as a port peer from the
    shard JAX wrote, the children as JAX peers from the shards the port
    wrote. The restarted tree converges to the cut's total and keeps
    working."""
    peers = _mixed_tree(free_port(), jax_root=True)
    total = np.zeros(N)
    rng = np.random.default_rng(22)
    try:
        _add(peers, rng, total, rounds=9)
        assert peers[0].snapshot_cluster(str(tmp_path), timeout=30.0)["ok"]
    finally:
        _close(peers)
    shard = {n: os.path.join(str(tmp_path), ckpt.shard_filename(n)) for n in ("r", "a", "b")}
    port = free_port()
    peers = []
    try:
        peers.append(_peer(port, _cfg("r", "device", restore=shard["r"]), "device"))
        peers.append(_jax_peer(port, _jax_cfg("a", restore=shard["a"])))
        peers.append(_jax_peer(port, _jax_cfg("b", restore=shard["b"])))
        assert all(p._restored_from for p in peers)
        assert _converged(peers, total)
        _add(peers, rng, total, rounds=3)
        assert _converged(peers, total)
    finally:
        _close(peers)


@pytest.mark.parametrize("kind", ["SNAP", "SNAP_ACK", "RESUME", "CTL"])
def test_encode_lifecycle_bytes_equal_jax(kind):
    """encode_lifecycle gives the JAX package's bytes on the same documents,
    and both refuse a body past the cap and a kind that is not a lifecycle
    kind alike."""
    k = getattr(wire, kind)
    assert k == getattr(jwire, kind)
    docs = [
        {"op": "save", "id": "snap-1f", "dir": "/d", "parent": "n0", "budget_sec": 59.5},
        {"id": "x", "nodes": [{"node": "n1", "file": "shard_n1.npz", "sha256": "ab", "bytes": 9, "links": []}],
         "errors": ["n2: é"]},
        {"op": "drain", "target": "n1", "from": "root"},
        {},
    ]
    for doc in docs:
        assert wire.encode_lifecycle(k, doc) == jwire.encode_lifecycle(k, doc)
        assert wire.decode_lifecycle(jwire.encode_lifecycle(k, doc)) == doc
    big = {"e": "x" * wire.DIGEST_MAX_BYTES}
    for enc in (wire.encode_lifecycle, jwire.encode_lifecycle):
        with pytest.raises(ValueError):
            enc(k, big)
        with pytest.raises(ValueError):
            enc(wire.DIGEST, {})
