"""The port's peer (shared_tensor_tpu_torch.comm.peer) on the CPU: the cases
of tests/test_peer.py, with every node a port peer on device="cpu" in one
process on loopback.

Tolerances are test_peer.py's: replicas equal the expected sum within
rtol 1e-4 and atol 1e-6 (1e-5 for the four-peer random deltas, 1e-4 for
the re-graft spread). Every wait has its own deadline."""

import time

import numpy as np
import pytest
import torch

from shared_tensor_tpu_torch import (
    CodecConfig,
    Config,
    SpecMismatch,
    TransportConfig,
    create_or_fetch,
)
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.ops.table import tree_flatten
from tests._ports import free_port

CPU = "cpu"
CFG = Config(transport=TransportConfig(peer_timeout_sec=10.0))
FAST = Config(transport=TransportConfig(peer_timeout_sec=5.0, max_rejoin_attempts=8))


def _leaves(tree):
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in tree_flatten(tree)[0]]


def _ok(peers, expect, tol):
    want = _leaves(expect)
    return all(
        all(np.allclose(g, e, rtol=1e-4, atol=tol) for g, e in zip(_leaves(p.read()), want)) for p in peers
    )


def wait_converged(peers, expect, tol=1e-6, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _ok(peers, expect, tol):
            return
        time.sleep(0.05)
    want = _leaves(expect)
    for i, p in enumerate(peers):
        for g, e in zip(_leaves(p.read()), want):
            np.testing.assert_allclose(g, e, rtol=1e-4, atol=tol, err_msg=f"peer {i} did not converge")


FAULTS = ("st_apply_dropped_total", "st_msg_errors_total", "st_recv_restarts_total", "st_unknown_msgs_total")


def _faults(peer) -> dict:
    m = peer.metrics()
    return {k: m[k] for k in FAULTS if m[k]}


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    return np.asarray(a) + np.asarray(b)


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return np.zeros_like(tree)


@pytest.mark.parametrize(
    "case",
    ["example_lua_roundtrip", "mixed_magnitude_table_sync"],
)
def test_two_peer_seed_and_adds(case):
    """BASELINE config 1 (example.lua: the master seeds a 4x5x6x2 f32, a
    joiner fetches it, both add, both read seed + both deltas) and config 3
    (a table with a 1000:1 magnitude spread syncs exactly, each leaf with
    its own scale)."""
    if case == "example_lua_roundtrip":
        seed = np.arange(1.0, 241.0, dtype=np.float32).reshape(4, 5, 6, 2)
        deltas = (np.full_like(seed, 1.0), np.full_like(seed, 0.5))
    else:
        seed = {"big": np.full((256,), 1000.0, np.float32), "small": np.full((256,), 1.0, np.float32)}
        deltas = ()
    port = free_port()
    with create_or_fetch("127.0.0.1", port, seed, CFG, device=CPU) as master:
        assert master.is_master
        got = master.read()
        assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu" for x in tree_flatten(got)[0])
        for g, e in zip(_leaves(got), _leaves(seed)):
            np.testing.assert_array_equal(g, e)
        with create_or_fetch("127.0.0.1", port, _zeros(seed), CFG, device=CPU) as joiner:
            assert not joiner.is_master
            wait_converged([joiner], seed)
            if deltas:
                master.add(deltas[0])
                joiner.add(torch.from_numpy(deltas[1]))  # torch or numpy deltas
                wait_converged([master, joiner], seed + deltas[0] + deltas[1])
                m = master.metrics()
                assert m["st_frames_out_total"] > 0 and m["st_frames_in_total"] > 0
                assert master.threads_alive() and joiner.threads_alive()
                assert _faults(master) == {} and _faults(joiner) == {}


def test_receive_faults_are_counted(monkeypatch):
    """A frame whose apply raises is dropped (and acknowledged, so never
    re-sent) and a recv loop that raises restarts: both are counted in
    metrics(), which is how a health check sees them."""
    port = free_port()
    seed = np.ones((64,), np.float32)
    with create_or_fetch("127.0.0.1", port, seed, CFG, device=CPU) as master:
        with create_or_fetch("127.0.0.1", port, np.zeros_like(seed), CFG, device=CPU) as joiner:
            wait_converged([joiner], seed)
            assert _faults(joiner) == {}

            def bad_apply(*args):
                raise RuntimeError("apply failed")

            monkeypatch.setattr(joiner.st, "receive_frames", bad_apply)
            monkeypatch.setattr(joiner.st, "receive_frame", bad_apply)
            handle_events = joiner._handle_events
            raised = []

            def events_once():
                if not raised:
                    raised.append(1)
                    raise RuntimeError("recv loop failed")
                return handle_events()

            monkeypatch.setattr(joiner, "_handle_events", events_once)
            master.add(np.full((64,), 0.5, np.float32))
            deadline = time.time() + 30
            while time.time() < deadline and not (
                joiner.metrics()["st_apply_dropped_total"] and joiner.metrics()["st_recv_restarts_total"]
            ):
                time.sleep(0.05)
            faults = _faults(joiner)
            assert faults.get("st_apply_dropped_total", 0) > 0 and faults.get("st_recv_restarts_total") == 1, faults
            assert joiner.threads_alive() and joiner._error is None


def test_four_peer_tree_consistency():
    """Four peers (one redirected below the master's children) converge to
    seed + every peer's update through split-horizon floods. The deltas
    are uniform with power-of-two bounds, which the codec drains in ~25
    frames a hop; test_peer.py's normal deltas leave sparse outliers that
    take thousands of frames, seconds for its C engine but minutes for the
    plain PyTorch codec on a CPU."""
    port = free_port()
    seed = {"w": np.ones((16, 8), np.float32), "b": np.zeros((8,), np.float32)}
    peers = [create_or_fetch("127.0.0.1", port, seed, CFG, device=CPU)]
    try:
        for _ in range(3):
            peers.append(create_or_fetch("127.0.0.1", port, _zeros(seed), CFG, device=CPU))
        wait_converged(peers, seed)
        assert sum(len(p.node.links) - (0 if p.is_master else 1) for p in peers) == 3
        rng = np.random.default_rng(0)
        total = seed
        for i, p in enumerate(peers):
            delta = {
                "w": rng.uniform(-1, 1, size=(16, 8)).astype(np.float32) * 2.0**i,
                "b": rng.uniform(-1, 1, size=(8,)).astype(np.float32),
            }
            p.add(delta)
            total = _tree_add(total, delta)
        wait_converged(peers, total, tol=1e-5)
    finally:
        for p in peers:
            p.close()


def _quiet(peer) -> bool:
    st = peer.st
    return st.inflight_total() == 0 and all(st.residual_rms(l) == 0.0 for l in st.link_ids)


def _interior(peers: dict) -> str:
    return next(n for n, p in peers.items() if not p.is_master and len(p.node.links) > 1)


def test_regraft_after_parent_death():
    """An interior node crashes (no drain); its orphan re-grafts through the
    rendezvous walk with a diff-seeded handshake and its carry. Settled
    state is never lost, survivors agree exactly, and the updates racing
    the crash land 0..2 times each (the delivery contract's crash arm)."""
    port = free_port()
    seed = np.ones((256,), np.float32)
    m = create_or_fetch("127.0.0.1", port, seed, FAST, device=CPU)
    peers = {"m": m}
    try:
        for name in ("a", "b", "c"):
            peers[name] = create_or_fetch("127.0.0.1", port, np.zeros_like(seed), FAST, device=CPU)
        for p in peers.values():
            p.add(np.full((256,), 0.5, np.float32))
        wait_converged(list(peers.values()), np.full((256,), 3.0, np.float32))
        parent = _interior(peers)
        for p in peers.values():
            p.add(np.full((256,), 0.25, np.float32))
        peers.pop(parent).close()
        survivors = list(peers.values())
        # agreement counts once every survivor is quiet (nothing owed on a
        # link or in the carry, nothing unacknowledged): right after the
        # crash each replica holds only its own 0.25, equal but not final
        deadline = time.time() + 60
        while time.time() < deadline:
            vals = [p.read().numpy() for p in survivors]
            if max(np.max(np.abs(v - vals[0])) for v in vals) < 1e-4 and all(_quiet(p) for p in survivors):
                break
            time.sleep(0.1)
        vals = [p.read().numpy() for p in survivors]
        assert max(np.max(np.abs(v - vals[0])) for v in vals) < 1e-4
        lo, hi = 3.0 - 1e-4, 3.0 + 2 * 4 * 0.25 + 1e-4
        for v in vals:
            assert lo <= v.min() and v.max() <= hi, (v.min(), v.max())
        assert all(p.threads_alive() for p in survivors)
    finally:
        for p in peers.values():
            p.close()


def test_graceful_leave_loses_nothing():
    """drain() then close(): everything the leaving interior node merged,
    its own and what it was flooding, lives on in the survivors."""
    port = free_port()
    seed = np.ones((128,), np.float32)
    m = create_or_fetch("127.0.0.1", port, seed, FAST, device=CPU)
    peers = {"m": m}
    try:
        for name in ("a", "b", "c"):
            peers[name] = create_or_fetch("127.0.0.1", port, np.zeros_like(seed), FAST, device=CPU)
        parent = _interior(peers)
        for p in peers.values():
            p.add(np.full((128,), 0.25, np.float32))
        leaver = peers.pop(parent)
        deadline = time.time() + 30
        while time.time() < deadline:
            if all(
                p.st.inflight_total() == 0 and all(p.st.residual_rms(l) == 0.0 for l in p.st.link_ids)
                for p in peers.values()
            ):
                break
            time.sleep(0.05)
        assert leaver.drain(timeout=30.0), "drain did not complete"
        leaver.close()
        wait_converged(list(peers.values()), np.full((128,), 2.0, np.float32), timeout=40.0)
    finally:
        for p in peers.values():
            p.close()


def test_child_handshake_survives_a_late_link_up_event():
    """The receive loop may read a new child's SYNC and CHUNKs before the
    link's LINK_UP event is polled. That event must not reset the
    snapshot being received: the DONE opens the link with residual =
    replica - the child's snapshot, so the child receives the tree's
    state."""
    from shared_tensor_tpu_torch.comm.transport import Event, EventKind

    rng = np.random.default_rng(3)
    seed = rng.normal(size=(64, 40)).astype(np.float32)
    with create_or_fetch("127.0.0.1", free_port(), seed, CFG, device=CPU) as m:
        spec = m.st.spec
        snap = np.zeros(spec.total, np.float32)
        snap[: seed.size] = rng.normal(size=seed.size)
        link = 1000  # not a transport link: the WELCOME's send fails, the handshake goes on
        m._on_message(link, wire.encode_sync(spec))
        chunks = list(wire.encode_snapshot_chunks(snap))
        for chunk in chunks[:-1]:
            m._on_message(link, chunk)
        m._on_link_up(Event(EventKind.LINK_UP, link, False))
        m._on_message(link, chunks[-1])  # DONE
        _, links = m.st.snapshot_all()
        assert link in links
        want = m.st.snapshot_flat().numpy() - snap
        np.testing.assert_array_equal(links[link].numpy(), want)


def test_spec_mismatch_rejected():
    """A joiner with another table layout fails loudly at join time."""
    port = free_port()
    with create_or_fetch("127.0.0.1", port, np.ones((64,), np.float32), CFG, device=CPU) as m:
        with pytest.raises(SpecMismatch, match="layout mismatch"):
            p = create_or_fetch("127.0.0.1", port, np.ones((128,), np.float32), CFG, device=CPU, timeout=10.0)
            p.close()
        assert m.threads_alive()


def test_peer_death_survival_and_convergence():
    """A dying peer does not take the tree with it; the survivors sync on."""
    port = free_port()
    seed = np.ones((128,), np.float32)
    master = create_or_fetch("127.0.0.1", port, seed, FAST, device=CPU)
    victim = create_or_fetch("127.0.0.1", port, np.zeros_like(seed), FAST, device=CPU)
    survivor = create_or_fetch("127.0.0.1", port, np.zeros_like(seed), FAST, device=CPU)
    try:
        wait_converged([victim, survivor], seed)
        victim.close()
        time.sleep(0.2)
        master.add(np.full((128,), 2.0, np.float32))
        wait_converged([master, survivor], seed + 2.0, timeout=30.0)
    finally:
        master.close()
        survivor.close()


def test_idle_links_quiesce():
    """After convergence the links go quiet: no steady idle drumbeat."""
    port = free_port()
    seed = np.ones((64,), np.float32)
    with create_or_fetch("127.0.0.1", port, seed, CFG, device=CPU) as a:
        with create_or_fetch("127.0.0.1", port, np.zeros_like(seed), CFG, device=CPU) as b:
            wait_converged([b], seed)
            time.sleep(0.5)
            f0, m0 = a.st.frames_out, a.metrics()["st_msgs_out_total"]
            time.sleep(1.0)
            assert a.st.frames_out - f0 <= 1
            assert a.metrics()["st_msgs_out_total"] - m0 <= 1


def test_device_tier_burst_path():
    """K-frame bursts: one quantize call, one fetch and one message per K
    halvings; convergence holds, and there are fewer data messages than
    frames."""
    port = free_port()
    tmpl = {"w": np.zeros(2048, np.float32)}
    a = create_or_fetch("127.0.0.1", port, tmpl, timeout=30.0, device=CPU)
    b = create_or_fetch("127.0.0.1", port, tmpl, timeout=30.0, device=CPU)
    try:
        assert a._burst_device == min(16, wire.burst_frames_cap(a.st.spec)) > 1
        # linspace deltas need ~28 halvings; a power-of-two uniform delta
        # would finish in one frame and prove nothing about bursts
        da = np.linspace(-1, 1, 2048, dtype=np.float32)
        db = np.linspace(0.5, -0.5, 2048, dtype=np.float32)
        a.add({"w": da})
        b.add({"w": db})
        wait_converged([a, b], {"w": da + db}, timeout=30.0)
        m = a.metrics()
        assert m["st_frames_out_total"] > 0
        assert m["st_msgs_out_total"] < m["st_frames_out_total"], m
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize(
    "config, burst",
    [
        (Config(device_frame_burst=1), 1),
        (Config(device_frame_burst=5), 5),
        (Config(device_frame_burst=10_000), "cap"),
        (Config(codec=CodecConfig(suppress_zero_frames=False)), 1),
    ],
    ids=["one", "five", "capped", "idle-frames-sent"],
)
def test_burst_sizing(config, burst):
    tmpl = np.zeros(1 << 16, np.float32)
    p = create_or_fetch("127.0.0.1", free_port(), tmpl, config, device=CPU)
    try:
        assert p._burst_device == (wire.burst_frames_cap(p.st.spec) if burst == "cap" else burst)
    finally:
        p.close()


def test_device_none_needs_a_gpu():
    """device=None is the GPU: without one, no peer (and no node) starts."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_or_fetch("127.0.0.1", free_port(), np.zeros(8, np.float32))


def test_unported_config_knobs_are_type_errors():
    cases = (
        (Config, {"lifecycle": None}),
        (Config, {"obs": None}),
        (Config, {"shard": None}),
    )
    for cls, kw in cases:
        with pytest.raises(TypeError):
            cls(**kw)
