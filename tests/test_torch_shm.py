"""The same-host shared-memory lane and the aligned v3 framing on port
peers (tests/test_shm.py's cases, and JAX peers on the same lanes).

- A same-host pair negotiates the lane (st_shm_active 2 at both ends) on
  each port tier, traffic crosses it, and the pair converges.
- A peer with the lane off (TransportConfig or ST_SHM=0) keeps TCP, either
  orientation, and converges.
- A sever on a lane-live link: rollback, carry, re-graft onto a fresh
  lane, exact convergence.
- A stall on a lane-live link: go-back-N tears it down in bounded time and
  the carry re-grafts.
- A ring far smaller than a burst: backpressure, nothing lost.
- A JAX engine child under a port device-tier parent: it sends v3 frames,
  which the parent decodes (counted at the decode), on a shared lane.
- A port engine and a JAX engine on one lane, both orientations.
- A subscriber link keeps TCP.
- Hard link kills in a steady stream, lane on and off: every replica ends
  within 1e-4 of the exact sum of the adds.
- A busy lane link outlives three liveness timeouts, under a port and
  under a JAX child.
- A re-grafted node is reachable at the address its parent hands out,
  and still at the one it handed out before, by a peer and a subscriber.
- A SIGKILLed lane child: its parent's link goes down and a fresh joiner
  takes its place within 10 s.

The lifecycle snapshot across live lanes (test_shm.py's fifth case) waits
for the lifecycle slice. Tolerances are test_shm.py's: rtol 1e-4, atol
1e-5 for the seed and 1e-4 after gaussian adds."""

import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, serve
from shared_tensor_tpu_torch.comm import faults, wire
from shared_tensor_tpu_torch.comm.peer import SharedTensorPeer
from shared_tensor_tpu_torch.config import FaultConfig
from tests._ports import free_port
from tests.test_torch_peer import wait_converged

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cfg(shm=True, tier="engine", **tkw):
    tkw.setdefault("peer_timeout_sec", 10.0)
    tkw.setdefault("shm_enabled", shm)
    return Config(transport=TransportConfig(**tkw), native_engine=tier != "host")


def _peer(port, template, tier="engine", shm=True, cls=create_or_fetch, **tkw):
    kw = {"device": "cpu"} if tier == "device" else {"host_tier": True}
    return cls("127.0.0.1", port, template, _cfg(shm, tier, **tkw), **kw)


def _shm_live(peer) -> int:
    """This peer's links whose data plane is on the rings."""
    return sum(1 for k, v in peer.metrics().items() if k.startswith("st_shm_active") and v == 2)


def _wait_lane_live(peers, want=1, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(_shm_live(p) >= want for p in peers):
            return True
        time.sleep(0.05)
    return False


def _gauss(rng, n):
    return rng.normal(0, 0.5, n).astype(np.float32)


@pytest.mark.parametrize("tier", ["engine", "host", "device"])
def test_same_host_pair_negotiates_lane_and_converges(tier):
    port = free_port()
    n = 1 << 13
    seed = np.full(n, 1.0, np.float32)
    m = _peer(port, seed, tier)
    j = _peer(port, np.zeros_like(seed), tier, cls=SharedTensorPeer)
    try:
        j.wait_ready(30.0)
        wait_converged([j], seed, tol=1e-5)
        assert _wait_lane_live([m, j]), "the lane never went live"
        rng = np.random.default_rng(3)
        total = seed.astype(np.float64)
        for _ in range(8):
            u = _gauss(rng, n)
            total = total + u
            m.add(u)
            time.sleep(0.02)  # several messages: the first after the switch may still ride TCP
        wait_converged([m, j], total.astype(np.float32), tol=1e-4)
        mm = m.metrics()
        assert mm["st_shm_msgs_out_total"] >= 1, "lane live but no traffic on it"
        assert mm['st_shm_ring_bytes{link="1"}'] == m._shm_ring_bytes() == 1 << 20
        assert mm["st_shm_fallback_total"] == 0 and mm["st_unknown_msgs_total"] == 0
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("off", ["parent", "child", "env"])
def test_peer_without_the_lane_keeps_tcp(off, monkeypatch):
    """A parent with the lane off neither parses the SYNC tail nor offers a
    segment; a child with it off never asks; ST_SHM=0 turns it off for
    every peer made under it. Each pair keeps TCP and converges."""
    port = free_port()
    seed = np.full(4096, 2.0, np.float32)
    if off == "env":
        monkeypatch.setenv("ST_SHM", "0")
    m = _peer(port, seed, shm=off != "parent")
    j = _peer(port, np.zeros_like(seed), shm=off != "child", cls=SharedTensorPeer)
    try:
        j.wait_ready(30.0)
        wait_converged([j], seed, tol=1e-5)
        m.add(np.full(4096, 1.0, np.float32))
        wait_converged([m, j], np.full(4096, 3.0, np.float32), tol=1e-4)
        assert _shm_live(m) == 0 and _shm_live(j) == 0
        assert "st_shm_msgs_out_total" not in m.metrics()
    finally:
        j.close()
        m.close()


def test_shm_sever_tears_down_into_carry_and_regraft(monkeypatch):
    port = free_port()
    n = 1 << 13
    seed = np.full(n, 1.0, np.float32)
    m = _peer(port, seed)
    env = faults.to_env(FaultConfig(enabled=True, seed=11, sever_after_frames=6, only_link=1))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = _peer(port, np.zeros_like(seed), cls=SharedTensorPeer)
    for k in env:
        monkeypatch.delenv(k)
    try:
        j.wait_ready(30.0)
        wait_converged([j], seed, tol=1e-5)
        assert _wait_lane_live([j]), "the lane never went live before the sever"
        up0 = j.node.uplink
        rng = np.random.default_rng(17)
        total = seed.astype(np.float64)
        for _ in range(12):
            u = _gauss(rng, n)
            total = total + u
            j.add(u)  # the joiner's uplink sender trips the sever
            time.sleep(0.02)
        wait_converged([m, j], total.astype(np.float32), tol=1e-4, timeout=60.0)
        assert j.node.uplink != up0, "the sever never tore the lane-live link down"
        assert _wait_lane_live([j]), "the re-grafted link has no lane"
    finally:
        j.close()
        m.close()


def test_shm_stall_blackholes_into_quarantine_path(monkeypatch):
    port = free_port()
    seed = np.full(4096, 2.0, np.float32)
    m = _peer(port, seed)
    env = faults.to_env(FaultConfig(enabled=True, seed=5, stall_after_frames=4, only_link=1))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = _peer(port, np.zeros_like(seed), cls=SharedTensorPeer, ack_timeout_sec=1.0, ack_retry_limit=2)
    for k in env:
        monkeypatch.delenv(k)
    try:
        j.wait_ready(30.0)
        wait_converged([j], seed, tol=1e-5)
        assert _wait_lane_live([j]), "the lane never went live before the stall"
        up0 = j.node.uplink
        delta = np.full(4096, 0.25, np.float32)
        for _ in range(8):
            j.add(delta)
            time.sleep(0.02)
        wait_converged([m, j], seed + 8 * delta, tol=1e-4, timeout=60.0)
        assert j.metrics()["st_retransmit_msgs_total"] >= 1, "go-back-N never re-sent into the stalled lane"
        assert j.node.uplink != up0, "the stalled lane-live link was never torn down"
    finally:
        j.close()
        m.close()


def test_ring_full_backpressure_bounds_not_loses():
    port = free_port()
    n = 1 << 15  # 132 KiB frames through 64 KiB rings
    m = _peer(port, np.zeros(n, np.float32), shm_ring_bytes=1 << 16)
    j = _peer(port, np.zeros(n, np.float32), cls=SharedTensorPeer, shm_ring_bytes=1 << 16)
    try:
        j.wait_ready(30.0)
        assert _wait_lane_live([m, j]), "the lane never went live"
        assert m._shm_ring_bytes() == 1 << 16
        rng = np.random.default_rng(23)
        total = np.zeros(n, np.float64)
        for _ in range(10):
            u = _gauss(rng, n)
            total += u
            m.add(u)
        wait_converged([m, j], total.astype(np.float32), tol=1e-4, timeout=60.0)
        assert max(v for k, v in m.metrics().items() if k.startswith("st_shm_active")) == 2
    finally:
        j.close()
        m.close()


def _jax_engine(port, tpl):
    build_native()
    return jax_create_or_fetch("127.0.0.1", port, tpl, JConfig(transport=JTransportConfig(peer_timeout_sec=10.0)))


def test_jax_engine_child_sends_v3_to_a_port_device_parent(monkeypatch):
    """The port device-tier parent advertises SYNC_FLAG_SHM in WELCOME, so
    the JAX engine child emits the aligned v3 framing toward it over their
    lane; the parent decodes every v3 message (counted at its decode) and
    the pair converges both ways."""
    seen = {"v3": 0}
    decode_burst, decode_frame = wire.decode_burst, wire.decode_frame

    def counting(fn):
        def wrapped(payload, spec):
            if wire._is_v3(payload, spec):
                seen["v3"] += 1
            return fn(payload, spec)
        return wrapped

    monkeypatch.setattr(wire, "decode_burst", counting(decode_burst))
    monkeypatch.setattr(wire, "decode_frame", counting(decode_frame))
    port = free_port()
    n = 4096
    seed = np.full(n, 1.0, np.float32)
    m = _peer(port, seed, "device")
    j = _jax_engine(port, np.zeros_like(seed))
    try:
        assert j._engine is not None
        wait_converged([j], seed, tol=1e-5)
        rng = np.random.default_rng(5)
        total = seed.astype(np.float64)
        for p in (j, m, j, j):
            u = _gauss(rng, n)
            total = total + u
            p.add(u)
            time.sleep(0.02)
        wait_converged([m, j], total.astype(np.float32), tol=1e-4)
        assert seen["v3"] > 0, "the JAX engine child sent no v3 message"
        assert _wait_lane_live([m]), "no lane between the port parent and the JAX child"
        mm = m.metrics()
        assert mm["st_unknown_msgs_total"] == 0 and mm["st_apply_dropped_total"] == 0
        assert mm["st_shm_msgs_in_total"] >= 1
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("orientation", ["torch_master", "jax_master"])
def test_port_engine_and_jax_engine_share_a_lane(orientation):
    port = free_port()
    n = 4096
    seed = np.full(n, 1.0, np.float32)
    if orientation == "torch_master":
        t = _peer(port, seed)
        j = _jax_engine(port, np.zeros_like(seed))
    else:
        j = _jax_engine(port, seed)
        t = _peer(port, np.zeros_like(seed))
    try:
        wait_converged([t, j], seed, tol=1e-5)
        assert _wait_lane_live([t]), "no lane between the port engine and the JAX engine"
        rng = np.random.default_rng(9)
        total = seed.astype(np.float64)
        for p in (t, j) * 4:
            u = _gauss(rng, n)
            total = total + u
            p.add(u)
            time.sleep(0.02)  # several messages each way: the first after the switch may still ride TCP
        wait_converged([t, j], total.astype(np.float32), tol=1e-4)
        tm = t.metrics()
        assert tm["st_shm_msgs_in_total"] >= 1 and tm["st_shm_msgs_out_total"] >= 1
    finally:
        (j if orientation == "torch_master" else t).close()
        (t if orientation == "torch_master" else j).close()


def test_subscriber_link_keeps_tcp():
    port = free_port()
    seed = np.arange(256, dtype=np.float32)
    with _peer(port, seed) as w:
        with serve.subscribe("127.0.0.1", port, np.zeros_like(seed), timeout=30.0) as sub:
            w.add(np.ones(256, np.float32))
            sub.wait_fresh(serve.epoch(), timeout=20.0)
            np.testing.assert_allclose(sub.read(max_staleness=10.0), seed + 1, atol=1e-4)
            assert _shm_live(w) == 0 and w.metrics()["st_shm_fallback_total"] == 0


#: The liveness timeout of the kill and SIGKILL cases: short enough that a
#: lane link whose socket falls silent (the Python tier's digests every
#: 0.5 s keep its send queue from ever idling for a keepalive_sec) times out
#: several times within the run, as the soak's 30 s do over 300 s.
KILL_PEER_TIMEOUT = 3.0
KILL_N = 4096
KILL_ROUNDS = 20
#: Each add is uniform in +-KILL_SCALE: a thousand of them keep the replicas
#: near 1, where float32 accumulation stays far inside the 1e-4 bound while
#: one re-delivered or lost message moves elements by hundredths.
KILL_SCALE = 1.0 / 32


def _leaves(peers):
    """Non-master peers whose only link is their uplink."""
    return [p for p in peers[1:] if p.node.uplink is not None and p.node.links == [p.node.uplink]]


def _quiet_uplink(p, timeout=1.0) -> bool:
    """Wait until ``p``'s uplink owes nothing and has nothing unacknowledged:
    a hard kill then leaves no message in flight whose re-delivery (the
    at-least-once contract that the soak's noise bound allows for) would
    blur the count."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        up = p.node.uplink
        if up is not None and p._engine.inflight_total() == 0 and p._engine.residual_rms(up) == 0.0:
            return True
        time.sleep(0.002)
    return False


def _max_dev(peers, total) -> float:
    return max(float(np.abs(np.asarray(p.read(), dtype=np.float64) - total).max()) for p in peers)


@pytest.mark.parametrize("lane", ["tcp", "shm"])
def test_lane_hard_kills_conserve_mass(lane):
    """A same-host tree of four engine peers (a master with two children
    and a grandchild) streams adds from every peer for several liveness
    timeouts while its leaves' uplinks are hard-killed (``drop_link``)
    about 20 times, each when the victim's uplink owes nothing: every
    replica ends within 1e-4 of the exact sum of the adds, on both sides,
    lane on and off alike. On the lane this needs the socket kept live
    under a busy ring (or the links time out mid-stream, unplanned kills
    that re-deliver their windows) and a re-grafted node reachable at the
    address its new parent hands out (or a later joiner's walk dead-ends
    there and the tree loses a member's mass)."""
    port = free_port()
    shm = lane == "shm"
    rng = np.random.default_rng(41)
    peers = []
    try:
        for _ in range(4):
            peers.append(_peer(port, np.zeros(KILL_N, np.float32), shm=shm, peer_timeout_sec=KILL_PEER_TIMEOUT))
        total = np.zeros(KILL_N, np.float64)
        if shm:
            assert _wait_lane_live(peers), "the lane never went live"
        kills = 0
        t_end = time.time() + 4 * KILL_PEER_TIMEOUT
        for r in range(KILL_ROUNDS):
            for _ in range(6):
                for p in peers:
                    u = rng.uniform(-KILL_SCALE, KILL_SCALE, KILL_N).astype(np.float32)
                    p.add(u)
                    total += u
                time.sleep(0.01)
            leaves = _leaves(peers)
            if leaves:
                victim = leaves[r % len(leaves)]
                if _quiet_uplink(victim):
                    victim.node.drop_link(victim.node.uplink)
                    kills += 1
        while time.time() < t_end:  # the stream outlasts several liveness timeouts
            for p in peers:
                u = rng.uniform(-KILL_SCALE, KILL_SCALE, KILL_N).astype(np.float32)
                p.add(u)
                total += u
            time.sleep(0.02)
        assert kills >= KILL_ROUNDS // 2, kills
        deadline = time.time() + 45.0
        while time.time() < deadline and _max_dev(peers, total) >= 1e-4:
            time.sleep(0.1)
        dev = _max_dev(peers, total)
        assert dev < 1e-4, f"{kills} kills: a replica is {dev} off the exact sum"
        if shm:
            assert _wait_lane_live(peers), "a re-grafted link has no lane"
            assert sum(p.metrics()["st_shm_msgs_out_total"] for p in peers) > 0
    finally:
        for p in reversed(peers):
            p.close()


LEAVE_ROUNDS = 15
LEAVE_TIMEOUT_S = 10.0


@pytest.mark.parametrize("tier,lane,every,rounds", [("engine", "tcp", 0.02, LEAVE_ROUNDS), ("engine", "shm", 0.02, LEAVE_ROUNDS),
                                                    ("host", "tcp", 0.02, LEAVE_ROUNDS), ("device", "tcp", 0.1, 3)],
                         ids=["tcp", "shm", "host", "device"])
def test_fast_graceful_leaves_conserve_mass(tier, lane, every, rounds):
    """A same-host chain of four peers (one child each) streams adds while,
    about every 0.5 s, the leaf's parent leaves gracefully and the leaf
    leaves too, still owing the tree mass (frames its sealed parent
    discarded, and one more add); both re-join as fresh peers at the
    chain's end, 15 times (the device tier, whose drains take seconds on
    the CPU, 3 times at a fifth of the add rate). In turn, the leaf leaves
    once its parent's leave has orphaned it, or at the same time as its
    parent. Every ``leave()`` returns True, and every replica ends within
    1e-4 of the exact sum of the adds. Before, an orphan's drain found no
    link owing anything and returned at once, so its close lost its
    carry; and two neighbours leaving at once each waited for the other's
    acknowledgements until their drains timed out."""
    port = free_port()
    shm = lane == "shm"
    rng = np.random.default_rng(47)
    total = np.zeros(KILL_N, np.float64)
    peers = []

    def mk():
        return _peer(port, np.zeros(KILL_N, np.float32), tier, shm=shm, max_children=1)

    def add(p):
        u = rng.uniform(-KILL_SCALE, KILL_SCALE, KILL_N).astype(np.float32)
        p.add(u)
        total[:] += u

    try:
        for _ in range(4):
            peers.append(mk())
        t0 = time.time()
        for r in range(rounds):
            t_r = time.time()
            while time.time() - t_r < 0.5:
                for p in peers:
                    add(p)
                time.sleep(every)
            parent, leaf = peers[2], peers[3]  # each joined at the chain's end
            assert len(parent.node.links) == 2 and leaf.node.links == [leaf.node.uplink], f"round {r}: not a chain"
            add(leaf)  # in flight toward the parent as it seals
            verdicts = []
            if r % 2 == 0:
                verdicts.append(parent.leave(timeout=LEAVE_TIMEOUT_S))
                deadline = time.time() + LEAVE_TIMEOUT_S
                while time.time() < deadline and leaf.node.uplink is not None:
                    time.sleep(0.001)
                add(leaf)  # made while orphaned: into the carry
                verdicts.append(leaf.leave(timeout=LEAVE_TIMEOUT_S))
            else:
                th = threading.Thread(target=lambda: verdicts.append(parent.leave(timeout=LEAVE_TIMEOUT_S)))
                th.start()
                add(leaf)
                verdicts.append(leaf.leave(timeout=LEAVE_TIMEOUT_S))
                th.join()
            assert verdicts == [True, True], f"round {r} ({'at once' if r % 2 else 'orphaned'}): {verdicts}"
            peers[2] = mk()
            peers[3] = mk()
        deadline = time.time() + 30.0
        while time.time() < deadline and _max_dev(peers, total) >= 1e-4:
            time.sleep(0.1)
        dev = _max_dev(peers, total)
        assert dev < 1e-4, f"{2 * rounds} leaves in {time.time() - t0:.1f} s: a replica is {dev} off the exact sum"
    finally:
        for p in reversed(peers):
            p.close()


@pytest.mark.parametrize("child", ["port", "jax"])
def test_busy_lane_link_outlives_its_liveness_timeout(child):
    """A lane link whose send queue never idles for a keepalive_sec (the
    child's digests every 0.5 s, and a stream of adds) stays up for three
    liveness timeouts: the port's lane writer keeps its socket live, and a
    port reader re-arms its timeout on ring records from a JAX child, whose
    writer keeps the idle-only keepalive."""
    port = free_port()
    n = 4096
    m = _peer(port, np.zeros(n, np.float32), peer_timeout_sec=KILL_PEER_TIMEOUT)
    if child == "port":
        c = _peer(port, np.zeros(n, np.float32), peer_timeout_sec=KILL_PEER_TIMEOUT)
    else:
        c = _jax_engine(port, np.zeros(n, np.float32))
    try:
        wait_converged([c], np.zeros(n, np.float32), tol=1e-6)
        assert _wait_lane_live([m]), "the lane never went live"
        link = m.node.links
        assert len(link) == 1
        rng = np.random.default_rng(43)
        total = np.zeros(n, np.float64)
        t_end = time.time() + 3 * KILL_PEER_TIMEOUT
        while time.time() < t_end:
            for p in (m, c):
                u = rng.uniform(-KILL_SCALE, KILL_SCALE, n).astype(np.float32)
                p.add(u)
                total += u
            time.sleep(0.05)
        assert m.node.links == link, "the busy lane link timed out"
        assert m.metrics()["st_shm_msgs_in_total"] >= 1
        wait_converged([m, c], total.astype(np.float32), tol=1e-4)
    finally:
        c.close()
        m.close()


@pytest.mark.parametrize("joiner", ["redirect", "peer", "subscriber"])
def test_regrafted_node_is_reachable(joiner):
    """A node whose uplink was killed re-grafts with a new local endpoint,
    which its new parent hands out in redirects, and keeps the address it
    handed out before (its listen_port: a shard owner advertises it, and a
    peer or subscriber joined there keeps it as its rendezvous). A joiner
    redirected to it (its parent full) and a peer created at its first
    address join below it; a subscriber at its first address reads the
    tree."""
    port = free_port()
    n = 1024
    m = _peer(port, np.zeros(n, np.float32), shm=False, max_children=1)
    a = _peer(port, np.zeros(n, np.float32), shm=False, max_children=1)
    j = None
    try:
        wait_converged([a], np.zeros(n, np.float32), tol=1e-6)
        a_port = a.node.listen_port
        up0 = a.node.uplink
        a.node.drop_link(up0)
        deadline = time.time() + 20.0
        while time.time() < deadline and (a.node.uplink in (None, up0) or not a._ready.is_set()):
            time.sleep(0.02)
        assert a.node.uplink not in (None, up0), "the killed node never re-grafted"
        assert a.node.listen_port == a_port
        u = np.full(n, 0.5, np.float32)
        if joiner == "subscriber":
            j = serve.subscribe("127.0.0.1", a_port, np.zeros(n, np.float32), timeout=30.0)
            m.add(u)
            # two hops from the writer: the node's own freshness marks may
            # reach the subscriber before the master's add does
            deadline = time.time() + 20.0
            while time.time() < deadline and not np.allclose(j.read(max_staleness=10.0), u, atol=1e-5):
                time.sleep(0.02)
            np.testing.assert_allclose(j.read(max_staleness=10.0), u, atol=1e-5)
        else:
            t0 = time.monotonic()
            j = _peer(port if joiner == "redirect" else a_port, np.zeros(n, np.float32), shm=False,
                      join_timeout_sec=10.0)
            assert time.monotonic() - t0 < 10.0
            assert j.node.uplink is not None and len(a.node.links) == 2, "the joiner is not below the node"
            j.add(u)
            wait_converged([m, a, j], u, tol=1e-5)
    finally:
        for p in (j, a, m):
            if p is not None:
                p.close()


_LANE_CHILD = """
import sys, time
import numpy as np
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
cfg = Config(transport=TransportConfig(peer_timeout_sec={timeout}, max_children=1))
p = create_or_fetch("127.0.0.1", {port}, np.zeros({n}, np.float32), cfg, timeout=30.0, host_tier=True)
deadline = time.time() + 20.0
while time.time() < deadline and not any(
        k.startswith("st_shm_active") and v == 2 for k, v in p.metrics().items()):
    time.sleep(0.05)
print("lane", flush=True)
rng = np.random.default_rng(0)
while True:
    p.add(rng.uniform(-0.03, 0.03, {n}).astype(np.float32))
    time.sleep(0.05)
"""


def test_sigkilled_lane_child_frees_its_slot():
    """A child in another process, joined over the lane below a node with
    one child slot, streams for two liveness timeouts and is SIGKILLed: the
    node's link to it goes down, and a fresh joiner, redirected there by
    the full master, takes the freed slot, both within 10 s of the kill.
    (Before its repair the lane links timed out under the child's digests,
    the re-grafted node listened at an address its parent never handed out,
    and the joiner's walk dead-ended there.)"""
    port = free_port()
    n = 2048
    m = _peer(port, np.zeros(n, np.float32), peer_timeout_sec=KILL_PEER_TIMEOUT, max_children=1)
    a = _peer(port, np.zeros(n, np.float32), peer_timeout_sec=KILL_PEER_TIMEOUT, max_children=1)
    child = subprocess.Popen(
        [sys.executable, "-c", _LANE_CHILD.format(port=port, n=n, timeout=KILL_PEER_TIMEOUT)],
        cwd=ROOT, stdout=subprocess.PIPE, text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    j = None
    try:
        assert child.stdout.readline().strip() == "lane", "the child never came up on the lane"
        assert _wait_lane_live([a], want=2), "the node's link to the child has no lane"
        time.sleep(2 * KILL_PEER_TIMEOUT)  # the child streams (and sends digests) over the lane
        down = [l for l in a.node.links if l != a.node.uplink]
        assert len(down) == 1, f"the node lost its link to the child before the SIGKILL (links {a.node.links})"
        t_kill = time.monotonic()
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=10)
        while time.monotonic() - t_kill < 10.0 and down[0] in a.node.links:
            time.sleep(0.01)
        t_down = time.monotonic() - t_kill
        assert down[0] not in a.node.links, "the SIGKILLed child's link is still up after 10 s"
        j = _peer(port, np.zeros(n, np.float32), peer_timeout_sec=KILL_PEER_TIMEOUT,
                  join_timeout_sec=max(1.0, 10.0 - (time.monotonic() - t_kill)))
        j.wait_ready(max(1.0, 10.0 - (time.monotonic() - t_kill)))
        t_join = time.monotonic() - t_kill
        assert t_join < 10.0, t_join
        assert j.node.uplink is not None and len(a.node.links) == 2, "the joiner did not take the freed slot"
        print(f"link down {t_down:.3f} s, joined {t_join:.3f} s after the SIGKILL")
        wait_converged([j], np.asarray(m.read()), tol=1e-4)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
        child.stdout.close()
        for p in (j, a, m):
            if p is not None:
                p.close()
