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

The lifecycle snapshot across live lanes (test_shm.py's fifth case) waits
for the lifecycle slice. Tolerances are test_shm.py's: rtol 1e-4, atol
1e-5 for the seed and 1e-4 after gaussian adds."""

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
