"""Fault injection in the port (shared_tensor_tpu_torch.comm.faults and the
peer's hooks), on the CPU: the cases of tests/test_faults.py.

- The FaultPlan cases run on the port's plan and on the JAX package's, fed
  the same config, seed and sequence of on_send/point calls: their
  decisions, payloads and counts must be identical, and to_env's strings
  equal.
- The peer cases run on port peers: the Python-boundary cases on the device
  tier (device="cpu") and on the Python host tier, the native cases on the
  engine (the env strings, read by the port's own build of the transport).
  Every convergence is exact (seed + the sum of the adds, test_faults.py's
  tolerance: rtol 1e-4, atol 1e-5 or 1e-6), so it also shows no state was
  lost to the injected chaos.

The two striped cases of test_faults.py wait for link striping
(TransportConfig.stripe_count), which the port does not have yet.
"""

import logging
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from shared_tensor_tpu.comm import faults as jfaults
from shared_tensor_tpu.config import FaultConfig as JFaultConfig
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
from shared_tensor_tpu_torch.comm import faults
from shared_tensor_tpu_torch.comm.faults import CRASH_EXIT_CODE, FaultPlan
from shared_tensor_tpu_torch.comm.peer import SharedTensorPeer
from shared_tensor_tpu_torch.config import FaultConfig
from tests._ports import free_port
from tests.test_torch_peer import wait_converged

#: The tiers whose data sends cross the Python boundary the plan sits at.
PY_TIERS = ("device", "host")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(fault=None, engine=True, **tkw):
    tkw.setdefault("peer_timeout_sec", 10.0)
    return Config(transport=TransportConfig(**tkw), faults=fault or FaultConfig(), native_engine=engine)


def _tier_kw(tier):
    return {"device": "cpu"} if tier == "device" else {"host_tier": True}


def _peer(port, template, tier, fault=None, cls=create_or_fetch, **tkw):
    """A port peer on ``tier`` (device on the CPU, the Python host tier, or
    the engine) with the fault config ``fault``."""
    return cls("127.0.0.1", port, template, _cfg(fault, engine=tier == "engine", **tkw), **_tier_kw(tier))


def _check_tier(p, tier):
    if tier == "engine":
        assert p._engine is not None
    else:
        assert p._engine is None and p.st.host_tier == (tier == "host")


# -- FaultPlan against the JAX package's, decision for decision -------------------------------


def _both(kwargs, drive, **plan_kw):
    """Run ``drive(plan)`` on the port's plan and on JAX's over the same
    config; their results and counts must be equal. Returns the result."""
    ours = FaultPlan(FaultConfig(**kwargs), **plan_kw)
    theirs = jfaults.FaultPlan(JFaultConfig(**kwargs), **plan_kw)
    got, want = drive(ours), drive(theirs)
    assert got == want
    assert dict(ours.counts) == dict(theirs.counts)
    return got, ours


def _schedule(payload, n=200, link=1):
    return lambda plan: [plan.on_send(link, payload) for _ in range(n)]


def test_fault_plan_is_deterministic():
    kw = dict(enabled=True, seed=42, drop_pct=0.3, dup_pct=0.2, corrupt_pct=0.2)
    payload = bytes(range(64)) * 4
    a, plan = _both(kw, _schedule(payload))
    b, _ = _both(kw, _schedule(payload))
    assert a == b
    c, _ = _both({**kw, "seed": 43}, _schedule(payload))
    assert a != c
    assert plan.counts["dropped"] > 0 and plan.counts["duplicated"] > 0 and plan.counts["corrupted"] > 0


def test_fault_plan_every_class_matches_jax():
    """Every fault class at once, over several links and a BURST-shaped
    payload, with the frame geometry given."""
    kw = dict(enabled=True, seed=7, drop_pct=0.1, dup_pct=0.1, truncate_pct=0.1, corrupt_pct=0.2,
              delay_pct=0.1, delay_sec=0.002)
    burst = bytes([7]) + struct.pack("<I", 1) + bytes([3]) + bytes(13) + bytes(range(3 * 24))

    def drive(plan):
        return [plan.on_send(1 + i % 3, burst) for i in range(300)]

    _, plan = _both(kw, drive, scale_bytes=8, trace_bytes=13)
    assert all(plan.counts[k] > 0 for k in ("dropped", "duplicated", "truncated", "corrupted", "delayed"))


def test_fault_plan_disabled_is_identity():
    payload = b"\x00payload"
    (got, _), plan = _both({}, lambda p: (p.on_send(1, payload), p.point("mid-burst")))
    assert got == ([payload], 0.0, False)
    assert not plan.counts


def test_fault_plan_only_link_filters():
    kw = dict(enabled=True, seed=1, stall_after_frames=0, only_link=3)
    payload = b"\x00payload"
    got, _ = _both(kw, lambda p: [p.on_send(link, payload)[0] for link in (3, 1, 2)])
    assert got == [[], [payload], [payload]]


def test_fault_plan_stall_and_sever_are_deterministic():
    p = b"\x00x" * 8
    got, _ = _both(dict(enabled=True, seed=0, stall_after_frames=2),
                   lambda plan: [plan.on_send(link, p)[0] for link in (1, 1, 1, 2)])
    assert got == [[p], [p], [], [p]]
    got, _ = _both(dict(enabled=True, sever_after_frames=2), lambda plan: [plan.on_send(1, p) for _ in range(2)])
    assert got == [([p], 0.0, False), ([], 0.0, True)]


def test_fault_plan_corrupt_preserves_kind_byte():
    payload = bytes([0]) + bytes(255)
    got, _ = _both(dict(enabled=True, seed=9, corrupt_pct=1.0), _schedule(payload, 64))
    for (out,), _, _ in got:
        assert out[0] == 0 and len(out) == len(payload)
        diff = [i for i in range(len(out)) if out[i] != payload[i]]
        assert len(diff) == 1 and diff[0] >= len(payload) // 4


@pytest.mark.parametrize("kind", ["data", "burst", "rdata"])
def test_fault_plan_corrupt_targets_sign_words(kind):
    """With the geometry known, every flip lands in a frame's sign words,
    never a header, seq, range, trace or scale byte: DATA, BURST and the
    serving tier's RDATA, each v2-framed (13 trace bytes)."""
    sb, wb, tb = 8, 16, 13
    if kind == "data":
        payload, hdr, per = bytes([0]) + struct.pack("<I", 1) + bytes(tb + sb + wb), 5 + tb, sb + wb
    elif kind == "burst":
        payload, hdr, per = bytes([7]) + struct.pack("<I", 1) + bytes([3]) + bytes(tb + 3 * (sb + wb)), 6 + tb, sb + wb
    else:
        payload, hdr, per = bytes([11]) + struct.pack("<III", 1, 2, 4) + bytes(tb + sb + wb), 13 + tb, sb + wb
    got, _ = _both(dict(enabled=True, seed=4, corrupt_pct=1.0), _schedule(payload, 128), scale_bytes=sb,
                   trace_bytes=tb)
    for (out,), _, _ in got:
        diff = [i for i in range(len(out)) if out[i] != payload[i]]
        assert len(diff) == 1
        assert (diff[0] - hdr) % per >= sb, f"flip at {diff[0]} hit a header or scale byte"


def test_fault_plan_crash_point_callback_and_counting():
    def drive(plan):
        hits = []
        plan._on_crash = hits.append
        for _ in range(5):
            plan.point("mid-join-walk")
        out = [list(hits)]
        for _ in range(3):
            plan.point("mid-burst")
            out.append(list(hits))
        return out

    got, plan = _both(dict(enabled=True, crash_point="mid-burst", crash_after=3), drive)
    assert got == [[], [], [], ["mid-burst"]]
    assert plan.counts["crashed"] == 1


def test_fault_plan_rejects_unknown_crash_point():
    with pytest.raises(ValueError, match="unknown crash point"):
        FaultPlan(FaultConfig(enabled=True, crash_point="mid-lunch"))
    assert faults.CRASH_POINTS == jfaults.CRASH_POINTS and CRASH_EXIT_CODE == jfaults.CRASH_EXIT_CODE


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(enabled=True, seed=1),
        dict(enabled=True, seed=5, drop_pct=0.1, sever_after_frames=7, only_link=1, crash_point="mid-join-walk",
             crash_after=2),
        dict(enabled=True, seed=3, dup_pct=0.2, truncate_pct=0.05, corrupt_pct=0.01, delay_pct=0.5, delay_sec=0.02,
             stall_after_frames=0, crash_point="between-apply-and-ack"),
        dict(enabled=True, seed=9, sever_after_frames=3, only_link=1, only_stripe=2),
    ],
    ids=["disabled", "seed-only", "sever", "all-classes", "one-stripe"],
)
def test_to_env_equals_jax(kw):
    env = faults.to_env(FaultConfig(**kw))
    assert env == jfaults.to_env(JFaultConfig(**kw))
    if kw.get("seed") == 5:
        assert env["ST_FAULT_PLAN"] == "seed=5,drop=0.1,sever_after=7,only_link=1"
        assert env["ST_FAULT_CRASH"] == "mid-join-walk:2"
    if kw.get("only_stripe") == 2:
        assert env["ST_FAULT_PLAN"] == "seed=9,sever_after=3,only_link=1,only_stripe=2"
    if kw == dict(enabled=True, seed=1):
        assert "stall_after" not in env["ST_FAULT_PLAN"]
    if not kw:
        assert env == {}


# -- peers under faults: the Python boundary (device and Python host tiers) -------------------


@pytest.mark.parametrize("tier", PY_TIERS)
def test_sever_rolls_unacked_into_carry(tier):
    """The joiner's plan swallows its uplink's messages after the first,
    then severs it: the unacknowledged mass rides the re-graft carry, and
    every replica ends at seed + the delta. only_link keeps the re-grafted
    uplink (a new id) clean."""
    port = free_port()
    seed = np.full((256,), 2.0, np.float32)
    fault = FaultConfig(enabled=True, seed=11, stall_after_frames=1, sever_after_frames=4, only_link=1)
    m = _peer(port, seed, tier)
    j = _peer(port, np.zeros_like(seed), tier, fault, cls=SharedTensorPeer, ack_timeout_sec=1.0)
    try:
        j.wait_ready(60.0)
        _check_tier(j, tier)
        wait_converged([j], seed)
        delta = np.random.default_rng(7).normal(size=(256,)).astype(np.float32)
        j.add(delta)
        wait_converged([m, j], seed + delta, tol=1e-5, timeout=90.0)
        assert j._faults.counts["severed"] >= 1 and j._faults.counts["stalled"] >= 1
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_drop_faults_recovered_by_retransmission(tier):
    """Half the data messages dropped: go-back-N re-sends the tail byte for
    byte and the receiver applies each message once: exact convergence on a
    live link."""
    port = free_port()
    seed = np.zeros((128,), np.float32)
    fault = FaultConfig(enabled=True, seed=3, drop_pct=0.5, only_link=1)
    m = _peer(port, seed, tier)
    j = _peer(port, seed, tier, fault, cls=SharedTensorPeer, ack_timeout_sec=1.0)
    try:
        j.wait_ready(60.0)
        delta = np.full((128,), 0.75, np.float32)
        j.add(delta)
        wait_converged([m, j], seed + delta, tol=1e-5, timeout=90.0)
        assert j._faults.counts["dropped"] >= 1
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_duplicate_is_deduped_exactly_once(tier):
    """Every data message sent twice: the echo carries the same seq and the
    receiver discards it, so both replicas hold exactly seed + delta."""
    port = free_port()
    seed = np.zeros((64,), np.float32)
    fault = FaultConfig(enabled=True, seed=1, dup_pct=1.0, only_link=1)
    m = _peer(port, seed, tier)
    j = _peer(port, seed, tier, fault, cls=SharedTensorPeer)
    try:
        j.wait_ready(60.0)
        delta = np.full((64,), 0.5, np.float32)
        j.add(delta)
        wait_converged([m, j], seed + delta, tol=1e-5)
        assert j._faults.counts["duplicated"] >= 1
        assert m.metrics()["st_dedup_discards_total"] >= 1
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_truncated_messages_are_resent_whole(tier):
    """A truncated message is refused by the receiver's decode without
    consuming its seq, and the re-send delivers it whole: exact
    convergence. Seed 1's first draw truncates, so the first data message
    is cut whatever the timing."""
    port = free_port()
    seed = np.zeros((128,), np.float32)
    fault = FaultConfig(enabled=True, seed=1, truncate_pct=0.5, only_link=1)
    m = _peer(port, seed, tier)
    j = _peer(port, seed, tier, fault, cls=SharedTensorPeer, ack_timeout_sec=1.0)
    try:
        j.wait_ready(60.0)
        delta = np.full((128,), 1.25, np.float32)
        j.add(delta)
        wait_converged([m, j], seed + delta, tol=1e-5, timeout=90.0)
        assert j._faults.counts["truncated"] >= 1
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_crash_points_fire_at_named_instants(tier):
    """Plans whose kill is a recorder: mid-burst fires on the joiner's send
    path, between-apply-and-ack on the master's receive path."""
    port = free_port()
    seed = np.zeros((64,), np.float32)
    m = _peer(port, seed, tier)
    j = _peer(port, seed, tier)
    hits_j, hits_m = [], []
    try:
        j._faults = FaultPlan(FaultConfig(enabled=True, crash_point="mid-burst"), on_crash=hits_j.append)
        m._faults = FaultPlan(FaultConfig(enabled=True, crash_point="between-apply-and-ack"), on_crash=hits_m.append)
        delta = np.full((64,), 0.25, np.float32)
        j.add(delta)
        wait_converged([m, j], seed + delta, tol=1e-5)
        assert hits_j and hits_j[0] == "mid-burst"
        assert hits_m and hits_m[0] == "between-apply-and-ack"
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_mid_join_walk_point_fires_between_sync_and_snapshot(tier, monkeypatch):
    """The Python mid-join-walk point: reached once the SYNC is sent and
    before the snapshot; the join completes after the recorder returns."""
    from shared_tensor_tpu_torch.comm import peer as peer_mod

    hits = []
    real = peer_mod.faults.FaultPlan

    def recording_plan(cfg, **kw):
        return real(cfg, on_crash=hits.append, **kw)

    monkeypatch.setattr(peer_mod.faults, "FaultPlan", recording_plan)
    port = free_port()
    seed = np.full((64,), 3.0, np.float32)
    m = _peer(port, seed, tier)
    j = _peer(port, np.zeros_like(seed), tier, FaultConfig(enabled=True, crash_point="mid-join-walk"))
    try:
        wait_converged([j], seed)
        assert hits == ["mid-join-walk"]
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_quarantine_tears_down_stalled_link(tier, caplog):
    """A peer that stops draining with its socket open: after
    quarantine_send_failures refusals the link is torn down and re-grafted,
    and the stalled mass arrives after all."""
    port = free_port()
    seed = np.zeros((64,), np.float32)
    m = _peer(port, seed, tier, quarantine_send_failures=5)
    j = _peer(port, seed, tier, quarantine_send_failures=5)
    try:
        up = j._uplink
        assert up is not None
        real_send = j.node.send

        def stalled_send(link, payload, timeout=0.1):
            if link == up:
                time.sleep(0.01)  # a full queue that never drains
                return False
            return real_send(link, payload, timeout=timeout)

        j.node.send = stalled_send
        with caplog.at_level(logging.WARNING, "shared_tensor_tpu_torch.peer"):
            delta = np.full((64,), 1.5, np.float32)
            j.add(delta)
            deadline = time.time() + 60.0
            while time.time() < deadline and j._uplink == up:
                time.sleep(0.05)
        j.node.send = real_send
        assert j._uplink != up, "stalled link was never quarantined"
        assert any("quarantining link" in r.message for r in caplog.records)
        wait_converged([m, j], seed + delta, tol=1e-5)
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_handshake_traffic_is_never_faulted(tier):
    """A plan that swallows every data message from the first still lets
    the join handshake complete (SYNC, CHUNK, DONE, WELCOME are control
    traffic), and the joiner still receives."""
    port = free_port()
    seed = np.full((64,), 4.0, np.float32)
    m = _peer(port, seed, tier)
    j = _peer(port, np.zeros_like(seed), tier, FaultConfig(enabled=True, seed=2, stall_after_frames=0),
              cls=SharedTensorPeer)
    try:
        j.wait_ready(60.0)
        wait_converged([j], seed)
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_dead_join_reply_does_not_hang(tier):
    """An accepting but silent rendezvous: creation fails with
    ConnectionError in bounded time and leaves no thread behind."""
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    port = silent.getsockname()[1]
    before = {t.name for t in threading.enumerate()}
    t0 = time.time()
    try:
        with pytest.raises(ConnectionError):
            _peer(port, np.zeros((32,), np.float32), tier, cls=SharedTensorPeer, connect_timeout_sec=0.5,
                  join_timeout_sec=1.5)
    finally:
        silent.close()
    assert time.time() - t0 < 30.0
    leaked = {t.name for t in threading.enumerate() if t.name.startswith("st-")} - before
    assert not leaked, f"join failure leaked threads: {leaked}"


# -- the native tier: the engine under ST_FAULT_PLAN / ST_FAULT_CRASH -------------------------


def test_engine_sever_rolls_unacked_into_carry(monkeypatch):
    """The same fault class in the port's transport build (ST_FAULT_PLAN,
    read at st_node_create, set around the joiner's creation only): the
    engine's ledger rolls the severed link's unacknowledged frames into
    its carry and the rejoin re-grafts them."""
    port = free_port()
    seed = np.full((256,), 1.0, np.float32)
    m = _peer(port, seed, "engine")
    env = faults.to_env(FaultConfig(enabled=True, seed=5, stall_after_frames=4, sever_after_frames=16, only_link=1))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = _peer(port, np.zeros_like(seed), "engine", cls=SharedTensorPeer)
    for k in env:
        monkeypatch.delenv(k)
    try:
        j.wait_ready(60.0)
        _check_tier(j, "engine")
        _check_tier(m, "engine")
        wait_converged([j], seed)
        delta = np.random.default_rng(13).normal(size=(256,)).astype(np.float32)
        j.add(delta)
        wait_converged([m, j], seed + delta, tol=1e-5, timeout=90.0)
    finally:
        j.close()
        m.close()


def test_engine_warns_when_wire_faults_cannot_inject(caplog):
    """Wire faults in Config.faults on an engine peer with no ST_FAULT_PLAN
    would inject nothing: the peer says so."""
    port = free_port()
    with caplog.at_level(logging.WARNING, "shared_tensor_tpu_torch.peer"):
        p = _peer(port, np.zeros(64, np.float32), "engine", FaultConfig(enabled=True, drop_pct=0.5))
        p.close()
    assert any("inject nothing" in r.message for r in caplog.records)


def test_striped_link_survives_single_stripe_sever(monkeypatch):
    """test_faults.py's striped sever on port engine peers: four stripes a
    link, the master's transport kills stripe 2 of its first link at its
    3rd data message (ST_FAULT_PLAN around the master's creation). The
    link degrades to three stripes (a death and re-routed messages on the
    master's side), stays up, and every update converges; the per-stripe
    plan pins the link to TCP (the lane would carry the data past it)."""
    port = free_port()
    seed = np.full((4096,), 1.0, np.float32)
    env = faults.to_env(FaultConfig(enabled=True, seed=9, sever_after_frames=3, only_link=1, only_stripe=2))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    m = _peer(port, seed, "engine", stripe_count=4)
    for k in env:
        monkeypatch.delenv(k)
    j = _peer(port, np.zeros_like(seed), "engine", cls=SharedTensorPeer, stripe_count=4)
    try:
        j.wait_ready(60.0)
        _check_tier(m, "engine")
        wait_converged([j], seed, tol=1e-5)
        rng = np.random.default_rng(21)
        total = seed.astype(np.float64)
        for _ in range(12):
            u = rng.normal(0, 0.5, 4096).astype(np.float32)
            total = total + u
            m.add(u)
            time.sleep(0.01)
        wait_converged([m, j], total.astype(np.float32), tol=1e-4, timeout=60.0)
        ss = m.node.stripe_stats(1)
        assert ss is not None and ss["stripes"] == 4
        assert ss["deaths"] >= 1, "the injected stripe sever never fired"
        assert ss["live"] == ss["stripes"] - ss["deaths"]
        assert ss["reroutes"] >= 1, "no message re-routed off the dead stripe"
        assert 1 in m.node.links, "the link must survive a stripe's death"
        mm = m.metrics()
        assert mm["st_stripe_deaths_total"] >= 1 and mm['st_stripe_count{link="1"}'] == 4
        assert not [k for k in mm if k.startswith("st_shm_active")], "a per-stripe plan keeps the link on TCP"
    finally:
        j.close()
        m.close()


def test_striped_link_stall_tears_down_cleanly_not_wedged(monkeypatch):
    """test_faults.py's other striped shape: stripe 1 of the joiner's uplink
    swallows every message past its 6th. Reassembly at the master wedges
    on the hole, the joiner's go-back-N tears the link down, the carry
    re-grafts on a fresh link, and the update converges exactly."""
    port = free_port()
    seed = np.full((4096,), 2.0, np.float32)
    m = _peer(port, seed, "engine", stripe_count=2)
    env = faults.to_env(FaultConfig(enabled=True, seed=4, stall_after_frames=6, only_link=1, only_stripe=1))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j = _peer(port, np.zeros_like(seed), "engine", cls=SharedTensorPeer, stripe_count=2, ack_timeout_sec=1.0,
              ack_retry_limit=2)
    for k in env:
        monkeypatch.delenv(k)
    try:
        j.wait_ready(60.0)
        wait_converged([j], seed, tol=1e-5)
        delta = np.random.default_rng(8).normal(size=(4096,)).astype(np.float32)
        j.add(delta)
        wait_converged([m, j], seed + delta, tol=1e-5, timeout=90.0)
    finally:
        j.close()
        m.close()


@pytest.mark.parametrize("tier", ["engine", "device"])
def test_native_crash_point_mid_join_walk(tier):
    """A port joiner in a subprocess armed with ST_FAULT_CRASH
    mid-join-walk:1 dies with exit code 17 inside the transport's join walk
    (the port's own build of it), and the master serves joins after."""
    port = free_port()
    seed = np.full((64,), 3.0, np.float32)
    m = _peer(port, seed, "engine")
    kw = "host_tier=True" if tier == "engine" else "device='cpu'"
    script = (
        "import numpy as np\n"
        "from shared_tensor_tpu_torch import Config, TransportConfig\n"
        "from shared_tensor_tpu_torch.comm.peer import SharedTensorPeer\n"
        f"SharedTensorPeer('127.0.0.1', {port}, np.zeros(64, np.float32), "
        f"Config(transport=TransportConfig(peer_timeout_sec=10.0)), {kw})\n"
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-c", script], cwd=ROOT, timeout=120, capture_output=True,
            env={**os.environ, "ST_FAULT_CRASH": "mid-join-walk:1"},
        )
        assert proc.returncode == CRASH_EXIT_CODE, (proc.returncode, proc.stderr[-2000:])
        j = _peer(port, np.zeros_like(seed), tier)
        try:
            wait_converged([j], seed)
        finally:
            j.close()
    finally:
        m.close()


def test_dead_rendezvous_fails_in_bounded_time():
    """Per-hop connect_timeout_sec and the join_timeout_sec budget bound a
    join against a silent rendezvous (the engine tier)."""
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    port = silent.getsockname()[1]
    t0 = time.time()
    try:
        with pytest.raises(ConnectionError, match="within 2s"):
            _peer(port, np.zeros((32,), np.float32), "engine", cls=SharedTensorPeer, connect_timeout_sec=0.5,
                  join_timeout_sec=2.0)
    finally:
        silent.close()
    assert time.time() - t0 < 30.0
