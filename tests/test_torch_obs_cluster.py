"""The port's cluster-wide observability against the JAX package's.

- The digest algebra (``obs/aggregate.py``): from_snapshot, merge, bounded,
  process_global_totals and prometheus_text give equal results on the same
  seeded snapshots, the port-only names included (JAX classifies them by
  suffix, the port by its schema: they must agree), and a 7-node digest
  with them stays under ``DIGEST_MAX_BYTES``.
- DIGEST and CLOCK messages are byte-identical.
- Causal paths and the Chrome trace export give identical JSON.
- Port peers (``device="cpu"``, the engine and the Python host tier): the
  v1/v2 mixed tree, the 7-node tree under native drops (contiguous paths,
  digest totals equal to the sum of the registries), the skew arm (+/-50
  ms recovered within the reported uncertainty), a subscriber's digest
  reaching the root, and mixed trees both ways: a port root lists its JAX
  children and answers their clock probes; a JAX root lists port children.
"""

import dataclasses
import io
import json
import tempfile
import time
from contextlib import redirect_stdout

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu.comm import wire as jax_wire
from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import ObsConfig as JObsConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu.obs import aggregate as jax_aggregate
from shared_tensor_tpu.obs import events as jax_events
from shared_tensor_tpu.obs import schema as jax_schema
from shared_tensor_tpu.obs import top as jax_top
from shared_tensor_tpu.obs import trace_export as jax_trace_export
from shared_tensor_tpu_torch import Config, TransportConfig, compat, create_or_fetch, obs
from shared_tensor_tpu_torch.comm import faults, wire
from shared_tensor_tpu_torch.config import FaultConfig, ObsConfig, ServeConfig
from shared_tensor_tpu_torch.obs import aggregate, schema, top, trace_export
from shared_tensor_tpu_torch.obs import events as obs_events
from tests._ports import free_port


@pytest.fixture(scope="module", autouse=True)
def _built():
    build_native()


def _cfg(obs_cfg=None, engine=True, **tkw):
    tkw.setdefault("peer_timeout_sec", 15.0)
    return Config(transport=TransportConfig(**tkw), obs=obs_cfg or ObsConfig(digest_interval_sec=0.2),
                  native_engine=engine)


def _peer(port, template, tier, cfg):
    if tier == "device":
        return create_or_fetch("127.0.0.1", port, template, cfg, device="cpu", timeout=60.0)
    return create_or_fetch("127.0.0.1", port, template, dataclasses.replace(cfg, native_engine=tier == "engine"),
                           host_tier=True, timeout=60.0)


def _wait(pred, timeout=60.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _fresh_hub(capacity: int = 0):
    h = obs.hub()
    h.poll_native()
    h.recorder.clear()
    if capacity:
        h.recorder.set_capacity(capacity)
    return h


PORT_ONLY = [n for n in schema.SCHEMA if n not in jax_schema.SCHEMA]


def _snap(rng, node: int) -> dict:
    """A seeded registry snapshot with JAX's names, the port-only names,
    labeled series, a histogram and the process-wide counters."""
    s = {
        "st_frames_out_total": int(rng.integers(0, 10**7)),
        "st_frames_in_total": int(rng.integers(0, 1000)),
        "st_updates_total": int(rng.integers(0, 50)),
        "st_residual_norm": float(rng.uniform(0, 3)),
        "st_corrupt_scales_zeroed_total": 4,
        "st_obs_events_dropped_total": 2,
        "st_clock_offset_seconds": float(rng.uniform(-0.1, 0.1)),
        "st_apply_seconds": {"sum": float(rng.uniform(0, 2)), "count": 6,
                             "buckets": {1e-4: 1, 1e-3: 3, 1e-2: 5, 0.1: 6}},
    }
    for link in (1, 2):
        s[schema.link_key("st_staleness_seconds", link)] = float(rng.uniform(0, 2))
        s[schema.link_key("st_link_bytes_out_total", link)] = int(rng.integers(0, 10**6))
        s[schema.link_key("st_shm_ring_bytes", link)] = 1 << 20
        s[schema.link_key("st_link_frames_out_total", link)] = int(rng.integers(0, 500))
    for name in PORT_ONLY:
        if name not in ("st_shm_ring_bytes", "st_link_frames_out_total"):
            s[name] = float(rng.uniform(0, 9)) if name.endswith("seconds_total") else int(rng.integers(0, 99))
    return s


def test_port_only_names_follow_the_suffix_rule():
    """A JAX root classifies a name it does not know by its suffix; every
    port-only name's kind agrees with that rule."""
    assert PORT_ONLY and "st_apply_dropped_total" in PORT_ONLY
    for name in PORT_ONLY:
        kind = schema.SCHEMA[name][0]
        assert kind == ("counter" if name.endswith("_total") else "gauge"), name
        assert jax_aggregate._kind(name, 1) == aggregate._kind(name, 1) == kind


def test_aggregate_equals_jax_on_seeded_snapshots():
    rng = np.random.default_rng(0)
    snaps = [(10 + i, _snap(rng, i), 1000 * i) for i in range(5)]
    port_docs = [aggregate.from_snapshot(n, s, t) for n, s, t in snaps]
    jax_docs = [jax_aggregate.from_snapshot(n, s, t) for n, s, t in snaps]
    assert port_docs == jax_docs
    m_p, m_j = aggregate.empty(), jax_aggregate.empty()
    for a, b in zip(port_docs, jax_docs):
        aggregate.merge(m_p, a)
        jax_aggregate.merge(m_j, b)
    assert m_p == m_j
    assert aggregate.process_global_totals(m_p) == jax_aggregate.process_global_totals(m_j)
    assert aggregate.cluster_nodes(m_p) == 5
    assert aggregate.prometheus_text(m_p) == jax_aggregate.prometheus_text(m_j)
    # a port digest merges at a JAX root and a JAX digest at a port root
    mixed_p = aggregate.merge(json.loads(json.dumps(port_docs[0])), jax_docs[1])
    mixed_j = jax_aggregate.merge(json.loads(json.dumps(jax_docs[0])), port_docs[1])
    assert mixed_p == mixed_j
    assert mixed_p["counters"]["st_apply_dropped_total"] == snaps[0][1]["st_apply_dropped_total"] + \
        snaps[1][1]["st_apply_dropped_total"]
    assert wire.encode_digest(aggregate.bounded(m_p)) == jax_wire.encode_digest(jax_aggregate.bounded(m_j))


def test_aggregate_process_global_counters_dedup_by_pid():
    """The process-wide counters count once a process, however many peers
    of it report them."""
    snap = {"st_obs_events_dropped_total": 5, "st_corrupt_scales_zeroed_total": 2, "st_frames_out_total": 3}
    m = aggregate.merge(aggregate.from_snapshot(1, snap, 1), aggregate.from_snapshot(2, snap, 2))
    assert m["counters"]["st_frames_out_total"] == 6
    assert "st_obs_events_dropped_total" not in m["counters"]
    assert aggregate.process_global_totals(m) == {"st_obs_events_dropped_total": 5, "st_corrupt_scales_zeroed_total": 2}
    other = json.loads(json.dumps(aggregate.from_snapshot(3, snap, 3)).replace(
        f'"{next(iter(m["proc"]))}"', '"999999"'))  # the same counters from another process
    aggregate.merge(m, other)
    assert aggregate.process_global_totals(m)["st_obs_events_dropped_total"] == 10


def test_aggregate_bounded_truncates_oldest_breakdowns():
    doc_p, doc_j = aggregate.empty(), jax_aggregate.empty()
    for i in range(aggregate.MAX_NODES + 10):
        aggregate.merge(doc_p, aggregate.from_snapshot(i, {"st_updates_total": 1}, t_ns=i))
        jax_aggregate.merge(doc_j, jax_aggregate.from_snapshot(i, {"st_updates_total": 1}, t_ns=i))
    assert aggregate.bounded(doc_p) == jax_aggregate.bounded(doc_j)
    assert len(doc_p["nodes"]) == aggregate.MAX_NODES and doc_p["truncated"] == 10
    assert "0" not in doc_p["nodes"] and "9" not in doc_p["nodes"]
    assert doc_p["counters"]["st_updates_total"] == aggregate.MAX_NODES + 10


def test_seven_node_digest_with_port_names_stays_under_the_cap():
    """Seven nodes' breakdowns with every port-only name and 130 links each:
    bounded() drops the oldest breakdowns until the encoding fits, keeps
    every total, and does what JAX's does."""
    rng = np.random.default_rng(1)
    doc_p, doc_j = aggregate.empty(), jax_aggregate.empty()
    for i in range(7):
        s = _snap(rng, i)
        for link in range(3, 130):
            s[schema.link_key("st_link_residual_rms", link)] = float(rng.uniform(0, 1))
            s[schema.link_key("st_shm_ring_bytes", link)] = float(link)
        aggregate.merge(doc_p, aggregate.from_snapshot(100 + i, s, t_ns=i))
        jax_aggregate.merge(doc_j, jax_aggregate.from_snapshot(100 + i, s, t_ns=i))
    raw = len(json.dumps(doc_p, separators=(",", ":")))
    assert raw > wire.DIGEST_MAX_BYTES  # the case needs truncation
    aggregate.bounded(doc_p)
    jax_aggregate.bounded(doc_j)
    assert doc_p == doc_j
    payload = wire.encode_digest(doc_p)
    assert len(payload) - 1 <= wire.DIGEST_MAX_BYTES
    assert doc_p["truncated"] >= 1 and "100" not in doc_p["nodes"]  # the oldest went first
    assert doc_p["counters"]["st_frames_in_total"] > 0


def test_digest_and_clock_messages_are_byte_identical():
    rng = np.random.default_rng(2)
    doc = aggregate.bounded(aggregate.from_snapshot(7, _snap(rng, 0), 123))
    assert wire.encode_digest(doc) == jax_wire.encode_digest(doc)
    assert wire.decode_digest(jax_wire.encode_digest(doc)) == jax_wire.decode_digest(wire.encode_digest(doc)) == doc
    for msg in ({"op": "probe", "t1": 12345678901}, {"op": "reply", "t1": 1, "t2": 2, "t3": 2, "off_ns": -5, "unc_ns": 9}):
        assert wire.encode_clock(msg) == jax_wire.encode_clock(msg)
        assert wire.decode_clock(jax_wire.encode_clock(msg)) == msg
    assert (wire.DIGEST, wire.CLOCK, wire.DIGEST_MAX_BYTES) == (jax_wire.DIGEST, jax_wire.CLOCK, jax_wire.DIGEST_MAX_BYTES)
    with pytest.raises(ValueError):
        wire.encode_digest({"x": "y" * wire.DIGEST_MAX_BYTES})


def _events(rng, cls):
    out = []
    for i in range(60):
        origin, gen, hop = int(rng.integers(1, 4)), int(rng.integers(1, 6)) * 1000, int(rng.integers(1, 4))
        out.append(cls(int(rng.integers(0, 10**9)), "c" if i % 2 else "py", "trace_apply", int(rng.integers(1, 6)),
                       int(rng.integers(1, 3)), gen, extra=(origin << 8) | hop))
    out.append(cls(5_000, "py", "retransmit", 2, 1, 3, detail="why"))
    return out


def test_trace_export_equals_jax():
    evs_p = _events(np.random.default_rng(4), obs_events.Event)
    evs_j = _events(np.random.default_rng(4), jax_events.Event)
    assert trace_export.trace_paths(evs_p) == jax_trace_export.trace_paths(evs_j)
    assert trace_export.path_stats(trace_export.trace_paths(evs_p)) == \
        jax_trace_export.path_stats(jax_trace_export.trace_paths(evs_j))
    offs = {2: 50_000_000, 3: -50_000_000}
    for kw in ({}, {"offsets_ns": offs}, {"flows": False}):
        a = json.dumps(trace_export.chrome_trace(evs_p, **kw))
        b = json.dumps(jax_trace_export.chrome_trace(evs_j, **kw))
        assert a == b
    doc = trace_export.chrome_trace(evs_p)
    assert any(t["ph"] == "s" for t in doc["traceEvents"])


def test_obs_top_renders_a_digest_file_as_jax(tmp_path):
    doc = aggregate.from_snapshot(3, {"st_frames_out_total": 12, "st_frames_in_total": 9, "st_updates_total": 4,
                                      "st_residual_norm": 1.25, 'st_staleness_seconds{link="2"}': 0.5}, t_ns=1)
    p = tmp_path / "cluster.json"
    p.write_text(json.dumps(doc))
    outs = []
    for main in (top.main, jax_top.main):
        out = io.StringIO()
        with redirect_stdout(out):
            assert main(["--file", str(p), "--once"]) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "1 node(s)" in outs[0] and "worst staleness 0.5000s @ node 3" in outs[0]


def test_wire_protocol_version_gate(monkeypatch):
    assert compat.wire_protocol_version(Config()) == compat.WIRE_VERSION_V2
    assert compat.wire_protocol_version(Config(obs=ObsConfig(trace_wire=False))) == compat.WIRE_VERSION_V1
    monkeypatch.setenv("ST_WIRE_TRACE", "0")
    assert compat.wire_protocol_version(Config()) == compat.WIRE_VERSION_V1


def test_obs_config_equals_jax():
    ours = {f.name: f.default for f in dataclasses.fields(ObsConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JObsConfig)}
    assert ours == theirs


def test_v1_v2_mixed_tree_interop():
    """A v1 joiner (``trace_wire=False``) in a traced tree: both directions
    decode, both converge, nothing is dropped as undecodable, and the v1
    peer sends no digest or probe (its parent might not speak them)."""
    port = free_port()
    n = 1024
    seed = np.zeros((n,), np.float32)
    m = create_or_fetch("127.0.0.1", port, seed, _cfg(), device="cpu")
    c = create_or_fetch("127.0.0.1", port, seed,
                        _cfg(ObsConfig(trace_wire=False, digest_interval_sec=0.2, clock_sync_interval_sec=0.2)),
                        device="cpu")
    try:
        assert m._trace_wire and not c._trace_wire
        assert c._digest_interval == 0.0 and c._clock_interval == 0.0
        total = np.zeros(n, np.float64)
        rng = np.random.default_rng(3)
        for i in range(10):
            d = rng.normal(size=n).astype(np.float32)
            (m if i % 2 == 0 else c).add(d)
            total += d
            time.sleep(0.01)
        for p in (m, c):
            _wait(lambda p=p: np.allclose(p.read().numpy(), total, atol=1e-4), msg="convergence across framings")
        assert c.metrics()["st_dedup_discards_total"] == 0
        time.sleep(0.5)
        assert m.metrics()["st_digest_msgs_in_total"] == 0 and c.metrics()["st_clock_probes_total"] == 0
    finally:
        c.close()
        m.close()


def test_cluster_trace_paths_and_digest_totals_7_nodes(monkeypatch):
    """Seven port engine peers, the deepest under a native drop schedule:
    every update's path is contiguous (>= 99%), and at a quiescent instant
    the root's digest totals equal the sum of the nodes' registries."""
    hub = _fresh_hub(capacity=200_000)
    port = free_port()
    n = 2048
    seed = np.zeros((n,), np.float32)
    env = faults.to_env(FaultConfig(enabled=True, seed=9, drop_pct=0.25, only_link=1))
    peers = []
    try:
        for i in range(7):
            if i == 6:
                monkeypatch.setenv("ST_FAULT_PLAN", env["ST_FAULT_PLAN"])
            try:
                peers.append(_peer(port, seed, "engine", _cfg(ack_timeout_sec=0.4)))
            finally:
                monkeypatch.delenv("ST_FAULT_PLAN", raising=False)
        assert all(p._engine is not None for p in peers)
        total = np.zeros(n, np.float64)
        rng = np.random.default_rng(0)
        for i in range(24):
            d = rng.uniform(-0.5, 0.5, n).astype(np.float32)
            peers[0 if i % 2 else 6].add(d)
            total += d
            time.sleep(0.015)
        for i, p in enumerate(peers):
            _wait(lambda p=p: np.allclose(p.read().numpy(), total, atol=1e-4), timeout=90.0, msg=f"peer {i}")
        assert all(p.drain(timeout=30.0, tol=1e-30) for p in peers)
        hub.poll_native()
        stats = trace_export.path_stats(trace_export.trace_paths(hub.recorder.timeline()))
        assert stats["paths"] >= 20 and stats["contiguous_frac"] >= 0.99 and stats["max_hops"] >= 3, stats
        assert hub.recorder.counts["fault_drop"] >= 1 and hub.recorder.counts["retransmit"] >= 1
        for _ in range(4):  # one round a tree level, and a margin
            for p in peers:
                if p._uplink is not None:
                    p.push_digest()
            time.sleep(0.4)
        cluster = peers[0].metrics(cluster=True)
        assert len(cluster["nodes"]) == 7
        snaps = [p.metrics() for p in peers]
        for name in ("st_frames_out_total", "st_frames_in_total", "st_updates_total", "st_msgs_out_total",
                     "st_msgs_in_total", "st_retransmit_msgs_total", "st_dedup_discards_total",
                     "st_traced_msgs_in_total"):
            assert cluster["counters"].get(name, 0) == sum(s.get(name, 0) for s in snaps), name
        gmax = cluster["gmax"]["st_staleness_seconds"]
        assert gmax[0] >= 0.0 and int(gmax[1]) in {p.node.obs_id for p in peers}
        want = sum(s["st_updates_total"] for s in snaps)
        assert f"st_updates_total {want}" in peers[0].cluster_prometheus_text()
    finally:
        for p in reversed(peers):
            p.close()


@pytest.mark.parametrize("tiers", [("device", "device", "engine"), ("engine", "host", "device")])
def test_skew_arm_recovers_offsets_within_uncertainty(tiers):
    """A root and two children whose stamps are skewed +50 and -50 ms: each
    child's offset estimate lies within its reported uncertainty of its
    skew, and the root's health document corrects staleness with them."""
    port = free_port()
    tmpl = {"w": np.zeros((64,), np.float32)}
    fast = dict(digest_interval_sec=0.1, clock_sync_interval_sec=0.1)
    with tempfile.TemporaryDirectory() as d:
        root = _peer(port, tmpl, tiers[0], _cfg(ObsConfig(health_json_path=f"{d}/h.json", **fast)))
        kids = []
        try:
            for tier, skew in zip(tiers[1:], (0.05, -0.05)):
                kids.append(_peer(port, tmpl, tier, _cfg(ObsConfig(clock_skew_sim_sec=skew, **fast))))
            for k in kids:
                k.add({"w": np.ones((64,), np.float32)})
            _wait(lambda: all(k._clock.replies >= 4 for k in kids), timeout=30.0, msg="clock replies")
            for k, skew in zip(kids, (0.05, -0.05)):
                m = k.metrics()
                off, unc = m["st_clock_offset_seconds"], m["st_clock_uncertainty_seconds"]
                assert abs(off - skew) <= unc, (off, unc, skew)
            _wait(lambda: len(json.load(open(f"{d}/h.json"))["clock"]) == 3, timeout=30.0, msg="health clock")
            h = json.load(open(f"{d}/h.json"))
            for k, skew in zip(kids, (0.05, -0.05)):
                c = h["clock"][str(k.node.obs_id)]
                assert abs(c["off_sec"] - skew) <= c["unc_sec"]
        finally:
            for p in kids + [root]:
                p.close()


def test_subscriber_digest_reaches_the_root_and_reads_fill_its_histogram():
    from shared_tensor_tpu_torch.serve import subscribe

    port = free_port()
    tmpl = {"w": np.zeros((256,), np.float32)}
    m = create_or_fetch("127.0.0.1", port, tmpl, _cfg(), device="cpu")
    sub = None
    try:
        sub = subscribe("127.0.0.1", port, tmpl, Config(obs=ObsConfig(digest_interval_sec=0.1),
                                                        serve=ServeConfig(max_staleness_sec=5.0)))
        m.add({"w": np.ones((256,), np.float32)})
        for _ in range(5):
            sub.read()
        h = sub.metrics()["st_read_staleness_seconds"]
        assert h["count"] >= 5 and sub.metrics()["st_read_total"] >= 5
        _wait(lambda: m.metrics(cluster=True)["counters"].get("st_read_total", 0) >= 5, timeout=20.0,
              msg="the subscriber's digest after the reads")
        cl = m.metrics(cluster=True)
        assert str(sub.node.obs_id) in cl["nodes"] and cl["hists"]["st_read_staleness_seconds"]["count"] >= 5
    finally:
        if sub is not None:
            sub.close()
        m.close()


def test_port_root_lists_jax_children_and_answers_their_probes():
    """A JAX engine child (+50 ms skew) and a JAX device child under a port
    root: both are in the root's cluster view, and the skewed child's
    offset, learnt from the port root's replies, is within its uncertainty
    of the skew."""
    port = free_port()
    tmpl = {"w": np.zeros((128,), np.float32)}
    root = create_or_fetch("127.0.0.1", port, tmpl, _cfg(), device="cpu")
    kids = []
    try:
        jobs = JObsConfig(digest_interval_sec=0.1, clock_sync_interval_sec=0.1, clock_skew_sim_sec=0.05)
        for engine in (True, False):
            kids.append(jax_create_or_fetch("127.0.0.1", port, tmpl, JConfig(
                native_engine=engine, transport=JTransportConfig(peer_timeout_sec=15.0), obs=jobs)))
        _wait(lambda: all(str(k.node.obs_id) in root.metrics(cluster=True)["nodes"] for k in kids), timeout=30.0,
              msg="JAX children in the port root's view")
        _wait(lambda: all(k._clock.replies >= 3 for k in kids), timeout=30.0, msg="replies to JAX probes")
        for k in kids:
            assert abs(k._clock.offset_seconds - 0.05) <= k._clock.uncertainty_seconds
        assert root.metrics()["st_unknown_msgs_total"] == 0
    finally:
        for k in kids:
            k.close()
        root.close()


def test_jax_root_lists_port_children():
    """Port children (device tier and engine, -50 ms skew) under a JAX root:
    the JAX root's cluster view lists them, and their offsets, learnt from
    the JAX root's replies, are within their uncertainty of the skew."""
    port = free_port()
    tmpl = {"w": np.zeros((128,), np.float32)}
    root = jax_create_or_fetch("127.0.0.1", port, tmpl, JConfig(transport=JTransportConfig(peer_timeout_sec=15.0)))
    kids = []
    try:
        ocfg = ObsConfig(digest_interval_sec=0.1, clock_sync_interval_sec=0.1, clock_skew_sim_sec=-0.05)
        for tier in ("device", "engine"):
            kids.append(_peer(port, tmpl, tier, _cfg(ocfg)))
        _wait(lambda: all(str(k.node.obs_id) in root.metrics(cluster=True)["nodes"] for k in kids), timeout=30.0,
              msg="port children in the JAX root's view")
        _wait(lambda: all(k._clock.replies >= 3 for k in kids), timeout=30.0, msg="replies to port probes")
        for k in kids:
            assert abs(k._clock.offset_seconds + 0.05) <= k._clock.uncertainty_seconds
        doc = root.metrics(cluster=True)
        for k in kids:
            assert doc["nodes"][str(k.node.obs_id)]["m"]["st_wire_version"] == 2
    finally:
        for k in kids:
            k.close()
        root.close()
