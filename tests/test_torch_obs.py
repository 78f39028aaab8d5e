"""The port's observability plane on one peer and one process, against the
JAX package's where both compute the same thing.

- The registry: the same operations give equal snapshots and byte-identical
  Prometheus text; the JSONL sink.
- The schema: every JAX entry is kept; every ``st_*`` literal of the port's
  package is documented; every key a real port peer serves is in it.
- The native ring: its codes equal JAX's names and the ``kEv*`` constants of
  the native sources the port builds; the port's ring drains on the shared
  clock; it follows ``obs_enabled()``, and with it the engine's trace
  bookkeeping (``st_update_hops``), as a JAX engine peer's does.
- ``test_obs.py``'s peer cases on port peers (``device="cpu"`` and the host
  tiers): the Python tier's chaos timeline accounts for every injection,
  the native injector's events reach it, the three postmortem dumps,
  disabled is inert, the JSONL sink, the corrupt-scale counter.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu import obs as jax_obs
from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu.obs import events as jax_events
from shared_tensor_tpu.obs import schema as jax_schema
from shared_tensor_tpu_torch import Config, TransportConfig, _build, create_or_fetch, obs
from shared_tensor_tpu_torch.comm import faults, transport, wire
from shared_tensor_tpu_torch.comm.peer import SharedTensorPeer
from shared_tensor_tpu_torch.config import FaultConfig, ObsConfig
from shared_tensor_tpu_torch.obs import events as obs_events
from shared_tensor_tpu_torch.obs import schema
from tests._ports import free_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIERS = ("device", "engine", "host")


@pytest.fixture(scope="module", autouse=True)
def _built():
    build_native()
    transport._load()


def _cfg(fault: FaultConfig | None = None, engine: bool = True, obs_cfg: ObsConfig | None = None, **tkw):
    tkw.setdefault("peer_timeout_sec", 10.0)
    return Config(transport=TransportConfig(**tkw), faults=fault or FaultConfig(), native_engine=engine,
                  obs=obs_cfg or ObsConfig())


def _peer(port, template, tier, cfg=None, **kw):
    cfg = cfg or _cfg()
    if tier == "device":
        return SharedTensorPeer("127.0.0.1", port, template, cfg, device="cpu", **kw)
    return SharedTensorPeer("127.0.0.1", port, template, dataclasses.replace(cfg, native_engine=tier == "engine"),
                            host_tier=True, **kw)


def _fresh_hub():
    """The process's hub, drained and emptied, its postmortem rate limit
    reset (a parametrized case dumps for the same reason as the last)."""
    h = obs.hub()
    h.poll_native()
    h.recorder.clear()
    h._last_dump.clear()
    return h


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


# -- registry ---------------------------------------------------------------


def _drive(reg_mod, seed: int) -> tuple[dict, str]:
    """The same seeded operations on a registry of ``reg_mod``."""
    rng = np.random.default_rng(seed)
    r = reg_mod.Registry()
    c = r.counter("st_test_total", help="a counter")
    g = r.gauge("st_test_gauge", help="a gauge")
    h = r.histogram("st_test_seconds", help="latency")
    h2 = r.histogram("st_update_hops", buckets=(1, 2, 3, 4, 6, 8))
    for _ in range(200):
        c.inc(float(rng.integers(0, 4)))
        g.set(float(rng.normal()))
        h.observe(float(rng.exponential(0.01)))
        h2.observe(int(rng.integers(1, 10)))
    r.register_collector(lambda: {"st_pulled_total": 11, "st_pulled_gauge": 0.25,
                                  "st_pulled_seconds": {"sum": 1.5, "count": 3, "buckets": {0.1: 1, 1.0: 3}}})
    r.register_collector(lambda: 1 / 0)  # a failing collector must not take the scrape down
    return r.snapshot(), r.prometheus_text()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_text_equal_jax(seed):
    snap, text = _drive(obs, seed)
    jsnap, jtext = _drive(jax_obs, seed)
    assert snap == jsnap
    assert text == jtext
    assert "# TYPE st_test_seconds histogram" in text and 'st_test_seconds_bucket{le="+Inf"} 200' in text
    assert obs.LATENCY_BUCKETS == jax_obs.LATENCY_BUCKETS
    r = obs.Registry()
    assert r.counter("st_x_total") is r.counter("st_x_total")
    with pytest.raises(TypeError):
        r.gauge("st_x_total")
    with pytest.raises(ValueError):
        r.counter("st_y_total").inc(-1)


def test_registry_jsonl_sink(tmp_path):
    r = obs.Registry()
    r.counter("st_s_total").inc(2)
    path = str(tmp_path / "metrics.jsonl")
    r.start_jsonl_sink(path, interval_sec=0.05)
    time.sleep(0.2)
    r.stop_jsonl_sink()
    lines = [json.loads(line) for line in open(path) if line.strip()]
    assert lines and all(x["metrics"]["st_s_total"] == 2 for x in lines)
    assert lines[-1]["t_ns"] <= time.monotonic_ns()


# -- schema -----------------------------------------------------------------


def test_schema_keeps_jax_entries():
    """Every JAX name with its kind; the help text too, except the two
    latency histograms', which say what they time on the port's tiers."""
    for name, (kind, help_) in jax_schema.SCHEMA.items():
        assert schema.SCHEMA[name][0] == kind, name
        if name not in ("st_encode_seconds", "st_apply_seconds"):
            assert schema.SCHEMA[name][1] == help_, name
    assert schema.PROCESS_GLOBAL == jax_schema.PROCESS_GLOBAL
    assert schema.link_key("st_link_send_queue", 3) == jax_schema.link_key("st_link_send_queue", 3)
    assert schema.label_key("st_slo_burn_rate", "window", "page") == 'st_slo_burn_rate{window="page"}'


def _native_symbols() -> set[str]:
    """The functions the port's native sources (csrc/ and its native copies) export."""
    out = set()
    csrc = ROOT / "shared_tensor_tpu_torch" / "csrc"
    for path in [*csrc.glob("*.cu"), *_build.PORT_NATIVE_DIR.glob("*.c*")]:
        out.update(re.findall(r"\b(st_[a-z0-9_]+)\s*\(", path.read_text(errors="replace")))
    return out


#: st_ literals of the package that name no metric and no native symbol.
NON_METRICS = {"st_mesh_": "the pod tier's temporary directory prefix (parallel/mesh.py)",
               "st_trace": "the Chrome trace_event category of update flows (obs/trace_export.py)",
               "st_ctl": "the operator CLI's default command directory, JAX's name (ctl.py)"}
#: st_ prefixes of names built by formatting that are no metric names.
DYNAMIC_NON_METRICS = {"st_postmortem_": "the postmortem file name (obs/recorder.py)"}


def test_schema_lint_every_emitted_st_name_is_documented():
    """Every quoted ``st_*`` literal under shared_tensor_tpu_torch/ is a
    schema name, a native function the package binds, or one of the few
    named non-metrics; and no metric name is built by formatting."""
    pat = re.compile(r"""["'](st_[a-z0-9_]+)["']""")
    dyn = re.compile(r"""[fF]["']st_[a-zA-Z0-9_]*\{""")
    symbols = _native_symbols()
    emitted: dict[str, set[str]] = {}
    for path in (ROOT / "shared_tensor_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for name in pat.findall(text):
            emitted.setdefault(name, set()).add(str(path.relative_to(ROOT)))
        built = [m for m in dyn.findall(text) if m[2:-1] not in DYNAMIC_NON_METRICS]
        assert not built, f"{path}: an st_ name built by formatting: {built}"
    undocumented = {n: sorted(f) for n, f in emitted.items()
                    if n not in schema.SCHEMA and n not in symbols and n not in NON_METRICS}
    assert not undocumented, undocumented
    assert set(NON_METRICS) <= set(emitted)  # the allowlist stays honest
    for must in ("st_staleness_seconds", "st_update_hops", "st_cluster_nodes", "st_apply_dropped_total"):
        assert must in emitted


@pytest.mark.parametrize("tier", TIERS)
def test_schema_covers_real_metrics_shape(tier):
    """Every key a port peer's metrics() serves, on each tier, with a child
    and traffic, is a schema name (labels stripped)."""
    port = free_port()
    tmpl = np.zeros((512,), np.float32)
    m = _peer(port, tmpl, tier)
    c = None
    try:
        m.wait_ready(30.0)
        c = _peer(port, tmpl, tier)
        c.wait_ready(30.0)
        c.add(np.ones((512,), np.float32))
        _wait(lambda: np.allclose(m.read().numpy(), 1.0, atol=1e-5), msg="sync")
        for p in (m, c):
            keys = {k.split("{", 1)[0] for k in p.metrics()}
            assert keys - set(schema.SCHEMA) == set(), keys - set(schema.SCHEMA)
            assert {"st_frames_out_total", "st_residual_norm", "st_wire_version"} <= keys
        assert "st_ack_rtt_seconds" in c.metrics()
        if tier != "engine":
            assert c.metrics()["st_ack_rtt_seconds"]["count"] >= 1
            assert c.metrics()["st_encode_seconds"]["count"] >= 1 and m.metrics()["st_apply_seconds"]["count"] >= 1
            assert m.metrics()["st_update_hops"]["count"] >= 1
    finally:
        if c is not None:
            c.close()
        m.close()


# -- the native ring --------------------------------------------------------


def test_native_ring_codes_match_jax_and_the_native_sources():
    assert obs_events.CODE_NAMES == jax_events.CODE_NAMES
    assert obs_events.EVENT_BYTES == 32
    for kind in transport.EventKind:
        assert obs_events.CODE_NAMES[int(kind)] == {1: "link_up", 2: "link_down", 3: "became_master",
                                                    4: "isolated"}[int(kind)]
    for names in ("LIFECYCLE_EVENT_NAMES", "HEALTH_EVENT_NAMES", "RESHARD_EVENT_NAMES", "FAULT_EVENT_NAMES"):
        assert getattr(obs_events, names) == getattr(jax_events, names)
    # every code the native sources emit has its name here
    # (those of the port's own copies, which it builds)
    for src in (_build.PORT_NATIVE_DIR / "sttransport.cpp", _build.PORT_NATIVE_DIR / "stengine.cpp"):
        consts = re.findall(r"constexpr uint32_t kEv(?!RingCap)\w+ = (\d+);", src.read_text())
        assert consts
        for code in consts:
            assert int(code) in obs_events.CODE_NAMES, (src, code)


def test_native_ring_emit_drain_and_clock_agreement():
    lib = transport._load()
    obs_events.drain_native(lib=lib)
    t_py = time.monotonic_ns()
    t_c = obs_events.native_now_ns(lib=lib)
    assert abs(t_c - t_py) < 250_000_000
    lib.st_obs_emit(42, 14, 3, 1234)
    lib.st_obs_emit(42, 10, 3, 2)
    mine = [e for e in obs_events.drain_native(lib=lib) if e.node == 42]
    assert [e.name for e in mine] == ["dedup_discard", "retransmit"]
    assert mine[0].link == 3 and mine[0].arg == 1234 and all(e.tier == "c" for e in mine)
    assert t_py - 1_000_000 <= mine[0].t_ns <= time.monotonic_ns()
    assert not [e for e in obs_events.drain_native(lib=lib) if e.node == 42]
    assert obs_events.native_dropped(lib=lib) >= 0


_HOPS_SCRIPT = """
import json, socket, time, numpy as np
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0))
t = np.zeros(4096, np.float32)
m = create_or_fetch("127.0.0.1", port, t, cfg, host_tier=True)
c = create_or_fetch("127.0.0.1", port, t, cfg, host_tier=True)
m.add(np.random.default_rng(0).uniform(-1, 1, 4096).astype(np.float32))
deadline = time.time() + 30
while time.time() < deadline and not c.metrics()["st_frames_in_total"]:
    time.sleep(0.05)
m.drain(timeout=30.0, tol=1e-30)
time.sleep(0.3)
out = {k: c.metrics().get(k) for k in ("st_update_hops_count", "st_update_hops_sum", "st_traced_msgs_in_total",
                                        "st_frames_in_total")}
c.close(); m.close()
print(json.dumps(out))
"""


@pytest.mark.parametrize("st_obs", ["1", "0"])
def test_engine_trace_bookkeeping_follows_st_obs(st_obs):
    """In a process of its own: the port's engine child counts hops of the
    traced messages it applies unless ``ST_OBS=0`` (the native ring's flag,
    which the transport sets at load from ``obs_enabled()``)."""
    env = dict(os.environ, ST_OBS=st_obs, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _HOPS_SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["st_frames_in_total"] > 0
    if st_obs == "1":
        assert got["st_update_hops_count"] > 0 and got["st_traced_msgs_in_total"] > 0
        assert got["st_update_hops_sum"] == got["st_update_hops_count"]  # one hop from the master
    else:
        assert got["st_update_hops_count"] == 0 and got["st_traced_msgs_in_total"] == 0


def test_engine_peer_reports_hops_as_a_jax_engine_peer_does():
    """The same traffic (a master's seeded update to one engine child) on a
    port pair and a JAX pair: both children count one-hop traced messages
    in ``st_update_hops``."""
    upd = np.random.default_rng(5).uniform(-1, 1, 4096).astype(np.float32)
    got = {}
    for impl in ("port", "jax"):
        port = free_port()
        t = np.zeros(4096, np.float32)
        if impl == "port":
            mk = lambda: create_or_fetch("127.0.0.1", port, t, _cfg(), host_tier=True)  # noqa: E731
        else:
            mk = lambda: jax_create_or_fetch(  # noqa: E731
                "127.0.0.1", port, t, JConfig(transport=JTransportConfig(peer_timeout_sec=10.0)))
        m = mk()
        c = mk()
        try:
            assert m._engine is not None and c._engine is not None
            m.add(upd)
            _wait(lambda: np.allclose(np.asarray(c.read()), upd, atol=1e-5), msg=f"{impl} child")
            mm = c.metrics()
            got[impl] = (mm["st_update_hops_count"], mm["st_update_hops_sum"], mm["st_traced_msgs_in_total"])
        finally:
            c.close()
            m.close()
    for impl, (count, total, traced) in got.items():
        assert count > 0 and total == count and traced == count, (impl, got)


# -- the flight recorder under chaos ----------------------------------------


def test_python_tier_chaos_timeline_accounts_every_injection():
    """On port peers of the Python host tier: every injected drop, dup and
    sever is on the merged timeline, in time order across the two tiers,
    and the native LINK_UP precedes its Python-tier twin."""
    hub = _fresh_hub()
    port = free_port()
    n = 512
    seed = np.zeros((n,), np.float32)
    fc = FaultConfig(enabled=True, seed=8, drop_pct=0.15, dup_pct=0.15, sever_after_frames=25, only_link=1)
    m = _peer(port, seed, "host", _cfg(engine=False))
    c = None
    try:
        m.wait_ready(30.0)
        c = _peer(port, seed, "host", _cfg(fc, engine=False, ack_timeout_sec=0.5))
        c.wait_ready(30.0)
        total = np.zeros(n, np.float64)
        rng = np.random.default_rng(0)
        for _ in range(40):
            d = rng.uniform(-0.5, 0.5, n).astype(np.float32)
            c.add(d)
            total += d
            time.sleep(0.01)
        _wait(lambda: np.allclose(m.read().numpy(), total, atol=1e-4), timeout=60.0, msg="reconvergence")
        injected = dict(c._faults.counts)
        assert injected.get("severed", 0) >= 1 and injected.get("dropped", 0) >= 1
        assert injected.get("duplicated", 0) >= 1, injected
        hub.poll_native()
        counts = hub.recorder.counts
        assert counts["fault_drop"] == injected["dropped"]
        assert counts["fault_dup"] == injected["duplicated"]
        assert counts["fault_sever"] == injected["severed"]
        timeline = hub.recorder.timeline()
        assert {e.tier for e in timeline} == {"c", "py"}
        assert [e.t_ns for e in timeline] == sorted(e.t_ns for e in timeline)
        c_up = min(e.t_ns for e in timeline if e.tier == "c" and e.name == "link_up")
        py_up = min(e.t_ns for e in timeline if e.tier == "py" and e.name == "link_up")
        assert c_up < py_up and counts["link_down"] >= 1
    finally:
        if c is not None:
            c.close()
        m.close()


def test_native_tier_chaos_events_reach_the_timeline(monkeypatch):
    """The native injector (``ST_FAULT_PLAN``) under a port engine peer puts
    its drops, and the retransmissions that repair them, on the ring."""
    hub = _fresh_hub()
    port = free_port()
    n = 4096
    seed = np.zeros((n,), np.float32)
    m = create_or_fetch("127.0.0.1", port, seed, _cfg(ack_timeout_sec=0.5), host_tier=True)
    env = faults.to_env(FaultConfig(enabled=True, seed=9, drop_pct=0.3, only_link=1))
    monkeypatch.setenv("ST_FAULT_PLAN", env["ST_FAULT_PLAN"])
    try:
        c = create_or_fetch("127.0.0.1", port, seed, _cfg(ack_timeout_sec=0.5), host_tier=True)
    finally:
        monkeypatch.delenv("ST_FAULT_PLAN")
    try:
        total = np.zeros(n, np.float64)
        rng = np.random.default_rng(1)
        for _ in range(30):
            d = rng.uniform(-0.5, 0.5, n).astype(np.float32)
            c.add(d)
            total += d
            time.sleep(0.01)
        _wait(lambda: np.allclose(m.read().numpy(), total, atol=1e-4), timeout=60.0, msg="reconvergence")
        hub.poll_native()
        counts = hub.recorder.counts
        assert counts["fault_drop"] >= 1 and counts["retransmit"] >= 1, dict(counts)
        drops = [e for e in hub.recorder.timeline() if e.name == "fault_drop"]
        assert all(e.tier == "c" and e.link == 1 for e in drops)
    finally:
        c.close()
        m.close()


# -- postmortems ------------------------------------------------------------


def test_crash_point_dumps_postmortem(tmp_path, monkeypatch):
    monkeypatch.setenv("ST_OBS_POSTMORTEM_DIR", str(tmp_path))
    exits = []
    monkeypatch.setattr(faults.os, "_exit", lambda code: exits.append(code))
    hub = _fresh_hub()
    hub.emit("link_up", node=1, link=1)
    reg = obs.Registry()
    reg.counter("st_test_total").inc(3)
    hub.register_registry("test-peer", reg)
    try:
        faults.FaultPlan(FaultConfig(enabled=True, crash_point="mid-burst")).point("mid-burst")
        assert exits == [faults.CRASH_EXIT_CODE]
        dumps = list(tmp_path.glob("st_postmortem_*crash_point*.json"))
        assert len(dumps) == 1
        doc = json.loads(dumps[0].read_text())
        assert doc["reason"] == "crash_point:mid-burst"
        assert doc["registries"]["test-peer"]["st_test_total"] == 3
        names = [e["name"] for e in doc["timeline"]]
        assert "link_up" in names and "crash_point" in names and doc["event_counts"]["crash_point"] == 1
        assert [e["t_ns"] for e in doc["timeline"]] == sorted(e["t_ns"] for e in doc["timeline"])
    finally:
        hub.unregister_registry("test-peer")


@pytest.mark.parametrize("tier", TIERS)
def test_recv_thread_exception_dumps_postmortem(tier, tmp_path, monkeypatch):
    monkeypatch.setenv("ST_OBS_POSTMORTEM_DIR", str(tmp_path))
    _fresh_hub()
    m = _peer(free_port(), np.zeros((256,), np.float32), tier)
    try:
        boom = {"armed": True}
        orig = m._handle_events

        def exploding():
            if boom.pop("armed", False):
                raise RuntimeError("injected recv-thread failure")
            return orig()

        monkeypatch.setattr(m, "_handle_events", exploding)
        _wait(lambda: list(tmp_path.glob("st_postmortem_*recv_thread*")), timeout=15.0, msg="postmortem")
        doc = json.loads(list(tmp_path.glob("st_postmortem_*recv_thread*"))[0].read_text())
        assert doc["reason"] == "recv_thread_exception"
        assert f"peer-{m.node.obs_id}" in doc["registries"]
        _wait(lambda: m.threads_alive() and m.metrics()["st_recv_restarts_total"] == 1, msg="the restart")
    finally:
        m.close()


@pytest.mark.parametrize("tier", ["device", "host"])
def test_goback_teardown_dumps_postmortem(tier, tmp_path, monkeypatch):
    monkeypatch.setenv("ST_OBS_POSTMORTEM_DIR", str(tmp_path))
    hub = _fresh_hub()
    port = free_port()
    seed = np.zeros((256,), np.float32)
    fc = FaultConfig(enabled=True, stall_after_frames=0, only_link=1)
    m = _peer(port, seed, tier, _cfg(engine=False))
    c = None
    try:
        m.wait_ready(30.0)
        c = _peer(port, seed, tier, _cfg(fc, engine=False, ack_timeout_sec=0.2, ack_retry_limit=2))
        c.wait_ready(30.0)
        c.add(np.ones((256,), np.float32))
        _wait(lambda: list(tmp_path.glob("st_postmortem_*goback*")), timeout=30.0, msg="teardown postmortem")
        assert hub.recorder.counts["blackhole_teardown"] >= 1 and hub.recorder.counts["fault_stall"] >= 1
        assert hub.recorder.counts["retransmit"] >= 1
    finally:
        if c is not None:
            c.close()
        m.close()


# -- switches ---------------------------------------------------------------


def test_obs_disabled_is_inert():
    was = obs.obs_enabled()
    obs.set_enabled(False)
    try:
        hub = obs.hub()
        hub.recorder.clear()
        hub.emit("link_up", node=1)
        assert not hub.recorder.counts
        assert hub.dump("disabled-test") is None
        m = create_or_fetch("127.0.0.1", free_port(), np.zeros((64,), np.float32), _cfg(), device="cpu")
        try:
            assert m._obs is None
            assert "st_frames_out_total" in m.metrics()  # the collector serves the schema alone
            assert isinstance(m.metrics(cluster=True), dict)
        finally:
            m.close()
        lib = transport._load()
        obs_events.drain_native(lib=lib)
        lib.st_obs_emit(99, 14, 1, 1)
        assert not [e for e in obs_events.drain_native(lib=lib) if e.node == 99]
    finally:
        obs.set_enabled(was)


@pytest.mark.parametrize("tier", TIERS)
def test_peer_obs_config_disabled(tier):
    m = _peer(free_port(), np.zeros((64,), np.float32), tier, _cfg(obs_cfg=ObsConfig(enabled=False)))
    try:
        m.wait_ready(30.0)
        assert m._obs is None
        assert "st_frames_out_total" in m.metrics() and "st_apply_seconds" not in m.metrics()
        assert f"peer-{m.node.obs_id}" not in obs.hub()._registries
    finally:
        m.close()


def test_jsonl_sink_config_wires_through(tmp_path):
    path = str(tmp_path / "peer_metrics.jsonl")
    cfg = _cfg(obs_cfg=ObsConfig(jsonl_path=path, jsonl_interval_sec=0.05))
    m = create_or_fetch("127.0.0.1", free_port(), np.zeros((64,), np.float32), cfg, device="cpu")
    try:
        _wait(lambda: os.path.exists(path) and os.path.getsize(path) > 0, timeout=10.0, msg="jsonl output")
    finally:
        m.close()
    lines = [json.loads(line) for line in open(path) if line.strip()]
    assert lines and "st_frames_out_total" in lines[-1]["metrics"]


def test_corrupt_scale_counter():
    from shared_tensor_tpu_torch.ops.table import make_spec

    before = wire.corrupt_scales_zeroed()
    spec = make_spec(np.zeros(64, np.float32))
    frame = b"\x00" + b"\x01\x00\x00\x00" + np.full(spec.num_leaves, np.inf, "<f4").tobytes() + \
        b"\x00" * (4 * (spec.total // 32))
    f = wire.decode_frame(frame, spec)
    assert float(np.asarray(f.scales)[0]) == 0.0
    assert wire.corrupt_scales_zeroed() == before + 1
    m = create_or_fetch("127.0.0.1", free_port(), np.zeros((64,), np.float32), _cfg(), device="cpu")
    try:
        assert m.metrics()["st_corrupt_scales_zeroed_total"] == wire.corrupt_scales_zeroed()
    finally:
        m.close()


def test_shm_fallback_is_on_the_timeline(monkeypatch):
    """A parent whose lane segment cannot be served keeps TCP, counts it,
    and puts a shm_fallback event on the timeline."""
    hub = _fresh_hub()
    port = free_port()
    tmpl = np.zeros((256,), np.float32)
    m = create_or_fetch("127.0.0.1", port, tmpl, _cfg(), device="cpu")
    monkeypatch.setattr(m.node, "shm_serve", lambda link, ring_bytes: (None, -2))
    c = create_or_fetch("127.0.0.1", port, tmpl, _cfg(), device="cpu")
    try:
        assert m.metrics()["st_shm_fallback_total"] == 1
        ev = [e for e in hub.recorder.timeline() if e.name == "shm_fallback"]
        assert len(ev) == 1 and ev[0].arg == -2 and ev[0].node == m.node.obs_id and ev[0].detail
    finally:
        c.close()
        m.close()
