"""The port's fleet-health plane against the JAX package's: the clock-offset
estimator, the digest time series, the health analyzer and ``obs.top``'s
renderer, fed the same seeded inputs, give the same estimates, the same
documents, the same alert events and the same text. No sockets: the peers'
clock probe is in test_torch_obs_cluster.py."""

import json

import numpy as np
import pytest

from shared_tensor_tpu.obs import top as jax_top
from shared_tensor_tpu.obs.clock import ClockSync as JaxClockSync
from shared_tensor_tpu.obs.health import HealthAnalyzer as JaxHealthAnalyzer
from shared_tensor_tpu.obs.timeseries import TimeSeriesStore as JaxStore
from shared_tensor_tpu.obs.timeseries import hist_quantile as jax_hist_quantile
from shared_tensor_tpu_torch.obs import top
from shared_tensor_tpu_torch.obs.clock import ClockSync
from shared_tensor_tpu_torch.obs.events import HEALTH_EVENT_NAMES
from shared_tensor_tpu_torch.obs.health import HealthAnalyzer
from shared_tensor_tpu_torch.obs.timeseries import TimeSeriesStore, hist_quantile

S = int(1e9)  # one second in ns


def _doc(nodes: dict, counters: dict | None = None, truncated: int = 0, hists: dict | None = None) -> dict:
    """A digest document in aggregate.py's shape."""
    return {
        "v": 1,
        "nodes": {str(nid): {"t_ns": 0, "m": dict(m)} for nid, m in nodes.items()},
        "counters": dict(counters or {}),
        "hists": dict(hists or {}),
        "gmax": {},
        "gmin": {},
        "proc": {},
        "truncated": truncated,
    }


def _hist(rng) -> dict:
    cum, b = 0, {}
    for bound in (1e-4, 1e-3, 1e-2, 0.1, 1.0):
        cum += int(rng.integers(0, 20))
        b[str(bound)] = cum
    return {"sum": float(rng.uniform(0, 5)), "count": cum + int(rng.integers(0, 3)), "buckets": b}


def _beats(scenario: str, seed: int = 0) -> list[tuple[dict, int]]:
    """A seeded sequence of (digest, t_ns) beats of one kind."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i in range(40):
        t += S // 5
        if scenario == "slo":
            # healthy, a stall that blows the objective, then recovery
            stale = 5.0 if 10 <= i < 25 else float(rng.uniform(0.0, 0.3))
            d = _doc({1: {"st_staleness_seconds": stale}}, {"st_frames_in_total": 10 * i})
        elif scenario == "heat":
            # shard 1 takes ten times the writes of shards 0 and 2
            nodes = {nid: {f'st_shard_heat_applies{{shard="{k}"}}': float(r * i),
                           f'st_shard_heat_outbox_bytes{{shard="{k}"}}': float(rng.integers(0, 1000)),
                           "st_shard_alloc_bytes": float(1000 + 10 * nid)}
                     for nid, (k, r) in {10: (0, 10), 11: (1, 100), 12: (2, 10)}.items()}
            d = _doc(nodes, {"st_updates_total": i})
        elif scenario == "staleness":
            # offsets, uncertainties and per-link origins: the correction
            nodes = {
                0: {"st_clock_offset_seconds": 0.0, "st_clock_uncertainty_seconds": 0.0},
                5: {"st_clock_offset_seconds": 0.05, "st_clock_uncertainty_seconds": 0.001,
                    'st_staleness_seconds{link="1"}': float(rng.uniform(0, 0.2)), 'st_staleness_origin{link="1"}': 0,
                    'st_staleness_seconds{link="2"}': float(rng.uniform(0, 2)), 'st_staleness_origin{link="2"}': 6},
                6: {"st_clock_offset_seconds": -0.05, "st_clock_uncertainty_seconds": 0.002,
                    'st_staleness_seconds{link="1"}': float(rng.uniform(0, 1.5)), 'st_staleness_origin{link="1"}': 9},
            }
            d = _doc(nodes, hists={"st_apply_seconds": _hist(rng)})
        else:  # truncated breakdowns and counter resets
            d = _doc({3: {"st_frames_in_total": float(i % 7)}}, {"st_frames_in_total": (i % 13) * 5},
                     truncated=int(i > 20))
        out.append((d, t))
    return out


@pytest.mark.parametrize("scenario", ["slo", "heat", "staleness", "truncated"])
def test_health_analyzer_documents_and_events_equal_jax(scenario, tmp_path):
    ev_p, ev_j = [], []
    kw = dict(objective_sec=1.0, budget=0.05, windows=(("page", 4.0, 1.0, 2.0), ("ticket", 8.0, 2.0, 1.5)))
    a = HealthAnalyzer(path=str(tmp_path / "port.json"), emit=lambda *e: ev_p.append(e), **kw)
    b = JaxHealthAnalyzer(path=str(tmp_path / "jax.json"), emit=lambda *e: ev_j.append(e), **kw)
    for d, t in _beats(scenario):
        assert a.beat(json.loads(json.dumps(d)), t) == b.beat(d, t)
        assert a.metrics() == b.metrics()
    assert ev_p == ev_j
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    if scenario == "slo":
        names = [e[0] for e in ev_p]
        assert names.count("slo_alert_fire") >= 1 and names.count("slo_alert_clear") >= 1
        assert {"slo_alert_fire", "slo_alert_clear"} <= HEALTH_EVENT_NAMES
    if scenario == "heat":
        assert a.doc()["heat"]["hot_shard"] == 1
    if scenario == "staleness":
        w = a.doc()["staleness"]["nodes"]["5"]
        assert w["unc_sec"] is not None


def test_health_json_written_atomically(tmp_path):
    path = tmp_path / "health.json"
    a = HealthAnalyzer(path=str(path))
    a.beat(_doc({1: {"st_staleness_seconds": 0.2}}), S)
    doc = json.loads(path.read_text())
    assert doc["v"] == 1 and doc["beats"] == 1
    assert "slo" in doc and "heat" in doc and "staleness" in doc
    assert not list(tmp_path.glob("*.tmp.*"))


@pytest.mark.parametrize("scenario", ["slo", "heat", "staleness", "truncated"])
def test_timeseries_store_equals_jax(scenario):
    a, b = TimeSeriesStore(max_points=16, max_series=24), JaxStore(max_points=16, max_series=24)
    for d, t in _beats(scenario, seed=3):
        a.ingest(d, t)
        b.ingest(d, t)
    assert sorted(a.keys(), key=repr) == sorted(b.keys(), key=repr)
    assert (a.beats, a.evicted, len(a)) == (b.beats, b.evicted, len(b))
    for k in a.keys():
        assert a.values(k) == b.values(k)
        for w in (0.5, 2.0, 30.0):
            assert a.rate(k, w) == b.rate(k, w) >= 0.0


def test_hist_quantile_equals_jax():
    rng = np.random.default_rng(7)
    for _ in range(20):
        h = _hist(rng)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert hist_quantile(h, q) == jax_hist_quantile(h, q)
    assert hist_quantile({"count": 0, "buckets": {}}, 0.5) == 0.0


def _exchange(child, parent, t, up_ns, down_ns):
    probe = child.probe_payload()
    t["now"] += up_ns
    reply = parent.reply_payload(probe)
    t["now"] += down_ns
    return child.on_reply(reply)


@pytest.mark.parametrize("skew_ms", [50, -50, 0])
def test_clock_sync_estimates_equal_jax(skew_ms):
    """Two estimator chains (root <- child <- grandchild), the port's and
    JAX's, fed the same stamps (seeded transit times, the child's clock
    skewed): the same offset and uncertainty after every reply, and the
    skew recovered within the reported uncertainty."""
    rng = np.random.default_rng(11)
    skew = skew_ms * 1_000_000
    t = {"now": 0}
    chains = []
    for cls in (ClockSync, JaxClockSync):
        root = cls(lambda: t["now"], is_root=True)
        child = cls(lambda: t["now"] + skew)
        grand = cls(lambda: t["now"] + 2 * skew)
        chains.append((root, child, grand))
    for _ in range(12):
        up, down = (int(x) for x in rng.integers(50_000, 2_000_000, 2))
        got = []
        for root, child, grand in chains:
            t0 = t["now"]
            ok1 = _exchange(child, root, t, up, down)
            ok2 = _exchange(grand, child, t, down, up)
            t["now"] = t0  # the second chain sees the same stamps
            got.append((ok1, ok2, child.known, child.offset_ns, child.uncertainty_ns, grand.known,
                        grand.offset_ns, grand.uncertainty_ns, child.probes, child.replies))
        assert got[0] == got[1]
        t["now"] += up + down + up + down
    _, child, grand = chains[0]
    assert abs(child.offset_ns - skew) <= child.uncertainty_ns
    assert abs(grand.offset_ns - 2 * skew) <= grand.uncertainty_ns


def test_unconverged_parent_is_skipped():
    t = {"now": 0}
    parent = ClockSync(lambda: t["now"])  # not a root: no estimate yet
    child = ClockSync(lambda: t["now"])
    reply = parent.reply_payload(child.probe_payload())
    assert "off_ns" not in reply
    assert not child.on_reply(reply) and not child.known


def test_top_render_with_health_and_store_equals_jax():
    """``obs.top``'s frame with the SLO row, the heat table and the
    sparklines is JAX's, character for character."""
    a, b = TimeSeriesStore(), JaxStore()
    ha, hb = HealthAnalyzer(windows=(("page", 4.0, 1.0, 2.0),)), JaxHealthAnalyzer(windows=(("page", 4.0, 1.0, 2.0),))
    beats = _beats("heat") + [(_doc({1: {"st_staleness_seconds": 3.0}}, {"st_frames_in_total": 9}), 41 * S // 5)]
    prev = None
    for d, t in beats:
        a.ingest(d, t)
        b.ingest(d, t)
        health = ha.beat(d, t)
        assert health == hb.beat(d, t)
        assert top.render(d, prev, 0.2, health=health, store=a) == jax_top.render(d, prev, 0.2, health=health, store=b)
        prev = d
    trunc = _doc({1: {"st_frames_in_total": 5.0}}, {"st_frames_in_total": 10}, truncated=3)
    out = top.render(trunc, None, 0.0)
    assert out == jax_top.render(trunc, None, 0.0)
    assert "3 node breakdown(s) TRUNCATED" in out
