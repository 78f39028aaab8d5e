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


def _doc(nodes: dict, counters: dict | None = None, truncated: int = 0, hists: dict | None = None,
         t_ns: int = 0) -> dict:
    """A digest document in aggregate.py's shape, every node sampled at
    ``t_ns``."""
    return {
        "v": 1,
        "nodes": {str(nid): {"t_ns": t_ns, "m": dict(m)} for nid, m in nodes.items()},
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
    """A seeded sequence of (digest, t_ns) beats of one kind, each node's
    digest sampled at its beat (where the port's store, which files a node
    at its digest's own sample time, and JAX's, which files it at the beat,
    agree)."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i in range(40):
        t += S // 5
        if scenario == "slo":
            # healthy, a stall that blows the objective, then recovery
            stale = 5.0 if 10 <= i < 25 else float(rng.uniform(0.0, 0.3))
            d = _doc({1: {"st_staleness_seconds": stale}}, {"st_frames_in_total": 10 * i}, t_ns=t)
        elif scenario == "heat":
            # shard 1 takes ten times the writes of shards 0 and 2
            nodes = {nid: {f'st_shard_heat_applies{{shard="{k}"}}': float(r * i),
                           f'st_shard_heat_outbox_bytes{{shard="{k}"}}': float(rng.integers(0, 1000)),
                           "st_shard_alloc_bytes": float(1000 + 10 * nid)}
                     for nid, (k, r) in {10: (0, 10), 11: (1, 100), 12: (2, 10)}.items()}
            d = _doc(nodes, {"st_updates_total": i}, t_ns=t)
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
            d = _doc(nodes, hists={"st_apply_seconds": _hist(rng)}, t_ns=t)
        else:  # truncated breakdowns and counter resets
            d = _doc({3: {"st_frames_in_total": float(i % 7)}}, {"st_frames_in_total": (i % 13) * 5},
                     truncated=int(i > 20), t_ns=t)
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
    beats = _beats("heat") + [(_doc({1: {"st_staleness_seconds": 3.0}}, {"st_frames_in_total": 9}, t_ns=41 * S // 5),
                               41 * S // 5)]
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


# -- a node's series at its digest's own sample time (the port's divergence) ----------------

APPLIES = 'st_shard_heat_applies{{shard="{}"}}'


def _aged(nodes: dict, beat_ns: int) -> dict:
    """A digest at ``beat_ns`` whose node entries were sampled ``age_ms``
    before it: ``nodes`` maps node id -> (age_ms, metrics)."""
    d = _doc({})
    d["nodes"] = {str(n): {"t_ns": beat_ns - int(age * 1e6), "m": dict(m)} for n, (age, m) in nodes.items()}
    return d


def test_a_node_series_is_filed_at_its_digests_own_sample_time():
    """Each node at its entry's ``t_ns`` less its clock offset to the root;
    the cluster series at the beat; an entry without a sample time at the
    beat."""
    st = TimeSeriesStore()
    d = _aged({7: (150.0, {"st_frames_in_total": 4.0, "st_clock_offset_seconds": 0.02}),
               8: (30.0, {"st_frames_in_total": 9.0})}, 5 * S)
    d["counters"] = {"st_updates_total": 3}
    d["nodes"]["9"] = {"m": {"st_frames_in_total": 1.0}}
    st.ingest(d, 5 * S)
    assert st.series(("node", 7, "st_frames_in_total")).points() == [(5 * S - 150_000_000 - 20_000_000, 4.0)]
    assert st.series(("node", 8, "st_frames_in_total")).points() == [(5 * S - 30_000_000, 9.0)]
    assert st.series(("node", 9, "st_frames_in_total")).points() == [(5 * S, 1.0)]
    assert st.series(("cluster", "st_updates_total")).points() == [(5 * S, 3.0)]


def test_a_digest_that_did_not_advance_adds_no_point():
    """A child digest merged again at the next beat (no newer one arrived)
    adds nothing to the node's series, so its rate is the rate its samples
    show; JAX's store files it again at the new beat, a flat step that
    halves the rate."""
    port, jax_store = TimeSeriesStore(), JaxStore()
    fresh = [_aged({4: (0.0, {"c": 0.0})}, 0), _aged({4: (0.0, {"c": 20.0})}, S // 5)]
    beats = [(fresh[0], 0), (fresh[1], S // 5), (fresh[1], 2 * S // 5)]  # beat 3 re-merges beat 2's digest
    for d, t in beats:
        port.ingest(d, t)
        jax_store.ingest(d, t)
    assert len(port.series(("node", 4, "c"))) == 2 and len(jax_store.series(("node", 4, "c"))) == 3
    assert port.node_rate(4, "c", 2.0) == pytest.approx(100.0)
    assert jax_store.node_rate(4, "c", 2.0) == pytest.approx(50.0)


def test_heat_names_the_hot_shard_through_jittering_digest_ages():
    """A loaded run of the fleet-health heat phase, its digests as the root
    read them (ages in ms at each beat, each owner's applies): shard 1's
    owner's digest was 231.5 ms old at beat 4 and 25.1 ms at beat 5, so at
    the beat its 24 applies came over 406 ms, not 200. Filed at their own
    sample times the rates name shard 2 at beat 5 (3.3x the rest); JAX's
    analyzer, filing at the beat, read 2.7x there and named it a beat
    later."""
    trace = [
        {39: (0.3, {0: 3}), 38: (202.5, {}), 37: (197.7, {})},
        {39: (0.3, {0: 47}), 38: (231.5, {1: 12}), 37: (218.6, {2: 64})},
        {39: (1.7, {0: 61}), 38: (25.1, {1: 36}), 37: (208.7, {2: 136})},
        {39: (0.3, {0: 84}), 38: (23.7, {1: 36}), 37: (177.4, {2: 274})},
    ]
    port, jax_a = HealthAnalyzer(), JaxHealthAnalyzer()
    named = {"port": [], "jax": []}
    for i, beat in enumerate(trace):
        t = (3 + i) * S // 5
        d = _aged({n: (age, {APPLIES.format(k): float(v) for k, v in m.items()}) for n, (age, m) in beat.items()}, t)
        named["port"].append(port.beat(d, t)["heat"]["hot_shard"])
        named["jax"].append(jax_a.beat(json.loads(json.dumps(d)), t)["heat"]["hot_shard"])
    assert named["port"][2:] == [2, 2]
    assert named["jax"][2:] == [-1, 2]
