"""The port's timelines against the protocol model both packages are held
to (``tools/protospec``, reached by path as the root benches reach it).

- ``ObsHub.export_timeline``: the same seeded events, recorded by the JAX
  package's hub and by the port's, export equal documents, and the port's
  loads with ``protospec.conformance.load_timeline``.
- Live timelines: a three-node tree of port engine peers and a three-node
  tree of port device-tier peers (``device="cpu"``), each with one
  subscriber below its master, replay through ``check_timeline`` with no
  violation and at least one routed event (the gate of the port's chaos
  benches, ``shared_tensor_tpu_torch.benchmarks.conformance``).
- A copy of the engine tree's timeline with one forbidden ordering put in
  (a subscriber resync before its attach) is rejected, naming the rule.

Exact equality throughout: the documents are compared as parsed JSON."""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from shared_tensor_tpu.obs import events as jev
from shared_tensor_tpu.obs import recorder as jrec
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, obs, serve
from shared_tensor_tpu_torch.benchmarks import conformance, gate_passes
from shared_tensor_tpu_torch.benchmarks.lifecycle import capture
from shared_tensor_tpu_torch.obs import events as pev
from shared_tensor_tpu_torch.obs import recorder as prec
from tests._ports import free_port

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from protospec.conformance import check_timeline, load_timeline  # noqa: E402

N = 2048
NAMES = ("link_up", "link_down", "retransmit", "dedup_discard", "sub_attach", "sub_resync", "lifecycle_pause",
         "lifecycle_resume", "snap_shard", "shm_lane_up", "trace_apply", "fault_drop")


def _events(seed: int, count: int = 200) -> list:
    """Seeded (t_ns, tier, name, node, link, arg, detail, extra) tuples,
    out of time order (the recorder sorts its timeline)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        detail = "" if rng.random() < 0.7 else f"d{int(rng.integers(0, 99))}"
        extra = 0 if rng.random() < 0.5 else int(rng.integers(1, 1 << 20))
        out.append((int(rng.integers(1, 1 << 50)), "c" if rng.random() < 0.5 else "py", NAMES[rng.integers(len(NAMES))],
                    int(rng.integers(0, 8)), int(rng.integers(0, 4)), int(rng.integers(0, 1 << 30)), detail, extra))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_export_timeline_equals_jax(seed, tmp_path, monkeypatch):
    """The same events give the same document: timeline (time-sorted
    event dicts), per-name totals and the ring's drop count."""
    monkeypatch.setattr(jev, "native_dropped", lambda lib=None: 5 + seed)
    monkeypatch.setattr(pev, "native_dropped", lambda lib=None: 5 + seed)
    hubs = ((jrec.ObsHub(4096), jev.Event), (prec.ObsHub(4096), pev.Event))
    paths = []
    for i, (hub, cls) in enumerate(hubs):
        hub.recorder.record([cls(*e) for e in _events(seed)])
        paths.append(hub.export_timeline(str(tmp_path / f"timeline_{i}.json")))
    docs = [json.loads(Path(p).read_text()) for p in paths]
    assert docs[0] == docs[1]
    assert set(docs[1]) == {"timeline", "event_counts", "native_events_dropped"}
    assert docs[1]["native_events_dropped"] == 5 + seed
    assert load_timeline(paths[1]) == docs[1]["timeline"]
    assert sum(docs[1]["event_counts"].values()) == 200


def test_export_timeline_raises_on_io_error(tmp_path):
    """Not a failure path like dump(): a file that cannot be written raises."""
    hub = prec.ObsHub(64)
    hub.recorder.record([pev.Event(1, "py", "link_up")])
    with pytest.raises(OSError):
        hub.export_timeline(str(tmp_path / "missing_dir" / "t.json"))


def _tree_timeline(tmp_path, tier: str) -> tuple[dict, list]:
    """Three peers on ``tier`` and a subscriber below the master: adds from
    two nodes, agreement, every node closed; then the conformance gate over
    the run's timeline. Returns (report, exported timeline)."""
    hub = obs.hub()
    capture(hub)
    kw = {"host_tier": True} if tier == "engine" else {"device": "cpu"}
    cfg = Config(transport=TransportConfig(peer_timeout_sec=20.0, ack_timeout_sec=0.4))
    port = free_port()
    zeros = np.zeros(N, np.float32)
    peers, sub = [], None
    total = np.zeros(N)
    try:
        for _ in range(3):
            peers.append(create_or_fetch("127.0.0.1", port, zeros, cfg, timeout=45.0, **kw))
        sub = serve.subscribe("127.0.0.1", port, zeros, cfg, timeout=45.0)
        rng = np.random.default_rng(3)
        for i in range(6):
            d = rng.uniform(-1, 1, N).astype(np.float32)
            peers[i % 2].add(d)
            total += d
            time.sleep(0.02)
        deadline = time.time() + 30
        while time.time() < deadline and not all(np.allclose(p.read().numpy(), total, atol=1e-4) for p in peers):
            time.sleep(0.05)
        assert all(np.allclose(p.read().numpy(), total, atol=1e-4) for p in peers)
        sub.wait_ready(30.0)
    finally:
        if sub is not None:
            sub.close()
        for p in reversed(peers):
            p.close()
    out = tmp_path / f"{tier}_timeline.json"
    report = conformance(hub)
    hub.export_timeline(str(out))
    return report, load_timeline(str(out))


@pytest.mark.parametrize("tier", ["engine", "device"])
def test_live_tree_with_subscriber_conforms(tier, tmp_path):
    report, timeline = _tree_timeline(tmp_path, tier)
    names = {e["name"] for e in timeline}
    assert "sub_attach" in names, sorted(names)
    assert report["violations"] == [], report["violations"]
    assert report["routed_events"] >= 1
    assert gate_passes(report)
    # the exported file replays to the same verdict
    again = check_timeline(timeline)
    assert again["violations"] == [] and again["routed_events"] == report["routed_events"]


def test_corrupted_timeline_is_rejected(tmp_path):
    """A subscriber resync put before its link's attach: an ordering the
    serving tier cannot produce, which the model rejects."""
    report, timeline = _tree_timeline(tmp_path, "engine")
    assert report["pass"]
    attach = next(e for e in timeline if e["name"] == "sub_attach")
    bad = sorted(timeline + [dict(attach, name="sub_resync", t_ns=attach["t_ns"] - 1)], key=lambda e: e["t_ns"])
    verdict = check_timeline(bad)
    assert not verdict["pass"]
    assert any("sub_resync before sub_attach" in v for v in verdict["violations"]), verdict["violations"]
    assert not gate_passes(verdict)
