"""Fleet-health acceptance bench: three loopback fleets, each with a
pass/fail verdict from the root's health analyzer (``obs/health.py``).

    python -m shared_tensor_tpu_torch.benchmarks.fleet_health OUT.json [--device cpu]

The counterpart of the root ``benchmarks/fleet_health.py``, with its
constants. Peers run on the GPU unless ``--device cpu`` asks for the CPU
(without a GPU they raise); the sharded nodes are host code on every tier.

- **heat**: a 7-node SHARDED fleet (Python shard plane, 4 shards: nodes 0-3
  own one each, nodes 4-6 are shardless writers) under zipf-skewed writes
  (about 79% of them into shard ``HOT_SHARD``). The root's analyzer must
  name that shard (``heat.hot_shard``) within 3 digest beats of the shard
  telemetry first making it computable.
- **slo**: a 7-node full-replica tree, every node writing, with a
  staleness objective of 3 s (5% budget, page = 2x burn over 6 s / 1 s).
  The senders are paced (``sync_interval_sec`` 0.5), so that the go-back-N
  window drains between frames and the steady-state staleness sits near
  1 s. Then every writer stalls: the page alert must FIRE (alert 2 in the
  health file and an ``slo_alert_fire`` event) while the stall holds, and
  CLEAR after the writers resume and the fleet quiesces under the
  objective.
- **skew**: a 3-node tree whose children run the clock simulator at +50 ms
  and -50 ms (``ObsConfig.clock_skew_sim_sec``). The offset estimator must
  agree with the simulated skews within its own uncertainty, and the
  root's offset-corrected staleness of the skewed writer's link must shift
  by that offset (``corrected - raw`` about +50 ms).

The health files live in a temporary directory that is removed at the
end: the bench writes only ``OUT``, one JSON document (printed too), and
exits 1 when a phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .lifecycle import _free_port

HEAT_N = int(os.environ.get("ST_FLEET_HEAT_N", 1 << 14))
HOT_SHARD = 2
BEAT_S = 0.2


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _wait(pred, timeout: float, msg: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {msg}")


# -- phase 1: zipf heat on a 7-node sharded fleet ---------------------------------------


def phase_heat(device, tmpdir: str) -> dict:
    from ..config import Config, ObsConfig, ShardConfig, TransportConfig
    from ..shard import create_or_fetch_sharded

    tmpl = {"t": np.zeros(HEAT_N, np.float32)}
    health_path = os.path.join(tmpdir, "heat.json")
    port = _free_port()

    def cfg(idx: int, root: bool = False) -> Config:
        return Config(
            shard=ShardConfig(n_shards=4, shard_index=idx, engine_lane=False),
            transport=TransportConfig(peer_timeout_sec=30.0),
            obs=ObsConfig(digest_interval_sec=BEAT_S, health_json_path=health_path if root else ""),
        )

    handles = [create_or_fetch_sharded("127.0.0.1", port, tmpl, cfg(0, root=True), timeout=60.0, device=device)]
    stop = threading.Event()
    threads: list[threading.Thread] = []
    try:
        for i in range(1, 7):
            handles.append(create_or_fetch_sharded("127.0.0.1", port, tmpl, cfg(i if i <= 3 else -1), timeout=60.0,
                                                   device=device))
        ranges = [handles[0].node.map.element_range(k) for k in range(4)]
        # zipf-ish mix: the hot shard takes the rank-1 weight, the rest a
        # steep tail (~79/14/5/2%). The Python shard plane coalesces
        # same-shard writes in its outbox, so the writes stay sparse enough
        # (40 ms apart) that nearly each one becomes its own FWD
        order = [HOT_SHARD] + [k for k in range(4) if k != HOT_SHARD]
        weights = np.array([1.0 / (r + 1) ** 2.5 for r in range(4)])
        weights /= weights.sum()
        deltas = {}
        for k, (lo, hi) in enumerate(ranges):
            d = np.zeros(HEAT_N, np.float32)
            d[lo : min(hi, HEAT_N)] = 0.01
            deltas[k] = d

        def writer(seed: int):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                k = order[int(rng.choice(4, p=weights))]
                handles[4 + seed % 3].add({"t": deltas[k]})
                stop.wait(0.04)

        # the writers start once the analyzer beats, so that the detection
        # clock below starts at the first telemetry, not mid-warm-up
        _wait(lambda: (_read_json(health_path) or {}).get("beats", 0) >= 2, 30.0, "first health beats")
        for i in range(3):
            t = threading.Thread(target=writer, args=(i,), daemon=True)
            t.start()
            threads.append(t)

        def beat_with(pred):
            doc = _read_json(health_path)
            return doc if doc and pred(doc) else None

        # the naming clock starts when naming becomes POSSIBLE: two shards
        # with telemetry, one of them with a live apply rate
        evidence = _wait(
            lambda: beat_with(lambda d: len(d["heat"]["shards"]) >= 2
                              and any(s["apply_rate"] > 0 for s in d["heat"]["shards"].values())),
            30.0, "computable shard telemetry reaching the root",
        )
        named = _wait(lambda: beat_with(lambda d: d["heat"]["hot_shard"] == HOT_SHARD), 30.0,
                      f"hot shard {HOT_SHARD} named")
        beats_to_name = named["beats"] - evidence["beats"]
        return {
            "hot_shard_expected": HOT_SHARD,
            "hot_shard_named": named["heat"]["hot_shard"],
            "skew_ratio": named["heat"]["skew_ratio"],
            "evidence_beat": evidence["beats"],
            "named_beat": named["beats"],
            "beats_to_name": beats_to_name,
            "shards": named["heat"]["shards"],
            "pass": bool(named["heat"]["hot_shard"] == HOT_SHARD and beats_to_name <= 3),
        }
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        for h in reversed(handles):
            h.close()


# -- phase 2: the SLO fires on a stall and clears at quiesce (7-node tree) ----------------


def phase_slo(device, tmpdir: str) -> dict:
    from .. import obs
    from ..comm.peer import create_or_fetch
    from ..config import Config, ObsConfig, TransportConfig

    health_path = os.path.join(tmpdir, "slo.json")
    port = _free_port()
    n = 1024
    seed = torch.zeros(n, dtype=torch.float32)

    def cfg(root: bool) -> Config:
        return Config(
            native_engine=False,
            # paced frames: a free-running sender always has residual to
            # halve and keeps the go-back-N window full; the queueing delay
            # (which the live-aged staleness gauge reports) would then
            # dwarf any objective
            sync_interval_sec=0.5,
            transport=TransportConfig(peer_timeout_sec=30.0, ack_timeout_sec=0.4),
            obs=ObsConfig(
                digest_interval_sec=BEAT_S,
                health_json_path=health_path if root else "",
                staleness_slo_sec=3.0,
                slo_budget=0.05,
                slo_windows=(("page", 6.0, 1.0, 2.0), ("ticket", 12.0, 2.0, 1.5)),
            ),
        )

    hub = obs.hub()
    hub.poll_native()
    fire0 = hub.recorder.counts["slo_alert_fire"]
    clear0 = hub.recorder.counts["slo_alert_clear"]
    peers = []
    stalled = threading.Event()
    stop = threading.Event()
    threads = []
    try:
        for i in range(7):
            peers.append(create_or_fetch("127.0.0.1", port, seed, cfg(i == 0), timeout=60.0, device=device))
        rng = np.random.default_rng(1)
        ds = [torch.from_numpy(rng.uniform(-0.01, 0.01, n).astype(np.float32)).to(peers[0].st.device)
              for _ in range(4)]

        def writer(i: int):
            j = 0
            while not stop.is_set():
                if not stalled.is_set():
                    peers[i].add(ds[j % len(ds)])
                    j += 1
                stop.wait(0.25)

        for i in range(7):
            t = threading.Thread(target=writer, args=(i,), daemon=True)
            t.start()
            threads.append(t)

        def alert() -> int:
            return int((_read_json(health_path) or {}).get("slo", {}).get("alert", -1))

        _wait(lambda: alert() == 0, 30.0, "steady state under the objective")
        time.sleep(2.0)  # a few green beats on the record
        pre_stall_alert = alert()
        stalled.set()
        t_stall = time.monotonic()
        fired = _wait(lambda: alert() == 2, 20.0, "page alert firing")
        fire_latency = time.monotonic() - t_stall
        fired_doc = _read_json(health_path)
        stalled.clear()
        t_resume = time.monotonic()
        cleared = _wait(lambda: alert() == 0, 30.0, "alert clearing")
        clear_latency = time.monotonic() - t_resume
        fires = hub.recorder.counts["slo_alert_fire"] - fire0
        clears = hub.recorder.counts["slo_alert_clear"] - clear0
        return {
            "pre_stall_alert": pre_stall_alert,
            "fired": bool(fired),
            "fire_latency_s": round(fire_latency, 2),
            "fired_windows": (fired_doc or {}).get("slo", {}).get("windows"),
            "cleared": bool(cleared),
            "clear_latency_s": round(clear_latency, 2),
            "fire_events": fires,
            "clear_events": clears,
            "pass": bool(pre_stall_alert == 0 and fired and cleared and fires > 0 and clears > 0),
        }
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        for p in reversed(peers):
            p.close()


# -- phase 3: +/-50 ms of simulated skew against the offset estimator ---------------------


def phase_skew(device, tmpdir: str) -> dict:
    from ..comm.peer import create_or_fetch
    from ..config import Config, ObsConfig, TransportConfig

    health_path = os.path.join(tmpdir, "skew.json")
    port = _free_port()
    n = 2048
    seed = torch.zeros(n, dtype=torch.float32)
    skews = [0.0, 0.05, -0.05]

    def cfg(i: int) -> Config:
        return Config(
            native_engine=False,
            transport=TransportConfig(peer_timeout_sec=30.0),
            obs=ObsConfig(
                digest_interval_sec=BEAT_S,
                health_json_path=health_path if i == 0 else "",
                clock_sync_interval_sec=0.2,
                clock_skew_sim_sec=skews[i],
            ),
        )

    peers = []
    stop = threading.Event()
    t = None
    try:
        for i in range(3):
            peers.append(create_or_fetch("127.0.0.1", port, seed, cfg(i), timeout=60.0, device=device))
        rng = np.random.default_rng(2)
        d = torch.from_numpy(rng.uniform(-0.01, 0.01, n).astype(np.float32)).to(peers[1].st.device)

        def writer():
            # the +50 ms child writes, so the ROOT's staleness record of that
            # link carries a skewed origin stamp
            while not stop.is_set():
                peers[1].add(d)
                stop.wait(0.05)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        ids = [p.node.obs_id for p in peers]

        def clock_ready() -> dict | None:
            doc = _read_json(health_path)
            if doc and all(str(i) in doc.get("clock", {}) for i in ids[1:]):
                return doc
            return None

        doc = _wait(clock_ready, 30.0, "clock estimates for both children")
        time.sleep(2.0)  # let the min-RTT sample window fill
        doc = _read_json(health_path) or doc
        table = doc["clock"]
        nodes = []
        est_ok = True
        for i, skew in enumerate(skews[1:], start=1):  # the root pins (0, 0)
            ent = table[str(ids[i])]
            err = abs(ent["off_sec"] - skew)
            ok = err <= ent["unc_sec"] + 0.002
            est_ok = est_ok and ok
            nodes.append({"node": ids[i], "skew_sim_sec": skew, "off_est_sec": ent["off_sec"],
                          "unc_sec": ent["unc_sec"], "abs_err_sec": err, "within_uncertainty": ok})

        # the root's corrected staleness shifts by the writer's offset:
        # corrected - raw = the origin's offset (the applier, the root, is at 0)
        def stale_rec() -> dict | None:
            d2 = _read_json(health_path)
            rec = (d2 or {}).get("staleness", {}).get("nodes", {}).get(str(ids[0]))
            if rec and rec.get("origin") == ids[1] and rec["unc_sec"] is not None:
                return rec
            return None

        rec = _wait(stale_rec, 30.0, "root's corrected staleness record")
        shift = rec["corrected_sec"] - rec["raw_sec"]
        shift_ok = abs(shift - skews[1]) <= rec["unc_sec"] + 0.005
        # raw staleness is skewed DOWN here (the origin's stamps run 50 ms
        # ahead) and may clamp at 0: then the shift is only bounded above
        if rec["raw_sec"] == 0.0:
            shift_ok = shift <= skews[1] + rec["unc_sec"] + 0.005
        return {
            "nodes": nodes,
            "estimator_within_uncertainty": est_ok,
            "root_staleness_record": rec,
            "corrected_minus_raw_sec": shift,
            "shift_matches_skew": bool(shift_ok),
            "pass": bool(est_ok and shift_ok),
        }
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=5.0)
        for p in reversed(peers):
            p.close()


PHASES = {"heat": phase_heat, "slo": phase_slo, "skew": phase_skew}


def run(device, phases=tuple(PHASES)) -> dict:
    """Run ``phases`` in order, each on a fresh fleet; the document's
    ``pass`` is every phase's. A phase that raises fails with its error."""
    from ..core import resolve_device

    dev = resolve_device(device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="fleet_health_") as tmpdir:
        for name in phases:
            t0 = time.monotonic()
            try:
                out[name] = PHASES[name](dev, tmpdir)
            except Exception as e:  # a wedged phase fails loudly, with its error
                out[name] = {"pass": False, "error": f"{type(e).__name__}: {e}"}
            out[name]["wall_s"] = round(time.monotonic() - t0, 2)
            print(f"fleet_health/{name}: {'PASS' if out[name]['pass'] else 'FAIL'} ({out[name]['wall_s']}s)",
                  file=sys.stderr)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"bench": "fleet_health", "beat_s": BEAT_S, "device": device_name, "phases": out,
            "pass": bool(all(p["pass"] for p in out.values()))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="the JSON file to write (the only file the bench leaves)")
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the GPU)")
    args = ap.parse_args()
    doc = run(args.device)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    print(json.dumps(doc, indent=2))
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
