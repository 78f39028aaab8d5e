"""Chaos soak: peers training under a seeded schedule of wire faults, on
the device tier and on the native engine.

    python -m shared_tensor_tpu_torch.benchmarks.chaos_soak [--device cpu] [--out FILE]

The counterpart of the root ``benchmarks/chaos_soak.py``, with its
defaults, knobs and JSON fields, in one continuous run on both data
planes:

- **python arm**: a master and three joiners on the Python plane: on the
  GPU (``--device``, the default) the device tier, so kernels A and B run
  under the faults; on the CPU the Python host tier, the root bench's CPU
  run (the device tier on a CPU drains this arm's tail slowly: about a
  minute at ``N`` = 512). Each joiner has a seeded
  :class:`~shared_tensor_tpu_torch.config.FaultConfig` from
  :func:`python_schedules`: one link drops, duplicates and delays frames,
  one flips bits in them and truncates them, one stalls and then severs
  its uplink mid-stream (a forced re-graft with the carry);
- **native arm**: a master and two native-engine joiners, the first made
  under the ``ST_FAULT_PLAN`` string of :func:`native_schedule`, so that
  the C transport's sender injects drops, a stall and a sever below
  Python.

Every peer adds linspace deltas every 100 ms for ``SECONDS`` while the
chaos runs; then the plans are detached, every peer drains, and the tree
settles. The gates, per arm: every replica within :func:`dev_bound` of the
exact sum of every delta (drops, duplicates, truncation, stalls, delays
and severs recover exactly; a corrupted message mis-applies one element
by at most 2 * scale, so the bound grows by 4.0 per corrupted message);
the replicas within the same bound of each other; every final drain ok;
the trainers joined; no ``st-*`` thread alive after every peer closed;
the flight recorder's fault events equal to the plans' tallies (python)
or every configured class present with a clean ring (native); the
postmortem dump consistent with them; both tiers of events ("c", "py") on
the timeline. Each peer's final drain is reported under ``drains`` (its
seconds, the frames it sent and applied while draining, and on a miss its
largest link residual's RMS and its frames in flight). On a CUDA device
the python arm also reports the launches of
A and B in the arm and holds both against their plain versions on the
master's state (0 mismatches required).

Knobs: ``ST_CHAOS_N`` (512), ``ST_CHAOS_SECONDS`` (40 a arm),
``ST_CHAOS_SEED`` (6), ``ST_CHAOS_ARMS`` ("python,native"). Prints one
JSON document (and writes it to ``--out``); exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from .lifecycle import _free_port

#: FaultPlan.counts key -> the timeline event it emits: the accounting
#: bridge between what the injector did and what the recorder saw.
FAULT_EVENT_OF = {
    "dropped": "fault_drop",
    "duplicated": "fault_dup",
    "delayed": "fault_delay",
    "corrupted": "fault_corrupt",
    "truncated": "fault_truncate",
    "stalled": "fault_stall",
    "severed": "fault_sever",
}


def st_threads() -> set:
    """The live threads of the package (every one it starts is ``st-*``)."""
    return {t for t in threading.enumerate() if t.name.startswith("st-") and t.is_alive()}


def python_schedules(rng: np.random.Generator, seed: int) -> list:
    """The python arm's three joiners' fault configs, drawn from ``rng``
    in the root bench's order: lossy (drop, duplicate, delay), corrupting
    (bit flips, truncation), stalled-then-severed uplink."""
    from ..config import FaultConfig

    return [
        FaultConfig(enabled=True, seed=seed + 1, drop_pct=float(rng.uniform(0.1, 0.3)),
                    dup_pct=float(rng.uniform(0.05, 0.2)), delay_pct=float(rng.uniform(0.1, 0.3)), delay_sec=0.003),
        FaultConfig(enabled=True, seed=seed + 2, corrupt_pct=float(rng.uniform(0.05, 0.15)),
                    truncate_pct=float(rng.uniform(0.05, 0.15))),
        FaultConfig(enabled=True, seed=seed + 3, stall_after_frames=int(rng.integers(10, 25)),
                    sever_after_frames=int(rng.integers(30, 45)), only_link=1),
    ]


def native_schedule(rng: np.random.Generator, seed: int) -> dict:
    """The native arm's chaotic joiner's environment (``faults.to_env``):
    drops, then a stall and a sever on its first uplink, drawn from
    ``rng`` in the root bench's order."""
    from ..comm import faults
    from ..config import FaultConfig

    return faults.to_env(FaultConfig(
        enabled=True, seed=seed, drop_pct=float(rng.uniform(0.1, 0.3)), stall_after_frames=int(rng.integers(20, 40)),
        sever_after_frames=int(rng.integers(45, 60)), only_link=1,
    ))


def dev_bound(corrupted: int) -> float:
    """The deviation a replica may keep: float slack, plus 4.0 for each
    corrupted message (one element off by at most 2 * an O(1) scale)."""
    return 0.05 + 4.0 * corrupted


def _train(peer, n: int, rng, stop, lock, contrib, last: list) -> None:
    """One peer's training loop: linspace deltas (they converge exactly,
    where gaussian tails oscillate at the scale's floor), summed exactly
    under ``lock``; ``last[0]`` holds the latest delta."""
    while not stop.is_set():
        lo, hi = sorted(rng.uniform(-0.5, 0.5, size=2))
        d = np.linspace(lo, hi, n, dtype=np.float32)
        peer.add(d)
        with lock:
            contrib += d.astype(np.float64)
        last[0] = d
        stop.wait(0.1)


def _drain(peer) -> dict:
    """One peer's final drain, with the frames it sent and applied while
    draining and, where it missed, what was left: its largest link
    residual's RMS and its unacknowledged frames."""
    m0 = peer.metrics()
    t0 = time.monotonic()
    ok = peer.drain(timeout=120.0, tol=1e-30)
    m1 = peer.metrics()
    out = {"ok": ok, "seconds": time.monotonic() - t0,
           "frames_out": int(m1["st_frames_out_total"] - m0["st_frames_out_total"]),
           "frames_in": int(m1["st_frames_in_total"] - m0["st_frames_in_total"])}
    if not ok:
        out["residual_rms"] = max((peer.st.residual_rms(l) for l in peer.st.link_ids if l >= 0), default=0.0)
        out["inflight"] = peer.st.inflight_total()
    return out


def run_arm(arm: str, rng: np.random.Generator, n: int, seconds: float, seed: int, device=None) -> dict:
    """One arm ("python": on a CUDA ``device`` its device tier, on the CPU
    the Python host tier; "native": the engine); the schedule draws from
    ``rng``. Returns its report."""
    import torch
    from .. import Config, TransportConfig, create_or_fetch, obs
    from ..comm.peer import SharedTensorPeer
    from ..config import FaultConfig
    from ..obs import events as obs_events
    from ..ops import codec_cuda as CC

    native = arm == "native"
    on_cuda = not native and torch.device("cuda" if device is None else device).type == "cuda"
    kw = {"device": device} if on_cuda else {"host_tier": True}
    # a fresh timeline for this arm, and its own base of the process-wide
    # ring-overflow count
    hub = obs.hub()
    hub.poll_native()
    hub.recorder.clear()
    ring_dropped_base = obs_events.native_dropped()

    def cfg(fault=None) -> Config:
        return Config(transport=TransportConfig(peer_timeout_sec=30.0, ack_timeout_sec=1.0),
                      faults=fault or FaultConfig(), native_engine=native)

    port = _free_port()
    zeros = np.zeros((n,), np.float32)
    launches0 = dict(CC.LAUNCHES)
    master = create_or_fetch("127.0.0.1", port, zeros, cfg(), **kw)
    peers = [master]
    plans = []
    env_schedule = None
    try:
        if native:
            env = native_schedule(rng, seed)
            env_schedule = env["ST_FAULT_PLAN"]
            os.environ.update(env)
            try:
                peers.append(SharedTensorPeer("127.0.0.1", port, zeros, cfg(), **kw))
            finally:
                for k in env:
                    os.environ.pop(k, None)
            peers.append(SharedTensorPeer("127.0.0.1", port, zeros, cfg(), **kw))
        else:
            for fc in python_schedules(rng, seed):
                p = SharedTensorPeer("127.0.0.1", port, zeros, cfg(fc), **kw)
                peers.append(p)
                plans.append(p._faults)
        for p in peers[1:]:
            p.wait_ready(60.0)
    except BaseException:
        for p in reversed(peers):
            p.close()
        raise

    stop = threading.Event()
    lock = threading.Lock()
    contribs = [np.zeros(n, np.float64) for _ in peers]
    lasts = [[zeros] for _ in peers]
    trainers = [
        threading.Thread(target=_train, args=(p, n, np.random.default_rng(seed + 10 + i), stop, lock, contribs[i],
                                              lasts[i]), daemon=True, name=f"chaos-train-{i}")
        for i, p in enumerate(peers)
    ]
    for t in trainers:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in trainers:
        t.join(timeout=30.0)
    trainers_ok = all(not t.is_alive() for t in trainers)

    # the chaos window ends with training: detach the plans first (a send
    # loop keeps dripping residual frames through an attached plan), settle,
    # then quiesce: the recovery machinery must repair all the chaos stranded
    for p in peers:
        p._faults = None
    time.sleep(0.5)
    t0 = time.monotonic()
    drains = [_drain(p) for p in peers]
    drains_ok = sum(1 for d in drains if d["ok"])
    settle_end = time.time() + 30.0
    prev = None
    while time.time() < settle_end:
        cur = master.read().cpu().numpy().copy()
        if prev is not None and np.array_equal(cur, prev):
            break
        prev = cur
        time.sleep(1.0)
    quiesce_sec = time.monotonic() - t0

    expected = sum(contribs)
    base = master.read().cpu().numpy().astype(np.float64)
    dev = spread = 0.0
    for p in peers:
        v = p.read().cpu().numpy().astype(np.float64)
        dev = max(dev, float(np.abs(v - expected).max()))
        spread = max(spread, float(np.abs(v - base).max()))

    # the recorder's accounting: python, the plans' tallies equal the
    # timeline's per-name totals (both harvested now, long quiesced);
    # native, the C injector is the emitter, so every configured class must
    # be present with a clean ring
    injected = {k: int(sum(pl.counts[k] for pl in plans if pl is not None)) for k in FAULT_EVENT_OF}
    bound = dev_bound(injected["corrupted"])
    hub.poll_native()
    ring_dropped = obs_events.native_dropped() - ring_dropped_base
    ev_counts = {k: int(hub.recorder.counts[k]) for k in FAULT_EVENT_OF.values()}
    if plans:
        obs_accounted = all(ev_counts[FAULT_EVENT_OF[k]] == injected[k] for k in injected)
    else:
        obs_accounted = (ev_counts["fault_drop"] > 0 and ev_counts["fault_stall"] > 0
                         and ev_counts["fault_sever"] >= 1 and ring_dropped == 0)
    timeline = hub.recorder.timeline()
    tiers = sorted({e.tier for e in timeline})
    dump_path = hub.dump(f"chaos_soak_{arm}", min_interval_sec=0.0)
    dump_ok = False
    if dump_path:
        try:
            with open(dump_path) as f:
                doc = json.load(f)
            dump_ok = (doc["reason"] == f"chaos_soak_{arm}" and len(doc["timeline"]) > 0
                       and all(doc["event_counts"].get(k, 0) == ev_counts[k] for k in ev_counts))
        except (OSError, ValueError, KeyError):
            dump_ok = False

    launches = {k: CC.LAUNCHES[k] - launches0[k] for k in ("quantize_rows", "apply_rows_batch")}
    state = None
    if on_cuda:
        from . import kernel_check, master_state

        state = master_state(master, lasts[0][0])
    for p in reversed(peers):
        p.close()
    deadline = time.time() + 15.0
    while time.time() < deadline and st_threads():
        time.sleep(0.2)
    wedged = sorted(t.name for t in st_threads())
    # after the close: a peer's send thread may be capturing a burst graph,
    # during which no other thread may synchronize the device
    kernels = kernel_check(state, master.st.spec) if state is not None else None

    result = {
        "peers": len(peers),
        "tier": "native-engine" if native else "python-host" if master.st.host_tier
        else f"device:{master.st.device.type}",
        # python: the plans' tallies; native: the injection runs in the C
        # transport, which exports no counters, so its schedule is recorded
        "faults_injected": injected if plans else None,
        "native_env_schedule": env_schedule,
        "trainers_joined": trainers_ok,
        "final_drains_ok": f"{drains_ok}/{len(peers)}",
        "drains": drains,
        "max_dev_vs_expected": dev,
        "cross_replica_spread": spread,
        "dev_bound": bound,
        "wedged_threads": wedged,
        "quiesce_sec": quiesce_sec,
        "obs": {
            "fault_event_counts": ev_counts, "accounted": obs_accounted, "timeline_events": len(timeline),
            "timeline_tiers": tiers, "native_ring_dropped": ring_dropped, "postmortem": dump_path,
            "postmortem_ok": dump_ok,
        },
        "pass": bool(trainers_ok and drains_ok == len(peers) and dev <= bound and spread <= bound and not wedged
                     and obs_accounted and dump_ok and tiers == ["c", "py"]),
    }
    if not native:
        result["launches"] = launches
    if kernels is not None:
        result["kernel_check"] = kernels
        result["pass"] = bool(result["pass"] and all(launches.values())
                              and not any(v["mismatches"] for v in kernels.values()))
    return result


def run(n: int = 512, seconds: float = 40.0, seed: int = 6, arms=("python", "native"), device=None) -> dict:
    """Every arm in turn, one ``rng`` seeded with ``seed`` drawing both
    schedules, as the root bench does. Returns the document."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    results = {arm: run_arm(arm, rng, n, seconds, seed, device) for arm in arms}
    return {"bench": "chaos_soak", "n": n, "seconds_per_arm": seconds, "seed": seed, "arms": results,
            "seconds": time.perf_counter() - t0, "pass": all(a["pass"] for a in results.values())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="the python arm's device (default: the GPU)")
    ap.add_argument("--out", default="", help="also write the JSON document here")
    args = ap.parse_args(argv)
    arms = tuple(a.strip() for a in os.environ.get("ST_CHAOS_ARMS", "python,native").split(",") if a.strip())
    out = run(int(os.environ.get("ST_CHAOS_N", "512")), float(os.environ.get("ST_CHAOS_SECONDS", "40")),
              int(os.environ.get("ST_CHAOS_SEED", "6")), arms, args.device)
    if args.device is None or str(args.device).startswith("cuda"):
        from . import device_record

        out["device"] = device_record(args.device)
    doc = json.dumps(out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    print(doc)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
