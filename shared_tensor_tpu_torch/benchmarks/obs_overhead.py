"""The observability plane's overhead: a peer pair's frames/s with obs on
against obs off.

The counterpart of the root ``benchmarks/obs_overhead.py``, with its paired
design and its four arms:

- **engine arm**: ONE warm loopback pair of engine peers (``host_tier=True``)
  on the v1 (untraced) framing, the master adding on a timer, with
  ``obs.set_enabled`` flipped every interval: K paired (on, off) samples of
  the child's frames/s over the same sockets, threads and caches, so slow
  drift cancels. The per-pair overheads o_i = 1 - on_i / off_i give a mean,
  its standard error and the mean's lower 90% bound; the arm fails only
  when that bound exceeds the budget (``--gate-pct``, 2%).
- **trace arm**: the same on a pair with the v2 trace: the native engine
  keys its per-message trace bookkeeping (clock reads, hops and staleness
  atomics, trace_apply ring events) off the same flag.
- **health arm**: the trace arm's pair with fast digest beats (0.25 s) and
  the root's health analyzer live (time series, SLO scoring, clock probes,
  health.json writes); the run-time flag pauses the whole housekeeping
  beat.
- **python arm** (informational): a fresh pair per side, on the peers' own
  Python send and receive loops, where the per-message histograms observe
  live: device-tier peers on ``--device`` (the card by default, so there
  the pair's codec runs kernels A and B), at ``--py-n`` elements.

The flag does not reach the ~50 ns of unconditional per-message engine
work (one clock read at the ledger push, two atomic adds at the ACK pop)
nor the 13 bytes of a v2 header.

    python -m shared_tensor_tpu_torch.benchmarks.obs_overhead [--device cuda|cpu] [--out FILE]

Prints one JSON document on its last line (and writes it to ``--out``);
exits 1 when a paired arm fails its budget. ``--small`` is a short run at
a small width for a smoke test on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import sys
import tempfile
import threading
import time

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _loopback_pair(n: int, engine: bool, device=None, trace: bool = True, health_path: str = ""):
    """A master and a child on one loopback port, the master adding a
    seeded update every ``period``; returns (the child's frames/s over
    ``seconds``, close)."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.config import ObsConfig

    obs_kw = {"digest_interval_sec": 0.25, "health_json_path": health_path} if health_path else {}
    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0), obs=ObsConfig(trace_wire=trace, **obs_kw))
    kw = {"host_tier": True} if engine else {"device": device}
    port = _free_port()
    seed = np.zeros((n,), np.float32)
    m = create_or_fetch("127.0.0.1", port, seed, cfg, **kw)
    try:
        c = create_or_fetch("127.0.0.1", port, seed, cfg, **kw)
    except BaseException:
        m.close()
        raise
    stop = threading.Event()
    delta = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    period = max(0.002, n / (1 << 20) * 0.005)

    def adder():
        while not stop.is_set():
            m.add(delta)
            stop.wait(period)

    t = threading.Thread(target=adder, daemon=True)
    t.start()

    def fps(seconds: float) -> float:
        f0 = c.metrics()["st_frames_in_total"]
        t0 = time.monotonic()
        time.sleep(seconds)
        f1 = c.metrics()["st_frames_in_total"]
        return (f1 - f0) / max(time.monotonic() - t0, 1e-9)

    def close():
        stop.set()
        t.join(timeout=10.0)
        c.close()
        m.close()

    return fps, close


def engine_arm(n: int, pairs: int, interval_s: float, gate_pct: float, trace: bool = False,
               health: bool = False) -> dict:
    """The paired A/B on one warm engine pair (module docstring)."""
    from shared_tensor_tpu_torch import obs

    health_path = ""
    if health:
        health_path = os.path.join(tempfile.gettempdir(), f"obs_bench_health_{os.getpid()}.json")
    fps, close = _loopback_pair(n, engine=True, trace=trace, health_path=health_path)
    on, off = [], []
    try:
        time.sleep(2.0)  # links hot, pools warm, codec threads up
        for _ in range(pairs):
            obs.set_enabled(True)
            on.append(fps(interval_s))
            obs.set_enabled(False)
            off.append(fps(interval_s))
    finally:
        close()
        obs.set_enabled(True)  # never leave the process half disabled
    overheads = [100.0 * (1.0 - a / b) for a, b in zip(on, off) if b > 0]
    k = len(overheads)
    out = {"n": n, "pairs": pairs, "interval_s": interval_s, "trace_wire": trace, "health": health,
           "fps_obs_on": on, "fps_obs_off": off, "dropped_pairs": len(on) - k}
    if k == 0:
        return dict(out, error="every obs-off sample was 0 (the loopback wedged)", overhead_pct_mean=None,
                    overhead_pct_sem=None, overhead_pct_lower90=None, **{"pass": False})
    mean = sum(overheads) / k
    sem = math.sqrt(sum((o - mean) ** 2 for o in overheads) / max(k - 1, 1) / k)
    lower90 = mean - 1.645 * sem
    return dict(out, overhead_pct_pairs=overheads, overhead_pct_mean=mean, overhead_pct_sem=sem,
                overhead_pct_lower90=lower90, **{"pass": bool(lower90 <= gate_pct)})


def python_arm(n: int, seconds: float, device) -> dict:
    """A fresh device-tier pair per side, obs on then off (informational)."""
    from shared_tensor_tpu_torch import obs

    out = {"n": n, "device": str(device)}
    try:
        for key, enabled in (("fps_obs_on", True), ("fps_obs_off", False)):
            obs.set_enabled(enabled)
            fps, close = _loopback_pair(n, engine=False, device=device)
            try:
                time.sleep(1.0)
                out[key] = fps(seconds)
            finally:
                close()
    finally:
        obs.set_enabled(True)
    out["overhead_pct"] = 100.0 * (1.0 - out["fps_obs_on"] / max(out["fps_obs_off"], 1e-9))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="the python arm's device (default: the GPU)")
    ap.add_argument("--n", type=int, default=1 << 20, help="elements of the engine arms' tensor")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--interval-s", type=float, default=2.5)
    ap.add_argument("--gate-pct", type=float, default=2.0)
    ap.add_argument("--py-n", type=int, default=4096, help="elements of the python arm's tensor")
    ap.add_argument("--py-s", type=float, default=4.0, help="seconds of each python arm side")
    ap.add_argument("--small", action="store_true", help="a short run at 64 Ki elements (CPU smoke)")
    ap.add_argument("--out", default="", help="also write the JSON document here")
    args = ap.parse_args(argv)
    if args.small:
        args.n, args.pairs, args.interval_s, args.py_s = 1 << 16, 2, 0.5, 1.0
    from shared_tensor_tpu_torch.core import resolve_device

    device = resolve_device(args.device, False)
    t0 = time.perf_counter()
    eng = engine_arm(args.n, args.pairs, args.interval_s, args.gate_pct)
    trc = engine_arm(args.n, args.pairs, args.interval_s, args.gate_pct, trace=True)
    hlt = engine_arm(args.n, args.pairs, args.interval_s, args.gate_pct, trace=True, health=True)
    py = python_arm(args.py_n, args.py_s, device)
    out = {
        "bench": "obs_overhead",
        "gate_pct": args.gate_pct,
        "gate_rule": "fail iff the lower 90% bound of a paired arm's mean overhead exceeds gate_pct",
        "engine_arm": eng,
        "trace_arm": trc,
        "health_arm": hlt,
        "python_arm_informational": py,
        "seconds": time.perf_counter() - t0,
        "pass": bool(eng["pass"] and trc["pass"] and hlt["pass"]),
    }
    if device.type == "cuda":
        import torch

        out["gpu"] = torch.cuda.get_device_name(0)
    for label, arm in (("engine", eng), ("trace", trc), ("health", hlt)):
        if arm["overhead_pct_mean"] is None:
            print(f"{label} arm: FAIL ({arm.get('error')})", file=sys.stderr)
        else:
            print(f"{label} arm: {arm['overhead_pct_mean']:+.2f}% +/- {arm['overhead_pct_sem']:.2f}% "
                  f"(lower 90% {arm['overhead_pct_lower90']:+.2f}%) against {args.gate_pct}%", file=sys.stderr)
    doc = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    print(doc)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
