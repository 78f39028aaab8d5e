"""The adaptive-precision governor against fixed 1-bit under a lossy,
capped uplink, and a mixed tree of sign2 and 1-bit links.

    python -m shared_tensor_tpu_torch.benchmarks.adaptive_ab

The counterpart of the root ``benchmarks/adaptive_ab.py``, with its
defaults, knobs and JSON fields, on the port's native engine
(``host_tier=True``):

- **A/B** (``ST_AB_REPEATS`` pairs, the arms interleaved so drift hits
  both): a master and a joiner whose C-tier uplink drops 25% of its sends
  (``ST_FAULT_PLAN`` around its creation) under a ``CAP_BPS`` token bucket;
  the joiner adds N(0, 0.1) deltas every 5 ms for ``ST_AB_SECONDS``, so
  mass arrives faster than a 1-bit link can move it. The only difference
  between the arms is ``CodecConfig.adaptive_precision``. Reported per
  run: ``final_residual_norm`` (the time mean of ``st_residual_norm`` over
  the window's second half: equal wall time), the last and peak samples,
  up- and downshifts, sign2 frames sent, retransmissions; then, chaos
  detached, a drain. Gates: the adaptive arm's mean below the fixed arm's,
  every adaptive run with at least one upshift and every fixed run with
  none, every drain ok.
- **mixed tree**: a sign2-pinned master (``ST_SIGN2=2``) floods a capable
  child (sign2 frames on its wire: ``st_frames2_in_total`` > 0) and a
  child with the governor off (``frames2_in`` 0); both drain and agree
  with the master within 1e-4.

Knobs: ``ST_AB_N`` (65536), ``ST_AB_SECONDS`` (12), ``ST_AB_REPEATS`` (3),
``ST_AB_SEED`` (11), ``ST_AB_CAP_BPS`` (1 MiB/s). Prints one JSON line;
exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .lifecycle import _free_port

N = 65536
SECONDS = 12.0
REPEATS = 3
SEED = 11
#: The joiner's uplink byte budget: between the two codecs' drain rates
#: for this add schedule on loopback (an uncapped socket absorbs the drop
#: storm and the governor correctly stays at 1 bit), so 1-bit falls behind
#: and sign2 keeps up.
CAP_BPS = 1 << 20


def _cfg(adaptive: bool, cap_bps: int = 0):
    from ..config import CodecConfig, Config, TransportConfig

    return Config(
        transport=TransportConfig(peer_timeout_sec=30.0, ack_timeout_sec=1.0, bandwidth_cap_bytes_per_sec=cap_bps),
        codec=CodecConfig(adaptive_precision=adaptive),
        native_engine=True,
    )


def run_chaos_arm(adaptive: bool, rep: int, n: int = N, seconds: float = SECONDS, seed: int = SEED,
                  cap_bps: int = CAP_BPS) -> dict:
    """One A/B run (module docstring). Returns its row."""
    from .. import create_or_fetch
    from ..comm import faults
    from ..comm.peer import SharedTensorPeer
    from ..config import FaultConfig

    port = _free_port()
    master = create_or_fetch("127.0.0.1", port, np.zeros((n,), np.float32), _cfg(adaptive), host_tier=True)
    try:
        env = faults.to_env(FaultConfig(enabled=True, seed=seed + rep, drop_pct=0.25, only_link=1))
        os.environ.update(env)
        try:
            child = SharedTensorPeer("127.0.0.1", port, np.zeros((n,), np.float32), _cfg(adaptive, cap_bps),
                                     host_tier=True)
        finally:
            for k in env:
                os.environ.pop(k, None)
    except BaseException:
        master.close()
        raise
    try:
        child.wait_ready(60.0)
        rng = np.random.default_rng(seed + 100 + rep)
        t0 = time.time()
        t_end = t0 + seconds
        adds = 0
        samples = []  # (t, residual norm) every ~0.5 s
        t_next = t0 + 0.5
        while True:
            now = time.time()
            if now >= t_end:
                break
            child.add((rng.standard_normal(n) * 0.1).astype(np.float32))
            adds += 1
            if now >= t_next:
                t_next += 0.5
                samples.append((round(now - t0, 2), child.metrics()["st_residual_norm"]))
            time.sleep(0.005)
        cm = child.metrics()
        samples.append((round(time.time() - t0, 2), cm["st_residual_norm"]))
        half = [rn for (t, rn) in samples if t >= seconds / 2]
        run = {
            "final_residual_norm": sum(half) / len(half),
            "endpoint_residual_norm": round(samples[-1][1], 3),
            "peak_residual_norm": round(max(rn for _, rn in samples), 3),
            "adds": adds,
            "upshifts": cm.get("st_precision_upshifts_total", 0),
            "downshifts": cm.get("st_precision_downshifts_total", 0),
            "frames2_out": cm.get("st_frames2_out_total", 0),
            "retransmits": cm.get("st_retransmit_msgs_total", 0),
            "engine": child._engine is not None and master._engine is not None,
        }
        # not part of the measurement: chaos detached, the contract holds
        for p in (child, master):
            p._faults = None
        run["drained"] = bool(child.drain(timeout=180.0, tol=1e-30))
    finally:
        child.close()
        master.close()
    return run


def run_mixed_arm(n: int = N, seed: int = SEED) -> dict:
    """A sign2-pinned master, a capable child and a 1-bit child, one flood,
    one final state (module docstring)."""
    from .. import create_or_fetch
    from ..comm.peer import SharedTensorPeer

    port = _free_port()
    peers = []
    os.environ["ST_SIGN2"] = "2"
    try:
        peers.append(create_or_fetch("127.0.0.1", port, np.zeros((n,), np.float32), _cfg(True), host_tier=True))
        peers.append(SharedTensorPeer("127.0.0.1", port, np.zeros((n,), np.float32), _cfg(True), host_tier=True))
        peers.append(SharedTensorPeer("127.0.0.1", port, np.zeros((n,), np.float32), _cfg(False), host_tier=True))
    except BaseException:
        for p in reversed(peers):
            p.close()
        raise
    finally:
        os.environ.pop("ST_SIGN2", None)
    master, child_a, child_b = peers
    try:
        child_a.wait_ready(60.0)
        child_b.wait_ready(60.0)
        rng = np.random.default_rng(seed + 777)
        for _ in range(200):
            master.add((rng.standard_normal(n) * 0.1).astype(np.float32))
            time.sleep(0.002)
        ok_drain = all(p.drain(timeout=120.0, tol=1e-30) for p in peers)
        ra, rb, rm = (p.read().numpy().astype(np.float64) for p in (child_a, child_b, master))
        ma, mb = child_a.metrics(), child_b.metrics()
        out = {
            "drained": ok_drain,
            "frames2_in_capable": ma.get("st_frames2_in_total", 0),
            "frames2_in_disabled": mb.get("st_frames2_in_total", 0),
            "max_dev_capable": float(np.abs(ra - rm).max()),
            "max_dev_disabled": float(np.abs(rb - rm).max()),
        }
    finally:
        for p in reversed(peers):
            p.close()
    out["pass"] = bool(
        ok_drain
        and out["frames2_in_capable"] > 0  # sign2 really on the wire
        and out["frames2_in_disabled"] == 0  # emission gated per link
        # float32 accumulation-order noise only, over 200 floods
        and out["max_dev_capable"] < 1e-4
        and out["max_dev_disabled"] < 1e-4
    )
    return out


def run(n: int = N, seconds: float = SECONDS, repeats: int = REPEATS, seed: int = SEED, cap_bps: int = CAP_BPS,
        mixed_only: bool = False) -> dict:
    """Both parts (or the mixed tree alone). Returns the document."""
    t0 = time.perf_counter()
    arms = {"adaptive": [], "fixed1": []}
    if not mixed_only:
        for rep in range(repeats):
            arms["adaptive"].append(run_chaos_arm(True, rep, n, seconds, seed, cap_bps))
            arms["fixed1"].append(run_chaos_arm(False, rep, n, seconds, seed, cap_bps))
    mean = {k: sum(r["final_residual_norm"] for r in v) / len(v) for k, v in arms.items() if v}
    mixed = run_mixed_arm(n, seed)
    verdict = mixed["pass"] and (mixed_only or (
        mean["adaptive"] < mean["fixed1"]
        and all(r["upshifts"] >= 1 for r in arms["adaptive"])
        and all(r["upshifts"] == 0 for r in arms["fixed1"])
        and all(r["drained"] for v in arms.values() for r in v)
    ))
    return {
        "bench": "adaptive_precision_ab",
        "tier": "host-native-engine",
        "n_elements": n,
        "seconds_per_run": seconds,
        "repeats": 0 if mixed_only else repeats,
        "cap_bytes_per_sec": cap_bps,
        "workload": "joiner trains N(0,0.1) deltas @5ms through a 25%-drop C-tier uplink (ST_FAULT_PLAN) under a "
                    f"{cap_bps} B/s token bucket; final = time-mean residual norm over the window's 2nd half, chaos "
                    "attached throughout, drain only as epilogue",
        "arms": arms,
        "mean_final_residual_norm": {k: round(v, 3) for k, v in mean.items()},
        "adaptive_over_fixed": round(mean["adaptive"] / mean["fixed1"], 4) if mean.get("fixed1") else None,
        "mixed_tree": mixed,
        "seconds": time.perf_counter() - t0,
        "pass": bool(verdict),
    }


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    env = os.environ.get
    out = run(int(env("ST_AB_N", str(N))), float(env("ST_AB_SECONDS", str(SECONDS))),
              int(env("ST_AB_REPEATS", str(REPEATS))), int(env("ST_AB_SEED", str(SEED))),
              int(env("ST_AB_CAP_BPS", str(CAP_BPS))))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
