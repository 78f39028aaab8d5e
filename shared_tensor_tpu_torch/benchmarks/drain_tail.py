"""Frames and seconds for one link to drain one add to exact zero, on each
tier of the port: the native engine, the Python host tier and the device
tier.

    python -m shared_tensor_tpu_torch.benchmarks.drain_tail [--n N] [--timeout S] [--device cpu]

Two peers on one ``{"t": N}`` table over loopback; the master adds one
seeded normal delta (scaled by 1e-2, as ``e2e_sync``'s adds) and drains
with ``tol=1e-30``: every link residual at exact zero and every frame
acknowledged, within ``--timeout`` seconds. Prints one JSON line a tier:
whether it drained, the seconds, the frames the master sent, its residual
norm at the end, and the joiner's largest error against the delta. The
device tier runs on ``--device`` (default: the GPU, which raises without
one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .lifecycle import _free_port

TIERS = ("engine", "python-host", "device")


def run_tier(tier: str, n: int = 1 << 20, timeout: float = 30.0, device=None) -> dict:
    """One add on one link of ``tier`` (module docstring). Returns its row."""
    from .. import Config, create_or_fetch

    kw = {"device": device} if tier == "device" else {"host_tier": True}
    if tier == "python-host":
        kw["config"] = Config(native_engine=False)
    port = _free_port()
    tmpl = {"t": np.zeros(n, np.float32)}
    master = create_or_fetch("127.0.0.1", port, tmpl, timeout=30.0, **kw)
    try:
        joiner = create_or_fetch("127.0.0.1", port, tmpl, timeout=30.0, **kw)
        try:
            joiner.wait_ready(30.0)
            delta = np.random.default_rng(1).normal(size=n).astype(np.float32) * 1e-2
            f0 = master.metrics()["st_frames_out_total"]
            master.add({"t": delta})
            t0 = time.perf_counter()
            drained = master.drain(timeout=timeout, tol=1e-30)
            secs = time.perf_counter() - t0
            m = master.metrics()
            err = float(np.abs(joiner.read()["t"].cpu().numpy() - delta).max())
        finally:
            joiner.close()
    finally:
        master.close()
    return {"bench": "drain_tail", "tier": tier, "n": n, "timeout_s": timeout, "drained": drained,
            "seconds": secs, "frames_out": int(m["st_frames_out_total"] - f0),
            "residual_norm": float(m["st_residual_norm"]), "joiner_max_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--device", default=None, help="the device tier's device (default: the GPU)")
    args = ap.parse_args(argv)
    for tier in TIERS:
        print(json.dumps(run_tier(tier, args.n, args.timeout, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
