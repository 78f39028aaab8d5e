"""Phases 12b and 14c of chip_smoke.py with the observability plane off and
on, in turns (off, on, on, off), in one process on the GPU.

    python tools/obs_ab.py [--seed N] [--turns 4]

"off" calls ``obs.set_enabled(False)`` before the run, so every peer made
in it has no registry, no housekeeping beat (native drain, digest, clock
probe) and, the native ring's flag being off, engines that keep no
per-message trace bookkeeping: what ``ST_OBS=0`` gives a fresh process.
"on" is the default. Each run is ``chip_smoke.mixed_tier_tree`` (12b: a CUDA
master and two engine peers on the char-RNN table, polled every 2 ms) and
``chip_smoke.lane_chain`` (14c: the chain CUDA master - engine - engine on
the shared-memory lane with sign2); each reports its last add to
agreement. Prints one line per run, the card's name and power limit, and
a JSON list of every run last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()
    import torch

    import chip_smoke as C
    from shared_tensor_tpu_torch import _build, obs
    from shared_tensor_tpu_torch.ops import codec_cuda as CC

    if not torch.cuda.is_available():
        raise SystemExit("obs_ab: no CUDA device")
    CC.build()
    _build.build_engine()
    dev = torch.device("cuda")
    template = C.char_rnn_template()
    arms = (["off", "on", "on", "off"] * (args.turns // 4 + 1))[: args.turns]
    rows = []
    try:
        for arm in arms:
            obs.set_enabled(arm == "on")
            t0 = time.perf_counter()
            mixed, _ = C.mixed_tier_tree(template, dev, args.seed, poll_s=0.002)
            chain, _ = C.lane_chain(template, dev, args.seed, striped=False)
            row = {"obs": arm, "seconds": time.perf_counter() - t0,
                   "12b_last_add_to_agree_s": mixed["last_add_to_converged_s"],
                   "12b_per_peer_agree_s": mixed["per_peer_agree_s"],
                   "14c_last_add_to_agree_s": chain["last_add_to_agree_s"]}
            rows.append(row)
            print(f"obs {arm}: 12b last add to agreement {row['12b_last_add_to_agree_s']:.3f} s (each peer "
                  f"{row['12b_per_peer_agree_s']}); 14c {row['14c_last_add_to_agree_s']:.3f} s; run "
                  f"{row['seconds']:.2f} s", flush=True)
    finally:
        obs.set_enabled(True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(rows, default=str))


if __name__ == "__main__":
    main()
