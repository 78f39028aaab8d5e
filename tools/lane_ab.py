"""Phases 12b and 13 of chip_smoke.py with the same-host shared-memory lane
off and on, in turns (off, on, on, off), in one process on the GPU.

    python tools/lane_ab.py [--seed N] [--turns 4]

"off" sets ``ST_SHM=0`` around the run (every peer made in it keeps its
links on TCP); "on" is the default. Each run is ``chip_smoke.mixed_tier_tree``
(a CUDA master and two engine peers on the char-RNN table: last add to
agreement) and ``chip_smoke.serve_tree`` (the serving path: last add to
fresh, subscriber seed times, the read arm's staleness). 12b is polled
every 2 ms, and each run also splits its time: when each peer's replica
agreed, whether each link was on the lane at the adds, the master's
seconds in each stage of its send and receive paths (encode, send, fetch
wait, decode, apply and the send loop's busy time), each peer's messages
on the lane and in all, and each engine's mean ACK round trip over the
window. Prints one line per run, the card's name and power limit, and a
JSON list of every run last.
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
    from shared_tensor_tpu_torch import _build
    from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig
    from shared_tensor_tpu_torch.ops import codec_cuda as CC

    if not torch.cuda.is_available():
        raise SystemExit("lane_ab: no CUDA device")
    CC.build()
    _build.build_engine()
    dev = torch.device("cuda")
    template = C.char_rnn_template()
    arms = ["off", "on", "on", "off"] * (args.turns // 4) + ["off", "on", "on", "off"][: args.turns % 4]
    rows = []
    stages = ("encode", "send", "fetch_wait", "decode", "apply", "apply_lock_wait", "send_loop_busy")
    for arm in arms:
        env = {"ST_SHM": "0"} if arm == "off" else {}
        t0 = time.perf_counter()
        mixed, _ = C._with_env(env, lambda: C.mixed_tier_tree(template, dev, args.seed, poll_s=0.002))
        serve, _ = C._with_env(env, lambda: C.serve_tree(CharRNNConfig(), dev, args.seed))
        row = {
            "lane": arm, "seconds": time.perf_counter() - t0,
            "12b_last_add_to_agree_s": mixed["last_add_to_converged_s"], "12b_join_s": mixed["join_s"],
            "12b_seed_agree_s": mixed["seed_converge_s"],
            "12b_shm_msgs_out": [p["delta"].get("st_shm_msgs_out_total", 0) for p in mixed["per_peer"]],
            "12b_msgs_out": [p["delta"].get("st_msgs_out_total", 0) for p in mixed["per_peer"]],
            "12b_frames_out": [p["delta"].get("st_frames_out_total", 0) for p in mixed["per_peer"]],
            "12b_per_peer_agree_s": mixed["per_peer_agree_s"], "12b_lane_at_add": mixed["lane_at_add"],
            "12b_master_stage_s": {k: mixed["per_peer"][0]["delta"].get(f"st_{k}_seconds_total", 0.0)
                                   for k in stages},
            "12b_engine_ack_rtt_ms": [1e3 * p["delta"]["st_ack_rtt_seconds_sum"]
                                      / max(1, p["delta"]["st_ack_rtt_seconds_count"])
                                      for p in mixed["per_peer"][1:]],
            "13_last_add_to_fresh_s": {k: v["last_add_to_fresh_s"] for k, v in serve["fresh"].items()},
            "13_writers_agree_s": serve["writers_agree_s"], "13_seed_s": serve["seed_s"],
            "13_read_arm": serve["read_arm"],
        }
        rows.append(row)
        print(f"lane {arm}: 12b last add to agreement {row['12b_last_add_to_agree_s']:.3f} s (joined in "
              f"{row['12b_join_s']:.3f} s, seed agreed in {row['12b_seed_agree_s']:.3f} s); 13 last add to fresh "
              f"{row['13_last_add_to_fresh_s']}; run {row['seconds']:.2f} s", flush=True)
        print(f"  12b split: each peer agreed at {row['12b_per_peer_agree_s']} s; lane at the adds "
              f"{row['12b_lane_at_add']}; master stages {row['12b_master_stage_s']}; msgs out "
              f"{row['12b_msgs_out']} (lane {row['12b_shm_msgs_out']}); frames out {row['12b_frames_out']}; "
              f"engine ACK rtt ms {row['12b_engine_ack_rtt_ms']}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(rows, default=str))


if __name__ == "__main__":
    main()
