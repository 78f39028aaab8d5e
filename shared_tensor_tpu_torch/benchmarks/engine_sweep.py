"""The same-host shared-memory lane against two TCP stripes, interleaved
per repeat over the table sizes.

    python -m shared_tensor_tpu_torch.benchmarks.engine_sweep OUT [REPS]

The counterpart of the root ``benchmarks/engine_sweep_r14.py``, with its
sizes (4 Ki to 16 Mi), arms and JSON fields, on the port's native engine
(``engine_bench.run_size``: a master adding on a fixed period and a child
counting the frames it applies, two spawned processes over loopback):

- ``shm``: the default data plane, the lane with one stripe (more TCP
  stripes would only idle beneath a live lane);
- ``tcp-2stripe``: the lane off (``shm=False``) and two TCP stripes, on the
  same build, so the comparison isolates the lane.

Each repeat runs both arms at every size, so the machine's drift hits both
alike. The verdict per size is each arm's mean equivalent fp32 GB/s and
whether the lane wins. Writes the JSON document to OUT (no default, so
that a run never overwrites the root bench's committed artifacts) and
prints the verdict.
"""

from __future__ import annotations

import argparse
import json
import sys

from .engine_bench import MEASURE_S, run_size

SIZES = (4096, 65536, 1 << 19, 1 << 20, 1 << 21, 1 << 24)
#: The reference's two-process loopback frames/s (BASELINE.md) at the sizes
#: it was measured at.
REFERENCE_FPS = {4096: 78000.0, 1 << 20: 242.0}
ARMS = {
    "shm": "default: shm lane + v3 aligned framing, 1 stripe",
    "tcp-2stripe": "shm off (no lane, v2 framing), 2 TCP stripes on the same build",
}


def run(sizes=SIZES, reps: int = 2, measure_s: float = MEASURE_S) -> dict:
    """Both arms at every size, ``reps`` times, interleaved. Returns the
    document."""
    rows = []
    for rep in range(reps):
        for arm, shm, stripes in (("shm", True, 1), ("tcp-2stripe", False, 2)):
            for n in sizes:
                row = run_size(n, measure_s, stripes=stripes, shm=shm)
                if n in REFERENCE_FPS:
                    row["vs_reference_e2e"] = round(row["frames_in_per_s"] / REFERENCE_FPS[n], 2)
                row.update(arm=arm, rep=rep)
                rows.append(row)
            print(f"rep {rep} {arm} done", file=sys.stderr, flush=True)
    verdict = {}
    for n in sizes:
        means = {}
        for arm in ARMS:
            vals = [r["equiv_fp32_GBps"] for r in rows if r["n"] == n and r["arm"] == arm]
            means[arm] = round(sum(vals) / len(vals), 3) if vals else 0.0
        verdict[str(n)] = {**means, "shm_wins": means["shm"] > means["tcp-2stripe"]}
    return {
        "bench": "engine_sweep_shm_vs_tcp",
        "tier": "host-native-engine",
        "arms": ARMS,
        "reps_per_point": reps,
        "measure_s": measure_s,
        "rows": rows,
        "verdict": verdict,
        "shm_wins_at_sizes": [n for n in sizes if verdict[str(n)]["shm_wins"]],
        # every row ran on the engine, and the shm arm's link on the lane
        "pass": all(r["engine"] and r["master_engine"] and (r["arm"] != "shm" or r["shm_active"] == 2)
                    for r in rows),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="where to write the JSON document")
    ap.add_argument("reps", nargs="?", type=int, default=2)
    args = ap.parse_args(argv)
    doc = run(reps=args.reps)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps(doc["verdict"], indent=1))
    return doc


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
