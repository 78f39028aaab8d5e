"""Trace the fleet-health heat phase beat by beat, on the port or on the JAX
package (their ``benchmarks/fleet_health.py`` heat phases, unchanged).

    JAX_PLATFORMS=cpu python tests/_heat_trace.py port|jax [--runs N] [--at-once M]

Runs the phase ``N`` times, ``M`` processes at once (the load that shows
the tail), each in a process of its own, and prints one JSON line a run:
``beats_to_name``, the named skew ratio, and for each beat from two before
the evidence beat to the naming beat the root analyzer's view: each
shard's apply rate, the skew ratio and the hot shard; and each node's
digest age at the root (ms), whether its digest advanced since the last
beat (``adv``: false where the root merged the same child digest again),
its pre-coalesce deposits by shard (``st_shard_heat_deposit_msgs``), its
applies by shard and its FWD messages out. The root's analyzer is wrapped
in the phase's process; the phase itself is the package's own. Then one
summary line of both distributions and of the naming beats (those after
the evidence beat) that read a digest that had not advanced (any node's,
and an owner's: a node with applies). Run it beside a loaded suite for
the tail. Not a test: ``tests/`` holds it because it imports both
packages.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHARD = re.compile(r"shard=\"?(\d+)")


def _by_shard(m: dict, prefix: str) -> dict:
    return {SHARD.search(k).group(1): v for k, v in m.items() if k.startswith(prefix)}


def one(impl: str) -> dict:
    """One traced heat phase in this process."""
    sys.path.insert(0, str(ROOT))
    if impl == "port":
        from shared_tensor_tpu_torch.benchmarks import fleet_health as fleet
        from shared_tensor_tpu_torch.obs import health
    else:
        sys.path.insert(0, str(ROOT / "benchmarks"))
        import fleet_health as fleet

        from shared_tensor_tpu.obs import health
    log = []
    real = health.HealthAnalyzer.beat
    last_t = {}

    def beat(self, doc, t_ns):
        out = real(self, doc, t_ns)
        nodes = {}
        for nid, e in doc.get("nodes", {}).items():
            m = e.get("m", {})
            adv = e.get("t_ns") != last_t.get(nid)
            last_t[nid] = e.get("t_ns")
            nodes[nid] = {"age_ms": round((t_ns - e.get("t_ns", t_ns)) / 1e6, 1), "adv": adv,
                          "deposits": _by_shard(m, "st_shard_heat_deposit_msgs"),
                          "applies": _by_shard(m, "st_shard_heat_applies"),
                          "fwd_out": m.get("st_shard_fwd_msgs_out_total")}
        heat = out["heat"]
        log.append({"beat": out["beats"], "rates": {k: round(v["apply_rate"], 2) for k, v in heat["shards"].items()},
                    "ratio": round(heat["skew_ratio"], 3), "hot": heat["hot_shard"], "nodes": nodes})
        return out

    health.HealthAnalyzer.beat = beat
    with tempfile.TemporaryDirectory() as d:
        os.environ["TMPDIR"] = d  # the JAX bench writes its health file there
        r = fleet.phase_heat("cpu", d) if impl == "port" else fleet.phase_heat()
    ev, named = r["evidence_beat"], r["named_beat"]
    return {"impl": impl, "beats_to_name": r["beats_to_name"], "skew_ratio": r["skew_ratio"],
            "trace": [b for b in log if ev - 2 <= b["beat"] <= named]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("impl", choices=("port", "jax"))
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--at-once", type=int, default=1)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.impl)))
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    results = []
    left = args.runs
    while left > 0:
        batch = [subprocess.Popen([sys.executable, __file__, args.impl, "--one"], stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True, env=env)
                 for _ in range(min(args.at_once, left))]
        for p in batch:
            out, _ = p.communicate(timeout=600)
            line = out.strip().splitlines()[-1] if out.strip() else ""
            doc = json.loads(line) if line.startswith("{") else {"impl": args.impl, "error": p.returncode}
            print(json.dumps(doc))
            results.append(doc)
        left -= len(batch)
    ok = [d for d in results if "beats_to_name" in d]
    naming = [b for d in ok for b in d["trace"] if b["beat"] > d["trace"][min(2, len(d["trace"]) - 1)]["beat"]]
    print(json.dumps({"impl": args.impl, "runs": len(results), "at_once": args.at_once,
                      "beats_to_name": [d["beats_to_name"] for d in ok],
                      "skew_ratio": [round(d["skew_ratio"], 2) for d in ok],
                      "over_3": sum(d["beats_to_name"] > 3 for d in ok), "errors": len(results) - len(ok),
                      "naming_beats": len(naming),
                      "stale_digest_beats": sum(any(not n["adv"] for n in b["nodes"].values()) for b in naming),
                      "stale_owner_beats": sum(any(not n["adv"] and n["applies"] for n in b["nodes"].values())
                                               for b in naming)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
