"""The bridge's overhead and its link's frames/s: the JAX bench against the
port's, on one host's CPU.

    python tools/bridge_frames.py --impl jax|port [--host-tier]

``--impl jax`` runs the root ``benchmarks/hierarchical_bench.py`` (two pods
of 4 virtual CPU devices, one process each, bridged by the JAX package's
peer on its native engine); ``--impl port`` runs
``shared_tensor_tpu_torch.benchmarks.hierarchical --device cpu --small``
(two pods of 2 gloo ranks at the same model width, batch and rate, bridged
by the port's peer on the CPU: its Python device-tier peer on
``device="cpu"``, or with ``--host-tier`` its host tier on the native
engine, the JAX bench's configuration). Each bench runs unchanged, except that
every bridge's ``HierarchicalTrainer.step`` is wrapped to read its peer's
``st_frames_out_total`` after each step. It prints the bench's own
line, then one line with the frames/s of each bridge over each bridged
arm's timed steps (the steps after the bench's warm-up). One run per call.

The spawned processes import this file as their main module, so the wrap
is made at import, in every process, from two environment variables that
the parent sets.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

IMPL = os.environ.get("BRIDGE_FRAMES_IMPL")
OUT = os.environ.get("BRIDGE_FRAMES_OUT")
JAX_STEPS, JAX_WARMUP = 30, 3  # hierarchical_bench.py's STEPS (ST_HIER_STEPS) and WARMUP
PORT_STEPS = 32  # the nearest multiple of 8 (the every-8 arm's period)


def _wrap(cls) -> None:
    """Log (sync_every, seconds, frames out) after each step of a bridge;
    each process appends its log to OUT as one line at close."""
    step, close = cls.step, cls.close

    def logged_step(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        if self.peer is not None:
            log = self.__dict__.setdefault("_frames_log", [])
            log.append((self.sync_every, time.perf_counter(), int(self.peer.metrics()["st_frames_out_total"])))
        return out

    def logged_close(self):
        log = self.__dict__.get("_frames_log")
        if log:
            fd = os.open(OUT, os.O_WRONLY | os.O_APPEND | os.O_CREAT)
            try:
                os.write(fd, (json.dumps({"pid": os.getpid(), "log": log}) + "\n").encode())
            finally:
                os.close(fd)
        return close(self)

    cls.step, cls.close = logged_step, logged_close


if IMPL == "jax" and OUT:
    from shared_tensor_tpu.train.hierarchical import HierarchicalTrainer as _JaxTrainer

    _wrap(_JaxTrainer)
elif IMPL == "port" and OUT:
    from shared_tensor_tpu_torch.train.hierarchical import HierarchicalTrainer as _PortTrainer

    _wrap(_PortTrainer)


def arms_frames_per_s(lines: list[dict], warmup: int) -> list[dict]:
    """Each bridge's frames/s over each arm (a run of steps with one
    sync_every) after its first ``warmup`` steps: from the end of the last
    warm-up step to the end of the arm's last step."""
    out = []
    for line in lines:
        arms: dict[int, list] = {}
        for every, t, frames in line["log"]:
            arms.setdefault(every, []).append((t, frames))
        for every, rows in arms.items():
            (t0, f0), (t1, f1) = rows[warmup - 1], rows[-1]
            out.append({"pid": line["pid"], "sync_every": every, "steps": len(rows) - warmup,
                        "frames_out": f1 - f0, "seconds": t1 - t0, "frames_per_s": (f1 - f0) / (t1 - t0)})
    return sorted(out, key=lambda r: (r["sync_every"], r["pid"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", choices=("port", "jax"), required=True)
    ap.add_argument("--host-tier", action="store_true", help="port bridge peers on the host tier (native engine)")
    args = ap.parse_args()
    os.environ["BRIDGE_FRAMES_IMPL"] = args.impl
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["BRIDGE_FRAMES_OUT"] = out = os.path.join(tmp, "frames.jsonl")
        if args.impl == "jax":
            os.environ["JAX_PLATFORMS"] = "cpu"
            os.environ["ST_HIER_STEPS"] = str(JAX_STEPS)
            import hierarchical_bench

            hierarchical_bench.main()
            warmup = JAX_WARMUP
        else:
            from shared_tensor_tpu_torch.benchmarks import hierarchical

            hierarchical.main(["--device", "cpu", "--small", "--steps", str(PORT_STEPS)]
                              + (["--host-tier"] if args.host_tier else []))
            warmup = hierarchical.WARMUP
        sys.stdout.flush()
        with open(out) as f:
            lines = [json.loads(x) for x in f]
    print(json.dumps({"impl": args.impl, "host_tier": args.host_tier, "bridges": arms_frames_per_s(lines, warmup)}),
          flush=True)


if __name__ == "__main__":
    main()
