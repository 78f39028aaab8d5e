"""The host tier's C loops alone: M elements/s of the quantize and apply
passes of ``native/stcodec.c``, through the port's ``ops/codec_np``.

    python -m shared_tensor_tpu_torch.benchmarks.host_codec_bench [--n 1048576] [--reps 50]

The counterpart of the root ``benchmarks/host_codec_bench.py``: one flat
table of ``--n`` uniform elements, ``quantize_table_np`` (the scale pass,
then sign, pack and error feedback) and ``apply_table_many_np`` (unpack and
accumulate into one array), each over the port's own ``libstcodec``
(``native()``, built on first use), the mean of ``--reps`` calls after one
warm call. Prints one JSON row an op (``ms``, ``meps``, ``native``,
``vs_ref_202meps``: the ratio to the 202 M elements/s BASELINE.md measured
for the reference's fused loop on one core), then, on its last line, one
document naming the host's CPU and the machine's card. It is host code: no
device runs it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import cpu_model, device_record
from ..config import ScalePolicy
from ..ops import codec_np
from ..ops.table import make_spec

REF_MEPS = 202.0  # BASELINE.md: the reference's quantize + apply, one core


def _mean_s(fn, reps: int) -> float:
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def run(n: int, reps: int) -> list[dict]:
    """One row an op: its mean seconds a call over ``n`` elements as ms and M
    elements/s."""
    lib = codec_np.native()
    spec = make_spec(np.zeros(n, np.float32))
    rng = np.random.default_rng(0)
    resid = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    t_q = _mean_s(lambda: codec_np.quantize_table_np(resid, spec, ScalePolicy.POW2_RMS), reps)
    scales, words, _ = codec_np.quantize_table_np(resid, spec)
    values = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    t_a = _mean_s(lambda: codec_np.apply_table_many_np((values,), scales, words, spec), reps)
    rows = []
    for op, t in (("quantize", t_q), ("apply", t_a)):
        meps = n / t / 1e6
        rows.append({"op": op, "n": n, "ms": t * 1e3, "meps": meps, "native": lib is not None,
                     "vs_ref_202meps": meps / REF_MEPS})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    cpu = cpu_model()
    for row in run(args.n, args.reps):
        print(json.dumps(row | {"cpu": cpu}), flush=True)
    card = device_record("cuda" if torch.cuda.is_available() else "cpu")
    print(json.dumps({"bench": "host_codec", "n": args.n, "reps": args.reps, "cpu": cpu, "device": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
