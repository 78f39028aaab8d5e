"""Config 5's scalar frame on the card, timed from several trees in turns.

    python -m shared_tensor_tpu_torch.benchmarks.scalar_codec --trees DIR [DIR ...] [--log2 20,30]

For each tree in the order given (a directory holding
``shared_tensor_tpu_torch``, such as a ``git archive`` of another commit),
a fresh process imports that tree's port and times config 5's frame
(``benchmarks.pareto.measure_size``: kernel C's path, the scale included,
then kernel D) at each size, and the sender's path alone
(``quantize_kernel`` without a scale, CUDA events over 10); at 2^20 also
the whole frame from a CUDA graph of 200. List a tree twice to alternate,
e.g. parent, change, change, parent.

Prints the card's name and power limit and one JSON line a size and tree.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import smi_line, trees_in_turns

BENCH_LOG2 = (20, 30)


#: The child: run in a tree's root, it imports that tree's port.
_FRAME_CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
from shared_tensor_tpu_torch.benchmarks import pareto
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.utils.timing import event_ms, graph_ms
CC.build()
dev = torch.device("cuda")
for log2 in json.loads(sys.argv[1]):
    n = 1 << log2
    row = pareto.measure_size(CC, n, ScalePolicy.POW2_RMS, dev, target_seconds=0.5, budget_s=60.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    r = torch.randn(n, generator=gen, device=dev)
    v = torch.zeros(n, device=dev)
    out = {"n": n, "frame_us": row["frame_us"], "equiv_gbps": row["equiv_gbps"],
           "rms_decay_per_frame": row["rms_decay_per_frame"],
           "quantize_path_ms": event_ms(lambda: CC.quantize_kernel(r, n), 10)}
    if n <= 1 << 22:
        def whole():
            f, _ = CC.quantize_kernel(r, n)
            CC.apply_frame(v, f, n)
        out["frame_graph_ms"] = graph_ms(whole, 200)
    print("FRAME " + json.dumps(out), flush=True)
    del r, v
    torch.cuda.empty_cache()
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--log2", type=lambda s: [int(x) for x in s.split(",")], default=list(BENCH_LOG2))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scalar_codec: needs a CUDA device", file=sys.stderr)
        return 2
    print(smi_line())
    return trees_in_turns(args.trees, _FRAME_CHILD, [json.dumps(args.log2)], "FRAME", "scalar_frame", args.timeout)


if __name__ == "__main__":
    sys.exit(main())
