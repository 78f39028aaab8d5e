"""The reference's example.lua in the same program shape (BASELINE config 1),
on PyTorch.

    python -m shared_tensor_tpu_torch.examples.example [host] [port] [--steps N] [--device cpu]

Run it once to become the master at 127.0.0.1:50000; run more copies (the
same command, other terminals) to join the tree. Every process adds ones
each second and prints its replica: the values converge across the
processes as the updates flood through. The counterpart of the root
``examples/example.py``. The shared tensor lives on the GPU unless
``--device cpu`` asks for the CPU (without a GPU it raises).
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import create_or_fetch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("host", nargs="?", default="127.0.0.1")
    ap.add_argument("port", nargs="?", type=int, default=50000)
    ap.add_argument("--steps", type=int, default=0, help="0 = run forever")
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the GPU)")
    args = ap.parse_args()

    # torch.range(1,4):float()  (example.lua:4)
    x = torch.arange(1.0, 5.0, dtype=torch.float32)

    with create_or_fetch(args.host, args.port, x, device=args.device) as a:
        step = 0
        while args.steps == 0 or step < args.steps:
            x = a.read()  # a:copyToTensor(x)

            # do something computationally intensive with x
            results = torch.ones_like(x)

            # add our updates into a; they propagate to every other
            # connected program asynchronously
            a.add(results)  # a:addFromTensor(results)

            print(x, flush=True)
            time.sleep(1)  # just so you can see what's going on
            step += 1


if __name__ == "__main__":
    main()
