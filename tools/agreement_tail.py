"""Time to agreement on a four-peer tree, with port peers or with JAX peers.

    python tools/agreement_tail.py --impl port|jax [--runs 5] [--width 8] [--seed 0]

The drive of ``chip_smoke.py`` phase 8b at a CPU's size, on its template
and its data (``chip_smoke.resnet18_template``, ``tree_updates``, and
``AGREE_REL``): four peers over loopback TCP in this process (the master
seeded, three joiners), on the ResNet-18 parameter table at ``--width``
(the same 56 leaves; width 64 is the real one); once every replica holds
the seed, each peer adds its update, and the drive times the last add to
agreement: every replica within AGREE_REL of each leaf's max |value| of
seed + all updates.

``--impl port`` runs shared_tensor_tpu_torch peers on the CPU (the plain
codec); ``--impl jax`` runs shared_tensor_tpu peers on their device tier
(``ST_HOST_CODEC=xla``, XLA on the CPU), the tier the port's peers mirror.
Prints one JSON line per run and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import AGREE_REL, resnet18_template, tree_updates  # noqa: E402
from shared_tensor_tpu_torch.ops.table import tree_flatten  # noqa: E402


def leaves(tree) -> list:
    return [np.asarray(x, np.float64) for x in tree_flatten(tree)[0]]


def worst_rel(peers, want: list) -> float:
    mags = [max(float(np.abs(w).max()), 1e-30) for w in want]
    worst = 0.0
    for p in peers:
        for got, w, m in zip(leaves(p.read()), want, mags):
            worst = max(worst, float(np.abs(got - w).max()) / m)
    return worst


def wait_agree(peers, want, deadline_s: float) -> tuple[float, float]:
    t0 = time.perf_counter()
    while True:
        err = worst_rel(peers, want)
        if err <= AGREE_REL or time.perf_counter() - t0 > deadline_s:
            return time.perf_counter() - t0, err
        time.sleep(0.05)


def make_peer_factory(impl: str):
    if impl == "jax":
        os.environ["ST_HOST_CODEC"] = "xla"
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from shared_tensor_tpu.comm.peer import create_or_fetch
        from shared_tensor_tpu.config import Config, TransportConfig

        cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0))
        return lambda port, tree: create_or_fetch("127.0.0.1", port, tree, cfg, 60.0)
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch

    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0))
    return lambda port, tree: create_or_fetch("127.0.0.1", port, tree, cfg, 60.0, device="cpu")


def frames_out(p) -> int:
    return int(p.metrics().get("st_frames_out_total", 0))


def drive(make, tpl, seed: int, deadline_s: float) -> dict:
    seed_tree, deltas = tree_updates(tpl, seed, 4)
    want_seed = leaves(seed_tree)
    want = [w + sum(leaves(d)[i] for d in deltas) for i, w in enumerate(want_seed)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    peers = []
    try:
        peers.append(make(port, seed_tree))
        for _ in range(3):
            peers.append(make(port, tpl))
        t_seed, _ = wait_agree(peers, want_seed, deadline_s)
        f0 = sum(frames_out(p) for p in peers)
        for p, d in zip(peers, deltas):
            p.add(d)
        t_conv, err = wait_agree(peers, want, deadline_s)
        return {"seed_agree_s": t_seed, "last_add_to_agreement_s": t_conv, "worst_rel": err,
                "agreed": err <= AGREE_REL, "frames_out": sum(frames_out(p) for p in peers) - f0}
    finally:
        for p in peers:
            p.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", choices=("port", "jax"), required=True)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=120.0)
    args = ap.parse_args()
    make = make_peer_factory(args.impl)
    tpl = resnet18_template(args.width)
    times = []
    for run in range(args.runs):
        res = drive(make, tpl, args.seed, args.deadline)
        times.append(res["last_add_to_agreement_s"])
        print(json.dumps({"impl": args.impl, "run": run, "width": args.width, "seed": args.seed} | res), flush=True)
    print(json.dumps({"impl": args.impl, "runs": args.runs, "width": args.width, "seed": args.seed,
                      "elements": int(sum(x.size for x in leaves(tpl))), "sorted_s": sorted(times),
                      "median_s": float(np.median(times)), "max_s": max(times)}))


if __name__ == "__main__":
    main()
