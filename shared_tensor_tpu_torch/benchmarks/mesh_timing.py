"""Step time of the pod trainer's four sync arms on one mesh: the fused
compressed sync against the overlapped one.

    python -m shared_tensor_tpu_torch.benchmarks.mesh_timing [--device cpu] [--steps 20]

The counterpart of the root ``benchmarks/mesh_timing.py``, at its small
char-RNN (vocab 96, embed 64, hidden 192, 2 layers), N_PEER peers of batch
8 x seq 32, WARMUP then ``--steps`` (MEASURE) timed steps an arm, over four
batches in turn: ``no_sync``, ``exact_allreduce``, ``compressed_fused``
and ``compressed_overlap`` (the all-gather started before the grads and
applied after them). Each step is timed on every rank from its start to
its end, device sync included; a step's time is the slowest rank's. It
reports each arm's median, p10 and p90 step seconds and final loss, and
``overlap_vs_fused``, the ratio of the two compressed arms' medians.

On the card every rank shares the one H100 over gloo (NCCL refuses two ranks
on one device); ``--device cpu`` is JAX's CPU-mesh analog, eight gloo ranks
on the host. Prints one JSON document on its last line, with the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import device_record
from .train_bench import mesh_max, sync_device
from ..models import char_rnn as m
from ..parallel.mesh import Mesh
from ..train import PodTrainer

CFG = m.CharRNNConfig(vocab=96, embed=64, hidden=192, layers=2)
TEXT = b"the quick brown fox jumps over the lazy dog. " * 400
N_PEER = 8
BATCH, SEQ = 8, 32
WARMUP, MEASURE = 3, 20
LR = 0.1
ARMS = (
    ("no_sync", dict(sync=False)),
    ("exact_allreduce", dict(compressed=False)),
    ("compressed_fused", dict(compressed=True)),
    ("compressed_overlap", dict(compressed=True, overlap=True)),
)


def arm(mesh: Mesh, name: str, kw: dict, steps: int) -> dict:
    """One arm on this rank: WARMUP steps, then ``steps`` timed ones, each
    step's seconds the mesh's slowest rank's. Collective."""
    params = m.init_params(torch.Generator().manual_seed(0), CFG, device=mesh.device)
    tr = PodTrainer(mesh, params, lambda p, b: m.loss_fn(p, b, CFG), **kw)
    data = m.encode_corpus(TEXT, device="cpu")
    batches = [tr.shard_batch(m.make_batches(data, BATCH, SEQ, torch.Generator().manual_seed(i),
                                             n_peer=mesh.n_peer, vocab=CFG.vocab)) for i in range(4)]
    for i in range(WARMUP):
        tr.step(batches[i % 4], lr=LR)
    sync_device(mesh.device)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        losses, _ = tr.step(batches[i % 4], lr=LR)
        sync_device(mesh.device)
        times.append(time.perf_counter() - t0)
    times = sorted(mesh_max(mesh, *times))
    return {
        "arm": name,
        "median_step_s": times[len(times) // 2],
        "p10_s": times[len(times) // 10],
        "p90_s": times[(len(times) * 9) // 10],
        "final_loss": float(losses.mean()),
    }


def run_arms(mesh: Mesh, steps: int, arms=ARMS) -> list[dict]:
    return [arm(mesh, name, kw, steps) for name, kw in arms]


def main(argv=None) -> int:
    from ..parallel import run_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU (default)")
    ap.add_argument("--steps", type=int, default=MEASURE, help="timed steps an arm")
    args = ap.parse_args(argv)
    device = torch.device("cuda" if args.device is None else args.device)
    backend = "gloo" if device.type == "cpu" or torch.cuda.device_count() < N_PEER else None
    arms = run_mesh(run_arms, N_PEER, 1, args.steps, device=args.device, backend=backend, timeout_s=900)[0]
    by = {a["arm"]: a for a in arms}
    out = {
        "bench": "mesh_timing",
        "device": device_record(args.device),
        "backend": backend or "nccl",
        "n_peer": N_PEER,
        "model": {"vocab": CFG.vocab, "embed": CFG.embed, "hidden": CFG.hidden, "layers": CFG.layers,
                  "params": CFG.param_count},
        "batch": BATCH,
        "seq": SEQ,
        "measure_steps": args.steps,
        "arms": arms,
        "overlap_vs_fused": by["compressed_overlap"]["median_step_s"] / by["compressed_fused"]["median_step_s"],
    }
    print(json.dumps(out), flush=True)
    return 0 if all(np.isfinite(a["final_loss"]) for a in arms) else 1


if __name__ == "__main__":
    sys.exit(main())
