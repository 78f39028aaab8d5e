"""The pod step's scales stage on the card, timed from several trees in turns.

    python -m shared_tensor_tpu_torch.benchmarks.pod_scales --trees DIR [DIR ...] [--steps 60] [--timed 50]

For each tree in the order given (a directory holding
``shared_tensor_tpu_torch``, such as a ``git archive`` of another commit),
a fresh process imports that tree's port, builds its kernels and runs:

- the stage alone: ``parallel.ici._leaf_scales`` (the per-leaf scales of
  a sync step) on one rank, a 1 x 1 mesh on config 2's table (3,870,976
  parameters, 30,248 rows), with a device sync after each call as
  ``utils.timing.Spans`` marks a stage: host ms over 300 calls (median,
  mean, p10, p90) after 20 warm ones;
- phase 9's pod step (``chip_smoke.py``): config 2 at full width on 4
  ranks of the one card over gloo (batch 32 x seq 128 a peer, lr 0.5),
  ``--steps`` steps of which the last ``--timed`` go through
  ``build_train_step`` with ``Spans``: each rank's mean ms a step by stage
  (grads, scales, quantize (A), gather, apply (B), update, losses).

List a tree twice to alternate, e.g. parent, change, change, parent.
Prints the card's name and power limit and one JSON line a tree. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import smi_line, trees_in_turns

#: The child: run in a tree's root (its pod's spawned ranks too), it
#: imports that tree's port.
_CHILD = r'''
import json, os, sys, time
TREE = os.path.abspath(".")
sys.path.insert(0, TREE)
STEPS, TIMED, SEED = int(sys.argv[1]), int(sys.argv[2]), 0


def _spec_params(device):
    import torch
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.ops.table import make_spec

    cfg = m.CharRNNConfig()
    params = m.init_params(torch.Generator().manual_seed(SEED), cfg, device=device)
    return cfg, params, make_spec(params)


def stage_alone(mesh):
    import numpy as np
    import torch
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.parallel import ici

    _, _, spec = _spec_params(mesh.device)
    ctx = ici._make_ctx(mesh, spec, True)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    r = torch.randn(ctx.rows_local * 128, generator=gen, device=mesh.device) * 1e-2
    ms = []
    for i in range(320):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ici._leaf_scales(ctx, r.view(-1, 128), ScalePolicy.POW2_RMS)
        torch.cuda.synchronize()
        if i >= 20:
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"rows": ctx.rows_local, "median_ms": float(np.median(ms)), "mean_ms": float(np.mean(ms)),
            "p10_ms": float(np.percentile(ms, 10)), "p90_ms": float(np.percentile(ms, 90))}


def pod_step(mesh):
    import torch
    from shared_tensor_tpu_torch.examples.train_char_rnn import PANGRAM
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.train import PodTrainer, build_train_step
    from shared_tensor_tpu_torch.utils.timing import Spans

    cfg, params, _ = _spec_params(mesh.device)
    loss = lambda p, b: m.loss_fn(p, b, cfg)
    data = m.encode_corpus(PANGRAM, device=mesh.device)
    tr = PodTrainer(mesh, params, loss)
    spans = Spans(mesh.device)
    timed = build_train_step(mesh, tr.spec, loss, spans=spans)
    for i in range(STEPS):
        batch = tr.shard_batch(m.make_batches(data, 32, 128, torch.Generator().manual_seed(SEED * 100_003 + i),
                                              n_peer=mesh.n_peer))
        if i < STEPS - TIMED:
            l, _ = tr.step(batch, lr=0.5)
        else:
            tr.state, _, l, _ = timed(tr.state, None, batch, 0.5)
        l.cpu()
    return spans.ms()


if __name__ == "__main__":
    import torch
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.parallel import run_mesh

    assert os.path.dirname(os.path.dirname(os.path.abspath(CC.__file__))).startswith(TREE), CC.__file__
    CC.build()
    (alone,) = run_mesh(stage_alone, 1, 1, device="cuda", backend="gloo", timeout_s=300)
    ranks = run_mesh(pod_step, 4, 1, device="cuda", backend="gloo", timeout_s=600)
    print("SCALES " + json.dumps({"steps": STEPS, "timed": TIMED, "stage_alone": alone, "pod_stage_ms": ranks}),
          flush=True)
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--timed", type=int, default=50)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pod_scales: needs a CUDA device", file=sys.stderr)
        return 2
    print(smi_line())
    return trees_in_turns(args.trees, _CHILD, [args.steps, args.timed], "SCALES", "pod_scales", args.timeout)


if __name__ == "__main__":
    sys.exit(main())
