"""Training throughput of the char-RNN pod trainer: ms a step, tokens/s, MFU
and sync overhead, in four arms of the same step.

    python -m shared_tensor_tpu_torch.benchmarks.train_bench [--device cpu] [--peers N]
        [--batch 16] [--seq 256] [--tiny]

The counterpart of the root ``benchmarks/train_bench.py``. The arms are
``PodTrainer``s (``train/async_sgd.py``) that differ only in the sync:

- ``sync_off``: local SGD, no communication (the baseline);
- ``compressed``: the 1-bit error-feedback sync (kernels A and B);
- ``compressed_overlap``: the same codec, its all-gather started before the
  grads and applied after them;
- ``exact``: the uncompressed delta exchange (an all-reduce).

Sync overhead is (t_arm - t_sync_off) / t_sync_off, of the median step
times. The ranks come from
``parallel.run_mesh``: ``--peers`` defaults to the number of cards (one on
the H100); ``--peers 4`` is BASELINE config 2's pod, four ranks on one card
over gloo (NCCL refuses two ranks on one device).

Timing. JAX chains the steps inside one jitted ``fori_loop``. The port runs
eagerly: a chain is k steps of the same batch in a host loop ended by a
device sync, and the slowest rank's seconds over k is its step time. Each
arm is built and warmed (WARM steps), then its k doubles from 2 until a
chain takes TARGET_S (2 s, JAX's target), while the wall-clock budget
``ST_TRAIN_BENCH_BUDGET_S`` (600 s, JAX's) lasts; an arm starts only with
MIN_ARM_S of its share of the budget left. Then ROUNDS timed chains of
every arm run in turn, the arms interleaved, so that a drift of the host's
speed falls on all of them alike. An arm reports the median step time and
its p10 and p90 over its chains; its sync overhead is resolved only where
the p10-p90 ranges of the arm and of ``sync_off`` do not overlap (an eager
host loop's chains spread by more than a sync of a few ms).

FLOPs and MFU. ``flops_per_token`` is JAX's analytic 6N (N the matmul
parameters a token touches). ``models/char_rnn._mm`` rounds its operands to
bf16 but multiplies them in f32, so the matmuls run at the f32 rate: 67
TFLOP/s on the H100 SXM data sheet, outside the tensor cores, or 495 TFLOP/s
when TF32 is on (``torch.backends.cuda.matmul.allow_tf32``, read in the
ranks at run time; nothing in the port sets it). ``mfu`` is taken against
that peak, and the document names it (``peak_flops``,
``matmul_precision``); ``ST_PEAK_FLOPS`` overrides the peak, as in JAX. On
the CPU ``mfu`` is null.

Launches. In the compressed arms every rank launches A and B once a step on
the card (0 on the CPU, where the wrappers take their plain versions); the
other arms launch none. A count off that is an arm's error.

Prints one JSON document on its last line, with the device. Exits 1 if any
arm failed or found no budget left (the document still prints).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import device_record
from ..convert import table_from_numpy
from ..models import char_rnn as m
from ..ops import codec_cuda as CC
from ..parallel.mesh import Mesh, all_reduce_, all_true
from ..train import PodTrainer

ARMS = (
    ("sync_off", dict(sync=False)),
    ("compressed", dict(sync=True, compressed=True)),
    ("compressed_overlap", dict(sync=True, compressed=True, overlap=True)),
    ("exact", dict(sync=True, compressed=False)),
)
TINY = dict(vocab=64, embed=32, hidden=64, layers=2)  # JAX's --tiny
TEXT = b"the quick brown fox jumps over the lazy dog. " * 200  # JAX's corpus
WARM = 3  # untimed steps at the start of each arm
MIN_ARM_S = 20.0  # an arm starts only with this much of its budget share left (JAX's)
TARGET_S = 2.0  # seconds a timed chain of steps aims at (JAX's)
ROUNDS = 5  # timed chains an arm, the arms in turn
SEED = 0
MAX_K = 100_000
KERNELS = ("quantize_rows", "apply_rows_batch")
#: Dense peaks of the H100 SXM data sheet (FLOP/s) by the precision the
#: f32 matmuls run at.
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12}


def flops_per_token(cfg: m.CharRNNConfig) -> int:
    """Analytic matmul FLOPs per token of one training step (JAX's): per
    layer the input projection d x 4H and the recurrent H x 4H, plus the
    output projection H x V (the embedding is a gather). Forward 2N,
    backward 4N: 6N."""
    n = 0
    d = cfg.embed
    for _ in range(cfg.layers):
        n += d * 4 * cfg.hidden + cfg.hidden * 4 * cfg.hidden
        d = cfg.hidden
    n += cfg.hidden * cfg.vocab
    return 6 * n


def matmul_peak(device) -> tuple[Optional[float], str]:
    """(peak FLOP/s, precision) of the port's f32 matmuls on ``device``:
    ``"tf32"`` when cuBLAS may use TF32, else ``"fp32"``; the peak is
    ``ST_PEAK_FLOPS`` if set, else the data sheet's, and None on the CPU."""
    precision = "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"
    if torch.device(device).type != "cuda":
        return None, precision
    env = os.environ.get("ST_PEAK_FLOPS")
    return (float(env) if env else PEAK_FLOPS[precision]), precision


@dataclasses.dataclass(frozen=True)
class Setup:
    """One run: the model (``CharRNNConfig`` keywords; empty is the
    flagship), the per-peer batch, the rate, a chain's target seconds and
    the budget.
    ``params`` (a numpy pytree) and ``batch_np`` (numpy (x, y), each
    [n_peer, batch, seq]) replace the seeded parameters and batch."""

    cfg: dict = dataclasses.field(default_factory=dict)
    batch: int = 16
    seq: int = 256
    lr: float = 0.05
    target_seconds: float = TARGET_S
    budget_s: float = 600.0
    t0: float = 0.0  # time.time() at which the budget started
    params: Any = None
    batch_np: Any = None


def sync_device(device: torch.device) -> None:
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_max(mesh: Mesh, *vals: float) -> list[float]:
    """The mesh-wide max of each value, on every rank (collective)."""
    t = torch.tensor(vals, dtype=torch.float64, device=mesh.device)
    all_reduce_(mesh, t, dist.ReduceOp.MAX, mesh.peer_group)
    all_reduce_(mesh, t, dist.ReduceOp.MAX, mesh.shard_group)
    return t.tolist()


def model(mesh: Mesh, setup: Setup):
    """(params, loss_fn, batch [n_peer, batch, seq] on the CPU) of a run;
    ``PodTrainer`` and ``shard_batch`` move them to the mesh's device."""
    cfg = m.CharRNNConfig(**setup.cfg)
    if setup.params is None:
        params = m.init_params(torch.Generator().manual_seed(SEED), cfg, device=mesh.device)
    else:
        params = table_from_numpy(setup.params)
    if setup.batch_np is None:
        data = m.encode_corpus(TEXT, device="cpu")
        batch = m.make_batches(data, setup.batch, setup.seq, torch.Generator().manual_seed(SEED + 1),
                               n_peer=mesh.n_peer, vocab=cfg.vocab)
    else:
        batch = tuple(torch.from_numpy(np.asarray(x)) for x in setup.batch_np)
    return params, (lambda p, b: m.loss_fn(p, b, cfg)), batch


def chain(mesh: Mesh, tr: PodTrainer, batch, lr: float, k: int) -> tuple[float, torch.Tensor]:
    """(the slowest rank's seconds, the last losses) of k steps of ``batch``
    run back to back from a common start and ended by a device sync.
    Collective."""
    sync_device(mesh.device)
    all_true(mesh, True)  # every rank starts together
    t0 = time.perf_counter()
    for _ in range(k):
        losses, _ = tr.step(batch, lr)
    sync_device(mesh.device)
    (secs,) = mesh_max(mesh, time.perf_counter() - t0)
    return secs, losses


def calibrate(mesh: Mesh, tr: PodTrainer, batch, setup: Setup, deadline: float) -> tuple[int, int]:
    """(k, steps taken): k doubles from 2 until a chain of ``tr`` on
    ``batch`` takes ``setup.target_seconds``, or the deadline passes.
    Collective."""
    k = 2
    secs, _ = chain(mesh, tr, batch, setup.lr, k)
    steps = k
    while secs < setup.target_seconds and k < MAX_K:
        if mesh_max(mesh, float(time.time() > deadline))[0]:
            break
        k = min(MAX_K, max(2 * k, int(setup.target_seconds / max(secs / k, 1e-9))))
        secs, _ = chain(mesh, tr, batch, setup.lr, k)
        steps += k
    return k, steps


def guarded(mesh: Mesh, fn) -> tuple[Any, Optional[str]]:
    """(fn(), None), or (None, the error) where ``fn`` raised on this rank
    or on another. Collective: the ranks agree on the failure, so that an
    arm's error does not cost the other arms."""
    try:
        res, err = fn(), None
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        res, err = None, f"{type(e).__name__}: {e}"
    if not all_true(mesh, err is None) and err is None:
        err = "failed on another rank"
    return res, err


def run_arms(mesh: Mesh, setup: Setup, arms=ARMS) -> dict:
    """Every arm on this rank: {name: its step times, or {"error": ...}}.
    Each arm in order is built, warmed and calibrated (:func:`calibrate`);
    then ROUNDS chains of every live arm run in turn. An arm's launches of
    A and B are counted over all of its steps. Collective."""
    params, loss, batch = model(mesh, setup)
    deadline = setup.t0 + setup.budget_s
    out: dict = {}
    live: dict = {}

    def counted(arm: dict, fn):
        CC.reset_launches()
        res = fn()
        for n in KERNELS:
            arm["launches"][n] += CC.LAUNCHES[n]
        return res

    for i, (name, kw) in enumerate(arms):
        share = (deadline - time.time()) / (len(arms) - i)
        if not all_true(mesh, share >= MIN_ARM_S):
            out[name] = {"error": "budget exhausted"}
            continue
        arm = {"launches": dict.fromkeys(KERNELS, 0), "samples": []}

        def start():
            tr = PodTrainer(mesh, params, loss, **kw)
            b = tr.shard_batch(batch)
            warm = [tr.step(b, setup.lr)[0].cpu().numpy() for _ in range(WARM)]
            k, steps = calibrate(mesh, tr, b, setup, time.time() + share)
            return tr, b, np.stack(warm), k, WARM + steps

        res, err = guarded(mesh, lambda: counted(arm, start))
        if err is not None:
            out[name] = {"error": err}
            continue
        arm["tr"], arm["batch"], arm["warm_losses"], arm["k"], arm["steps"] = res
        live[name] = arm
    for r in range(ROUNDS):
        if r and mesh_max(mesh, float(time.time() > deadline))[0]:
            break
        for name, arm in list(live.items()):
            res, err = guarded(mesh, lambda: counted(arm, lambda: chain(mesh, arm["tr"], arm["batch"], setup.lr,
                                                                         arm["k"])))
            if err is not None:
                out[name] = {"error": err}
                del live[name]
                continue
            arm["samples"].append(res[0] / arm["k"])
            arm["steps"] += arm["k"]
            arm["final_loss"] = float(res[1].mean())
    for name, arm in live.items():
        t = np.asarray(arm["samples"])
        out[name] = {"step_s": float(np.median(t)), "step_s_p10": float(np.percentile(t, 10)),
                     "step_s_p90": float(np.percentile(t, 90)), "chains": len(t), "k": arm["k"],
                     "steps": arm["steps"], "warm_losses": arm["warm_losses"], "final_loss": arm["final_loss"],
                     "launches": arm["launches"]}
    out["matmul_peak"] = matmul_peak(mesh.device)
    return out


def summarize(ranks: list[dict], setup: Setup, n_peer: int, device, arms=ARMS) -> dict:
    """The document: every arm's median ms a step with its p10 and p90,
    tokens/s, MFU, sync overhead (and whether it stands out of the spread)
    and launches (per rank), checked against the steps taken."""
    cfg = m.CharRNNConfig(**setup.cfg)
    fpt = flops_per_token(cfg)
    peak, precision = ranks[0]["matmul_peak"]
    on_card = torch.device(device).type == "cuda"
    tokens_per_step = n_peer * setup.batch * setup.seq
    out: dict = {
        "metric": "train_step_bench", "model": "char_rnn",
        "config": {"vocab": cfg.vocab, "embed": cfg.embed, "hidden": cfg.hidden, "layers": cfg.layers,
                   "params": cfg.param_count, "n_peer": n_peer, "batch": setup.batch, "seq": setup.seq},
        "flops_per_token": fpt, "tokens_per_step": tokens_per_step,
        "peak_flops": peak, "matmul_precision": precision, "arms": {},
    }
    base = None
    for name, kw in arms:
        res = [r[name] for r in ranks]
        err = next((r["error"] for r in res if "error" in r), None)
        if err is not None:
            out["arms"][name] = {"error": err}
            continue
        r0 = res[0]
        t = r0["step_s"]
        tok_s = tokens_per_step / t
        arm = {"step_ms": 1e3 * t, "step_ms_p10": 1e3 * r0["step_s_p10"], "step_ms_p90": 1e3 * r0["step_s_p90"],
               "chains": r0["chains"], "k": r0["k"], "tokens_per_s": tok_s,
               "mfu": fpt * tok_s / peak if peak else None, "steps": r0["steps"], "final_loss": r0["final_loss"],
               "launches": {k: [r["launches"][k] for r in res] for k in KERNELS}}
        if name == "sync_off":
            base = r0
        elif base is not None:
            arm["sync_overhead_pct"] = (t - base["step_s"]) / base["step_s"] * 100.0
            arm["sync_overhead_resolved"] = (r0["step_s_p10"] > base["step_s_p90"]
                                             or r0["step_s_p90"] < base["step_s_p10"])
        want = arm["steps"] if on_card and kw.get("sync", True) and kw.get("compressed", True) else 0
        wrong = {k: v for k, v in arm["launches"].items() if any(x != want for x in v)}
        if wrong:
            arm["error"] = f"launches {wrong}, want {want} a rank"
        out["arms"][name] = arm
    return out


def main(argv=None) -> int:
    from ..parallel import run_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU (default)")
    ap.add_argument("--peers", type=int, default=None, help="ranks of the pod (default: the number of cards)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true", help="tiny model (CI smoke)")
    args = ap.parse_args(argv)
    t0 = time.time()
    device = torch.device("cuda" if args.device is None else args.device)
    n_peer = args.peers or (torch.cuda.device_count() if device.type == "cuda" else 1)
    backend = "gloo" if device.type == "cpu" or torch.cuda.device_count() < n_peer else None
    setup = Setup(cfg=TINY if args.tiny else {}, batch=args.batch, seq=args.seq, target_seconds=TARGET_S,
                  budget_s=float(os.environ.get("ST_TRAIN_BENCH_BUDGET_S", "600")), t0=t0)
    arms = ARMS  # read at call time, so that a caller may swap the arms
    head = {"device": device_record(args.device), "backend": backend or "nccl"}
    try:
        ranks = run_mesh(run_arms, n_peer, 1, setup, arms, device=args.device, backend=backend,
                         timeout_s=setup.budget_s + 300)
    except (RuntimeError, TimeoutError) as e:
        print(json.dumps(head | {"metric": "train_step_bench", "error": f"{type(e).__name__}: {e}"}), flush=True)
        return 1
    out = summarize(ranks, setup, n_peer, device, arms) | head | {"seconds": time.time() - t0}
    print(json.dumps(out), flush=True)
    failed = [k for k, v in out["arms"].items() if "error" in v]
    if failed:
        print(f"train_bench: arms {failed} failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
