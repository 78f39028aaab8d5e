"""A profiler trace of the char-RNN training step, read for the device's busy
share; or a Chrome trace of the observability timeline of a peer chain.

    python -m shared_tensor_tpu_torch.benchmarks.profile_trace [--device cpu] [--peers N] [--steps 3]
        [--batch 16] [--seq 256] [--tiny] [--out profiles/profile_trace]
    python -m shared_tensor_tpu_torch.benchmarks.profile_trace --events-out FILE

The counterpart of the root ``benchmarks/profile_trace.py``. The default
mode runs WARM steps of each arm (``sync_off``, ``compressed``,
``compressed_overlap``: ``train_bench.ARMS`` but the exact one), then
profiles ``--steps`` more with ``utils/profiling.trace``, which writes
``<out>/<arm>/trace.json`` (``<out>/<arm>/rank<i>/trace.json`` with several
ranks). The profile holds the device's side alone (kernels, copies and
the CUDA calls that launched them): recording every host op too slows the
eager host loop about twofold, and the device's share of the window falls
with it (PERF.md). ``trace`` starts the autograd profiler itself, not
``torch.profiler.profile``, whose first start in a process imports
``torch._inductor`` and Triton (seconds). A step at the flagship width is some twenty thousand eager kernels, tens
of MB of trace, so the default is 3 steps (JAX's, one fused program a
step, was 20).

It reads the device's side of each profile (:func:`device_side`) for what
the root bench's trace was read for by hand: device ms by kernel name (A's
and B's among them), and the device's busy share, the union of the kernel
intervals over the profiled window (opened right after a barrier, closed
after a device sync); the idle share is its complement. Each process sees
only its own kernels, so with ``--peers`` above 1 every rank's window and
intervals go to rank 0 (``gather_object``), which merges them on one
clock: the profiler stamps its events in ns on the host's wall clock
(the time of ``time.time_ns()``; an exported trace's ``ts`` + its
``baseTimeNanoseconds``), which every process of the host shares.
``window_start_spread_ms`` is how far apart the windows opened across
ranks on that clock (the barrier's own skew, a check on it). The card's
merged share stands beside each rank's own. On the card a profile with
no kernel events at all fails the run (it never reports a share of 0),
as do launches of A and B other than one a step in the compressed arms
(none in ``sync_off``), or no device time of theirs. On the CPU there is
no device and the shares are null.

``--events-out FILE`` instead runs a 3-node loopback chain
(``max_children=1``, so updates travel two hops), streams 12 updates
through it and exports the flight recorder's timeline as a Chrome trace
(``obs/trace_export.export_file``): open it in https://ui.perfetto.dev. It
prints the update paths and their most hops (2). The chain runs on the host
tier (the native engine), as the root bench's does: it pins JAX to the CPU,
where JAX's default tier is its engine. On the device tier the peers relay
a received stamp on their own tail frames, back and forth along the chain,
so the hop counts climb far past 2 (33 with JAX's device tier, 36 with the
port's, on the CPU).

Prints one JSON document on its last line, with the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import device_record
from . import train_bench as TB
from ..ops import codec_cuda as CC
from ..parallel.mesh import Mesh, all_true
from ..train import PodTrainer
from ..utils.profiling import trace

ARMS = tuple(a for a in TB.ARMS if a[0] != "exact")
WARM = 3  # untraced steps of each arm
STEPS = 3
WINDOW = "profile_window"
TOP = 10
COPY_KINDS = ("gpu_memcpy", "gpu_memset")
CODEC_KERNELS = {"quantize_rows": "quantize_rows_kernel", "apply_rows_batch": "apply_rows_kernel"}


def busy_share(intervals, window: tuple[int, int]) -> float:
    """The share of ``window`` = (lo, hi) that the union of ``intervals``
    covers: (start, end) pairs on one clock (integers: ns since the epoch
    are past float64's exact range), in any order, overlapping or not
    (several ranks' kernels together give the card's share), clipped to
    the window. Sorted by start, each interval adds what it reaches past
    the furthest end before it."""
    lo, hi = window
    if hi <= lo:
        raise ValueError(f"empty window {window}")
    iv = np.asarray(intervals if isinstance(intervals, np.ndarray) else list(intervals), dtype=np.int64)
    iv = iv.reshape(-1, 2)[np.argsort(iv.reshape(-1, 2)[:, 0], kind="stable")]
    s, e = np.clip(iv[:, 0], lo, hi), np.clip(iv[:, 1], lo, hi)
    reach = np.concatenate(([lo], np.maximum.accumulate(e)[:-1]))
    return int(np.maximum(e - np.maximum(s, reach), 0).sum()) / (hi - lo)


def kind(event) -> str:
    """The kineto activity type of a profiler event ("kernel",
    "gpu_memcpy", "gpu_memset", "user_annotation", ...): its
    ``activity_type()`` where torch has it; else (torch 2.11) told from its
    device, its annotation flag and its name ("cpu" for any other host
    event)."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    on_card = event.device_type() == torch.autograd.DeviceType.CUDA
    flag = getattr(event, "is_user_annotation", None)  # the window is this code's one annotation
    if flag() if flag is not None else event.name() == WINDOW:
        return "gpu_user_annotation" if on_card else "user_annotation"
    if not on_card:
        return "cpu"
    name = event.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def device_side(events, stamps: tuple[int, int]) -> dict:
    """The device's side of one profile, from its events (the profiler's
    kineto events: ``name()``, :func:`kind`, ``start_ns()`` and
    ``end_ns()``, in ns on the host's wall clock, the clock of
    ``time.time_ns()`` and of every process on the host): the window (the
    WINDOW annotation's span, or ``stamps`` where the host's ops were not
    recorded), every kernel's (start, end), device ms by kernel name, and
    the copies' and memsets' ms."""
    window, starts, ends, by_ns, copy_ns = None, [], [], {}, 0
    for e in events:
        kind_ = kind(e)
        if kind_ == "kernel":
            name, start, end = e.name(), e.start_ns(), e.end_ns()
            starts.append(start)
            ends.append(end)
            by_ns[name] = by_ns.get(name, 0) + end - start
        elif kind_ in COPY_KINDS:
            copy_ns += e.end_ns() - e.start_ns()
        elif kind_ == "user_annotation" and e.name() == WINDOW:
            window = (e.start_ns(), e.end_ns())
    return {"window": window or stamps, "kernels": np.array([starts, ends], dtype=np.int64).T.reshape(-1, 2),
            "by_name": {k: v / 1e6 for k, v in by_ns.items()}, "copy_ms": copy_ns / 1e6}


def top(by_name: dict, n: int = TOP) -> list[tuple[str, float]]:
    """The ``n`` names with the most device ms, most first."""
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def codec_ms(by_name: dict) -> dict:
    """Device ms of kernels A and B by wrapper name (their kernels' names,
    demangled, sit inside an anonymous namespace)."""
    return {k: sum(v for name, v in by_name.items() if kernel in name) for k, kernel in CODEC_KERNELS.items()}


def _share(kernels: np.ndarray, window) -> Optional[float]:
    return busy_share(kernels, window) if len(kernels) else None


def profile_window(mesh: Mesh, step: Callable[[], object], steps: int, out_dir: Optional[str]) -> dict:
    """Profile ``steps`` calls of ``step`` (already warm) on every rank of
    the mesh, write ``<out_dir>/trace.json`` (none for ``None``) and read
    the device's side (:func:`device_side`): this rank's busy share of its
    window (None without kernel events), device ms by kernel name, A's and
    B's, the launches of A and B in the window, the seconds of each stage
    of the profile, and on rank 0 ``card``: every rank's window and
    kernels merged. The profile holds the device's side alone
    (``utils/profiling.trace(host_ops=False)``): recording the host's ops
    too slows the eager host loop, and so dilutes the share. Collective."""
    dev = mesh.device
    TB.sync_device(dev)
    CC.reset_launches()
    t0 = time.perf_counter()
    with trace(out_dir, host_ops=False) as prof:
        all_true(mesh, True)  # the windows open together
        opened = time.time_ns()
        t1 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            for _ in range(steps):
                step()
            TB.sync_device(dev)
        stamps = (opened, time.time_ns())
        t2 = time.perf_counter()
    t3 = time.perf_counter()
    launches = {k: CC.LAUNCHES[k] for k in TB.KERNELS}
    d = device_side(prof.kineto_results.events(), stamps)
    del prof  # 60k events a rank at the flagship width: freed in the read's seconds
    lo, hi = d["window"]
    share = _share(d["kernels"], d["window"])
    out = {"trace": out_dir and os.path.join(out_dir, "trace.json"), "steps": steps,
           "window_ms": (hi - lo) / 1e6, "kernel_events": len(d["kernels"]), "busy_share": share,
           "idle_share": None if share is None else 1.0 - share, "kernel_ms": sum(d["by_name"].values()),
           "codec_ms": codec_ms(d["by_name"]), "copy_ms": d["copy_ms"], "by_name": d["by_name"],
           "launches": launches, "card": None}
    mine = (d["window"], d["kernels"], d["by_name"])
    root = mesh.rank_of(0, 0)
    if mesh.n_peer * mesh.n_shard == 1:
        every = [mine]
    else:
        every = [None] * mesh.n_peer if dist.get_rank() == root else None
        dist.gather_object(mine, every, dst=root, group=mesh.peer_group)
    if every is not None:
        window = (min(w[0] for w, _, _ in every), max(w[1] for w, _, _ in every))
        share = _share(np.concatenate([k for _, k, _ in every]), window)
        names: dict = {}
        for _, _, by in every:
            for k, v in by.items():
                names[k] = names.get(k, 0.0) + v
        out["card"] = {"ranks": len(every), "window_ms": (window[1] - window[0]) / 1e6, "busy_share": share,
                       "idle_share": None if share is None else 1.0 - share,
                       "window_start_spread_ms": (max(w[0] for w, _, _ in every) - window[0]) / 1e6,
                       "by_name": names}
    out["seconds"] = {"open": t1 - t0, "steps": t2 - t1, "close": t3 - t2, "read": time.perf_counter() - t3}
    return out


def run_arms(mesh: Mesh, setup: TB.Setup, steps: int, out: str, arms=ARMS) -> dict:
    """WARM steps of each arm, then :func:`profile_window` over ``steps``
    more. Collective."""
    params, loss, batch = TB.model(mesh, setup)
    res = {}
    for name, kw in arms:
        tr = PodTrainer(mesh, params, loss, **kw)
        b = tr.shard_batch(batch)
        for _ in range(WARM):
            tr.step(b, setup.lr)
        where = os.path.join(out, name) if mesh.n_peer == 1 else os.path.join(out, name, f"rank{mesh.peer}")
        res[name] = profile_window(mesh, lambda: tr.step(b, setup.lr), steps, where)
        del tr
    return res


def _summary(res: dict) -> dict:
    """One rank's arm without the full name table (its top TOP stay)."""
    out = {k: v for k, v in res.items() if k not in ("by_name", "card")}
    out["top_kernels_ms"] = top(res["by_name"])
    return out


def events_demo(out_path: str) -> dict:
    """The 3-node chain (``max_children=1``) on the host tier: 12 updates, one
    added at a node in turn, until every replica holds their sum and the
    peers drain; then the flight recorder's timeline exported as a Chrome
    trace to ``out_path``. Returns the events, the update paths and their
    most hops."""
    from .. import obs
    from ..comm.peer import create_or_fetch
    from ..config import Config, ObsConfig, TransportConfig
    from ..obs import trace_export

    hub = obs.hub()
    hub.poll_native()
    hub.recorder.clear()
    hub.recorder.set_capacity(100_000)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = Config(transport=TransportConfig(peer_timeout_sec=20.0, max_children=1),
                 obs=ObsConfig(digest_interval_sec=0.2))
    n = 4096
    seed = torch.zeros(n, dtype=torch.float32)
    peers = []
    try:
        for _ in range(3):
            peers.append(create_or_fetch("127.0.0.1", port, seed, cfg, timeout=60.0, host_tier=True))
        total = np.zeros(n, np.float64)
        rng = np.random.default_rng(0)
        for i in range(12):
            d = rng.normal(size=n).astype(np.float32)
            peers[i % len(peers)].add(torch.from_numpy(d))
            total += d
            time.sleep(0.02)
        deadline = time.time() + 60.0
        agreed = False
        while not agreed and time.time() < deadline:
            agreed = all(np.allclose(p.read().cpu().numpy(), total, atol=1e-4) for p in peers)
            time.sleep(0.05)
        for p in peers:
            p.drain(timeout=20.0, tol=1e-30)
        hub.poll_native()
        timeline = hub.recorder.timeline()
        stats = trace_export.path_stats(trace_export.trace_paths(timeline))
        trace_export.export_file(out_path, timeline)
    finally:
        for p in peers:
            p.close()
    print(f"exported {len(timeline)} events / {stats['paths']} update paths (max {stats['max_hops']} hops) "
          f"-> {out_path}", flush=True)
    return {"events": len(timeline), "paths": stats["paths"], "max_hops": stats["max_hops"], "agreed": agreed,
            "out": out_path}


def main(argv=None) -> int:
    from ..parallel import run_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU (default)")
    ap.add_argument("--peers", type=int, default=None, help="ranks of the pod (default: the number of cards)")
    ap.add_argument("--steps", type=int, default=STEPS, help="traced steps an arm")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true", help="tiny model (CI smoke)")
    ap.add_argument("--out", default=os.path.join("profiles", "profile_trace"))
    ap.add_argument("--events-out", default="", help="export the obs timeline of a 3-node chain to this file instead")
    args = ap.parse_args(argv)
    if args.events_out:  # host code: the record names the machine's card, if any
        ev = events_demo(args.events_out)
        card = device_record("cuda" if torch.cuda.is_available() else "cpu")
        print(json.dumps({"bench": "profile_trace", "device": card, "events_out": ev}), flush=True)
        return 0 if ev["agreed"] and ev["paths"] else 1
    device = torch.device("cuda" if args.device is None else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_trace: no CUDA device; pass --device cpu for the CPU")
    head = {"bench": "profile_trace", "device": device_record(device)}

    n_peer = args.peers or (torch.cuda.device_count() if device.type == "cuda" else 1)
    backend = "gloo" if device.type == "cpu" or torch.cuda.device_count() < n_peer else None
    setup = TB.Setup(cfg=TB.TINY if args.tiny else {}, batch=args.batch, seq=args.seq)
    ranks = run_mesh(run_arms, n_peer, 1, setup, args.steps, args.out, device=args.device,
                     backend=backend, timeout_s=1800)
    arms, bad = {}, []
    for name, _ in ARMS:
        card = ranks[0][name]["card"]
        arms[name] = {"ranks": [_summary(r[name]) for r in ranks],
                      "card": {k: v for k, v in card.items() if k != "by_name"} | {"top_kernels_ms": top(card["by_name"])}}
        if device.type == "cuda" and card["busy_share"] is None:
            bad.append(f"{name}: no kernel events in the trace")
        want = args.steps if device.type == "cuda" and name != "sync_off" else 0
        for rk, r in enumerate(ranks):
            if any(n != want for n in r[name]["launches"].values()):
                bad.append(f"{name} rank {rk}: launches {r[name]['launches']} (want {want} each)")
            if want and not all(r[name]["codec_ms"].values()):
                bad.append(f"{name} rank {rk}: A or B has no device time in the trace ({r[name]['codec_ms']})")
        for rk, r in enumerate(ranks):
            print(f"{name} rank {rk}: busy {r[name]['busy_share']}, window {r[name]['window_ms']:.3f} ms, "
                  f"{r[name]['kernel_events']} kernels -> {r[name]['trace']}", flush=True)
    out = head | {"backend": backend or "nccl", "n_peer": n_peer, "setup": dataclasses.asdict(setup),
                  "steps": args.steps, "arms": arms}
    print(json.dumps(out), flush=True)
    if bad:
        print("profile_trace: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
