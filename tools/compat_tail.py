"""Phase 14b's traffic on the reference wire, with port peers or JAX peers,
on the CPU.

    python tools/compat_tail.py --impl port|jax [--n 3870976] [--mode at-once|in-turn]
                                [--seconds 30] [--seed 0] [--master-frame-delay S]

The drive of ``chip_smoke.py`` phase 14b on its data (``tree_updates(...,
seed + 14, 3)`` on one flat f32 tensor of ``--n`` elements, config 2's
width by default): three ``wire_compat`` peers over loopback TCP in this
process, a master on the device tier seeded, a joiner on the native engine
and a joiner on the device tier. Once every replica holds the seed, each
peer adds its update: all three at once (``at-once``), or each in turn,
waiting for agreement after each (``in-turn``, what the phase gates on).
Each peer first adds zeros, so no timed add pays for a first compile.
The drive then reads, every half second for ``--seconds``, the worst
replica's max |replica - target| / max |target| (the phase's AGREE_REL
measure), and each peer's frames out.

``--impl port`` runs shared_tensor_tpu_torch peers (``device="cpu"``: the
plain codec; ``host_tier=True``: the engine). ``--impl jax`` runs
shared_tensor_tpu peers, the device tier on XLA's CPU (``ST_HOST_CODEC=xla``)
and the engine tier (``ST_HOST_CODEC=numpy``), set around each peer's
creation.

``--master-frame-delay S`` sleeps S seconds before each frame the master
quantizes (its ``st.begin_frame``), slowing its send rate and nothing else:
with it the JAX master sends at the pace the port's does, so the two can be
compared at one frame rate. Whether an update that arrives from a child
lands in a link's residual before or after the master's own update has
drained from it decides the drain: a residual that is one update bounded by
a power of two halves every frame, the sum of two does not. Prints one JSON
line per reading and a summary line.
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

from chip_smoke import AGREE_REL, _with_env, tree_updates  # noqa: E402

TIERS = ("device", "engine", "device")


def make_factory(impl: str):
    """(create(port, tensor, tier), read(handle) -> flat f64 numpy,
    frames_out(handle))."""
    if impl == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from shared_tensor_tpu.compat import createOrFetch
        from shared_tensor_tpu.config import Config, TransportConfig

        cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0, wire_compat=True))

        def create(port, tensor, tier):
            env = {"ST_HOST_CODEC": "numpy" if tier == "engine" else "xla"}
            return _with_env(env, lambda: createOrFetch("127.0.0.1", port, tensor, cfg))
    else:
        from shared_tensor_tpu_torch import Config, TransportConfig
        from shared_tensor_tpu_torch.compat import createOrFetch

        cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0, wire_compat=True))

        def create(port, tensor, tier):
            if tier == "engine":
                return createOrFetch("127.0.0.1", port, tensor, cfg, host_tier=True)
            return createOrFetch("127.0.0.1", port, tensor, cfg, device="cpu")

    def read(h) -> np.ndarray:
        v = h.copyToTensor()
        v = v.numpy() if hasattr(v, "numpy") and not isinstance(v, np.ndarray) else v
        return np.asarray(v, np.float64).reshape(-1)

    def frames_out(h) -> int:
        return int(h._peer.metrics().get("st_frames_out_total", 0))

    return create, read, frames_out


def worst_rel(handles, read, want: np.ndarray) -> float:
    mag = max(float(np.abs(want).max()), 1e-30)
    return max(float(np.abs(read(h) - want).max()) / mag for h in handles)


def wait_agree(handles, read, want, deadline_s: float) -> tuple[float, float]:
    t0 = time.perf_counter()
    while True:
        err = worst_rel(handles, read, want)
        if err <= AGREE_REL or time.perf_counter() - t0 > deadline_s:
            return time.perf_counter() - t0, err
        time.sleep(0.05)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", choices=("port", "jax"), required=True)
    ap.add_argument("--n", type=int, default=3_870_976)
    ap.add_argument("--mode", choices=("at-once", "in-turn"), default="at-once")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--master-frame-delay", type=float, default=0.0)
    args = ap.parse_args()
    create, read, frames_out = make_factory(args.impl)
    template = np.zeros(args.n, np.float32)
    seed_tree, deltas = tree_updates(template, args.seed + 14, 3)
    want_seed = np.asarray(seed_tree, np.float64)
    want = want_seed + sum(np.asarray(d, np.float64) for d in deltas)
    bounds = [float(np.abs(d).max()) for d in deltas]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    handles = []
    try:
        handles.append(create(port, seed_tree, TIERS[0]))
        if args.master_frame_delay > 0:
            st = handles[0]._peer.st
            begin = st.begin_frame

            def slow_begin(link, _begin=begin, _s=args.master_frame_delay):
                time.sleep(_s)
                return _begin(link)

            st.begin_frame = slow_begin
        for tier in TIERS[1:]:
            handles.append(create(port, template, tier))
        for h in handles:
            h.addFromTensor(template)  # a zero add: compiles the add path before the timed adds
        t_seed, _ = wait_agree(handles, read, want_seed, 60.0)
        f0 = [frames_out(h) for h in handles]
        t0 = time.perf_counter()
        per_add = []
        for i, (h, d) in enumerate(zip(handles, deltas)):
            h.addFromTensor(d)
            if args.mode == "in-turn":
                part = want_seed + sum(np.asarray(x, np.float64) for x in deltas[: i + 1])
                per_add.append(wait_agree(handles, read, part, args.seconds)[0])
        readings, agreed_s = [], None
        t1 = time.perf_counter()
        while True:
            err = worst_rel(handles, read, want)
            t = time.perf_counter() - t1
            if agreed_s is None and err <= AGREE_REL:
                agreed_s = t
            row = {"t_s": t, "worst_rel": err, "frames_out": [frames_out(h) - f for h, f in zip(handles, f0)]}
            readings.append(row)
            print(json.dumps(row), flush=True)
            if t > args.seconds:
                break
            time.sleep(0.5)
    finally:
        for h in reversed(handles):
            h.close()
    print(json.dumps({"impl": args.impl, "n": args.n, "mode": args.mode, "seed": args.seed,
                      "master_frame_delay_s": args.master_frame_delay,
                      "update_bounds": bounds, "seed_agree_s": t_seed, "in_turn_add_to_agree_s": per_add,
                      "last_add_to_agree_s": agreed_s, "worst_rel_at_end": readings[-1]["worst_rel"],
                      "seconds": readings[-1]["t_s"], "frames_out": readings[-1]["frames_out"],
                      "adds_window_s": t1 - t0}))


if __name__ == "__main__":
    main()
