"""The serving tier under write load: read rate against verified staleness,
and the hot swap.

    python -m shared_tensor_tpu_torch.benchmarks.serve [--device cpu] [--small] [--seconds S]

The counterpart of the root ``benchmarks/serve_bench.py``, with its arms:

- **Pareto**: two writers (a device-tier master and one native-engine
  peer below it) add seeded deltas at a paced rate while one read-only
  subscriber serves ``read_flat(bound)``; for each staleness bound, the
  reads per second (paced like a request frontend, not a spin loop that
  would starve the subscriber's own thread of the GIL), the staleness of
  every attempt at p50 and p99 (a refused read counts its staleness too)
  and the refused fraction;
- **hot swap**: a ``ServingHandle`` on ``--device``, refreshed by a
  background thread every 20 ms, and ``params()`` reference reads: what a
  model server's request path pays, with the refresh's ms.

The subscriber is host numpy, as the JAX package's: its apply ms per frame
is reported beside the arms. The table is BASELINE config 2's (the default
char-RNN, 3,870,976 elements); ``--small`` is a narrow char-RNN for the
CPU. ``--device`` places the master and the handle (default: the GPU,
which raises without one). Prints one JSON line. ``chip_smoke.py`` phase
13 calls :func:`tables` and :func:`read_arm` on its own tree.
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time

import numpy as np
import torch

#: Adds per second per writer at config 2's width: paced, since unpaced
#: engine writers produce frames far faster than a subscriber's numpy
#: apply absorbs them, and the arm would only measure queue growth.
ADD_HZ = 10.0
#: Read attempts per second of a verification arm.
READ_HZ = 2000.0
BOUNDS = (0.05, 0.25, 1.0)


def _pct(sorted_xs, q):
    if not sorted_xs:
        return None
    return sorted_xs[min(len(sorted_xs) - 1, int(q * (len(sorted_xs) - 1)))]


def paced_adds(peer, deltas, hz: float, stop: threading.Event, count: list) -> threading.Thread:
    """A thread that adds ``deltas`` in turn to ``peer`` ``hz`` times a
    second until ``stop``; ``count[0]`` counts the adds."""

    def loop():
        period = 1.0 / hz if hz > 0 else 0.0
        nxt = time.monotonic()
        i = 0
        while not stop.is_set():
            peer.add(deltas[i % len(deltas)])
            i += 1
            count[0] += 1
            if period:
                nxt += period
                lag = nxt - time.monotonic()
                if lag > 0:
                    stop.wait(lag)
                else:
                    nxt = time.monotonic()

    t = threading.Thread(target=loop, daemon=True, name="serve-bench-adds")
    t.start()
    return t


def read_arm(sub, bound: float, seconds: float, read_hz: float = READ_HZ) -> dict:
    """``read_flat(bound)`` paced at ``read_hz`` for ``seconds`` in this
    thread: reads/s, the refused fraction, the p99 read latency and the
    p50/p99 staleness of every attempt."""
    from ..serve import StalenessError

    reads = refused = 0
    stal, lat = [], []
    period = 1.0 / read_hz if read_hz > 0 else 0.0
    t0 = time.monotonic()
    nxt = t0
    while time.monotonic() - t0 < seconds:
        ta = time.perf_counter()
        try:
            _flat, s, _ver = sub.read_flat(bound)
            reads += 1
            stal.append(s)
        except StalenessError as e:
            refused += 1
            if math.isfinite(e.staleness):
                stal.append(e.staleness)
        lat.append(time.perf_counter() - ta)
        if period:
            nxt += period
            lag = nxt - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            else:
                nxt = time.monotonic()
    dt = time.monotonic() - t0
    lat.sort()
    stal.sort()
    attempts = reads + refused
    return {
        "bound_s": bound, "seconds": dt, "reads": reads, "refused": refused,
        "read_per_s": reads / dt, "refused_fraction": refused / attempts if attempts else None,
        "read_latency_p99_us": _pct(lat, 0.99) * 1e6 if lat else None,
        "staleness_p50_s": _pct(stal, 0.50), "staleness_p99_s": _pct(stal, 0.99),
    }


def hot_swap_arm(sub, bound: float, seconds: float, device) -> dict:
    """A background refresher (every 20 ms) of a ServingHandle on
    ``device`` and ``params()`` reads in chunks of 10,000 (with a 1 ms
    breath, so the refresher and the subscriber get the GIL)."""
    from ..serve import StalenessError

    handle = sub.serving_handle(max_staleness=bound, device=device)
    stop = threading.Event()
    refresh_ms = []

    def refresher():
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                if handle.refresh():
                    refresh_ms.append(1e3 * (time.perf_counter() - t0))
            except StalenessError:
                pass
            stop.wait(0.02)

    rt = threading.Thread(target=refresher, daemon=True, name="serve-bench-refresh")
    rt.start()
    try:
        deadline = time.monotonic() + 30.0
        while handle.params() is None and time.monotonic() < deadline:
            time.sleep(0.01)
        if handle.params() is None:
            raise TimeoutError("the handle never verified fresh within 30 s")
        n = 0
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            for _ in range(10_000):
                handle.params()
            n += 10_000
            time.sleep(0.001)
        dt = time.monotonic() - t0
    finally:
        stop.set()
        rt.join(timeout=10.0)
    refresh_ms.sort()
    return {"params_per_s": n / dt, "swaps": handle.swaps, "refresh_ms_p50": _pct(refresh_ms, 0.5),
            "refresh_ms_max": refresh_ms[-1] if refresh_ms else None, "device": str(handle.device)}


def tables(cfg, seed: int, n: int = 2):
    """The serving benches' data, from ``seed``: the zero template of the
    char-RNN ``cfg``'s table; its init (``init_params``) with every leaf
    redrawn uniform in +-2^round(log2(its std * sqrt(3))), the power of two
    nearest the init's spread (2^-6 for a leaf of zeros), so that the seed
    has the init's scale and the codec drains it exactly (a residual whose
    bound is not a power of two drains its sparse outliers over thousands
    of frames); and ``n`` updates, each leaf uniform in 2^-6 of its seed's
    bound (an SGD step's size, a power of two again)."""
    from ..models import char_rnn as m
    from ..ops.table import tree_flatten, tree_unflatten

    init, treedef = tree_flatten(m.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu"))
    rng = np.random.default_rng(seed + 13)
    mags = [2.0 ** np.round(np.log2(float(x.std()) * 3**0.5)) if float(x.std()) > 0 else 2.0**-6 for x in init]

    def draw(scale):
        leaves = [(rng.uniform(-1, 1, tuple(x.shape)) * g * scale).astype(np.float32) for x, g in zip(init, mags)]
        return tree_unflatten(treedef, leaves)

    template = tree_unflatten(treedef, [np.zeros(tuple(x.shape), np.float32) for x in init])
    return template, draw(1.0), [draw(2.0**-6) for _ in range(n)]


def run(device, small: bool, seconds: float, repeats: int, bounds=BOUNDS, add_hz: float = ADD_HZ,
        read_hz: float = READ_HZ, seed: int = 0) -> dict:
    """Both arms on a tree of its own: a master on ``device`` seeded with
    :func:`tables`' data, an engine writer and one subscriber over
    loopback; both writers add the updates in turn at ``add_hz``."""
    from .. import Config, TransportConfig, create_or_fetch, serve
    from ..models import char_rnn as m
    from .hierarchical import SMALL

    cfg_model = m.CharRNNConfig(**SMALL.cfg) if small else m.CharRNNConfig()
    template, seed_tree, deltas = tables(cfg_model, seed, 4)
    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0))
    port = _free_port()
    peers, sub = [], None
    stop, counts, threads = threading.Event(), [[0], [0]], []
    try:
        peers.append(create_or_fetch("127.0.0.1", port, seed_tree, cfg, timeout=60.0, device=device))
        peers.append(create_or_fetch("127.0.0.1", port, template, cfg, timeout=60.0, host_tier=True))
        sub = serve.subscribe("127.0.0.1", port, template, cfg, timeout=60.0)
        t_load = time.monotonic()
        threads = [paced_adds(p, deltas, add_hz, stop, c) for p, c in zip(peers, counts)]
        time.sleep(1.0)  # the write load reaches steady state
        pareto = [{"bound_s": b, "repeats": [read_arm(sub, b, seconds, read_hz) for _ in range(repeats)]}
                  for b in bounds]
        hot = hot_swap_arm(sub, max(bounds), seconds, device)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        if sub is not None:
            sub.close()
        for p in reversed(peers):
            p.close()
    wrote = time.monotonic() - t_load
    return {
        "bench": "serve", "elements": sub.spec.total_n, "writers": 2,
        "engine_writer": peers[1]._engine is not None, "add_hz_per_writer": add_hz, "read_hz": read_hz,
        "seconds_per_arm": seconds, "repeats": repeats, "pareto": pareto, "hot_swap": hot,
        "adds_per_s": (counts[0][0] + counts[1][0]) / wrote, "subscriber": sub.metrics(),
        "apply_ms_per_frame": 1e3 * sub.apply_s / max(1, sub.frames_applied), "frames_applied": sub.frames_applied,
    }


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU (default)")
    ap.add_argument("--small", action="store_true", help="a narrow char-RNN for the CPU")
    ap.add_argument("--seconds", type=float, default=3.0, help="seconds per arm")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--add-hz", type=float, default=ADD_HZ)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.small, args.seconds, args.repeats, add_hz=args.add_hz, seed=args.seed)))


if __name__ == "__main__":
    main()
