"""The native engine's steady state end to end: two processes over loopback,
each a port peer on the host tier (the engine), at one table size.

    python -m shared_tensor_tpu_torch.benchmarks.engine_bench [--n N] [--seconds S]
        [--compat] [--stripes K] [--no-shm]

The counterpart of the root ``benchmarks/engine_bench.py``'s ``run_size``.
A master adds fresh deltas on a fixed period, so its link never idles, and
a child reports the frames it applied per second over a window that opens
once frames flow: the full stack, quantize, encode, TCP, decode, flood
apply and ACK, in the engine's C threads. Prints one JSON line: the
child's frames/s, the equivalent applied fp32 bandwidth, and whether each
peer ran the engine (a Python-tier rate must not pass for the engine's).

The arms: ``--compat`` runs both peers on the reference wire format (the
engine's compat data plane; the root bench's ``ST_ENGINE_BENCH_COMPAT=1``);
``--stripes K`` runs each link over K sockets and ``--no-shm`` keeps it on
TCP (``benchmarks/engine_sweep_r14.py``'s ``tcp2`` arm is ``--stripes 2
--no-shm``). By default a same-host pair runs over the shared-memory lane,
and the row says whether the lane carried the link (``shm_active``: 2).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import time

N = 1 << 20
MEASURE_S = 8.0
JOIN_S = 25.0  # the child's bound on the join and the first frame


def add_period(n: int) -> float:
    """The master's add period: one add per ms at 1 Mi (an add is two
    fused table passes), scaled with n, so that residual mass never
    quiesces and the codec stream still owns the core."""
    return max(0.001, n / (1 << 20) * 0.001)


def _cfg(arm: dict):
    from ..config import Config, TransportConfig

    return Config(transport=TransportConfig(
        peer_timeout_sec=30.0, wire_compat=arm["compat"], stripe_count=arm["stripes"], shm_enabled=arm["shm"]))


def _template(n: int, arm: dict):
    import numpy as np

    # the reference format syncs one flat tensor
    return np.zeros(n, np.float32) if arm["compat"] else {"w": np.zeros(n, np.float32)}


def _master(n: int, port: int, q, done, measure_s: float, arm: dict) -> None:
    import numpy as np

    from .. import create_or_fetch

    peer = create_or_fetch("127.0.0.1", port, _template(n, arm), _cfg(arm), host_tier=True)
    delta = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    if not arm["compat"]:
        delta = {"w": delta}
    t_bail = time.time() + measure_s + JOIN_S + 60  # if the child never reports
    while not done.is_set() and time.time() < t_bail:
        peer.add(delta)
        time.sleep(add_period(n))
    q.put(("master", peer._engine is not None))
    peer.close()


def _child(n: int, port: int, q, done, measure_s: float, arm: dict) -> None:
    from .. import create_or_fetch

    peer = create_or_fetch("127.0.0.1", port, _template(n, arm), _cfg(arm), host_tier=True)
    deadline = time.time() + JOIN_S
    while peer.st.frames_in == 0 and time.time() < deadline:
        time.sleep(0.1)
    time.sleep(0.5)  # just past the first delivery
    f0, t0 = peer.st.frames_in, time.time()
    time.sleep(measure_s)
    f1, t1 = peer.st.frames_in, time.time()
    done.set()  # the master stops only after the window closed
    fps = (f1 - f0) / (t1 - t0)
    m = peer.metrics()
    q.put(("child", {"frames_in_per_s": fps, "equiv_fp32_GBps": fps * n * 4 / 1e9,
                     "engine": peer._engine is not None,
                     "shm_active": max([v for k, v in m.items() if k.startswith("st_shm_active")], default=0),
                     "stripes_live": max([v for k, v in m.items() if k.startswith("st_stripe_live")], default=1)}))
    peer.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_size(n: int = N, measure_s: float = MEASURE_S, budget_s: float = 120.0, compat: bool = False,
             stripes: int = 1, shm: bool = True) -> dict:
    """The child's frames/s at ``n`` elements on one arm (the reference
    wire, stripes a link, the shared-memory lane); every process is stopped
    by the time it returns. Raises if the run does not finish within
    ``budget_s``."""
    arm = {"compat": compat, "stripes": stripes, "shm": shm}
    ctx = mp.get_context("spawn")
    port = _free_port()
    q, done = ctx.Queue(), ctx.Event()
    procs = [ctx.Process(target=f, args=(n, port, q, done, measure_s, arm), daemon=True) for f in (_master, _child)]
    t_end = time.monotonic() + budget_s
    out = {}
    try:
        procs[0].start()
        time.sleep(1.0)  # the master founds the tree first
        procs[1].start()
        for _ in range(2):
            who, data = q.get(timeout=max(1.0, t_end - time.monotonic()))
            out[who] = data
        for p in procs:
            p.join(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    row = dict(out["child"], master_engine=bool(out["master"]), n=n, measure_s=measure_s,
               wire="compat" if compat else "native", stripes=stripes, shm=shm)
    return row


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--seconds", type=float, default=MEASURE_S, help="the measure window")
    ap.add_argument("--compat", action="store_true", help="the reference wire format")
    ap.add_argument("--stripes", type=int, default=1, help="sockets a link (1..8)")
    ap.add_argument("--no-shm", action="store_true", help="keep the link on TCP")
    args = ap.parse_args(argv)
    row = {"bench": "engine_steady_state", "tier": "host-native-engine"} | run_size(
        args.n, args.seconds, compat=args.compat, stripes=args.stripes, shm=not args.no_shm)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
