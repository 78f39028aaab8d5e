"""The shard plane's FWD throughput on one link: the Python plane against
the engine lane.

    python -m shared_tensor_tpu_torch.benchmarks.shard_bench [--out FILE]

The counterpart of the root ``benchmarks/shard_bench.py``, with its
constants: a 2-node sharded pair on loopback, ``N`` = 2^19 elements in one
leaf. Node 0 (the master, owning shard 0) is the WRITER: every add() lands
entirely in shard 1's range, so all its mass drains as owner-routed FWD
frames over the one link; node 1 is the OWNER applying them. Throughput is
reported as the other benches report the data plane:

    GB/s equiv = applied FWD frames x slice f32 bytes / wall

(each 1-bit frame conveys a full-slice update against per-leaf scales).

Arms, a fresh pair per repeat (``ShardConfig.engine_lane`` pins the
plane): ``python``, the semantic reference; ``engine``, the native plane
in the port's ``libstengine``. ``REPEATS`` repeats of each, after
``WARM_S`` of warm-up, ``MEASURE_S`` measured.

Gate: the engine arm's mean is at least ``RATIO_BAR`` times the Python
arm's (the JAX bench's bar). The JAX bench also ratchets the engine's
lower 90% bound against its newest committed record; that record was
taken on another machine, so this bench reports the bound and holds no
floor. Host code only: no device is used. Prints one JSON document on its
last line (and writes it to ``--out``); exits 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import threading
import time

import numpy as np

#: The JAX bench's constants (benchmarks/shard_bench.py).
N = 1 << 19
REPEATS = 3
WARM_S = 1.0
MEASURE_S = 4.0
RATIO_BAR = 5.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cfg(idx: int, engine: bool):
    from shared_tensor_tpu_torch.config import Config, ShardConfig, TransportConfig

    return Config(
        shard=ShardConfig(n_shards=2, shard_index=idx, engine_lane=engine),
        transport=TransportConfig(peer_timeout_sec=20.0, ack_timeout_sec=0.4),
    )


def run_arm(engine: bool, n: int = N, warm_s: float = WARM_S, measure_s: float = MEASURE_S) -> dict:
    """One fresh writer -> owner pair: {"gbps", "frames", "slice_elements",
    "wall_sec"}."""
    from shared_tensor_tpu_torch.shard import create_or_fetch_sharded

    tmpl = {"t": np.zeros(n, np.float32)}
    port = _free_port()
    h0 = create_or_fetch_sharded("127.0.0.1", port, tmpl, _cfg(0, engine), timeout=30.0)
    try:
        h1 = create_or_fetch_sharded("127.0.0.1", port, tmpl, _cfg(1, engine), timeout=30.0)
    except BaseException:
        h0.close()
        raise
    try:
        lane = h0.node._lane is not None
        if lane != engine:
            raise RuntimeError(f"the arm wanted engine={engine}, the node runs lane={lane}")
        elo, ehi = h0.node.map.element_range(1)  # shard 1's slice: all out-of-shard
        slice_el = ehi - elo
        rng = np.random.default_rng(42)
        stop = threading.Event()
        # pre-generated deltas: drawing the slice each pass would meter the
        # producer, not the plane (one leaf of a 32-multiple N has no
        # padding, so the padded range is the template's)
        width = min(ehi, n) - elo
        deltas = []
        for _ in range(8):
            full = np.zeros(n, np.float32)
            full[elo:elo + width] = rng.uniform(-0.1, 0.1, width).astype(np.float32)
            deltas.append(full)

        def writer():
            i = 0
            while not stop.is_set():
                h0.add({"t": deltas[i % len(deltas)]})
                i += 1
                time.sleep(0.001)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            time.sleep(warm_s)
            f0 = h1.node.metrics().get("st_shard_fwd_frames_in_total", 0)
            t0 = time.monotonic()
            time.sleep(measure_s)
            f1 = h1.node.metrics().get("st_shard_fwd_frames_in_total", 0)
            wall = time.monotonic() - t0
        finally:
            stop.set()
            t.join(timeout=5.0)
        frames = int(f1) - int(f0)
        return {"gbps": frames * slice_el * 4 / wall / 1e9, "frames": frames, "slice_elements": slice_el,
                "wall_sec": wall}
    finally:
        h1.close()
        h0.close()


def lower90(xs: list[float]) -> float:
    if len(xs) < 2:
        return xs[0] if xs else 0.0
    return float(np.mean(xs)) - 1.645 * float(np.std(xs, ddof=1)) / len(xs) ** 0.5


def run(n: int = N, repeats: int = REPEATS, warm_s: float = WARM_S, measure_s: float = MEASURE_S) -> dict:
    res: dict[str, list[dict]] = {"python": [], "engine": []}
    for r in range(repeats):
        for arm in ("python", "engine"):
            out = run_arm(arm == "engine", n, warm_s, measure_s)
            res[arm].append(out)
            print(f"repeat {r + 1}/{repeats} {arm}: {out['gbps']:.3f} GB/s equiv", file=sys.stderr)
    py = [o["gbps"] for o in res["python"]]
    en = [o["gbps"] for o in res["engine"]]
    py_mean, en_mean = float(np.mean(py)), float(np.mean(en))
    ratio = en_mean / py_mean if py_mean > 0 else float("inf")
    return {
        "bench": "shard_bench", "n": n, "slice_elements": res["engine"][0]["slice_elements"],
        "repeats": repeats, "warm_s": warm_s, "measure_s": measure_s,
        "python_gbps": py, "engine_gbps": en,
        "python_frames": [o["frames"] for o in res["python"]], "engine_frames": [o["frames"] for o in res["engine"]],
        "python_mean": py_mean, "engine_mean": en_mean, "engine_lower90": lower90(en),
        "ratio": ratio, "ratio_bar": RATIO_BAR, "pass": bool(ratio >= RATIO_BAR),
        "note": "GB/s equiv = applied FWD frames x slice f32 bytes / wall",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="", help="also write the JSON document here")
    args = ap.parse_args(argv)
    out = run()
    doc = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    print(f"shard_bench: python {out['python_mean']:.3f} / engine {out['engine_mean']:.3f} GB/s equiv "
          f"(engine lower90 {out['engine_lower90']:.3f}), ratio {out['ratio']:.1f}x (bar {RATIO_BAR}x) -> "
          f"{'PASS' if out['pass'] else 'FAIL'}", file=sys.stderr)
    print(doc)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
