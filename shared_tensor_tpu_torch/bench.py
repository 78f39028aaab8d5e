"""Headline codec bench on one GPU: approximate-delta sync bandwidth of the
codec in equivalent applied-fp32-delta GB/s per link.

    python -m shared_tensor_tpu_torch.bench [--codec kernel|plain|host|engine] [--device cuda|cpu] [--n N]

The counterpart of the root ``bench.py``'s arms. Per frame it runs one
full sender half (scale, sign-quantize, bit-pack and error feedback) and one
receiver half (unpack and apply) on an n = 1 Mi buffer with the POW2_RMS
policy, and prints one JSON line in the root bench's schema:

- ``kernel`` (kernels C and D, ``ops/codec_cuda``) or ``plain`` (the plain
  PyTorch golden, ``ops/codec``): chained on the device by
  :func:`..utils.timing.codec_frame_time`, ``backend`` the card's name;
- ``host``: one full link frame of the host tier's table codec
  (``ops/codec_np``, the C loops of ``native/stcodec.c``) on the CPU, timed
  as host work (the root bench's ``_worker_host``);
- ``engine``: the native engine end to end, two processes over loopback
  through the full stack (``benchmarks/engine_bench.run_size``; the root
  bench's ``_worker_engine``); the time per frame is the inverse of the
  child's applied frames/s, and both peers must have run the engine.

Each arm runs under its own time budget (``BUDGET_S``) and raises when it
cannot run: ``kernel`` without a CUDA device, ``host`` and ``engine`` when
their library does not build. There is no ladder from one arm to the next,
as the root bench has: the bench runs the arm it is asked for, or fails.
"""

from __future__ import annotations

import argparse
import json

import torch

from .config import ScalePolicy

N = 1 << 20  # 1 Mi elements, the reference's headline E2E size
#: The reference C implementation's two-node loopback E2E rate at 1 Mi
#: (BASELINE.md), the yardstick of the schema's ``vs_baseline``. It is a
#: CPU figure of the reference, not a figure of this port.
BASELINE_GBPS = 1.01
BUDGET_S = 120.0  # hard cap on one measurement (utils.timing.codec_frame_time)


def resolve(codec_name: str, device: str | torch.device) -> tuple[object, torch.device]:
    """The codec module and device for a device-codec run: ``kernel`` ->
    ``ops.codec_cuda`` (kernels C and D), ``plain`` -> ``ops.codec`` (the
    plain golden). Raises when ``device`` is CUDA and there is none, and for
    the kernel codec on any device but CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    if codec_name == "kernel":
        if dev.type != "cuda":
            raise RuntimeError(f"the kernel codec needs a CUDA device, got {str(dev)!r}")
        from .ops import codec_cuda as codec
    elif codec_name == "plain":
        from .ops import codec
    else:
        raise ValueError(f"unknown codec {codec_name!r}; expected 'kernel' or 'plain'")
    return codec, dev


def result(t_frame: float, n: int, backend: str, codec_name: str) -> dict:
    """The root bench's one-line schema for a time per frame."""
    fps = 1.0 / t_frame
    equiv_gbps = fps * n * 4 / 1e9
    return {
        "metric": "sync_bandwidth_equiv_fp32_per_link",
        "value": round(equiv_gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(equiv_gbps / BASELINE_GBPS, 2),
        "detail": {
            "n_elements": n,
            "frames_per_s": round(fps, 1),
            "backend": backend,
            "codec": codec_name,
            "wire_gbps": round(fps * (n / 8 + 4) / 1e9, 4),
            "frame_s": t_frame,
        },
    }


def host_frame_time(n: int, target_seconds: float = 3.0, budget_s: float = BUDGET_S) -> float:
    """Seconds per full link frame of the host codec at ``n`` elements: the
    sender's quantize of a residual and the receiver's apply of its frame
    into a replica, synchronous host work (3 warm-up frames, then at least
    5 and at least ``target_seconds``, at most ``budget_s``)."""
    import time

    import numpy as np

    from .ops import codec_np
    from .ops.table import make_spec

    spec = make_spec(np.zeros(n, np.float32))
    rng = np.random.default_rng(0)
    resid = rng.uniform(-1.0, 1.0, spec.total).astype(np.float32)
    values = rng.uniform(-1.0, 1.0, spec.total).astype(np.float32)

    def frame():
        scales, words, _ = codec_np.quantize_table_np(resid, spec, ScalePolicy.POW2_RMS)
        codec_np.apply_table_many_np((values,), scales, words, spec)

    for _ in range(3):
        frame()
    t0, reps = time.perf_counter(), 0
    while True:
        frame()
        reps += 1
        dt = time.perf_counter() - t0
        if (dt >= min(target_seconds, budget_s) and reps >= 5) or dt >= budget_s:
            return dt / reps


def run(
    codec_name: str = "kernel",
    device: str = "cuda",
    n: int = N,
    target_seconds: float = 3.0,
) -> dict:
    """Time the codec frame at size ``n`` (on ``device`` for the device
    codecs); the schema dict."""
    if codec_name == "host":
        return result(host_frame_time(n, target_seconds), n, "cpu", "host")
    if codec_name == "engine":
        from .benchmarks.engine_bench import run_size

        row = run_size(n, measure_s=target_seconds, budget_s=BUDGET_S)
        if not (row["engine"] and row["master_engine"]):
            raise RuntimeError(f"the native engine did not run on both peers: {row}")
        if row["frames_in_per_s"] <= 0:
            raise RuntimeError(f"the engine run applied no frames: {row}")
        return result(1.0 / row["frames_in_per_s"], n, "cpu", "engine")
    from .utils.timing import codec_frame_time

    codec, dev = resolve(codec_name, device)
    t_frame = codec_frame_time(
        codec, n, ScalePolicy.POW2_RMS, target_seconds=target_seconds,
        budget_s=BUDGET_S, device=dev,
    )
    backend = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return result(t_frame, n, backend, codec_name)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--codec", choices=("kernel", "plain", "host", "engine"), default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="elements (a multiple of 128)")
    ap.add_argument("--target-seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    res = run(args.codec, args.device, args.n, args.target_seconds)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
