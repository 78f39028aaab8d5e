"""Headline codec bench on one GPU: approximate-delta sync bandwidth of the
codec in equivalent applied-fp32-delta GB/s per link.

    python -m shared_tensor_tpu_torch.bench [--codec kernel|plain] [--device cuda|cpu] [--n N]

The counterpart of the root ``bench.py``'s device arm. Per frame it runs one
full sender half (scale, sign-quantize, bit-pack and error feedback) and one
receiver half (unpack and apply) on an n = 1 Mi buffer with the POW2_RMS
policy, chained on the device by :func:`..utils.timing.codec_frame_time`,
and prints one JSON line in the root bench's schema, with ``backend`` the
card's name and ``codec`` ``kernel`` (kernels C and D, ``ops/codec_cuda``)
or ``plain`` (the plain PyTorch golden, ``ops/codec``).

``--codec kernel`` needs a CUDA device and raises without one: it never
falls back to the plain codec. The root bench's watchdog supervisor and its
host and engine arms are host-tier work and are not ported here.
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
    """The codec module and device for a run: ``kernel`` -> ``ops.codec_cuda``
    (kernels C and D), ``plain`` -> ``ops.codec`` (the plain golden). Raises
    when ``device`` is CUDA and there is none, and for the kernel codec on
    any device but CUDA."""
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


def run(
    codec_name: str = "kernel",
    device: str = "cuda",
    n: int = N,
    target_seconds: float = 3.0,
) -> dict:
    """Time the codec frame at size ``n`` on ``device``; the schema dict."""
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
    ap.add_argument("--codec", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="elements (a multiple of 128)")
    ap.add_argument("--target-seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    res = run(args.codec, args.device, args.n, args.target_seconds)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
