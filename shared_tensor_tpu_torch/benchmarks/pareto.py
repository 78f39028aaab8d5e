"""BASELINE config 5 on one GPU: the dense-tensor sweep, approximation
error against sync bandwidth.

    python -m shared_tensor_tpu_torch.benchmarks.pareto [--sizes 12,16,20,24,26] [--policy POW2_RMS]

The counterpart of the root ``benchmarks/pareto.py``. For each table size
it measures (a) the codec roundtrip time per frame on the device
(:func:`..utils.timing.codec_frame_time`, uniform residuals), giving
equivalent-fp32-delta GB/s per link at 1 bit/element/frame on the wire, and
(b) the residual-RMS decay per frame over 8 frames on U(-1, 1) data, the
matched-approximation-error yardstick (the reference codec halves the RMS
per frame on such data), also given as :func:`..utils.profiling.effective_bits`.
Prints one JSON line per size.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..config import ScalePolicy
from ..utils.profiling import effective_bits

#: The reference C implementation's two-node loopback E2E equivalent-delta
#: GB/s by size (BASELINE.md): CPU figures of the reference, the yardstick
#: of ``vs_baseline``.
BASELINE_GBPS = {1 << 12: 1.28, 1 << 20: 1.01, 1 << 24: 0.52}
CURVE_FRAMES = 8


def uniform(n: int, seed: int, device) -> torch.Tensor:
    """U(-1, 1) float32 of length ``n`` from a ``torch.Generator``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.empty(n, dtype=torch.float32, device=device).uniform_(-1.0, 1.0, generator=gen)


def rms_curve(codec, resid: torch.Tensor, n: int, policy) -> list[float]:
    """Residual RMS after each of ``CURVE_FRAMES`` chained ``codec.quantize``
    calls starting from ``resid`` (which the kernel codec updates in place).
    One copy to the host, at the end."""
    rms = []
    r = resid
    for _ in range(CURVE_FRAMES):
        _, r = codec.quantize(r, n, policy)
        rms.append(torch.sqrt(torch.mean(r * r)))
    return [float(x) for x in torch.stack(rms).cpu()]


def measure_size(
    codec,
    n: int,
    policy,
    device: str | torch.device = "cuda",
    target_seconds: float = 3.0,
    budget_s: float | None = None,
) -> dict:
    """One row of the sweep at size ``n`` (a multiple of 128)."""
    from ..utils.timing import codec_frame_time

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_frame = codec_frame_time(
        codec, n, policy, make_residual=lambda seed: uniform(n, seed, dev),
        target_seconds=target_seconds, budget_s=budget_s, device=dev,
    )
    equiv_gbps = n * 4 / t_frame / 1e9

    r0 = uniform(n, 7, dev)
    rms0 = float(torch.sqrt(torch.mean(r0 * r0)))
    curve = rms_curve(codec, r0, n, policy)
    del r0
    decay = (curve[-1] / rms0) ** (1 / len(curve)) if rms0 else 0.0

    base = BASELINE_GBPS.get(n)
    return {
        "n_elements": n,
        "mbytes": round(n * 4 / 1e6, 1),
        "equiv_gbps": round(equiv_gbps, 2),
        "wire_gbps": round(equiv_gbps / 32, 3),
        "frame_us": t_frame * 1e6,
        "rms_decay_per_frame": round(decay, 4),  # reference: 0.5
        "effective_bits": effective_bits([rms0] + curve),
        "vs_baseline": round(equiv_gbps / base, 1) if base else None,
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="12,16,20,24,26", help="log2 of each size")
    ap.add_argument("--policy", default="POW2_RMS", choices=[p.name for p in ScalePolicy])
    ap.add_argument("--codec", choices=("kernel", "plain"), default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--target-seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    from ..bench import resolve

    codec, dev = resolve(args.codec, args.device)
    policy = ScalePolicy[args.policy]
    rows = []
    for log2n in (int(s) for s in args.sizes.split(",")):
        rows.append(measure_size(codec, 1 << log2n, policy, dev, args.target_seconds))
        print(json.dumps(rows[-1]), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
