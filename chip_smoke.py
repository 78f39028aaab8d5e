#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shared_tensor_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. Build: compile the CUDA kernels from shared_tensor_tpu_torch/csrc/ (one
   nvcc per source, started together) and print the build seconds.
2. Kernel vs plain on the card, at the ResNet-18 table shape (87,504 rows,
   partial rows, zero-scale leaves): kernel A (quantize_rows) words and
   residual bit-equal, kernel B (apply_rows_batch) bit-equal for
   K in {1, 2, 8} and N in {1, 3}.
3. Tree drive at full width: three SharedTensors on the GPU in a chain
   master - interior - leaf over the ResNet-18 parameter table (56 leaves,
   11,172,170 elements). The master is seeded; the seed spreads, then each
   node in turn adds its own update and it spreads. Frames cross as host
   wire bytes in batches (receive_frames) until every link is quiet
   (every leaf's scale <= 1e-7 of its max |value|); every replica must
   equal seed + all updates to
   1e-5 of each leaf's max |value|, and each link's first frame must equal
   the CPU plain path's on the same state (scales equal or one octave apart).
   The kernel launch counts of this phase are reported.
4. Times: CUDA-event times of A and B at the phase-3 shapes beside their
   memory bound and their plain versions' times.

Prints the card's name and power limit (nvidia-smi), a {"kernels": [...]}
line, and last {"ok": true, "device": {...}}. Exits non-zero with no result
when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: HBM bandwidth by card (NVIDIA data sheets), bytes/s; the SXM part's is
#: the default.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
HBM_DEFAULT = 3.35e12

QUIET_REL = 1e-7  # a frame is quiet when every leaf's scale <= this * its max |value|
AGREE_REL = 1e-5  # replicas agree when every leaf is within this * its max |value|
BATCH = 4  # frames per link per round, delivered together (K of kernel B)
MAX_ROUNDS = 400
WORDS_BYTES = 4 * 4  # packed words per row x bytes per word


def resnet18_template(width: int = 64) -> dict:
    """ResNet-18 parameter shapes (the repo's default ResNetConfig: 3x3 CIFAR
    stem, two basic blocks per stage, 10 classes), as zero float32 arrays.
    A smaller ``width`` gives the same structure for a rehearsal on the CPU."""
    classes, stages = 10, (2, 2, 2, 2)
    z = lambda *s: np.zeros(s, np.float32)
    params = {"stem": {"conv": z(3, 3, 3, width), "scale": z(width), "bias": z(width)}}
    blocks = []
    cin = width
    for si, depth in enumerate(stages):
        cout = width * 2**si
        for bi in range(depth):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {
                "conv1": z(3, 3, cin, cout), "scale1": z(cout), "bias1": z(cout),
                "conv2": z(3, 3, cout, cout), "scale2": z(cout), "bias2": z(cout),
            }
            if stride != 1 or cin != cout:
                blk["proj"] = z(1, 1, cin, cout)
            blocks.append(blk)
            cin = cout
    params["blocks"] = blocks
    params["head"] = {"w": z(cin, classes), "b": z(classes)}
    return params


def random_like(template, rng: np.random.Generator, scale: float = 1.0):
    """Per leaf uniform(-1, 1) times 10^U(-3, 3), the magnitude rounded to
    a power of two, so the per-leaf scales matter. The rounding keeps the
    drive short: the sign codec drains a uniform residual in about 25
    frames when its bound is a power of two, and otherwise leaves sparse
    outliers that drain at about sqrt(n)/2 frames per octave."""
    from shared_tensor_tpu_torch.ops.table import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(template)
    out = []
    for leaf in leaves:
        mag = scale * 2.0 ** np.round(np.log2(10.0 ** rng.uniform(-3, 3)))
        out.append((rng.uniform(-1, 1, np.shape(leaf)) * mag).astype(np.float32))
    return tree_unflatten(treedef, out)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    return HBM_DEFAULT


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bitdiff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose 32 bits differ."""
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def _maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs()
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


# -- phase 2 --------------------------------------------------------------------


def kernel_vs_plain(spec, device, rng) -> dict:
    """Both kernels against their plain versions at this table's shapes.
    Returns {kernel: {"mismatches": n, "max_abs_err": x}}."""
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops import table as TT

    row_leaf, rowcount, live, *_ = TT._consts(spec, str(torch.device(device)))
    n = spec.total
    mags = 10.0 ** rng.uniform(-3, 3, spec.num_leaves)
    resid = torch.from_numpy(
        (rng.uniform(-1, 1, n) * mags[spec.row_leaf()].repeat(128)).astype(np.float32)
    ).to(device)
    resid = torch.where(live.view(-1), resid, torch.zeros_like(resid))
    resid[::97] = 0.0  # zeros count as negative
    scales = TT.compute_scales(resid, spec)
    scales[:: 5] = 0.0  # zero-scale (idle) leaves
    s_row = scales[row_leaf].contiguous()
    r_k, r_p = resid.clone(), resid.clone()
    w_k = CC.quantize_rows_kernel(s_row, rowcount, r_k)
    w_p = CC.quantize_rows_plain(s_row, rowcount, r_p)
    _sync(device)
    out = {"quantize_rows": {"mismatches": _bitdiff(w_k, w_p) + _bitdiff(r_k, r_p),
                             "max_abs_err": _maxerr(r_k, r_p)}}
    print(f"[2] A quantize_rows rows={spec.rows}: word mismatches {_bitdiff(w_k, w_p)}, "
          f"residual mismatches {_bitdiff(r_k, r_p)}")

    # real frames, RMS scales (not powers of two: the k order matters)
    frames, _ = TT.quantize_table_burst(resid.clone(), spec, 8, ScalePolicy.RMS, impl="plain")
    frames.scales[:, ::7] = 0.0
    mism, err = 0, 0.0
    for k in (1, 2, 8):
        s_rows = frames.scales[:k, row_leaf].contiguous()
        words = frames.words[:k].contiguous()
        for n_arr in (1, 3):
            base = [resid * (i + 1) for i in range(n_arr)]
            a_k = [b.clone() for b in base]
            a_p = [b.clone() for b in base]
            CC.apply_rows_batch_kernel(s_rows, rowcount, words, a_k)
            CC.apply_rows_batch_plain(s_rows, rowcount, words, a_p)
            _sync(device)
            m = sum(_bitdiff(x, y) for x, y in zip(a_k, a_p))
            e = max(_maxerr(x, y) for x, y in zip(a_k, a_p))
            mism += m
            err = max(err, e)
            print(f"[2] B apply_rows_batch K={k} N={n_arr}: mismatches {m}")
    out["apply_rows_batch"] = {"mismatches": mism, "max_abs_err": err}
    return out


# -- phase 3 --------------------------------------------------------------------


def _to_wire(frame, spec) -> tuple[bytes, bytes]:
    from shared_tensor_tpu_torch.ops.packing import words_to_wire

    return np.asarray(frame.scales, "<f4").tobytes(), words_to_wire(frame.words, spec.total)


def _from_wire(payload: tuple[bytes, bytes], spec):
    from shared_tensor_tpu_torch.ops.packing import wire_to_words
    from shared_tensor_tpu_torch.ops.table import TableFrame

    scales = np.frombuffer(payload[0], "<f4").astype(np.float32)
    return TableFrame(scales, wire_to_words(payload[1], spec.total))


def _first_frame_check(resid_cpu, host, resid_after, spec, codec) -> int:
    """The link's first frame vs the CPU plain path on the same residual:
    words bit-equal, scales equal or one octave apart, residual bit-equal on
    leaves whose scales are equal. Returns the mismatch count."""
    from shared_tensor_tpu_torch.ops import table as TT

    f_cpu, r_cpu = TT.quantize_table(resid_cpu, spec, codec.scale_policy, codec.per_leaf_scale, impl="plain")
    s_dev, s_cpu = np.asarray(host.scales), f_cpu.scales.numpy()
    octave = (s_dev == s_cpu) | (s_dev == 2 * s_cpu) | (2 * s_dev == s_cpu)
    bad = int((~octave).sum())
    bad += int((np.asarray(host.words).view(np.int32) != f_cpu.words.numpy()).sum())
    same = torch.from_numpy(s_dev == s_cpu)[torch.from_numpy(spec.row_leaf().astype(np.int64))]
    r_dev = resid_after.view(-1, 128)[same]
    bad += _bitdiff(r_dev, r_cpu.view(-1, 128)[same])
    return bad


def tree_drive(template, device, seed: int, verbose: bool = True) -> dict:
    """master - interior - leaf over ``template`` on ``device``; see the
    module docstring (phase 3). Returns counts, timings and the check
    results; raises on disagreement."""
    from shared_tensor_tpu_torch.core import SharedTensor
    from shared_tensor_tpu_torch.ops.table import make_spec, tree_flatten

    rng = np.random.default_rng(seed)
    seed_tree = random_like(template, rng)
    updates = [random_like(template, rng, 0.5) for _ in range(3)]
    t0 = time.perf_counter()
    m = SharedTensor(seed_tree, seed_values=True, device=device)
    i = SharedTensor(template, device=device)
    l = SharedTensor(template, device=device)
    spec = m.spec
    m.new_link(1, seed=True)
    i.new_link(1, seed=False)
    i.new_link(2, seed=True)
    l.new_link(2, seed=False)
    target = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
    for u in updates:
        for j, x in enumerate(tree_flatten(u)[0]):
            target[j] += x
    mag = np.array([np.abs(x).max() for x in target])
    _sync(device)

    links = ((m, i, 1), (i, m, 1), (i, l, 2), (l, i, 2))
    stats = {"frames": 0, "rounds": 0, "max_k": 0, "first_mismatch": 0}
    checked = set()

    def pump() -> None:
        """Exchange frames over every link, up to BATCH per link per round,
        delivered together, until a round in which every frame is quiet."""
        for _ in range(MAX_ROUNDS):
            stats["rounds"] += 1
            quiet = True
            for src, dst, link in links:
                batch = []
                for _ in range(BATCH):
                    first = (id(src), link) not in checked
                    pre = src._links[link].to("cpu", copy=True) if first else None
                    seq, dframe = src.begin_frame(link)
                    host = src.finish_frame(dframe)
                    src.ack_frame(link, seq)
                    if host is None:
                        break
                    if first:
                        checked.add((id(src), link))
                        stats["first_mismatch"] += _first_frame_check(
                            pre, host, src._links[link].to("cpu", copy=True), spec, src.codec
                        )
                    batch.append(_from_wire(_to_wire(host, spec), spec))
                    if np.any(host.scales > QUIET_REL * mag):
                        quiet = False
                if batch:
                    dst.receive_frames(link, batch)
                    stats["frames"] += len(batch)
                    stats["max_k"] = max(stats["max_k"], len(batch))
            if quiet:
                return
        raise AssertionError(f"links did not quiesce in {MAX_ROUNDS} rounds")

    # the seed spreads, then each node adds its own update and it spreads
    t_pump = time.perf_counter()
    pump()
    for st, u in zip((m, i, l), updates):
        st.add(u)
        pump()
    _sync(device)
    pump_s = time.perf_counter() - t_pump
    frames, rounds, first_mismatch = stats["frames"], stats["rounds"], stats["first_mismatch"]
    max_k = stats["max_k"]
    if len(checked) != len(links):
        raise AssertionError(f"only {len(checked)} of {len(links)} links sent a frame")

    worst = 0.0
    for st in (m, i, l):
        got = tree_flatten(st.read())[0]
        for j, g in enumerate(got):
            rel = float(np.abs(g.cpu().numpy().astype(np.float64) - target[j]).max()) / mag[j]
            worst = max(worst, rel)
    res = {
        "rounds": rounds, "frames": frames, "pump_s": pump_s,
        "frames_per_s": frames / pump_s, "max_k": max_k,
        "worst_rel_err": worst, "first_frame_mismatches": first_mismatch,
        "setup_s": t_pump - t0,
        "frames_out": [st.frames_out for st in (m, i, l)],
        "frames_in": [st.frames_in for st in (m, i, l)],
    }
    if verbose:
        print(f"[3] tree drive: {frames} frames in {rounds} rounds, {pump_s:.3f} s "
              f"({res['frames_per_s']:.1f} frames/s), worst leaf error {worst:.3e} of max|value|, "
              f"first-frame mismatches {first_mismatch}")
    if worst > AGREE_REL:
        raise AssertionError(f"replicas disagree: worst leaf error {worst:.3e} > {AGREE_REL}")
    if first_mismatch:
        raise AssertionError(f"{first_mismatch} first-frame mismatches against the CPU plain path")
    if sum(res["frames_out"]) != sum(res["frames_in"]):
        raise AssertionError(f"frames out {res['frames_out']} != frames in {res['frames_in']}")
    return res


# -- phase 4 --------------------------------------------------------------------


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def times(spec, device, k: int, n_arr: int, rate: float) -> dict:
    """CUDA-event ms per launch of each kernel and its plain version at this
    table's shapes, with the memory bound."""
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops import table as TT

    row_leaf, rowcount, live, *_ = TT._consts(spec, str(torch.device(device)))
    gen = torch.Generator(device=device).manual_seed(0)
    rows, n = spec.rows, spec.total
    resid = torch.rand(n, generator=gen, device=device) * 2 - 1
    resid = torch.where(live.view(-1), resid, torch.zeros_like(resid))
    s_row = TT.compute_scales(resid, spec)[row_leaf].contiguous()
    out = {}
    a_bytes = n * 8 + rows * WORDS_BYTES + rows * 8
    out["quantize_rows"] = {
        "ms": _time_ms(lambda: CC.quantize_rows_kernel(s_row, rowcount, resid), 50),
        "plain_ms": _time_ms(lambda: CC.quantize_rows_plain(s_row, rowcount, resid), 5, 1),
        "bytes": a_bytes, "bound_ms": a_bytes / rate * 1e3, "shape": f"rows={rows}",
    }
    frames, _ = TT.quantize_table_burst(resid.clone(), spec, k, impl="kernel")
    s_rows = frames.scales[:, row_leaf].contiguous()
    words = frames.words.contiguous()
    arrays = [resid.clone() for _ in range(n_arr)]
    b_bytes = n * k / 8 + k * rows * 4 + rows * 4 + 8 * n_arr * n
    out["apply_rows_batch"] = {
        "ms": _time_ms(lambda: CC.apply_rows_batch_kernel(s_rows, rowcount, words, arrays), 50),
        "plain_ms": _time_ms(lambda: CC.apply_rows_batch_plain(s_rows, rowcount, words, arrays), 5, 1),
        "bytes": b_bytes, "bound_ms": b_bytes / rate * 1e3, "shape": f"rows={rows} K={k} N={n_arr}",
    }
    for name, r in out.items():
        print(f"[4] {name} {r['shape']}: {r['ms']:.4f} ms/launch, bound {r['bound_ms']:.4f} ms "
              f"({r['bytes'] / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s), plain {r['plain_ms']:.4f} ms")
    return out

SOURCES = {
    "quantize_rows": ("shared_tensor_tpu_torch/csrc/quantize_rows.cu", "shared_tensor_tpu/ops/codec_pallas.py:286"),
    "apply_rows_batch": ("shared_tensor_tpu_torch/csrc/apply_rows.cu", "shared_tensor_tpu/ops/codec_pallas.py:337"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.table import make_spec

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # 1. build
    t0 = time.perf_counter()
    report = CC.build()
    print(f"[1] build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in report.items()))
    for k, v in report.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1] {k}: {line.strip()}")

    template = resnet18_template()
    spec = make_spec(template)
    if (spec.num_leaves, spec.total_n, spec.total) != (56, 11172170, 11200512):
        raise AssertionError(f"unexpected ResNet-18 table {spec.num_leaves} {spec.total_n} {spec.total}")

    # 2. kernel vs plain
    parity = kernel_vs_plain(spec, dev, np.random.default_rng(args.seed + 1))
    bad = {k: v["mismatches"] for k, v in parity.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"kernel vs plain mismatches: {bad}")

    # 3. tree drive (the launch counts are this phase's)
    CC.reset_launches()
    drive = tree_drive(template, dev, args.seed)
    launches = dict(CC.LAUNCHES)
    print(f"[3] launches {launches}, frames out {drive['frames_out']}, in {drive['frames_in']}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # 4. times at the drive's shapes: B as at the interior's flood (K, N=2)
    rate = hbm_rate(name)
    t = times(spec, dev, drive["max_k"], 2, rate)
    print(smi)
    kernels = []
    for k in ("quantize_rows", "apply_rows_batch"):
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
            "launches": launches[k], "mismatches": parity[k]["mismatches"],
            "max_abs_err": parity[k]["max_abs_err"], "ms": t[k]["ms"],
            "plain_ms": t[k]["plain_ms"], "bound_ms": t[k]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": t[k]["shape"],
        })
    print(json.dumps({"drive": drive}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
