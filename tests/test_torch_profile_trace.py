"""The port's profile and host-codec benches on the CPU
(shared_tensor_tpu_torch.benchmarks.profile_trace and host_codec_bench):
the busy-share arithmetic on hand-made intervals of two "ranks" and
against a plain sweep on random ones, the
profile reader on hand-made events, a trace a rank and arm from a 2-rank run, the
obs timeline of a 3-node chain exported with 2 hops, and the C loops' rows.
No tolerance: the arithmetic is on integers."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from shared_tensor_tpu_torch.benchmarks import profile_trace as PT
from tests.test_torch_pod_jobs import mesh_lock

ROOT = pathlib.Path(__file__).resolve().parent.parent

# two ranks' kernels on one clock, overlapping within and across the ranks
RANK_A = [(30, 40), (0, 10), (5, 15)]
RANK_B = [(12, 20), (90, 120), (38, 50)]


@pytest.mark.parametrize("intervals, window, want", [
    (RANK_A, (0, 100), 0.25),  # [0, 15] + [30, 40]
    (RANK_B, (0, 100), 0.30),  # [12, 20] + [38, 50] + [90, 100], clipped
    (RANK_A + RANK_B, (0, 100), 0.50),  # the card: [0, 20] + [30, 50] + [90, 100]
    (RANK_A + RANK_B, (10, 40), 20 / 30),  # [10, 20] + [30, 40]
    (RANK_A + RANK_B, (200, 300), 0.0),  # nothing in the window
    ([(0, 100), (10, 20)], (0, 100), 1.0),  # nested
], ids=["rank-a", "rank-b", "merged", "clipped", "outside", "nested"])
def test_busy_share_of_two_ranks(intervals, window, want):
    assert PT.busy_share(intervals, window) == pytest.approx(want, abs=1e-12)


def _sweep(intervals, window):
    """The busy share by a loop over the intervals in order of start."""
    lo, hi = window
    busy, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy / (hi - lo)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_busy_share_equals_the_interval_sweep(seed):
    """On random intervals at the profiler's ns-since-epoch stamps (past
    float64's exact integers), some outside the window, the vectorized
    union equals a plain sweep exactly."""
    rng = np.random.default_rng(seed)
    base = 1_760_000_000_000_000_000
    for _ in range(50):
        n = int(rng.integers(0, 60))
        s = base + rng.integers(0, 1000, n)
        iv = np.stack([s, s + rng.integers(0, 100, n)], 1)
        window = (base + int(rng.integers(0, 300)), base + int(rng.integers(400, 1200)))
        assert PT.busy_share(iv, window) == _sweep(map(tuple, iv.tolist()), window)


def test_busy_share_refuses_an_empty_window():
    with pytest.raises(ValueError):
        PT.busy_share(RANK_A, (5, 5))


class _Event:
    """A profiler event as ``device_side`` reads it."""

    def __init__(self, kind, name, start, end):
        self._kind, self._name, self._start, self._end = kind, name, start, end

    def activity_type(self):
        return self._kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end


A_NAME = "(anonymous namespace)::quantize_rows_kernel(float const*, int const*, float*, unsigned int*, long)"
B_NAME = "void (anonymous namespace)::apply_rows_kernel<1>(float const*, int const*, unsigned int const*, long)"
EVENTS = [
    _Event("user_annotation", PT.WINDOW, 1_000_000, 1_050_000),
    _Event("kernel", A_NAME, 1_010_500, 1_012_750),
    _Event("kernel", A_NAME, 1_020_000, 1_021_000),
    _Event("kernel", B_NAME, 1_030_000, 1_034_000),
    _Event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1_040_000, 1_043_000),
    _Event("cuda_runtime", "cudaLaunchKernel", 1_009_000, 1_010_000),
    _Event("cpu_op", "aten::mm", 1_001_000, 1_010_000),
]


def test_device_side_reads_kernels_copies_and_the_window():
    d = PT.device_side(EVENTS, (0, 1))
    assert d["window"] == (1_000_000, 1_050_000)  # the annotation's, not the stamps
    assert d["kernels"].tolist() == [[1_010_500, 1_012_750], [1_020_000, 1_021_000], [1_030_000, 1_034_000]]
    assert d["by_name"] == {A_NAME: 0.00325, B_NAME: 0.004}
    assert d["copy_ms"] == pytest.approx(0.003)
    assert PT.busy_share(map(tuple, d["kernels"].tolist()), d["window"]) == pytest.approx(7.25 / 50)
    assert PT.top(d["by_name"], 1) == [(B_NAME, 0.004)]
    assert PT.codec_ms(d["by_name"]) == {"quantize_rows": 0.00325, "apply_rows_batch": 0.004}


class _OldEvent:
    """A profiler event of a torch without ``activity_type()`` (2.11)."""

    def __init__(self, on_card, annotation, name):
        self._on_card, self._annotation, self._name = on_card, annotation, name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._on_card else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation

    def name(self):
        return self._name


@pytest.mark.parametrize("on_card, annotation, name, want", [
    (True, False, A_NAME, "kernel"),
    (True, False, "Memcpy HtoD (Pinned -> Device)", "gpu_memcpy"),
    (True, False, "Memset (Device)", "gpu_memset"),
    (True, True, PT.WINDOW, "gpu_user_annotation"),
    (False, True, PT.WINDOW, "user_annotation"),
    (False, False, "cudaLaunchKernel", "cpu"),
], ids=["kernel", "memcpy", "memset", "gpu-annotation", "annotation", "runtime"])
def test_kind_without_activity_type(on_card, annotation, name, want):
    assert PT.kind(_OldEvent(on_card, annotation, name)) == want


def test_device_side_takes_the_stamps_without_an_annotation():
    d = PT.device_side(EVENTS[1:], (1_000_000, 1_100_000))
    assert d["window"] == (1_000_000, 1_100_000)
    assert PT.device_side([], (5, 9))["kernels"].shape == (0, 2)


def test_profile_trace_writes_a_trace_per_rank_and_arm(tmp_path):
    out = tmp_path / "prof"
    with mesh_lock():
        proc = subprocess.run(
            [sys.executable, "-m", "shared_tensor_tpu_torch.benchmarks.profile_trace", "--device", "cpu", "--peers",
             "2", "--tiny", "--batch", "2", "--seq", "16", "--steps", "1", "--out", str(out)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(doc["arms"]) == ["sync_off", "compressed", "compressed_overlap"]
    for name, arm in doc["arms"].items():
        for rk in range(2):
            trace = json.loads((out / name / f"rank{rk}" / "trace.json").read_text())
            assert any(e.get("name") == PT.WINDOW for e in trace["traceEvents"])  # the CPU records host ops
            assert arm["ranks"][rk]["busy_share"] is None  # no device on the CPU
            assert arm["ranks"][rk]["window_ms"] > 0
        card = arm["card"]
        assert card["ranks"] == 2 and card["busy_share"] is None
        assert 0 <= card["window_start_spread_ms"] < card["window_ms"]


def test_events_out_exports_a_two_hop_chain(tmp_path):
    path = tmp_path / "events.json"
    proc = subprocess.run(
        [sys.executable, "-m", "shared_tensor_tpu_torch.benchmarks.profile_trace", "--events-out", str(path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ev = json.loads(proc.stdout.strip().splitlines()[-1])["events_out"]
    assert ev["agreed"] and ev["paths"] > 0 and ev["max_hops"] == 2
    assert json.loads(path.read_text())["traceEvents"]


def test_host_codec_bench_prints_its_two_rows():
    proc = subprocess.run(
        [sys.executable, "-m", "shared_tensor_tpu_torch.benchmarks.host_codec_bench", "--n", "65536", "--reps", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [r["op"] for r in lines[:2]] == ["quantize", "apply"]
    for r in lines[:2]:
        assert r["native"] is True and r["n"] == 65536 and r["meps"] > 0
        assert r["vs_ref_202meps"] == pytest.approx(r["meps"] / 202.0)
        assert np.isclose(r["ms"], 65536 / r["meps"] / 1e3)
    assert lines[-1]["bench"] == "host_codec" and lines[-1]["cpu"] and lines[-1]["device"]["count"] == 0
