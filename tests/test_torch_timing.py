"""The port's codec timing and headline bench on the CPU: the chain of
frames runs and is timed, the budget holds, the kernel codec refuses to run
without a GPU, and the bench prints one line of the root bench's schema.
(Times here are of PyTorch's CPU kernels; the card's come from
chip_smoke.py.)"""

import json
import math
import time

import pytest
import torch

from shared_tensor_tpu_torch import bench
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec as TC
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.utils.timing import codec_frame_time


@pytest.mark.parametrize("codec", [TC, CC], ids=["golden", "codec_cuda_plain"])
def test_codec_frame_time_on_cpu(codec):
    t0 = time.monotonic()
    t = codec_frame_time(codec, 4096, ScalePolicy.POW2_RMS, target_seconds=0.05,
                         budget_s=10.0, device="cpu")
    assert math.isfinite(t) and t > 0
    assert time.monotonic() - t0 < 10.0 + 5.0


def test_codec_frame_time_stops_at_budget():
    """A target far beyond the budget: the best estimate so far comes back
    once the budget trips."""
    t0 = time.monotonic()
    t = codec_frame_time(TC, 4096, ScalePolicy.POW2_RMS, target_seconds=1e6,
                         budget_s=0.3, device="cpu")
    assert math.isfinite(t) and t > 0
    assert time.monotonic() - t0 < 5.0


def test_codec_frame_time_uses_the_given_residual():
    seen = []

    def make(seed):
        seen.append(seed)
        return torch.ones(1024)

    codec_frame_time(CC, 1024, ScalePolicy.POW2_RMS, make_residual=make,
                     target_seconds=0.01, reps=2, device="cpu")
    assert set(seen) == {0, 1}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_bench_kernel_codec_without_gpu_raises(device):
    if torch.cuda.is_available() and device == "cuda":
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError):
        bench.main(["--codec", "kernel", "--device", device, "--n", "4096"])


def test_bench_main_prints_one_schema_line(capsys):
    res = bench.main(["--codec", "plain", "--device", "cpu", "--n", "4096",
                      "--target-seconds", "0.05"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got == res
    assert got["metric"] == "sync_bandwidth_equiv_fp32_per_link" and got["unit"] == "GB/s"
    assert got["value"] > 0
    d = got["detail"]
    assert d["n_elements"] == 4096 and d["codec"] == "plain" and d["backend"] == "cpu"
    assert d["frames_per_s"] > 0 and d["wire_gbps"] > 0
