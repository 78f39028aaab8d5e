"""The port's config-5 sweep (shared_tensor_tpu_torch.benchmarks.pareto)
against the JAX codec: the same U(-1, 1) residual from numpy, chained
through 8 quantize frames, gives bit-equal residuals, so the RMS curves
agree to a relative 1e-6 (the means run in another order). On such data
the RMS halves per frame."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import codec as JC
from shared_tensor_tpu_torch.benchmarks import pareto
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec as TC
from shared_tensor_tpu_torch.ops import codec_cuda as CC

N = 1 << 12


def _jax_curve(r, n, frames=8):
    r = jnp.asarray(r)
    out = []
    for _ in range(frames):
        _, r = JC.quantize(r, n, JPolicy.POW2_RMS)
        out.append(float(jnp.sqrt(jnp.mean(r * r))))
    return out, np.asarray(r)


@pytest.mark.parametrize("codec", [TC, CC], ids=["golden", "codec_cuda_plain"])
def test_rms_curve_matches_jax(codec):
    r = np.random.default_rng(7).uniform(-1, 1, N).astype(np.float32)
    want, want_r = _jax_curve(r, N)
    t = torch.from_numpy(r.copy())
    got = pareto.rms_curve(codec, t, N, ScalePolicy.POW2_RMS)
    assert len(got) == 8
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the same residual after 8 frames, bit for bit (C updates in place)
    r_port = torch.from_numpy(r.copy())
    for _ in range(8):
        _, r_port = codec.quantize(r_port, N, ScalePolicy.POW2_RMS)
    np.testing.assert_array_equal(r_port.numpy().view(np.uint32), want_r.view(np.uint32))


def test_measure_size_halves_rms_per_frame():
    row = pareto.measure_size(CC, N, ScalePolicy.POW2_RMS, device="cpu", target_seconds=0.05)
    assert 0.45 <= row["rms_decay_per_frame"] <= 0.55
    assert row["effective_bits"] == pytest.approx(-np.log2(row["rms_decay_per_frame"]), abs=1e-3)
    assert row["n_elements"] == N and row["frame_us"] > 0 and row["equiv_gbps"] > 0
    assert row["backend"] == "cpu" and row["peak_bytes"] is None


def test_pareto_main_prints_a_line_per_size(capsys):
    rows = pareto.main(["--sizes", "10,12", "--codec", "plain", "--device", "cpu",
                        "--target-seconds", "0.02"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x) for x in lines] == rows
    assert [r["n_elements"] for r in rows] == [1 << 10, 1 << 12]


def test_pareto_kernel_codec_on_cpu_raises():
    with pytest.raises(RuntimeError):
        pareto.main(["--sizes", "10", "--codec", "kernel", "--device", "cpu"])
