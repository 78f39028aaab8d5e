"""The port's profiling helpers: RateMeter and effective_bits replay the
same recorded trajectories as the JAX package's copies and give the same
numbers (exactly: the code is the same Python); trace() writes a Chrome
trace on the CPU."""

import json

import numpy as np
import pytest
import torch

from shared_tensor_tpu.utils import profiling as JP
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.utils import profiling as TP

#: Recorded counter trajectories: (window_sec, [(t, {counter: value}), ...]).
TRAJECTORIES = {
    "steady": (60.0, [(0.0, {"frames": 0, "bytes": 0}), (0.05, {"frames": 50, "bytes": 5000})]),
    "many_in_window": (60.0, [(0.01 * i, {"frames": i}) for i in range(50)]),
    "stale_anchor": (0.01, [(0.0, {"frames": 0})] + [(0.02 + 0.001 * i, {"frames": i}) for i in range(1, 5)]),
    "counter_reset": (60.0, [(0.0, {"frames": 1000, "bytes": 100000}), (0.01, {"frames": 2000, "bytes": 200000}),
                             (0.02, {"frames": 5, "bytes": 500}), (0.03, {"frames": 10, "bytes": 1000})]),
    "one_counter_resets": (60.0, [(0.0, {"a": 100, "b": 100}), (0.01, {"a": 0, "b": 200}),
                                  (0.02, {"a": 50, "b": 300})]),
    "idle_gap": (0.05, [(0.0, {"frames": 0}), (0.5, {"frames": 100}), (0.51, {"frames": 200})]),
    "clock_rewind": (60.0, [(5.0, {"frames": 10}), (6.0, {"frames": 20}), (1.0, {"frames": 30}),
                            (1.5, {"frames": 40})]),
    "single_sample": (10.0, [(0.0, {"frames": 3})]),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_rate_meter_matches_jax(name):
    window, samples = TRAJECTORIES[name]
    jm, tm = JP.RateMeter(window_sec=window), TP.RateMeter(window_sec=window)
    for t, counters in samples:
        jm.update_at(t, **counters)
        tm.update_at(t, **counters)
        assert tm.rates() == jm.rates()
    assert [s for s in tm._samples] == [s for s in jm._samples]
    assert all(v >= 0 for v in tm.rates().values())


@pytest.mark.parametrize(
    "traj",
    [[], [1.0], [0.0, 0.0], [1.0, 0.0], [1.0, 0.5, 0.25, 0.125], [0.577, 0.29, 0.14, 0.071, 0.036],
     [2.0, 1.9, 1.85], [3.0, 3.0, 3.0]],
    ids=lambda t: "-".join(map(str, t)) or "empty",
)
def test_effective_bits_matches_jax(traj):
    assert TP.effective_bits(traj) == JP.effective_bits(traj)


def test_effective_bits_of_the_port_codec_is_one():
    """Uniform residual through the port's quantize: RMS halves per frame."""
    n = 4096
    r = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, n).astype(np.float32))
    traj = []
    for _ in range(10):
        traj.append(float(torch.sqrt(torch.mean(r * r))))
        _, r = CC.quantize(r, n)
    assert 0.8 < TP.effective_bits(traj) < 1.2, traj


def test_trace_writes_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "prof")) as prof:
        torch.ones(128, 128).sum()
    path = tmp_path / "prof" / "trace.json"
    assert path.is_file()
    assert "traceEvents" in json.loads(path.read_text())
    assert len(prof.key_averages()) > 0
