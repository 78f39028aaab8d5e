"""The port's bench arms on the host CPU: ``--codec host`` (the host codec's
full link frame) and ``--codec engine`` (two engine peers over loopback, in
spawned processes), each printing one line of the root bench's schema."""

import json

import numpy as np
import pytest

from shared_tensor_tpu_torch import bench
from shared_tensor_tpu_torch.benchmarks import engine_bench


@pytest.mark.parametrize("codec", ["host", "engine"])
def test_host_arms_print_one_schema_line(codec, capsys):
    res = bench.main(["--codec", codec, "--n", str(1 << 16), "--target-seconds", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert line["metric"] == "sync_bandwidth_equiv_fp32_per_link" and line["unit"] == "GB/s"
    d = line["detail"]
    assert d["codec"] == codec and d["backend"] == "cpu" and d["n_elements"] == 1 << 16
    assert d["frames_per_s"] > 0 and line["value"] > 0
    np.testing.assert_allclose(line["value"], d["frames_per_s"] * (1 << 16) * 4 / 1e9, rtol=2e-3)


def test_engine_bench_runs_both_peers_on_the_engine():
    row = engine_bench.run_size(4096, measure_s=1.0, budget_s=90.0)
    assert row["engine"] and row["master_engine"], row
    assert row["frames_in_per_s"] > 0 and row["n"] == 4096


def test_host_frame_time_is_positive_and_bounded():
    t = bench.host_frame_time(4096, target_seconds=0.05, budget_s=5.0)
    assert 0 < t < 1.0
