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


def test_serve_bench_runs_on_the_cpu(capsys):
    """The serving bench's both arms at --device cpu --small: a device-tier
    master and an engine writer adding, one subscriber read at every bound
    (each attempt served or refused), and the hot swap's params() reads."""
    from shared_tensor_tpu_torch.benchmarks import serve as serve_bench

    serve_bench.main(["--device", "cpu", "--small", "--seconds", "0.3", "--repeats", "1"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["bench"] == "serve" and row["engine_writer"] and row["writers"] == 2
    assert [p["bound_s"] for p in row["pareto"]] == list(serve_bench.BOUNDS)
    for p in row["pareto"]:
        (r,) = p["repeats"]
        assert r["reads"] + r["refused"] > 0 and r["read_per_s"] >= 0
    assert row["hot_swap"]["params_per_s"] > 0 and row["hot_swap"]["swaps"] >= 1
    assert row["hot_swap"]["device"] == "cpu" and row["frames_applied"] > 0 and row["adds_per_s"] > 0


def test_obs_overhead_bench_runs_on_the_cpu(capsys):
    """The obs overhead bench at --device cpu --small: its three paired arms
    and the python arm each measure frames/s with obs on and off, and it
    prints its document as its last line."""
    from shared_tensor_tpu_torch.benchmarks import obs_overhead

    res = obs_overhead.main(["--device", "cpu", "--small"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bench"] == "obs_overhead" and line == json.loads(json.dumps(res))
    for arm in ("engine_arm", "trace_arm", "health_arm"):
        a = line[arm]
        assert len(a["fps_obs_on"]) == len(a["fps_obs_off"]) == 2 and min(a["fps_obs_off"]) > 0, a
        assert a["overhead_pct_lower90"] <= a["overhead_pct_mean"]
    assert line["trace_arm"]["trace_wire"] and line["health_arm"]["health"] and not line["engine_arm"]["trace_wire"]
    py = line["python_arm_informational"]
    assert py["device"] == "cpu" and py["fps_obs_on"] > 0 and py["fps_obs_off"] > 0


def test_shard_bench_runs_both_planes_on_the_cpu():
    """The shard bench's two arms at a small table and one short repeat:
    the Python plane and the lane each apply FWD frames on the one link,
    and the document carries both arms and the ratio gate."""
    from shared_tensor_tpu_torch.benchmarks import shard_bench

    doc = shard_bench.run(n=1 << 14, repeats=1, warm_s=0.2, measure_s=0.5)
    assert doc["bench"] == "shard_bench" and doc["slice_elements"] == 1 << 13
    assert min(doc["python_frames"]) > 0 and min(doc["engine_frames"]) > 0, doc
    assert doc["ratio"] == doc["engine_mean"] / doc["python_mean"] and doc["pass"] == (doc["ratio"] >= 5.0)
