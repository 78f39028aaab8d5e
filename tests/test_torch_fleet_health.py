"""The port's fleet-health bench (shared_tensor_tpu_torch.benchmarks.fleet_health)
on the CPU at the root bench's constants: the heat phase (7 sharded nodes,
the hot shard named within 3 beats) and the skew phase (+-50 ms of
simulated skew recovered within the estimator's uncertainty) each pass,
and the run leaves no file behind. The SLO phase (about 10 s of stall and
recovery) runs in the bench command, not here. The bench's output path is
required: it has no default."""

import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from shared_tensor_tpu_torch.benchmarks import fleet_health as fh

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    saved, tempfile.tempdir = tempfile.tempdir, str(tmp)
    try:
        doc = fh.run("cpu", phases=("heat", "skew"))
    finally:
        tempfile.tempdir = saved
    return doc, tmp


def test_constants_are_the_root_bench_s():
    assert (fh.HEAT_N, fh.HOT_SHARD, fh.BEAT_S) == (1 << 14, 2, 0.2)


def test_heat_names_the_hot_shard(report):
    heat = report[0]["phases"]["heat"]
    assert heat["pass"], heat
    assert heat["hot_shard_named"] == fh.HOT_SHARD and heat["beats_to_name"] <= 3


def test_skew_is_recovered_within_uncertainty(report):
    skew = report[0]["phases"]["skew"]
    assert skew["pass"], skew
    assert [n["skew_sim_sec"] for n in skew["nodes"]] == [0.05, -0.05]
    assert all(n["within_uncertainty"] for n in skew["nodes"])


def test_run_leaves_no_file(report):
    doc, tmp = report
    assert doc["device"] == "cpu" and doc["pass"]
    assert list(tmp.iterdir()) == []


def test_output_path_is_required():
    out = subprocess.run([sys.executable, "-m", "shared_tensor_tpu_torch.benchmarks.fleet_health", "--device", "cpu"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "out" in out.stderr
