"""The port's process mesh (shared_tensor_tpu_torch.parallel.mesh): the
(peer, shard) grid of ranks and its two process-group families, run_mesh's
results, failures and timeouts, and the GPU default of its entry points."""

import time

import pytest
import torch

from shared_tensor_tpu_torch.parallel import make_mesh, rows_per_shard, run_mesh
from tests import test_torch_pod_jobs as P


def test_grid_groups_and_sub_meshes():
    """2 peers x 2 shards: rank r at peer r // 2, shard r % 2; the peer group
    of a rank is its shard's column, the shard group its peer's row; each
    rank runs one intra-op thread; a sub-mesh over ranks 2 and 3 is None on
    ranks 0 and 1."""
    out = run_mesh(P.sub_mesh_facts, 2, 2, device="cpu", timeout_s=120)
    for r, res in enumerate(out):
        f = res["world"]
        assert res["rank"] == f["rank"] == r
        assert (f["peer"], f["shard"]) == (r // 2, r % 2)
        assert f["peer_group"] == [r % 2, 2 + r % 2]
        assert f["shard_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert f["shape"] == {"peer": 2, "shard": 2}
        assert (f["backend"], f["device"]) == ("gloo", "cpu")
        assert "needs 64 ranks, have 4" in f["oversized"]
        assert res["threads"] == 1
        assert res["sub"] == (None if r < 2 else (r - 2, 0, (2, 3)))


def test_a_failed_rank_fails_the_mesh_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_mesh(P.fail_on_rank, 3, 1, 1, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60  # the waiting ranks were killed, not waited for


def test_a_hung_rank_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_mesh(P.hang, 2, 1, device="cpu", timeout_s=8)
    assert time.monotonic() - t0 < 60


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="run_mesh or init_multihost"):
        make_mesh(2, 1, device="cpu")


def test_the_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mesh(P.hang, 2, 1, timeout_s=8)


def test_rows_per_shard():
    assert rows_per_shard(2048, 4) == 4
    assert rows_per_shard(3_871_744, 2) == 15_124
    with pytest.raises(ValueError, match="not divisible"):
        rows_per_shard(1024, 3)


def test_init_multihost_joins_a_launched_group():
    """init_multihost reads the launcher's environment (here one rank, as
    torchrun would set it), is idempotent, and make_mesh then works."""
    import os
    import subprocess
    import sys

    from tests._ports import free_port

    code = (
        "from shared_tensor_tpu_torch.parallel import init_multihost, make_mesh\n"
        "assert init_multihost() == 0 and init_multihost() == 0\n"
        "m = make_mesh(1, 1, device='cpu')\n"
        "print(m.shape, m.backend)\n"
    )
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0", WORLD_SIZE="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'peer': 1, 'shard': 1} gloo"
