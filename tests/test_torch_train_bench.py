"""The port's training benches (shared_tensor_tpu_torch.benchmarks.train_bench
and mesh_timing) on the CPU, against the root benchmarks/train_bench.py and
the JAX PodTrainer.

- ``flops_per_token`` equals the root bench's (imported by path) for the
  flagship and the tiny config.
- The bench's four arms, run by its own rank code on two gloo ranks from
  JAX's initial parameters and batch (numpy, carried over by
  ``convert.table_from_numpy``), give the losses of JAX's PodTrainer in the
  same arm over the warm-up's 3 steps. Tolerance 3e-4, as
  tests/test_torch_trainer.py's parity case: XLA fuses the vmapped step
  differently, and each update carries the f32 differences of the grads.
- Its document has the four arms and a null ``mfu`` on the CPU, and it
  exits 1 when an arm fails.
- ``mesh_timing --device cpu --steps 3`` prints its four arms and
  ``overlap_vs_fused``.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from shared_tensor_tpu.models import char_rnn as jm
from shared_tensor_tpu.train import PodTrainer as JPodTrainer
from shared_tensor_tpu_torch.benchmarks import train_bench as TB
from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig
from tests._mesh import make_mesh as j_mesh
from tests.test_torch_pod_jobs import mesh_lock

ROOT = pathlib.Path(__file__).resolve().parent.parent
PEERS, BATCH, SEQ = 2, 2, 32
ARM_NAMES = [name for name, _ in TB.ARMS]


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_train_bench", ROOT / "benchmarks" / "train_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cfg", [{}, TB.TINY], ids=["flagship", "tiny"])
def test_flops_per_token_equals_the_root_bench(cfg):
    want = _root_bench().flops_per_token(jm.CharRNNConfig(**cfg))
    assert TB.flops_per_token(CharRNNConfig(**cfg)) == want
    if not cfg:
        assert want == 22_806_528  # 6 N, N = 3,801,088


def _jax_inputs():
    cfg = jm.CharRNNConfig(**TB.TINY)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), cfg))
    batch = tuple(np.asarray(a) for a in jm.make_batches(TB.TEXT, batch=BATCH, seq=SEQ, key=jax.random.key(1),
                                                         n_peer=PEERS, vocab=cfg.vocab))
    return cfg, params, batch


@pytest.fixture(scope="module")
def port_arms():
    """The bench's rank code (``run_arms``) on two CPU ranks, every chain
    cut to 2 steps (``target_seconds`` 0) after the 3 warm-up steps."""
    from shared_tensor_tpu_torch.parallel import run_mesh

    _, params, batch = _jax_inputs()
    setup = TB.Setup(cfg=TB.TINY, batch=BATCH, seq=SEQ, target_seconds=0.0, t0=time.time(), params=params,
                     batch_np=batch)
    with mesh_lock():
        return setup, run_mesh(TB.run_arms, PEERS, 1, setup, TB.ARMS, device="cpu", timeout_s=120)


@pytest.mark.parametrize("arm", ARM_NAMES)
def test_arm_losses_match_the_jax_pod_trainer(port_arms, arm):
    setup, ranks = port_arms
    cfg, params, batch = _jax_inputs()
    tr = JPodTrainer(j_mesh(PEERS, 1), params, lambda p, b: jm.loss_fn(p, b, cfg), **dict(TB.ARMS)[arm])
    b = tr.shard_batch(batch)
    want = np.stack([np.asarray(tr.step(b, lr=setup.lr)[0]) for _ in range(TB.WARM)])
    for r in ranks:
        np.testing.assert_allclose(r[arm]["warm_losses"], want, rtol=0, atol=3e-4)


def test_document_has_four_arms_and_no_mfu_on_the_cpu(port_arms):
    setup, ranks = port_arms
    out = TB.summarize(ranks, setup, PEERS, "cpu")
    assert list(out["arms"]) == ARM_NAMES
    assert out["peak_flops"] is None and out["matmul_precision"] == "fp32"
    assert out["tokens_per_step"] == PEERS * BATCH * SEQ
    for name, arm in out["arms"].items():
        assert "error" not in arm, (name, arm)
        assert arm["mfu"] is None and arm["tokens_per_s"] > 0
        assert 0 < arm["step_ms_p10"] <= arm["step_ms"] <= arm["step_ms_p90"]
        assert arm["chains"] == TB.ROUNDS and arm["k"] == 2
        assert arm["steps"] == TB.WARM + 2 + TB.ROUNDS * 2  # warm-up, calibration, the timed chains
        assert arm["launches"] == {"quantize_rows": [0, 0], "apply_rows_batch": [0, 0]}  # plain versions
        assert ("sync_overhead_pct" in arm) == ("sync_overhead_resolved" in arm) == (name != "sync_off")


def test_a_failed_arm_exits_1_and_keeps_the_others(monkeypatch, capsys):
    """An arm that raises on every rank (``compressed`` given overlap
    without sync) is an error in the document and exit code 1; the other
    three arms still run."""
    broken = tuple((n, dict(sync=False, overlap=True)) if n == "compressed" else (n, kw) for n, kw in TB.ARMS)
    monkeypatch.setattr(TB, "ARMS", broken)
    monkeypatch.setattr(TB, "TARGET_S", 0.0)
    with mesh_lock():
        rc = TB.main(["--device", "cpu", "--peers", str(PEERS), "--tiny", "--batch", str(BATCH), "--seq", str(SEQ)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert list(out["arms"]) == ARM_NAMES
    assert "overlap=True requires" in out["arms"]["compressed"]["error"]
    for name in ("sync_off", "compressed_overlap", "exact"):
        assert "error" not in out["arms"][name] and out["arms"][name]["mfu"] is None
    assert out["device"] == {"name": "cpu", "count": 0, "smi": None}


def test_mesh_timing_prints_four_arms_on_the_cpu():
    with mesh_lock():
        proc = subprocess.run(
            [sys.executable, "-m", "shared_tensor_tpu_torch.benchmarks.mesh_timing", "--device", "cpu", "--steps", "3"],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [a["arm"] for a in out["arms"]] == ["no_sync", "exact_allreduce", "compressed_fused", "compressed_overlap"]
    assert out["measure_steps"] == 3 and out["n_peer"] == 8
    for a in out["arms"]:
        assert 0 < a["p10_s"] <= a["median_step_s"] <= a["p90_s"] and np.isfinite(a["final_loss"])
    assert out["overlap_vs_fused"] > 0
    assert out["model"]["params"] == CharRNNConfig(vocab=96, embed=64, hidden=192, layers=2).param_count
