"""The port's chaos, soak and end-to-end benches on the CPU, each held to the
gates of its root counterpart and printing that bench's JSON keys (those
of the committed artifacts JAX's runs wrote: CHAOS_r09-r14, CHAOS_r08,
SOAK_r04, AB_r11, ENGINE_SWEEP_r14, and the line of benchmarks/e2e_sync.py).

- ``cluster_chaos``: the base, ``--subscribers 2`` and ``--stripes 4`` arms
  at the root bench's defaults (7 nodes, N = 2048, 40 adds, seed 9: no
  cut); ``--shm`` (the kill-restore arm with the lane's gates, through the
  CLI's dispatch) at the same defaults.
- ``chaos_soak``: each arm alone for 3 s of chaos (the root bench's 40 s
  cut to fit here) at N = 512, seed 6; on the CPU the python arm runs on
  the Python host tier, as the root bench's CPU run does (the card's
  device-tier run is a ``cuda`` case of test_torch_cuda.py).
- ``soak``: 8 s (the root bench's 300 s cut) with a chaos event every 2.5 s
  (its 7 s cut), so that at least one link kill and one leave-and-rejoin
  happen.
- ``adaptive_ab``: the mixed-tree arm at the root bench's defaults.
- ``engine_sweep``: one size (64 Ki), one repeat, 2 s windows (the root
  sweep's 8 s).
- ``e2e_sync``: a host-tier parent and child at N = 1 Mi for 2 s after 1 s
  of warm-up (the root bench's 10 s and 3 s); its ``ScaleTally`` on a
  SharedTensor's frames.
- ``drain_tail``: the engine's row at 64 Ki.
- The CLIs that write a document refuse to run without OUT.

The pure functions run beside JAX's on the same inputs: the seeded fault
schedules (captured from the root ``chaos_soak._run_arm`` with its peers
stubbed out), ``dev_bound`` (against the bound JAX's committed runs
report for their injected corruptions), and the E2E artifact's assembly
(the root ``e2e_artifact.main`` on the same rows). Equality is exact."""

import ast
import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

from shared_tensor_tpu_torch.benchmarks import adaptive_ab, chaos_soak, cluster_chaos, e2e_artifact, e2e_sync
from shared_tensor_tpu_torch.benchmarks import engine_sweep, soak

ROOT = Path(__file__).resolve().parent.parent


def _artifact(name: str) -> dict:
    return json.loads((ROOT / name).read_text())


def _root_bench(name: str):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _has_keys(got: dict, want: dict, where: str = "") -> None:
    """Every key of ``want`` is in ``got``, recursively through dicts."""
    missing = sorted(set(want) - set(got))
    assert not missing, f"{where or 'top'}: missing {missing}"
    for k, v in want.items():
        if isinstance(v, dict) and isinstance(got[k], dict) and v:
            _has_keys(got[k], v, f"{where}.{k}")


ARMS = {
    # the committed CHAOS_r09.json was last written by a striped run
    "base": (0, 1, lambda: {k: v for k, v in _artifact("CHAOS_r09.json").items() if k != "stripes"}),
    "subscribers": (2, 1, lambda: _artifact("CHAOS_r10.json")),
    "stripes": (0, 4, lambda: _artifact("CHAOS_r11.json")),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_cluster_chaos_arm(arm):
    subs, stripes, jax_doc = ARMS[arm]
    out = cluster_chaos.run(nodes=7, n=2048, adds=40, seed=9, subs=subs, stripes=stripes)
    want = jax_doc()
    if arm == "base":
        want["chaos"] = {k: v for k, v in want["chaos"].items() if k not in ("severed_stripe", "sever_after_frames")}
    _has_keys(out, want)
    assert out["engine_tier"]
    assert out["converged_all"] and out["drained_all"]
    assert out["injected"]["fault_drop"] >= 1 and out["injected"]["retransmit"] >= 1
    assert out["trace_paths"]["paths"] >= 20 and out["trace_paths"]["contiguous_frac"] >= 0.99
    assert out["digest_exact"], out["digest"]
    assert out["conformance"]["violations"] == [] and out["conformance"]["routed_events"] >= 1
    if subs:
        assert out["subscribers"]["converged_all"]
    if stripes > 1:
        assert out["stripes"]["outcome"] in ("degraded-to-survivors", "gbn-teardown-regraft"), out["stripes"]
    assert out["pass"]


def test_cluster_chaos_shm_dispatches_to_kill_restore(tmp_path):
    """``--shm``: lifecycle.run_kill_restore with the lane's gates, through
    the CLI, at the root bench's defaults; the document holds CHAOS_r14's
    keys and the conformance report, and the gate passes."""
    path = tmp_path / "CHAOS_shm.json"
    assert cluster_chaos.main([str(path), "--shm"]) == 0
    out = json.loads(path.read_text())
    _has_keys(out, _artifact("CHAOS_r14.json"))
    assert out["bench"] == "lifecycle_kill_restore_shm"
    assert out["shm"]["pre_kill_lanes_live"] >= 12 and out["shm"]["restored_lanes_live"] >= 12
    assert out["shm"]["digest_exact_at_quiesce"]
    assert out["conformance"]["pass"] and out["conformance"]["routed_events"] >= 1
    assert out["snapshot"]["released"]
    assert out["pass"]


@pytest.mark.parametrize("arm", ["python", "native"])
def test_chaos_soak_arm(arm):
    out = chaos_soak.run(n=512, seconds=3.0, seed=6, arms=(arm,), device="cpu")
    jax_doc = _artifact("CHAOS_r08.json")
    _has_keys(out, {k: v for k, v in jax_doc.items() if k != "arms"})
    r = out["arms"][arm]
    _has_keys(r, jax_doc["arms"][arm])
    assert r["trainers_joined"] and r["final_drains_ok"] == f"{r['peers']}/{r['peers']}"
    assert r["max_dev_vs_expected"] <= r["dev_bound"] and r["cross_replica_spread"] <= r["dev_bound"]
    assert r["wedged_threads"] == []
    assert r["obs"]["accounted"] and r["obs"]["postmortem_ok"] and r["obs"]["timeline_tiers"] == ["c", "py"]
    assert r["tier"] == ("native-engine" if arm == "native" else "python-host")
    assert out["pass"]


class _Stop(Exception):
    pass


def test_chaos_soak_schedules_equal_jax(monkeypatch):
    """One rng seeded 6, the python arm's three joiners' schedules then the
    native joiner's ST_FAULT_PLAN: the root bench's (its peers stubbed out
    to capture their configs) and the port's, field for field."""
    import jax.numpy as jnp

    from shared_tensor_tpu.comm import peer as jpeer

    jcs = _root_bench("chaos_soak")
    captured = []

    class Peer:
        def __init__(self, host, port, template, cfg):
            captured.append((cfg.faults, os.environ.get("ST_FAULT_PLAN")))
            self._faults = None

        def wait_ready(self, timeout):
            raise _Stop

    monkeypatch.setattr(jpeer, "SharedTensorPeer", Peer)
    monkeypatch.setattr(jpeer, "create_or_fetch", lambda host, port, t, cfg, *a, **k: Peer(host, port, t, cfg))
    rng = np.random.default_rng(jcs.SEED)
    for arm in ("python", "native"):
        with pytest.raises(_Stop):
            jcs._run_arm(arm, np, jnp, rng)
    # the master, three python joiners; the master, the chaotic and the calm native joiner
    assert len(captured) == 7
    rng = np.random.default_rng(6)
    mine = chaos_soak.python_schedules(rng, 6)
    assert [dataclasses.asdict(c) for c in mine] == [dataclasses.asdict(c) for c, _ in captured[1:4]]
    env = chaos_soak.native_schedule(rng, 6)
    assert env["ST_FAULT_PLAN"] == captured[5][1] and captured[6][1] is None


@pytest.mark.parametrize("artifact", ["CHAOS_r06.json", "CHAOS_r08.json"])
def test_dev_bound_equals_jax_runs(artifact):
    """The bound JAX's committed runs report for the corruptions they
    injected is the port's dev_bound of the same count."""
    r = _artifact(artifact)["arms"]["python"]
    assert chaos_soak.dev_bound(r["faults_injected"]["corrupted"]) == r["dev_bound"]
    assert chaos_soak.dev_bound(0) == _artifact(artifact)["arms"]["native"]["dev_bound"]


def test_soak_kills_and_rejoins():
    out = soak.run(seconds=8.0, n=8192, chaos_period=2.5)
    _has_keys(out, _artifact("SOAK_CRASH_r04.json"))
    assert out["hard_link_kills"] >= 1 and out["graceful_leave_rejoin_cycles"] >= 1
    assert out["population_ok"] and out["workers_on_engine"]
    assert out["final_drains_ok"] == "4/4" and out["leave_failures"] == 0
    assert out["agreement_dev_master_vs_fresh_joiner"] < out["agreement_bar"]
    assert max(out["sum_dev_neg"], out["sum_dev_pos"]) < out["redelivery_noise_bound"]
    assert out["pass"]


def test_adaptive_ab_mixed_tree():
    out = adaptive_ab.run(mixed_only=True)
    jax_doc = _artifact("AB_r11.json")
    # the A/B's arms and means are empty when the mixed tree runs alone
    _has_keys(out, {k: {} if k in ("arms", "mean_final_residual_norm") else v for k, v in jax_doc.items()})
    m = out["mixed_tree"]
    _has_keys(m, jax_doc["mixed_tree"])
    assert m["frames2_in_capable"] > 0 and m["frames2_in_disabled"] == 0
    assert m["drained"] and m["max_dev_capable"] < 1e-4 and m["max_dev_disabled"] < 1e-4
    assert out["pass"]


def test_engine_sweep_one_point():
    out = engine_sweep.run(sizes=(65536,), reps=1, measure_s=2.0)
    jax_doc = _artifact("ENGINE_SWEEP_r14.json")
    _has_keys(out, {k: v for k, v in jax_doc.items() if k not in ("notes", "verdict", "rows")})
    jax_row = next(r for r in jax_doc["rows"] if r["n"] == 65536)
    for row in out["rows"]:
        _has_keys(row, {k: v for k, v in jax_row.items() if k != "vs_reference_e2e"})
        assert row["frames_in_per_s"] > 0
    assert set(out["verdict"]["65536"]) == set(jax_doc["verdict"]["65536"])
    assert out["pass"]


def _jax_e2e_keys() -> set:
    """The keys of the root e2e_sync.py's JSON line, read from its source:
    the ``out`` dict's literal keys and those of ``per_dir`` it unpacks."""
    tree = ast.parse((ROOT / "benchmarks" / "e2e_sync.py").read_text())
    dicts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id in ("out", "per_dir"):
                dicts[t.id] = node.value
    keys = {k.value for k in dicts["out"].keys if k is not None}
    keys |= {k.value for k in dicts["per_dir"].keys}
    return keys


def test_e2e_sync_host_parent_and_child():
    out = e2e_sync.run(n=1 << 20, seconds=2.0, warmup=1.0, parent_host=True)
    assert _jax_e2e_keys() <= set(out)
    assert out["parent_tier"] == "engine" and not out["on_gpu"] and out["wire"] == "native"
    assert out["frames_out_per_s"] > 0 and out["frames_in_per_s"] > 0
    assert out["baseline_equiv_GBps"] == 1.01
    assert out["vs_baseline_out"] == pytest.approx(out["equiv_out_GBps"] / 1.01, abs=0.01)
    assert out["vs_baseline_in"] == pytest.approx(out["equiv_in_GBps"] / 1.01, abs=0.01)


def test_e2e_artifact_assembly_equals_jax(monkeypatch, capsys):
    """The root e2e_artifact.main and the port's assemble, on the same rows,
    give the same artifact (bar the line naming the module that made it),
    over the same CPU arms in the same order."""
    monkeypatch.setenv("ST_E2E_ROUND", "r15")  # read when the root module loads
    jea = _root_bench("e2e_artifact")
    calls = []

    def row(name, env_overrides):
        return {"arm": name, "n": env_overrides.get("ST_E2E_N"), "frames_out_per_s": 1.5 * len(name),
                "vs_baseline_out": 0.5, "repro": f"{name} repro"}

    def fake_run_arm(name, env_overrides, timeout=420.0):
        calls.append((name, dict(env_overrides)))
        return row(name, env_overrides)

    monkeypatch.setattr(jea, "run_arm", fake_run_arm)
    jea.main()
    jax_doc = json.loads(capsys.readouterr().out)
    ours = e2e_artifact.arms(skip_gpu=True)
    assert [(n, dict(e)) for n, e in ours] == calls
    doc = e2e_artifact.assemble([row(n, e) for n, e in ours], "r15")
    assert {k: v for k, v in doc.items() if k != "produced_by"} == \
        {k: v for k, v in jax_doc.items() if k != "produced_by"}
    assert e2e_artifact.arms(skip_c=True, skip_gpu=True) == list(e2e_artifact.ARMS)
    assert e2e_artifact.arms()[-1][0] == "cuda_parent_1mi"


def test_scale_tally_counts_every_frame_by_its_scale():
    """e2e_sync.ScaleTally, on a device-tier SharedTensor on the CPU: every
    frame finish_frame returns is counted once, under the exponent of its
    largest scale, and detach puts the class's methods back."""
    from shared_tensor_tpu_torch.core import SharedTensor

    rng = np.random.default_rng(3)
    st = SharedTensor({"a": np.zeros(1000, np.float32), "b": np.zeros(300, np.float32)}, device="cpu")
    st.new_link(1, seed=False)
    st.add({"a": rng.normal(size=1000).astype(np.float32), "b": 8 * rng.normal(size=300).astype(np.float32)})
    tally = e2e_sync.ScaleTally(st)
    want = []
    for _ in range(12):
        f = st.make_frame(1)
        if f is not None:
            want.append(int(np.floor(np.log2(np.abs(f.scales).max()))))
    doc = tally.detach()
    assert doc["frames"] == len(want) == 12
    assert doc["max_scale_log2"] == {str(e): want.count(e) for e in sorted(set(want))}
    assert "finish_frame" not in vars(st) and "finish_frame_burst" not in vars(st)


@pytest.mark.parametrize("bench", ["cluster_chaos", "engine_sweep"])
def test_cli_writes_only_the_named_out(bench, tmp_path, monkeypatch):
    """OUT has no default: run with none, the CLI refuses and writes
    nothing, so that a run from the repo's root never overwrites the root
    benches' committed CHAOS_r*.json or ENGINE_SWEEP_r*.json."""
    monkeypatch.chdir(tmp_path)
    mod = {"cluster_chaos": cluster_chaos, "engine_sweep": engine_sweep}[bench]
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code == 2
    assert list(tmp_path.iterdir()) == []


def test_drain_tail_engine_drains_one_gaussian_add_exactly():
    """drain_tail's engine row: one gaussian add at 64 Ki drains to exact
    zero (the engine's amax-anchored cascade) in tens of frames, and the
    joiner holds the delta; the row has the bench's keys."""
    from shared_tensor_tpu_torch.benchmarks import drain_tail

    row = drain_tail.run_tier("engine", n=1 << 16, timeout=20.0)
    assert set(row) == {"bench", "tier", "n", "timeout_s", "drained", "seconds", "frames_out", "residual_norm",
                        "joiner_max_err"}
    assert row["drained"] and row["residual_norm"] == 0.0
    assert 0 < row["frames_out"] < 200
    assert row["joiner_max_err"] < 1e-6


def test_e2e_baseline_rows():
    """BASELINE.md's per-direction rows at their sizes, flat past the ends,
    log-interpolated between (the root bench's rule)."""
    assert e2e_sync.baseline_equiv_bps(4096) == 1.28e9
    assert e2e_sync.baseline_equiv_bps(1 << 20) == 1.01e9
    assert e2e_sync.baseline_equiv_bps(16 << 20) == 0.52e9
    assert e2e_sync.baseline_equiv_bps(1024) == 1.28e9 and e2e_sync.baseline_equiv_bps(1 << 26) == 0.52e9
    # 64 Ki lies halfway in log n between 4 Ki and 1 Mi: the geometric mean
    assert e2e_sync.baseline_equiv_bps(1 << 16) == pytest.approx(np.sqrt(1.28e9 * 1.01e9), rel=1e-12)
