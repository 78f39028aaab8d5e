"""The end-to-end artifact: every arm of ``e2e_sync`` in a subprocess of
its own, each row the arm's JSON line verbatim.

    python -m shared_tensor_tpu_torch.benchmarks.e2e_artifact > E2E.json

The counterpart of the root ``benchmarks/e2e_artifact.py``, with its arms
(host-tier parents at 4 Ki, 1 Mi and 16 Mi, both peers on the reference's
wire at 1 Mi, and the reference C peer as the child at 1 Mi) and one more:
``cuda_parent_1mi``, the parent on the GPU's device tier, so the artifact
needs the card (on the CPU run ``e2e_sync`` with
``ST_E2E_PARENT_PLATFORM=cpu``). The headline ratios are each row's
own per-direction fields (``vs_baseline_out`` / ``vs_baseline_in``) and
their mean; a failed arm is a row with ``status`` "failed" and the tail of
its stderr.

Knobs: ``ST_E2E_ROUND`` (the tag), ``ST_E2E_ARM_SECONDS`` (each arm's
window, 10), ``ST_E2E_SKIP_C=1`` (no C peer arm).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from . import REPO

#: The root artifact's arms: (name, the environment of e2e_sync).
ARMS = (
    ("host_bidir_4ki", {"ST_E2E_PARENT_PLATFORM": "cpu", "ST_E2E_N": 4096}),
    ("host_bidir_1mi", {"ST_E2E_PARENT_PLATFORM": "cpu", "ST_E2E_N": 1 << 20}),
    ("host_bidir_16mi", {"ST_E2E_PARENT_PLATFORM": "cpu", "ST_E2E_N": 16 << 20}),
    ("compat_both_ours_1mi", {"ST_E2E_PARENT_PLATFORM": "cpu", "ST_E2E_N": 1 << 20, "ST_E2E_COMPAT": 1}),
)
C_ARM = ("wire_compat_vs_compiled_C_peer", {"ST_E2E_PARENT_PLATFORM": "cpu", "ST_E2E_N": 1 << 20, "ST_E2E_CHILD": "c"})
GPU_ARM = ("cuda_parent_1mi", {"ST_E2E_N": 1 << 20})
NOTE = ("2-process E2E through the full peer stack; every row is the verbatim e2e_sync.py output for that arm (see "
        "each row's repro). Ratios are PER-DIRECTION vs BASELINE.md's per-direction reference rows "
        "(vs_baseline_out/in), vs_baseline = their fair average. Both peers stream full-duplex, as does the "
        "reference.")


def run_arm(name: str, env_overrides: dict, seconds: str, timeout: float = 420.0) -> dict:
    """One arm: ``e2e_sync`` in a subprocess under ``env_overrides``; its
    last JSON line, with ``arm`` and ``repro`` added."""
    env = dict(os.environ, ST_E2E_SECONDS=seconds, **{k: str(v) for k, v in env_overrides.items()})
    repro = (" ".join(f"{k}={v}" for k, v in sorted(env_overrides.items()))
             + " python -m shared_tensor_tpu_torch.benchmarks.e2e_sync")
    try:
        r = subprocess.run([sys.executable, "-m", "shared_tensor_tpu_torch.benchmarks.e2e_sync"], env=env, cwd=REPO,
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return {"arm": name, "status": "failed", "stderr": f"timed out after {e.timeout} s", "repro": repro}
    if r.returncode != 0 or not r.stdout.strip():
        return {"arm": name, "status": "failed", "stderr": r.stderr[-500:], "repro": repro}
    row = json.loads(r.stdout.strip().splitlines()[-1])
    row["arm"] = name
    row["repro"] = repro
    return row


def assemble(rows: list, round_tag: str) -> dict:
    """The artifact from the arms' rows, verbatim."""
    return {
        "bench": f"e2e_peer_sync_{round_tag}",
        "note": NOTE,
        "arms": rows,
        "produced_by": "shared_tensor_tpu_torch/benchmarks/e2e_artifact.py (machine-generated)",
    }


def arms(skip_c: bool = False, skip_gpu: bool = False) -> list:
    """The arms to run, in order."""
    return list(ARMS) + ([] if skip_c else [C_ARM]) + ([] if skip_gpu else [GPU_ARM])


def main(argv=None) -> dict:
    if (sys.argv[1:] if argv is None else argv)[:1] in (["-h"], ["--help"]):
        print(f"usage: python -m shared_tensor_tpu_torch.benchmarks.e2e_artifact\n\n{__doc__}")
        return {}
    seconds = os.environ.get("ST_E2E_ARM_SECONDS", "10")
    todo = arms(os.environ.get("ST_E2E_SKIP_C") == "1")
    out = assemble([run_arm(name, envo, seconds) for name, envo in todo], os.environ.get("ST_E2E_ROUND", "r05"))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    doc = main()
    sys.exit(1 if any(r.get("status") == "failed" for r in doc.get("arms", [])) else 0)
