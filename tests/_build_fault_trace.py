"""A pytest plugin that traces the no-fallback rule on the card: after every
test it runs, inline in the same process, the check of
``test_torch_cuda.py::test_a_failed_cascade_kernel_build_raises_on_the_card``
(a cascade burst on a CUDA residual whose kernels cannot be built) and its
twin for the per-leaf scale pass (a table frame), and records what each
reached.

    PYTHONPATH=tests python -m pytest --noconftest -p no:cacheprovider -p _build_fault_trace \\
        tests/test_torch_cuda.py -m cuda

One JSON line a test goes to ``$ST_BUILD_FAULT_TRACE`` (default
``profiles/build_fault_trace.jsonl``): the test it ran after, and for each
check whether it raised (the message), the kernels whose wrapper asked for
its library (``codec_cuda._fn``), the launches counted and whether the
residual changed. A check that did not raise names what reached a kernel
without a library. Imports no jax: it runs on the chip machine. Not a
test: ``tests/`` holds it beside the file it traces.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch


def _check(kind: str) -> dict:
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.table import make_spec, quantize_table, quantize_table_cascade

    reached = []
    real_fn = CC._fn

    def broken(names=None):
        raise RuntimeError("nvcc failed")

    def fn(name):
        reached.append(name)
        return real_fn(name)

    mp = pytest.MonkeyPatch()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.setattr(CC, "_LIBS", {})
            mp.setattr(CC, "BUILD_DIR", Path(tmp))
            mp.setattr(CC, "build", broken)
            mp.setattr(CC, "_fn", fn)
            spec = make_spec({"t": np.zeros(4096, np.float32)})
            r = torch.randn(spec.total, device="cuda")
            before = r.clone()
            CC.reset_launches()
            raised = None
            try:
                if kind == "cascade":
                    quantize_table_cascade(r, spec, 8, 32)
                else:
                    quantize_table(r, spec)
            except RuntimeError as e:
                raised = str(e)[:120]
            torch.cuda.synchronize()
            return {"raised": raised, "reached": reached,
                    "launches": {k: v for k, v in CC.launches().items() if v},
                    "changed": not torch.equal(r, before)}
        finally:
            mp.undo()


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    if not torch.cuda.is_available():
        return
    rec = {"after": item.nodeid, "cascade": _check("cascade"), "leaf": _check("leaf")}
    path = os.environ.get("ST_BUILD_FAULT_TRACE", os.path.join("profiles", "build_fault_trace.jsonl"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
