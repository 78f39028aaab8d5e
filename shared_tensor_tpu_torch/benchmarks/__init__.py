"""Benchmarks of the port that run on the card (``pareto.py``, the training
benches, ...), and the record of the machine each one names on its last
line, and the trace-conformance gate every chaos arm ends on."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional

import torch

#: The repo's root: ``tools/protospec``, the protocol model both packages
#: are replayed against, lies below it.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def smi_line() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def device_record(device) -> dict:
    """What a bench ran on: ``{"name", "count", "smi"}``, the card's name
    (``torch.cuda.get_device_name``), the number of cards and the
    ``nvidia-smi`` line for a CUDA ``device``; for the CPU, ``"cpu"`` and no
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {"name": "cpu", "count": 0, "smi": None}
    return {"name": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count(), "smi": smi_line()}


def cpu_model() -> str:
    """The host CPU's model name as lscpu gives it, or, where that reads
    "unknown" (a virtual machine may hide it), its vendor, family and model
    numbers."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        out = ""
    info = {k.strip(): v.strip() for k, v in (line.split(":", 1) for line in out.splitlines() if ":" in line)}
    name = info.get("Model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{info.get('Vendor ID', 'unknown')} family {info.get('CPU family', '?')} model "
                f"{info.get('Model', '?')}, {info.get('CPU(s)', '?')} CPUs")
    return name


def conformance(hub) -> dict:
    """The trace-conformance gate of the chaos arms: drain the native ring
    one last time and replay the run's merged timeline through the protocol
    specs' trace acceptors (``tools/protospec``, reached by path from the
    repo's root, the one model the JAX package's peers are held to as
    well). A violation fails the arm as a convergence failure does.
    ``ST_CLUSTER_TIMELINE_OUT`` also writes the raw timeline there
    (``ObsHub.export_timeline``). Returns ``check_timeline``'s report:
    ``events``, ``routed_events``, ``scopes``, ``violations``, ``pass``."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from protospec.conformance import check_timeline

    hub.poll_native()
    timeline_out = os.environ.get("ST_CLUSTER_TIMELINE_OUT", "")
    if timeline_out:
        hub.export_timeline(timeline_out)
    report = check_timeline(hub.recorder.timeline())
    if timeline_out:
        report["timeline_out"] = timeline_out
    return report


def gate_passes(report: dict) -> bool:
    """The gate's verdict: no violation, and at least one event routed to
    an acceptor (a timeline none of whose events reaches one, after an
    event's rename say, verifies nothing)."""
    return bool(report["pass"] and report["routed_events"] >= 1)


def path_kernels(peer) -> tuple[str, ...]:
    """The kernels a device-tier peer's data plane launches: its sender's
    (A-cascade and its finish kernel for bursts by the engine's cascade,
    ``CodecConfig.cascade_frames`` > 1; A for single frames and per-frame
    bursts) and B."""
    if peer._burst_device > 1 and peer.st.cascade > 1:
        return ("quantize_rows_cascade", "cascade_round", "apply_rows_batch")
    return ("quantize_rows", "apply_rows_batch")


def master_state(peer, update_tree) -> tuple:
    """What :func:`kernel_check` holds the kernels on: a device-tier peer's
    replica and link residuals (``snapshot_all``), ``update_tree`` flattened
    onto its device, and its codec config. Take it before the peer closes."""
    from ..ops.table import flatten

    values, links = peer.st.snapshot_all()
    return values, links, flatten(update_tree, peer.st.spec, values.device), peer.st.codec


def kernel_check(master: tuple, spec) -> dict:
    """Kernels A and B against their plain versions on a device-tier peer's
    state (:func:`master_state`), at the shapes an engine child gives it: A
    as a burst of K = the most frames one BURST carries for this table, on
    the update with the codec's scale policy; B with those K frames into
    N = 2 targets, the replica and one link's residual. Launches made here
    count in ``codec_cuda.LAUNCHES``: read a path's counts before. Returns
    {kernel: {"mismatches", "max_abs_err", ...}}."""
    from ..comm import wire
    from ..ops import table as TT

    values, links, update, codec = master
    k = wire.burst_frames_cap(spec)
    f_k, r_k = TT.quantize_table_burst(update.clone(), spec, k, codec.scale_policy, codec.per_leaf_scale, "kernel")
    f_p, r_p = TT.quantize_table_burst(update.clone(), spec, k, codec.scale_policy, codec.per_leaf_scale, "plain")
    resid = next(iter(links.values()))
    a_k = TT.apply_table_batch((values.clone(), resid.clone()), f_p, spec, "kernel")
    a_p = TT.apply_table_batch((values.clone(), resid.clone()), f_p, spec, "plain")
    if values.device.type == "cuda":
        torch.cuda.synchronize(values.device)

    def bitdiff(a, b) -> int:
        return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())

    def maxerr(a, b) -> float:  # NaN in both counts as equal, NaN in one as inf
        d = (a.double() - b.double()).abs()
        d = torch.nan_to_num(torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d), nan=float("inf"))
        return float(d.max()) if d.numel() else 0.0

    return {
        "quantize_rows": {"mismatches": bitdiff(f_k.words, f_p.words) + bitdiff(f_k.scales, f_p.scales)
                          + bitdiff(r_k, r_p), "max_abs_err": maxerr(r_k, r_p), "k": k,
                          "live_frames": int((f_p.scales != 0).any(dim=1).sum())},
        "apply_rows_batch": {"mismatches": sum(bitdiff(x, y) for x, y in zip(a_k, a_p)),
                             "max_abs_err": max(maxerr(x, y) for x, y in zip(a_k, a_p)), "k": k, "n": 2},
    }
