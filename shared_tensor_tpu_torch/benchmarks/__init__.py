"""Benchmarks of the port that run on the card (``pareto.py``, the training
benches, ...), and the record of the machine each one names on its last
line."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch


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
