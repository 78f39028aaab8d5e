"""The observability plane of the port.

The counterpart of ``shared_tensor_tpu/obs/``, computing and sending what
the JAX package's does: the same metric names, the same digest bytes, the
same clock estimates and the same health document on the same inputs.

- :mod:`~shared_tensor_tpu_torch.obs.schema`: one name per number;
- :mod:`~shared_tensor_tpu_torch.obs.registry`: counters, gauges and
  fixed-bucket histograms, Prometheus text and a JSONL sink;
- :mod:`~shared_tensor_tpu_torch.obs.events`: the drain of the native
  event ring (``st_obs_drain`` in the port's build of
  ``native/sttransport.cpp``) merged with Python-tier events on the shared
  CLOCK_MONOTONIC timebase;
- :mod:`~shared_tensor_tpu_torch.obs.recorder`: the process flight
  recorder and its postmortem dumps;
- :mod:`~shared_tensor_tpu_torch.obs.aggregate`: the bounded cluster
  metrics digest that peers piggyback up the tree;
- :mod:`~shared_tensor_tpu_torch.obs.clock`: the four-stamp clock-offset
  estimator;
- :mod:`~shared_tensor_tpu_torch.obs.timeseries` and
  :mod:`~shared_tensor_tpu_torch.obs.health`: the root's digest history and
  its health analyzer (``health.json``);
- :mod:`~shared_tensor_tpu_torch.obs.trace_export`: causal update paths
  and the Chrome/Perfetto ``trace_event`` export;
- :mod:`~shared_tensor_tpu_torch.obs.top`:
  ``python -m shared_tensor_tpu_torch.obs.top``, a terminal view of the
  root's cluster digest.

``ST_OBS=0`` disables the whole plane, the native ring's emission and the
engine's per-message trace bookkeeping included; ``ObsConfig.enabled``
disables one peer's Python-tier part. The default is on.
"""

from __future__ import annotations

import os

from .recorder import FlightRecorder, ObsHub, hub  # noqa: F401
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS,
    Registry,
)

_ENABLED: bool | None = None


def obs_enabled() -> bool:
    """The process-wide switch (env ``ST_OBS``, default on), read once:
    peers wire themselves at creation, and flipping it mid-process is for
    the overhead bench (:func:`set_enabled`)."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("ST_OBS", "1") != "0"
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Flip obs at run time, for the paired on/off overhead measurement
    (``benchmarks/obs_overhead.py``), not for production. Also flips the
    native ring's emission flag when the transport library is loaded.
    Peers created before the flip keep their wiring."""
    global _ENABLED
    _ENABLED = bool(on)
    from ..comm import transport

    lib = transport._lib
    if lib is not None:
        lib.st_obs_set_enabled(1 if on else 0)
