"""Profiling and rate metrics: the counterpart of
``shared_tensor_tpu/utils/profiling.py``, which imports jax and so cannot
be imported by the port.

- :func:`trace`: context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``, for chrome://tracing or Perfetto) of
  whatever ran inside: the codec chain, a training loop.
- :class:`RateMeter`: turns monotonically increasing counters (frames,
  wire bytes) into rates over a sliding window. Copied from the JAX
  package.
- :func:`effective_bits`: measured bits/element/frame from a residual-RMS
  trajectory, the matched-approximation-error yardstick (1.0 when the RMS
  halves per frame). Copied from the JAX package.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import deque
from typing import Iterable, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile what runs inside (host ops, and CUDA kernels when a GPU is
    present) and write ``<log_dir>/trace.json`` on exit. Yields the
    profiler, whose ``key_averages()`` sums the time by operator and
    kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RateMeter:
    """Sliding-window rates from cumulative counters.

    >>> meter = RateMeter()
    >>> meter.update(frames=st.frames_in, wire_bytes=stats.bytes_in)
    >>> meter.rates()  # {"frames": f/s, "wire_bytes": B/s}
    """

    def __init__(self, window_sec: float = 10.0):
        self.window = window_sec
        self._samples: deque[tuple[float, dict[str, float]]] = deque()

    def update(self, **counters: float) -> None:
        self.update_at(time.monotonic(), **counters)

    def update_at(self, now: float, **counters: float) -> None:
        """`update` with an explicit timestamp — the testable entry point
        (r18 satellite), and the one for callers replaying recorded
        counter trajectories."""
        # Wall-clock-jump tolerance (r18 satellite): a sample stamped
        # EARLIER than the previous one (suspend/resume replay, a caller
        # switching time sources, test replays) would give a negative dt
        # and an inverted window. Re-anchor exactly like a counter reset:
        # the old timeline is unusable, the new one starts here.
        if self._samples and now < self._samples[-1][0]:
            self._samples.clear()
        # Counter-reset tolerance (r08 satellite): cumulative counters can
        # legitimately restart from ~0 — a link re-graft hands the stream
        # to a FRESH link id (new LinkStats), an engine peer is re-created
        # after a crash-point kill, a compat peer reconnects, a process
        # restores from checkpoint with zeroed registries. A window
        # spanning the reset would then report a huge NEGATIVE rate (new
        # minus old counter). Detect any counter going backwards and drop
        # the pre-reset history: the meter re-anchors at the reset point
        # and reports rates for the new stream only.
        if self._samples:
            _, last = self._samples[-1]
            if any(
                counters[k] < last[k] for k in counters if k in last
            ):
                self._samples.clear()
        self._samples.append((now, dict(counters)))
        cutoff = now - self.window
        # Evict while the SECOND-oldest sample is already at/past the window
        # edge — keeping exactly one sample at or before it, so rates() spans
        # the full window rather than just the last update interval.
        while len(self._samples) > 2 and self._samples[1][0] <= cutoff:
            self._samples.popleft()

    def rates(self) -> dict[str, float]:
        """Per-second rates over (at most) the trailing window.

        The oldest retained sample can be far older than the window (it is
        kept as the at-or-before-the-edge anchor; after an idle gap it may
        predate the edge by the whole gap). Using its raw timestamp would
        dilute the rate over the gap, so the counter value AT the window
        edge is linearly interpolated between the two samples bracketing it
        and the rate taken from there.
        """
        if len(self._samples) < 2:
            return {}
        t1, c1 = self._samples[-1]
        cutoff = t1 - self.window
        t0, c0 = self._samples[0]
        if t0 < cutoff:
            i = 1
            while i < len(self._samples) - 1 and self._samples[i][0] < cutoff:
                i += 1
            (ta, ca), (tb, cb) = self._samples[i - 1], self._samples[i]
            w = min(1.0, (cutoff - ta) / max(tb - ta, 1e-9))
            c0 = {
                k: ca.get(k, 0.0) + (cb.get(k, 0.0) - ca.get(k, 0.0)) * w
                for k in cb
            }
            t0 = min(cutoff, tb)
        dt = max(t1 - t0, 1e-9)
        # Clamped at zero: resets/rewinds re-anchor the window above, so a
        # negative delta here can only be float noise at the interpolated
        # edge — and a rate is a non-negative quantity by definition.
        return {
            k: max(0.0, (c1.get(k, 0.0) - c0.get(k, 0.0)) / dt) for k in c1
        }


def effective_bits(rms_trajectory: Iterable[float]) -> float:
    """Average bits of precision gained per element per frame, from a
    residual-RMS trajectory (one entry per frame). The reference codec
    achieves 1.0 on homogeneous data (RMS halves per frame, BASELINE.md)
    and ~0.15 on 1000:1 mixed magnitudes — the failure per-leaf scales fix."""
    traj = [float(x) for x in rms_trajectory]
    if len(traj) < 2 or traj[0] <= 0:
        return 0.0
    first, last = traj[0], traj[-1]
    if last <= 0:  # exact convergence: count bits down to fp32 epsilon
        last = first * 2.0**-24
    return math.log2(first / last) / (len(traj) - 1)
