"""Bounded ring-buffered time series over the cluster digest.

The counterpart of ``shared_tensor_tpu/obs/timeseries.py``. A digest is an
instantaneous snapshot; this module keeps a bounded in-memory history of
digest beats at the root and derives rates and trends from it.

- **Bounded everything.** Each series is a ring of at most ``max_points``
  samples; the store holds at most ``max_series`` series, evicting the
  least recently updated first (``evicted`` counts them).
- **Reset-tolerant rates.** A counter rate is the sum of POSITIVE deltas
  over the window divided by the window's span: a counter reset (a
  re-grafted node, a restore) contributes zero instead of a negative
  spike. Rates are never negative.
- **Standard library only, no threads.** The store is fed synchronously
  from the digest beat and read by the health analyzer or ``obs.top`` in
  the same thread.

Series are keyed by tuples, so callers never parse strings:

- ``("cluster", name)``: whole-tree counter totals; gauge extrema are
  ``("gmax", name)`` / ``("gmin", name)``;
- ``("hist", name, "p50"|"p99")``: quantile tracks of merged histograms;
- ``("node", node_id, name)``: per-node breakdown entries, labeled gauges
  included (the rendered name is the key's last element).

A node's breakdown is filed at its digest entry's own sample time (the
entry's ``t_ns``, less the node's clock offset to the root,
``st_clock_offset_seconds``, where the node exports one: on one host the
monotonic clocks agree and the offset is about 0), not at the beat that
reads it, and an entry that did not advance since the last beat (the same
child digest merged again) adds no point. A child's digest reaches the
root one or more beats old, and its age varies from beat to beat: filed at
the beat, a re-merged digest left a flat step in the node's counters and a
fresher one a steep one, both of which skewed its rates. The cluster
series stay at the beat. JAX's store files every node at the beat (a
documented divergence of the port).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

from . import aggregate as _agg

#: Default ring depth per series: 256 beats at the default 0.5s digest
#: interval is ~2 minutes of history — enough for the SLO long windows.
DEFAULT_MAX_POINTS = 256

#: Default series cap: a 256-node fleet with ~16 breakdown entries each
#: fits with headroom; past it the least-recently-updated series evict.
DEFAULT_MAX_SERIES = 4096

#: Histogram quantile tracks sampled per beat.
QUANTILES = (0.5, 0.99)


def hist_quantile(hist: dict, q: float) -> float:
    """Linear-interpolated quantile from a merged digest histogram
    (``{"sum","count","buckets":{bound_str: cumulative_count}}``).
    Returns 0.0 for an empty histogram; values past the last finite
    bucket clamp to that bucket's bound (the +Inf tail has no width to
    interpolate over)."""
    count = int(hist.get("count", 0))
    if count <= 0:
        return 0.0
    target = q * count
    bounds = sorted(hist.get("buckets", {}), key=float)
    prev_bound, prev_cum = 0.0, 0
    for b in bounds:
        cum = int(hist["buckets"][b])
        bound = float(b)
        if cum >= target:
            span = cum - prev_cum
            if span <= 0:
                return bound
            frac = (target - prev_cum) / span
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = bound, cum
    return prev_bound  # target lives in the +Inf bucket: clamp


class RingSeries:
    """One bounded series: (t_ns, value) pairs, oldest evicted first."""

    __slots__ = ("_ring", "last_t_ns")

    def __init__(self, max_points: int) -> None:
        self._ring: deque = deque(maxlen=max_points)
        self.last_t_ns = 0

    def append(self, t_ns: int, value: float) -> None:
        self._ring.append((int(t_ns), float(value)))
        self.last_t_ns = int(t_ns)

    def __len__(self) -> int:
        return len(self._ring)

    def points(self) -> list:
        return list(self._ring)

    def latest(self) -> Optional[float]:
        return self._ring[-1][1] if self._ring else None

    def window(self, since_ns: int) -> list:
        """Samples with t_ns >= since_ns, plus one anchor sample at or
        before the edge when available (rate interpolation needs it)."""
        pts = list(self._ring)
        lo = 0
        for i, (t, _) in enumerate(pts):
            if t >= since_ns:
                lo = i
                break
        else:
            return pts[-1:] if pts else []
        return pts[max(0, lo - 1):]


class TimeSeriesStore:
    """Bounded store of digest-beat series; see module docstring."""

    def __init__(
        self,
        max_points: int = DEFAULT_MAX_POINTS,
        max_series: int = DEFAULT_MAX_SERIES,
    ) -> None:
        self._max_points = max(2, int(max_points))
        self._max_series = max(1, int(max_series))
        self._series: dict = {}
        self.evicted = 0
        self.beats = 0
        self._node_t: dict = {}  # node id -> the own t_ns of its last digest entry filed

    # -- feeding ---------------------------------------------------------

    def _put(self, key: tuple, t_ns: int, value) -> None:
        if not isinstance(value, (int, float)):
            return
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = RingSeries(self._max_points)
        s.append(t_ns, value)

    def ingest(self, doc: dict, t_ns: int) -> None:
        """Sample one cluster digest document at the beat ``t_ns``: the
        cluster series at ``t_ns``, each node's breakdown at its own sample
        time (module docstring)."""
        self.beats += 1
        for name, v in doc.get("counters", {}).items():
            self._put(("cluster", name), t_ns, v)
        for name, v in _agg.process_global_totals(doc).items():
            self._put(("cluster", name), t_ns, v)
        for name, pair in doc.get("gmax", {}).items():
            self._put(("gmax", name), t_ns, pair[0])
        for name, pair in doc.get("gmin", {}).items():
            self._put(("gmin", name), t_ns, pair[0])
        for name, h in doc.get("hists", {}).items():
            for q in QUANTILES:
                self._put(
                    ("hist", name, f"p{int(q * 100)}"),
                    t_ns,
                    hist_quantile(h, q),
                )
        nodes = doc.get("nodes", {})
        for nid, entry in nodes.items():
            node = int(nid)
            at = self._sample_ns(node, entry, t_ns)
            if at is None:
                continue  # the digest filed at an earlier beat
            for name, v in entry.get("m", {}).items():
                self._put(("node", node, name), at, v)
        if len(self._node_t) > self._max_series:
            self._node_t = {n: t for n, t in self._node_t.items() if str(n) in nodes}
        self._evict()

    def _sample_ns(self, node: int, entry: dict, beat_ns: int) -> Optional[int]:
        """When a node's digest entry was sampled, on the root's clock: its
        own ``t_ns`` less its clock offset to the root (where it exports
        one), or None if that entry was filed already. An entry without a
        sample time is filed at the beat."""
        own = entry.get("t_ns")
        if not isinstance(own, (int, float)):
            return beat_ns
        own = int(own)
        last = self._node_t.get(node)
        if last is not None and own <= last:
            return None
        self._node_t[node] = own
        off = entry.get("m", {}).get("st_clock_offset_seconds")
        return own - int(round(float(off) * 1e9)) if isinstance(off, (int, float)) else own

    def _evict(self) -> None:
        over = len(self._series) - self._max_series
        if over <= 0:
            return
        by_age = sorted(self._series, key=lambda k: self._series[k].last_t_ns)
        for k in by_age[:over]:
            del self._series[k]
            self.evicted += 1

    # -- reading ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self._series)

    def keys(self) -> Iterable[tuple]:
        return self._series.keys()

    def series(self, key: tuple) -> Optional[RingSeries]:
        return self._series.get(key)

    def latest(self, key: tuple) -> Optional[float]:
        s = self._series.get(key)
        return s.latest() if s is not None else None

    def values(self, key: tuple, n: int = 0) -> list:
        """The series' values (optionally the last ``n``), oldest first."""
        s = self._series.get(key)
        if s is None:
            return []
        vals = [v for _, v in s.points()]
        return vals[-n:] if n > 0 else vals

    def rate(self, key: tuple, window_sec: float, now_ns: Optional[int] = None) -> float:
        """Reset-tolerant counter rate over the trailing window: sum of
        positive inter-sample deltas divided by the covered span. Counter
        resets (negative deltas) contribute zero; the result is >= 0."""
        s = self._series.get(key)
        if s is None or len(s) < 2:
            return 0.0
        if now_ns is None:
            now_ns = s.last_t_ns
        pts = s.window(int(now_ns - window_sec * 1e9))
        if len(pts) < 2:
            return 0.0
        gained = 0.0
        for (_, a), (_, b) in zip(pts, pts[1:]):
            if b > a:
                gained += b - a
        span = (pts[-1][0] - pts[0][0]) / 1e9
        if span <= 0:
            return 0.0
        return gained / span

    def node_rate(self, node: int, name: str, window_sec: float) -> float:
        return self.rate(("node", int(node), name), window_sec)

    def cluster_rate(self, name: str, window_sec: float) -> float:
        return self.rate(("cluster", name), window_sec)
