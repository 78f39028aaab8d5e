"""Metrics registry: counters, gauges and fixed-bucket histograms.

The counterpart of ``shared_tensor_tpu/obs/registry.py``, line for line,
so a snapshot and its Prometheus text are the same bytes in both packages.
Names come from :mod:`~shared_tensor_tpu_torch.obs.schema`. Three
instrument kinds:

- :class:`Counter`: a monotone cumulative count (``*_total`` names);
- :class:`Gauge`: a point-in-time level (queue depth, residual RMS);
- :class:`Histogram`: fixed upper-bound buckets, cumulative counts and
  sum/count (Prometheus histogram semantics). ``observe()`` is one lock and
  a linear scan over ~14 bounds, cheap enough for a per-message path.

Collectors bridge the pull side: a registered zero-arg callable returning
``{name: value}`` is invoked at snapshot time, so counters that live
elsewhere (the engine's atomics, the transport's stats) are sampled once
per scrape instead of being kept twice.

Exports: :meth:`Registry.snapshot` (plain dict, JSON-safe),
:meth:`Registry.prometheus_text` (text exposition format v0.0.4), and a
background JSONL sink thread (:meth:`Registry.start_jsonl_sink`) appending
one ``{"t_ns": ..., "metrics": {...}}`` line per interval.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional, Sequence

#: Default histogram bounds (seconds): wire/codec latencies span ~10 us
#: (engine-tier ACK turnarounds) to seconds (retransmission timers), log-ish
#: spaced so each bucket is meaningful at some table size.
LATENCY_BUCKETS = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 3.0, 10.0,
)


class Counter:
    """Monotone cumulative counter. ``inc`` only; never decreases (a reset
    — e.g. a re-created peer — is a NEW counter; RateMeter tolerates the
    discontinuity downstream)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._mu = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._mu:
            self._v += n

    @property
    def value(self) -> float:
        with self._mu:
            return self._v


class Gauge:
    """Point-in-time level; set() or a pull callback (``fn``) — a callback
    gauge samples at snapshot time and ignores set()."""

    def __init__(
        self, name: str, help: str = "", fn: Optional[Callable[[], float]] = None
    ):
        self.name = name
        self.help = help
        self._fn = fn
        self._v = 0.0
        self._mu = threading.Lock()

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._mu:
            return self._v


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics): ``buckets`` are the
    finite upper bounds; counts are CUMULATIVE per bound, with an implicit
    +Inf bucket == total count. ``observe`` is one lock + a linear scan —
    fine for the Python tier's per-message cadence (the native data plane
    never routes through here)."""

    def __init__(
        self,
        name: str,
        buckets: Sequence[float] = LATENCY_BUCKETS,
        help: str = "",
    ):
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.name = name
        self.help = help
        self.bounds = tuple(b)
        self._counts = [0] * len(b)  # per-bound, NON-cumulative internally
        self._sum = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._mu:
            self._sum += v
            self._count += 1
            for i, bound in enumerate(self.bounds):
                if v <= bound:
                    self._counts[i] += 1
                    break

    def snapshot(self) -> dict:
        """{"sum": s, "count": n, "buckets": {bound: cumulative_count}}."""
        with self._mu:
            out, cum = {}, 0
            for bound, c in zip(self.bounds, self._counts):
                cum += c
                out[bound] = cum
            return {"sum": self._sum, "count": self._count, "buckets": out}


class Registry:
    """A namespace of instruments + pull collectors, snapshot-able to a
    plain dict and renderable as Prometheus text exposition. Thread-safe:
    instrument creation takes the registry lock; the instruments themselves
    carry their own locks so the hot path never touches the registry's."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: list[Callable[[], dict]] = []
        self._sink_stop: Optional[threading.Event] = None
        self._sink_thread: Optional[threading.Thread] = None

    # -- instrument constructors (idempotent by name) -----------------------

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help), Counter)

    def gauge(
        self, name: str, help: str = "", fn: Optional[Callable[[], float]] = None
    ) -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help, fn), Gauge)

    def histogram(
        self,
        name: str,
        buckets: Sequence[float] = LATENCY_BUCKETS,
        help: str = "",
    ) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, buckets, help), Histogram
        )

    def _get_or_make(self, name, make, want_type):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = make()
            elif not isinstance(m, want_type):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {want_type.__name__}"
                )
            return m

    def register_collector(self, fn: Callable[[], dict]) -> None:
        """``fn() -> {name: value}`` sampled at every snapshot — the bridge
        for counters that already live in C (engine/transport ABIs)."""
        with self._mu:
            self._collectors.append(fn)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat JSON-safe dict: scalars for counters/gauges, the
        sum/count/buckets dict for histograms, collector outputs merged in
        (collectors never override a registered instrument's name)."""
        with self._mu:
            metrics = dict(self._metrics)
            collectors = list(self._collectors)
        out: dict = {}
        for fn in collectors:
            try:
                out.update(fn())
            except Exception:
                # a dying peer's collector (closed engine handle) must not
                # take the scrape down with it
                pass
        for name, m in metrics.items():
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            else:
                out[name] = m.value
        return out

    def prometheus_text(self) -> str:
        """Text exposition format v0.0.4 (one scrape body). Histogram
        buckets render with the standard ``_bucket{le=...}`` /
        ``_sum`` / ``_count`` series; collector scalars render as untyped
        samples. Dict-valued collector entries shaped like
        ``Histogram.snapshot()`` render as histograms too."""
        lines: list[str] = []

        def render_hist(name: str, snap: dict, help: str = "") -> None:
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} histogram")
            for bound, cum in snap["buckets"].items():
                lines.append(f'{name}_bucket{{le="{float(bound):g}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {snap["count"]}')
            lines.append(f"{name}_sum {snap['sum']:g}")
            lines.append(f"{name}_count {snap['count']}")

        with self._mu:
            metrics = dict(self._metrics)
            collectors = list(self._collectors)
        seen = set()
        for name, m in sorted(metrics.items()):
            seen.add(name)
            if isinstance(m, Histogram):
                render_hist(name, m.snapshot(), m.help)
            else:
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                kind = "counter" if isinstance(m, Counter) else "gauge"
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {m.value:g}")
        collected: dict = {}
        for fn in collectors:
            try:
                collected.update(fn())
            except Exception:
                pass
        for name, v in sorted(collected.items()):
            if name in seen:
                continue
            if isinstance(v, dict) and "buckets" in v:
                render_hist(name, v)
            else:
                lines.append(f"{name} {float(v):g}")
        return "\n".join(lines) + "\n"

    # -- background JSONL sink ----------------------------------------------

    def start_jsonl_sink(self, path: str, interval_sec: float = 5.0) -> None:
        """Append one ``{"t_ns": monotonic_ns, "metrics": snapshot()}`` line
        every ``interval_sec`` until :meth:`stop_jsonl_sink` (daemon thread;
        one final line is written at stop so short runs still record)."""
        self.stop_jsonl_sink()
        stop = threading.Event()

        def _run():
            while True:
                fired = stop.wait(interval_sec)
                try:
                    with open(path, "a") as f:
                        f.write(
                            json.dumps(
                                {
                                    "t_ns": time.monotonic_ns(),
                                    "metrics": self.snapshot(),
                                }
                            )
                            + "\n"
                        )
                except OSError:
                    pass  # sink target vanished; keep the process alive
                if fired:
                    return

        self._sink_stop = stop
        self._sink_thread = threading.Thread(
            target=_run, daemon=True, name="st-obs-jsonl"
        )
        self._sink_thread.start()

    def stop_jsonl_sink(self) -> None:
        if self._sink_stop is not None:
            self._sink_stop.set()
            if self._sink_thread is not None:
                self._sink_thread.join(timeout=5.0)
            self._sink_stop = None
            self._sink_thread = None
