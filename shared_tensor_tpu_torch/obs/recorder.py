"""The flight recorder and the process's observability hub.

The counterpart of ``shared_tensor_tpu/obs/recorder.py``. A bounded deque
of the last N merged native and Python events, dumped with per-name event
totals and a snapshot of every registered metrics registry to a postmortem
JSON file when something terminal happens:

- a fault plan's crash point fires (the dump comes before ``os._exit``;
  the native tier's crash points ``_exit(17)`` inside C and cannot dump,
  so the other peers' recorders are the evidence there);
- a peer's receive thread takes an unhandled exception;
- a go-back-N teardown fires on either tier (the Python tiers dump
  directly; a native teardown is seen as a ring event at drain time).

One hub per process: peers share the native ring (events carry per-node
obs ids), so one merged timeline spans every peer in the process. The ring
is drained on the peers' receive loops (and on demand), never on a
background thread touching ctypes handles, so no drain races a close.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Iterable, Optional

from . import events as ev


class FlightRecorder:
    """Last-N merged event store + per-name totals. ``record`` is the only
    writer API; ``timeline`` returns a time-sorted copy (events arrive
    batched per tier, so insertion order is NOT global time order)."""

    def __init__(self, capacity: int = 4096):
        self._mu = threading.Lock()
        self._events: collections.deque[ev.Event] = collections.deque(
            maxlen=max(16, int(capacity))
        )
        #: name -> total ever recorded (NOT bounded by the deque): timeline
        #: accounting survives even when the window has rolled past an event
        self.counts: collections.Counter = collections.Counter()

    def record(self, batch: Iterable[ev.Event]) -> None:
        with self._mu:
            for e in batch:
                self._events.append(e)
                self.counts[e.name] += 1

    def set_capacity(self, capacity: int) -> None:
        """Re-bound the window, preserving the newest events. A run that
        reconstructs update paths raises this first, so every trace_apply
        record survives until then (the default window is sized for
        postmortems, not full-run captures)."""
        with self._mu:
            self._events = collections.deque(
                self._events, maxlen=max(16, int(capacity))
            )

    def timeline(self) -> list[ev.Event]:
        with self._mu:
            out = list(self._events)
        out.sort(key=lambda e: e.t_ns)
        return out

    def clear(self) -> None:
        with self._mu:
            self._events.clear()
            self.counts.clear()


class ObsHub:
    """Process-wide observability hub: the flight recorder, the Python-tier
    event entry point, the native-ring drain, and registered registries
    (snapshotted into postmortems). Use the module-level :func:`hub`."""

    def __init__(self, capacity: int = 4096):
        self.recorder = FlightRecorder(capacity)
        self._mu = threading.Lock()
        self._registries: dict[str, object] = {}  # label -> Registry
        self._last_drain = 0.0
        self._last_dump: dict[str, float] = {}  # reason -> monotonic time
        self.dump_paths: list[str] = []
        # taps: callables fed every drained native batch (peers use
        # one to read engine-tier trace_apply origins without a second
        # drain of the ring — draining is destructive, so the recorder is
        # the single drain point and taps fan the batch out).
        self._taps: list = []

    # -- event ingestion ----------------------------------------------------

    def emit(
        self, name: str, node: int = 0, link: int = 0, arg: int = 0,
        detail: str = "", extra: int = 0,
    ) -> None:
        """Record one Python-tier event (no-op when obs is disabled — the
        callers gate on their own cached flag; this is the backstop)."""
        from . import obs_enabled

        if not obs_enabled():
            return
        self.recorder.record([ev.py_event(name, node, link, arg, detail, extra)])

    def poll_native(self, min_interval_sec: float = 0.0, lib=None) -> int:
        """Drain the native ring into the recorder (rate-limited when
        ``min_interval_sec`` > 0 — peers call this from their recv loops
        every pass). A drained black-hole teardown event triggers a
        postmortem dump, so a NATIVE go-back-N teardown leaves a trace even
        though the teardown itself ran in C. Returns events drained."""
        now = time.monotonic()
        with self._mu:
            if min_interval_sec > 0 and now - self._last_drain < min_interval_sec:
                return 0
            self._last_drain = now
        batch = ev.drain_native(lib=lib)
        if not batch:
            return 0
        self.recorder.record(batch)
        for tap in list(self._taps):
            try:
                tap(batch)
            except Exception:
                pass  # a broken tap must not stop the drain
        if any(e.name == "blackhole_teardown" for e in batch):
            self.dump("native_blackhole_teardown")
        return len(batch)

    def add_tap(self, fn) -> None:
        """Register a callable fed every drained native event batch."""
        with self._mu:
            if fn not in self._taps:
                self._taps.append(fn)

    def remove_tap(self, fn) -> None:
        with self._mu:
            try:
                self._taps.remove(fn)
            except ValueError:
                pass

    # -- registries ----------------------------------------------------------

    def register_registry(self, label: str, registry) -> None:
        with self._mu:
            self._registries[label] = registry

    def unregister_registry(self, label: str) -> None:
        with self._mu:
            self._registries.pop(label, None)

    # -- postmortem ----------------------------------------------------------

    def dump(
        self, reason: str, path: Optional[str] = None,
        min_interval_sec: float = 5.0,
    ) -> Optional[str]:
        """Write the postmortem file: merged timeline (time-sorted), event
        totals, native ring-drop count, and a snapshot of every registered
        registry. Per-reason rate limit (``min_interval_sec``) so a
        crash-looping recv thread cannot spray the disk. Returns the path,
        or None when rate-limited / obs disabled. Never raises: this runs
        on failure paths that must stay failure paths."""
        from . import obs_enabled

        if not obs_enabled():
            return None
        now = time.monotonic()
        with self._mu:
            if now - self._last_dump.get(reason, -1e9) < min_interval_sec:
                return None
            self._last_dump[reason] = now
            regs = dict(self._registries)
        try:
            doc = {
                "reason": reason,
                "pid": os.getpid(),
                "t_ns": time.monotonic_ns(),
                "native_events_dropped": ev.native_dropped(),
                "event_counts": dict(self.recorder.counts),
                "registries": {},
                "timeline": [e.as_dict() for e in self.recorder.timeline()],
            }
            for label, reg in regs.items():
                try:
                    doc["registries"][label] = reg.snapshot()
                except Exception:
                    doc["registries"][label] = None
            if path is None:
                base = os.environ.get(
                    "ST_OBS_POSTMORTEM_DIR", tempfile.gettempdir()
                )
                safe = "".join(
                    c if c.isalnum() or c in "-_." else "_" for c in reason
                )
                path = os.path.join(
                    base,
                    f"st_postmortem_{os.getpid()}_"
                    f"{time.monotonic_ns()}_{safe}.json",
                )
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            with self._mu:
                self.dump_paths.append(path)
            return path
        except Exception:
            return None

    def export_timeline(self, path: str) -> str:
        """Write the recorder's merged timeline as conformance-replayable
        JSON: ``{"timeline": [...], "event_counts": {...},
        "native_events_dropped": N}``, the shape
        ``tools/protospec/conformance.py`` (and its ``run_conformance.py``
        CLI) accepts directly. Unlike :meth:`dump` this is not a failure
        path: it raises on I/O errors, so a truncated file cannot pass for
        a captured one."""
        doc = {
            "timeline": [e.as_dict() for e in self.recorder.timeline()],
            "event_counts": dict(self.recorder.counts),
            "native_events_dropped": ev.native_dropped(),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        return path


_hub: Optional[ObsHub] = None
_hub_mu = threading.Lock()


def hub() -> ObsHub:
    """The process-wide hub (created on first use; capacity from
    ``ST_OBS_RECORDER_EVENTS``, default 4096)."""
    global _hub
    with _hub_mu:
        if _hub is None:
            cap = int(os.environ.get("ST_OBS_RECORDER_EVENTS", "4096"))
            _hub = ObsHub(cap)
        return _hub
