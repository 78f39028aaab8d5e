"""How long each call site waits for a lock and how long it holds it.

``SharedTensor``'s state lock serializes every add, apply, frame and
snapshot of a node, so a section that holds it long stalls every other
thread of the node (the bridge rank's pull and push, a receive, the obs
beat). :class:`TracedLock` is a drop-in ``threading.Lock`` that records,
for each call site (the function that acquired it), the number of
acquisitions, the seconds spent waiting for the lock and holding it, and
the longest of each. ``SharedTensor`` uses it when ``ST_LOCK_TRACE=1`` is
set in the environment at its construction (:func:`enabled`), and a plain
lock otherwise; ``SharedTensor.lock_stats()`` returns the table
(:meth:`TracedLock.stats`), empty without the trace.

Cost when on: two ``perf_counter`` reads and a frame lookup per
acquisition, about a microsecond on a CPU.
"""

from __future__ import annotations

import os
import sys
import threading
import time

ENV = "ST_LOCK_TRACE"


def enabled() -> bool:
    """True when ``ST_LOCK_TRACE`` asks for traced state locks."""
    return os.environ.get(ENV, "0") not in ("", "0")


class TracedLock:
    """A mutex that times its acquisitions by call site (module
    docstring). Use it as ``threading.Lock``: ``with lock:``, or
    ``acquire()`` / ``release()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._mu = threading.Lock()  # guards _stats
        self._stats: dict[str, list] = {}  # site -> [n, wait_s, hold_s, max_wait_s, max_hold_s]
        self._held: tuple[str, float] | None = None  # (site, acquired at), set by the holder

    def acquire(self, blocking: bool = True, timeout: float = -1, _depth: int = 1) -> bool:
        site = sys._getframe(_depth).f_code.co_name
        t0 = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            t1 = time.perf_counter()
            self._held = (site, t1)
            with self._mu:
                s = self._stats.setdefault(site, [0, 0.0, 0.0, 0.0, 0.0])
                s[0] += 1
                s[1] += t1 - t0
                s[3] = max(s[3], t1 - t0)
        return ok

    def release(self) -> None:
        site, t1 = self._held
        self._held = None
        held = time.perf_counter() - t1
        self._lock.release()
        with self._mu:
            s = self._stats[site]
            s[2] += held
            s[4] = max(s[4], held)

    def __enter__(self) -> bool:
        return self.acquire(_depth=2)

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def stats(self) -> dict[str, dict]:
        """{call site: {"n", "wait_s", "hold_s", "max_wait_s",
        "max_hold_s", "mean_wait_ms", "mean_hold_ms"}}, the sites in
        order of their total hold."""
        with self._mu:
            rows = {k: list(v) for k, v in self._stats.items()}
        out = {}
        for site, (n, wait, hold, mwait, mhold) in sorted(rows.items(), key=lambda kv: -kv[1][2]):
            out[site] = {"n": n, "wait_s": wait, "hold_s": hold, "max_wait_s": mwait, "max_hold_s": mhold,
                         "mean_wait_ms": 1e3 * wait / n, "mean_hold_ms": 1e3 * hold / n}
        return out

    def reset(self) -> None:
        with self._mu:
            self._stats.clear()


def new_lock():
    """A :class:`TracedLock` when the trace is on, else a plain lock."""
    return TracedLock() if enabled() else threading.Lock()


def stats(lock) -> dict[str, dict]:
    """``lock``'s table if it is traced, else {}."""
    return lock.stats() if isinstance(lock, TracedLock) else {}
