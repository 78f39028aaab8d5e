"""NTP-style clock-offset estimation over the tree's control plane.

The counterpart of ``shared_tensor_tpu/obs/clock.py``. Staleness gauges
difference CLOCK_MONOTONIC stamps of two nodes, which share no epoch
across hosts. This module estimates each node's offset to the tree root
with the four-timestamp exchange (RFC 5905's origin/receive/transmit/
destination, scoped down to a tree):

- every non-root node periodically probes its UPLINK with a
  ``wire.CLOCK`` message carrying ``t1`` (the child's clock at send);
- the parent replies with ``t2``/``t3`` (its clock at receive/transmit,
  one read: the handler is synchronous) plus its OWN current offset to
  the root and that offset's uncertainty;
- the child stamps ``t4`` at the reply's arrival and forms one sample::

      theta = ((t2 - t1) + (t3 - t4)) / 2     # parent_clock - child_clock
      rtt   = (t4 - t1) - (t3 - t2)           # pure network round trip

Writing ``off_X`` for ``C_X - C_root``, ``theta = off_parent -
off_child``, so::

      off_child = off_parent - theta
      unc_child = unc_parent + rtt / 2

The root pins ``off = unc = 0`` and never probes; a parent answers with an
offset only once it knows its own, so convergence flows down the tree one
probe interval per level. Sample selection is min-RTT over a bounded
window (the shortest round trip has the least asymmetric queueing, hence
the tightest ``rtt/2`` bound). No clock is adjusted: the estimate only
corrects cross-node comparisons (staleness, trace timestamps).

CLOCK messages are control-plane traffic, which fault injection never
touches.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

#: Bounded sample window for min-RTT selection.
SAMPLE_WINDOW = 16


class ClockSync:
    """Per-node offset estimator; one instance per peer/shard node.

    Thread-safety: mutated only from the owner's receive/housekeeping
    thread (same discipline as the digest state), read by collectors —
    plain attribute reads of immutable tuples, no lock needed.
    """

    def __init__(self, now_ns, is_root: bool = False) -> None:
        self._now_ns = now_ns
        self._samples: deque = deque(maxlen=SAMPLE_WINDOW)
        self.probes = 0          # probes sent (root never probes)
        self.replies = 0         # usable replies folded in
        self._is_root = bool(is_root)
        # (offset_ns, uncertainty_ns) relative to the root, or None until
        # the first usable reply; the root is its own reference.
        self._est: Optional[tuple] = (0, 0) if is_root else None

    # -- state -----------------------------------------------------------

    @property
    def known(self) -> bool:
        return self._est is not None

    @property
    def offset_ns(self) -> int:
        return self._est[0] if self._est is not None else 0

    @property
    def uncertainty_ns(self) -> int:
        return self._est[1] if self._est is not None else 0

    @property
    def offset_seconds(self) -> float:
        return self.offset_ns / 1e9

    @property
    def uncertainty_seconds(self) -> float:
        return self.uncertainty_ns / 1e9

    # -- wire payloads (bounded JSON dicts, wire.encode_clock) -----------

    def probe_payload(self) -> dict:
        """Child -> parent probe."""
        self.probes += 1
        return {"op": "probe", "t1": int(self._now_ns())}

    def reply_payload(self, probe: dict) -> dict:
        """Parent's synchronous answer to a child's probe. ``t2 == t3``
        because the handler turns the reply around inline — the serve
        time is already inside the child's measured RTT either way."""
        now = int(self._now_ns())
        out = {
            "op": "reply",
            "t1": int(probe.get("t1", 0)),
            "t2": now,
            "t3": now,
        }
        if self._est is not None:
            out["off_ns"] = int(self._est[0])
            out["unc_ns"] = int(self._est[1])
        return out

    def on_reply(self, reply: dict) -> bool:
        """Fold a parent reply into the estimate; returns True if the
        sample was usable (parent knew its own offset)."""
        if self._is_root or "off_ns" not in reply:
            return False  # parent not yet converged: skip, try again
        t4 = int(self._now_ns())
        t1 = int(reply.get("t1", 0))
        t2 = int(reply.get("t2", 0))
        t3 = int(reply.get("t3", 0))
        rtt = (t4 - t1) - (t3 - t2)
        if rtt < 0:
            return False  # nonsensical (reordered stamps): drop
        theta = ((t2 - t1) + (t3 - t4)) // 2
        self._samples.append(
            (rtt, theta, int(reply["off_ns"]), int(reply.get("unc_ns", 0)))
        )
        rtt, theta, p_off, p_unc = min(self._samples)
        self._est = (p_off - theta, p_unc + rtt // 2)
        self.replies += 1
        return True
