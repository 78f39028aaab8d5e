"""The event model and the drain of the native event ring.

The counterpart of ``shared_tensor_tpu/obs/events.py``. The port's own
builds of ``native/sttransport.cpp`` and ``native/stengine.cpp`` record
protocol events into lock-free per-thread rings of 32-byte timestamped
records; this module drains them over the ``st_obs_drain`` ABI and decodes
them into the same :class:`Event` the Python tiers emit directly: one
timeline spanning both tiers.

Common clock: the native ring stamps CLOCK_MONOTONIC nanoseconds and
``time.monotonic_ns()`` reads the same clock on Linux, so native and
Python timestamps merge by a plain sort (``st_obs_now_ns`` is bound so
tests can show the clocks agree).

The event codes are ABI: they mirror the ``kEv*`` constants of
``native/sttransport.cpp`` and ``native/stengine.cpp``. A failure to load
the transport library or to drain its ring raises; nothing turns the
ring off quietly.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

#: Native event record: u64 t_ns, u32 node_id, u32 code, i32 link,
#: u32 reserved, u64 arg — 32 bytes, matching sttransport.cpp's EventRec.
_EVENT_FMT = "<QIIiIQ"
EVENT_BYTES = struct.calcsize(_EVENT_FMT)
assert EVENT_BYTES == 32

#: code -> name. 1..4 are the transport's membership event kinds (same
#: numbers as transport.EventKind); 10..15 protocol/recovery events;
#: 20..26 fault-injection hits (mirroring comm/faults.py's classes).
CODE_NAMES: dict[int, str] = {
    1: "link_up",
    2: "link_down",
    3: "became_master",
    4: "isolated",
    10: "retransmit",
    11: "blackhole_teardown",
    12: "quarantine",
    13: "send_window_stall",
    14: "dedup_discard",
    15: "seal",
    20: "fault_drop",
    21: "fault_dup",
    22: "fault_corrupt",
    23: "fault_truncate",
    24: "fault_delay",
    25: "fault_stall",
    26: "fault_sever",
    27: "crash_point",
    # 30+: cross-hop trace propagation. One trace_apply per accepted
    # traced DATA/BURST message: node/link say who applied it, ``arg``
    # carries the update generation (origin monotonic ns) and ``extra``
    # packs (origin_node << 8 | hop) — obs/trace_export.py reconstructs
    # full causal paths from these records.
    30: "trace_apply",
    # 31: subscriber link attached in the native engine (unledgered,
    # possibly range-filtered; arg = subscribed word count). The python
    # tier emits the same name — plus "sub_resync" — directly.
    31: "sub_attach",
    # 32: adaptive-precision governor flipped a link's wire precision
    # (arg = the new precision, 1 or 2). 33: one stripe socket of a
    # striped link died (arg = stripe index) and the link degraded to the
    # survivors — the LAST stripe's death shows up as link_down instead.
    32: "precision_shift",
    33: "stripe_down",
    # 34/35: same-host shm lane. shm_lane_up fires once per link when
    # its data plane switches onto the shared-memory rings (arg = ring
    # bytes per direction); shm_fallback records a negotiated attach that
    # failed validation — the link stays on TCP (arg = reason: 1 segment
    # open failed, 2 map/size failed, 3 header/token mismatch).
    34: "shm_lane_up",
    35: "shm_fallback",
    # 36/37: engine-tier shard plane. shard_park_drop is the native
    # twin of the python tier's event of the same name (a parked FWD
    # dropped at the ShardConfig.park_cap bound — loud bounded loss);
    # shard_dedup_discard records an end-to-end (origin, fwd_seq)
    # duplicate discarded at an engine-lane owner (arg = the fwd_seq) —
    # distinct from code 14's per-link dup/gap discards.
    36: "shard_park_drop",
    37: "shard_dedup_discard",
}
NAME_CODES = {v: k for k, v in CODE_NAMES.items()}

#: cluster lifecycle events — PYTHON-tier only (the barrier protocol
#: lives in comm/peer.py; the native engine's part is just the pause flag,
#: which emits nothing). No native codes, so these are names rather than
#: ABI numbers: snap_begin (entered a barrier; arg = children awaited,
#: detail = op), snap_shard (shard captured; arg = link count), snap_done
#: (root finished; arg = shard count), lifecycle_pause/lifecycle_resume
#: (quiesce edges), drain_begin (routed drain accepted), ctl_cmd (operator
#: command received; detail = op).
LIFECYCLE_EVENT_NAMES = frozenset(
    {
        "snap_begin",
        "snap_shard",
        "snap_done",
        "lifecycle_pause",
        "lifecycle_resume",
        "drain_begin",
        "ctl_cmd",
    }
)

#: fleet-health events (python tier only — the analyzer runs at the
#: root, never in the C hot path, so these are names rather than ABI
#: numbers; tools/lint_events.py pins the set). slo_alert_fire /
#: slo_alert_clear carry the severity index in arg and the burn-rate
#: numbers in detail; hot_shard carries the named shard id in arg.
HEALTH_EVENT_NAMES = frozenset(
    {
        "slo_alert_fire",
        "slo_alert_clear",
        "hot_shard",
    }
)

#: elastic-resharding events (python tier, name-only — reserved by
#: the protospec reshard models BEFORE the implementation lands, so the
#: implementation emits against conformance acceptors that already
#: exist; tools/lint_events.py pins the set). *_begin/*_done bracket one
#: staged transfer on the owning node (arg = shard / epoch);
#: reshard_grant carries the minted epoch in arg with node = the minter
#: (tools/protospec/spec_reshard.py's MasterAuthorityAcceptor checks the
#: epochs mint monotonically and only from the current authority).
RESHARD_EVENT_NAMES = frozenset(
    {
        "reshard_split_begin",
        "reshard_split_done",
        "reshard_merge_begin",
        "reshard_merge_done",
        "reshard_master_begin",
        "reshard_master_done",
        "reshard_grant",
    }
)

#: Names the flight recorder treats as fault-injection hits (timeline
#: accounting in the chaos soak keys on these).
FAULT_EVENT_NAMES = frozenset(
    n for c, n in CODE_NAMES.items() if 20 <= c <= 26
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One timeline entry. ``tier`` is "c" (drained from the native ring)
    or "py" (emitted by the Python tier); ``node`` is the transport node's
    process-unique obs id (0 = not node-scoped); ``arg`` is the event's
    numeric payload (is_uplink for membership, message count for
    retransmit, wire seq for dedup_discard, origin ns for trace_apply,
    ...); ``extra`` is the record's fourth word (u32 on the native ABI —
    packs origin<<8|hop there for trace_apply)."""

    t_ns: int
    tier: str
    name: str
    node: int = 0
    link: int = 0
    arg: int = 0
    detail: str = ""
    extra: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if not d["detail"]:
            del d["detail"]
        if not d["extra"]:
            del d["extra"]
        return d


def py_event(
    name: str, node: int = 0, link: int = 0, arg: int = 0, detail: str = "",
    extra: int = 0,
) -> Event:
    return Event(time.monotonic_ns(), "py", name, node, link, arg, detail, extra)


def _lib():
    """The port's transport library, which owns the process-wide ring;
    built and loaded at the first call, so importing obs builds nothing.
    A failed build raises."""
    from ..comm import transport

    return transport._load()


def drain_native(cap_events: int = 8192, lib=None) -> list[Event]:
    """Drain up to ``cap_events`` native events (all threads' rings).
    Leftovers stay in the rings for the next drain."""
    import ctypes

    lib = lib if lib is not None else _lib()

    buf = bytearray(cap_events * EVENT_BYTES)
    n = lib.st_obs_drain(
        (ctypes.c_char * len(buf)).from_buffer(buf), len(buf)
    )
    out: list[Event] = []
    for off in range(0, int(n), EVENT_BYTES):
        t_ns, node, code, link, res, arg = struct.unpack_from(
            _EVENT_FMT, buf, off
        )
        out.append(
            Event(
                t_ns,
                "c",
                CODE_NAMES.get(code, f"code_{code}"),
                node,
                link,
                arg,
                extra=res,
            )
        )
    return out


def native_now_ns(lib=None) -> int:
    """The native ring's clock, for clock-agreement checks."""
    lib = lib if lib is not None else _lib()
    return int(lib.st_obs_now_ns())


def native_dropped(lib=None) -> int:
    """Events lost to ring overflow since process start (a timeline with
    drops says so)."""
    lib = lib if lib is not None else _lib()
    return int(lib.st_obs_dropped())
