"""Deterministic fault injection at the wire boundary, on every tier.

The counterpart of ``shared_tensor_tpu/comm/faults.py``: the same plan
makes the same decisions over the same traffic, and :func:`to_env` renders
the same strings, so a JAX peer and a port peer under one ``FaultConfig``
face the same chaos.

- :class:`FaultPlan` wraps a frozen :class:`~shared_tensor_tpu_torch.config.FaultConfig`
  with a seeded RNG and per-link message counters. The peer consults it at
  its data send boundary (``peer._send_data``) and at named protocol points
  (``peer._fault_point``). Every decision is a function of (seed, the
  per-link sequence of data messages).
- :func:`to_env` renders the config into the ``ST_FAULT_PLAN`` /
  ``ST_FAULT_CRASH`` strings that the native transport parses in
  ``st_node_create`` (``native/sttransport.cpp``, the port's own build),
  so the native engine's data plane faces the same fault classes. Set
  them around one node's creation and only that node is chaotic.

Fault classes and the recovery path each drives:

==================  =======================================================
fault               recovery path
==================  =======================================================
drop / stall        the unacknowledged ledger grows; go-back-N re-sends the
                    tail byte for byte, or a dead link rolls it into the
                    re-graft carry; on a subscriber link, a seq gap and a
                    resync
duplicate           the receiver's seq check discards the echo
truncate            the receiver's decode rejects it without consuming its
                    seq; the re-send delivers it whole
corrupt             one sign bit flipped: one element off by 2*scale
delay               reordering pressure on drain and the ACK timer
sever               LINK_DOWN, rollback, carry, re-graft
crash points        process death at mid-join-walk, mid-burst (ledgered,
                    unsent) and between-apply-and-ack
==================  =======================================================

Frames only: the plan never sees handshake (SYNC, CHUNK, DONE, WELCOME,
REJECT), ACK or FRESH traffic, so injected chaos exercises recovery and
never wedges a join that the protocol has no retry for.

The JAX plan also emits each fault onto its observability timeline; the
port has no such plane yet, so this one only counts (``counts``).
"""

from __future__ import annotations

import logging
import os
import random
import threading
from collections import Counter
from typing import Callable, Optional

from ..config import FaultConfig

log = logging.getLogger("shared_tensor_tpu_torch.faults")

#: Exit status of a crash point (the native tier's ``_exit(17)`` too), so a
#: harness tells an injected kill from a real one.
CRASH_EXIT_CODE = 17

#: The named protocol points a plan may kill a peer at.
CRASH_POINTS = ("mid-join-walk", "mid-burst", "between-apply-and-ack")

# first bytes of the data messages corrupt() knows the framing of
_DATA, _BURST, _RDATA = 0, 7, 11


class FaultPlan:
    """One peer's fault state: the config, a seeded RNG, per-link counters
    and ``counts``, the tally of every injected event (a chaos run's bound
    scales with what was injected, not with what was asked for).
    Thread-safe: the send and receive threads both consult it.

    ``scale_bytes`` (4 * leaves) and ``trace_bytes`` (13 on a v2 sender)
    give :func:`corrupt` the frame geometry, so its flips land in sign
    words. ``wire_compat`` skips truncation and duplication, which the
    reference's fixed-size framing cannot recover from (it has no seq and
    no re-send). ``FaultConfig.only_stripe`` aims the native transport's
    faults at one socket of a striped link; this plan, at the Python send
    boundary, sees whole messages and ignores it."""

    def __init__(
        self,
        config: FaultConfig,
        on_crash: Optional[Callable[[str], None]] = None,
        scale_bytes: int = 0,
        wire_compat: bool = False,
        trace_bytes: int = 0,
    ):
        if config.crash_point and config.crash_point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {config.crash_point!r} (valid: {CRASH_POINTS})")
        self.cfg = config
        self.scale_bytes = scale_bytes
        self.trace_bytes = trace_bytes
        self.wire_compat = wire_compat
        self._rng = random.Random(config.seed)
        self._sent: dict[int, int] = {}  # link -> data messages seen
        self._point_hits: dict[str, int] = {}
        self._mu = threading.Lock()
        self._on_crash = on_crash
        self.counts: Counter = Counter()

    @property
    def active(self) -> bool:
        return self.cfg.enabled

    def on_send(self, link: int, payload: bytes) -> tuple[list[bytes], float, bool]:
        """One outgoing data message's fate: ``(payloads, delay_sec,
        sever)``. The caller sleeps ``delay_sec``, sends each payload in
        order (none: the message vanished on the wire; two: duplicated) and
        tears the link down after when ``sever`` is set."""
        cfg = self.cfg
        if not cfg.enabled:
            return [payload], 0.0, False
        if cfg.only_link > 0 and link != cfg.only_link:
            return [payload], 0.0, False
        with self._mu:
            n = self._sent[link] = self._sent.get(link, 0) + 1
            r = self._rng
            if cfg.sever_after_frames > 0 and n >= cfg.sever_after_frames:
                self.counts["severed"] += 1
                return [], 0.0, True
            if cfg.stall_after_frames >= 0 and n > cfg.stall_after_frames:
                self.counts["stalled"] += 1
                return [], 0.0, False
            delay = 0.0
            if cfg.delay_pct > 0 and r.random() < cfg.delay_pct:
                self.counts["delayed"] += 1
                delay = cfg.delay_sec
            if cfg.drop_pct > 0 and r.random() < cfg.drop_pct:
                self.counts["dropped"] += 1
                return [], delay, False
            out = payload
            if cfg.corrupt_pct > 0 and len(payload) > 1 and r.random() < cfg.corrupt_pct:
                self.counts["corrupted"] += 1
                out = corrupt(out, r, self.scale_bytes, self.trace_bytes)
            if cfg.truncate_pct > 0 and not self.wire_compat and len(out) > 2 and r.random() < cfg.truncate_pct:
                self.counts["truncated"] += 1
                out = out[: r.randrange(1, len(out))]
            if cfg.dup_pct > 0 and not self.wire_compat and r.random() < cfg.dup_pct:
                self.counts["duplicated"] += 1
                return [out, out], delay, False
            return [out], delay, False

    def point(self, name: str) -> None:
        """A named protocol point was reached: kill the process here when
        the plan says so (``os._exit``, so that nothing below the point
        runs, as under SIGKILL), or call ``on_crash`` instead when given."""
        cfg = self.cfg
        if not cfg.enabled or cfg.crash_point != name:
            return
        with self._mu:
            hits = self._point_hits[name] = self._point_hits.get(name, 0) + 1
            if hits < max(1, cfg.crash_after):
                return
            self.counts["crashed"] += 1
        if self._on_crash is not None:
            self._on_crash(name)
            return
        log.warning("fault plan killing the process at protocol point %r", name)
        os._exit(CRASH_EXIT_CODE)


def corrupt(payload: bytes, rng: random.Random, scale_bytes: int = 0, trace_bytes: int = 0) -> bytes:
    """Flip one random bit in the packed sign words of one frame: past the
    kind byte, the seq (and RDATA's range), the trace and every scale
    prefix, so one element is mis-applied by 2*scale, a bounded fault (a
    flipped scale exponent would rescale a whole frame by up to 2^127).
    A BURST's words spans come from its own framing; with the geometry
    unknown (``scale_bytes`` 0) the flip lands in the last 3/4 of the
    message."""
    b = bytearray(payload)
    lo, hi = 0, 0
    data_hdr = 5 + trace_bytes  # [kind][u32 seq][trace?]
    burst_hdr = 6 + trace_bytes  # [kind][u32 seq][u8 k][trace?]
    rdata_hdr = 13 + trace_bytes  # [kind][u32 seq][u32 lo][u32 cnt][trace?]
    if scale_bytes > 0 and b[0] == _DATA and len(b) > data_hdr + scale_bytes:
        lo, hi = data_hdr + scale_bytes, len(b)
    elif scale_bytes > 0 and b[0] == _RDATA and len(b) > rdata_hdr + scale_bytes:
        lo, hi = rdata_hdr + scale_bytes, len(b)
    elif scale_bytes > 0 and b[0] == _BURST and len(b) > burst_hdr:
        k = b[5]
        per = (len(b) - burst_hdr) // k if k else 0
        if k and per > scale_bytes and burst_hdr + k * per == len(b):
            f = rng.randrange(k)  # one frame's words span
            lo = burst_hdr + f * per + scale_bytes
            hi = burst_hdr + (f + 1) * per
    if not lo:
        lo, hi = max(1, len(b) // 4), len(b)
    i = rng.randrange(lo, hi)
    b[i] ^= 1 << rng.randrange(8)
    return bytes(b)


def to_env(cfg: FaultConfig) -> dict[str, str]:
    """The native tier's environment strings for ``cfg``: ``ST_FAULT_PLAN``
    (per-link wire faults, parsed by ``st_node_create``: set it around one
    node's creation to make only that node chaotic) and ``ST_FAULT_CRASH``
    (a process-wide crash point, parsed once per process by each build of
    the library). Knobs at their defaults are left out; a disabled config
    renders to {}. The native injector's corruption is geometry-blind (it
    may hit seq and scale bytes): survival chaos, not bounded chaos."""
    if not cfg.enabled:
        return {}
    parts = [f"seed={cfg.seed}"]
    if cfg.drop_pct > 0:
        parts.append(f"drop={cfg.drop_pct}")
    if cfg.dup_pct > 0:
        parts.append(f"dup={cfg.dup_pct}")
    if cfg.truncate_pct > 0:
        parts.append(f"trunc={cfg.truncate_pct}")
    if cfg.corrupt_pct > 0:
        parts.append(f"corrupt={cfg.corrupt_pct}")
    if cfg.delay_pct > 0:
        parts.append(f"delay_pct={cfg.delay_pct}")
        parts.append(f"delay_ms={cfg.delay_sec * 1000.0}")
    if cfg.stall_after_frames >= 0:
        parts.append(f"stall_after={cfg.stall_after_frames}")
    if cfg.sever_after_frames > 0:
        parts.append(f"sever_after={cfg.sever_after_frames}")
    if cfg.only_link > 0:
        parts.append(f"only_link={cfg.only_link}")
    if cfg.only_stripe >= 0:
        parts.append(f"only_stripe={cfg.only_stripe}")
    env = {"ST_FAULT_PLAN": ",".join(parts)}
    if cfg.crash_point:
        env["ST_FAULT_CRASH"] = f"{cfg.crash_point}:{max(1, cfg.crash_after)}"
    return env
