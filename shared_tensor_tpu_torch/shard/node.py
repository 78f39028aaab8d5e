"""ShardNode: one member of a cluster-sharded tensor.

The counterpart of ``shared_tensor_tpu/shard/node.py``: the same messages,
the same bytes and the same shard-state files, so port and JAX nodes sit
in one sharded cluster in any role (master, owner, relay, writer with no
shard) on either FWD plane.

The core invariant changes here, from "every node converges on the whole
table" (the flood) to "every word has exactly one owner and the cluster
converges on the union of the owned slices". A ShardNode joins the same
transport tree as every other tier, but:

- it holds ONLY its owned shard slices (plus transient outboxes and
  subscriber residuals: :class:`~shared_tensor_tpu_torch.shard.state.
  ShardState` carries the memory contract, O(total / n_shards) per node,
  never the full table);
- a local ``add()`` applies its IN-shard part exactly (local applies never
  quantize) and accumulates the out-of-shard parts into per-target-shard
  outbox residuals, drained as :data:`wire.FWD` frames routed hop by hop
  toward each shard's owner; a relay forwards the frame VERBATIM
  (re-stamping only the per-link seq), so owner-routed forwarding never
  re-quantizes;
- delivery is the peer tier's discipline per hop (per-link tx_seq,
  cumulative wire.ACK, byte-identical go-back-N retransmission, black-hole
  teardown into re-route) plus END-TO-END dedup at the owner on the
  frame's (origin, fwd_seq) identity: a re-routed resend of a
  delivered-but-unacked frame is discarded instead of applied twice;
- readers never land here: full and partial views ride the serving
  tier's subscriptions against each owner
  (:mod:`shared_tensor_tpu_torch.shard.gather`), and a ShardNode serves
  ranged read-only subscribers within its owned shards as a classic
  writer does.

Membership and the shard map
----------------------------

The master (the node that created the rendezvous) partitions the word
space into ``ShardConfig.n_shards`` contiguous ranges and is the ONLY
minter of ownership grants. A joiner advertises the capability in its
SYNC flags (``compat.SYNC_FLAG_SHARD`` and a 2-byte shard-index claim
tail); a sharded parent answers WELCOME with the same flag and the
current map as a wire.SHARD control message, after which the joiner's
claim rides ``{"t": "claim"}`` up the tree to the master, the grant
floods back down, and the claimer adopts its slice. Tolerant in both
orientations: a sharded joiner under an unsharded parent (a port or JAX
classic peer) sees no shard flag in WELCOME and raises
:class:`ShardFallback` (``create_or_fetch_sharded`` then returns a
classic full-replica peer); a classic WRITER joining a sharded parent is
REJECTed with an explicit reason (no node here can seed a full replica).

Routing is reverse-path: an owner floods ``{"t": "own"}`` announces
(epoch-filtered, so stale floods cannot loop) and every node records the
arrival link as its next hop toward that shard; unknown routes default
to the uplink, and a frame with no route at all parks in a bounded
buffer (``ShardConfig.park_cap``: overflow drops the OLDEST parked frame
and counts it loudly, never unbounded memory).

Drain-handoff: a leaving owner drains its outboxes and ledgers, then
transfers each owned slice to its PARENT over the control plane
(``ho_meta`` / ``ho_state`` chunks / ``ho_dedup`` / ``ho_done`` /
``ho_ack``) with its END-TO-END dedup windows; without them, a
retransmission of a frame the old owner applied but never acknowledged
would apply twice at the successor. The successor merges the windows
before it adopts the slice, mints the next epoch, announces, and the
cluster's routes flip.

Host code on every tier, as JAX's is: numpy and the native lane, no
device state (``ShardHandle.torch_view`` copies a verified gather to the
card). One loop thread owns all protocol state except ShardState, which
has its own lock so that ``add()`` can run on the caller's thread.
"""

from __future__ import annotations

import base64
import logging
import os
import struct
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np

from .. import obs as _obs
from ..obs import schema as _schema
from ..obs.clock import ClockSync
from ..comm import wire
from ..comm.transport import EventKind, TransportNode
from ..compat import (
    SYNC_FLAG_RANGE,
    SYNC_FLAG_READ_ONLY,
    SYNC_FLAG_SHARD,
    wire_protocol_version,
)
from ..config import Config
from ..ops.codec_np import flatten_np
from ..ops.table import TableFrame, make_spec
from .engine_lane import ShardLane, load_shard_lib, shard_engine_eligible
from .map import OwnerEntry, ShardMap
from .state import ShardState, SliceCodec

log = logging.getLogger("shared_tensor_tpu_torch.shard")


class ShardBackpressure(RuntimeError):
    """add() refused: the per-target-shard outbox allocation would exceed
    ShardConfig.outbox_limit_bytes and the overflow policy is "raise"
    (or the "block" wait timed out). The writer is outrunning the FWD
    plane's drain — back off, or raise the limit."""


class _NullCounter:
    """Stands in for a Registry counter whose value the engine lane serves
    from the C counters ABI instead (the collector would lose to a
    registered instrument of the same name — obs/registry.py snapshot)."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

#: Go-back-N bounds, mirroring comm/peer.py's ledgered discipline: most
#: unacked FWD messages per link (backpressure: a full window leaves mass
#: in the outbox residual, where error feedback keeps it exact), and how
#: many head entries one retransmission round re-sends byte-identical.
SEND_WINDOW = 32
RETX_PREFIX = 4
#: Most FWD messages drained per outbox per loop pass (fairness across
#: shards; the loop comes right back while any outbox is non-idle). Each
#: message carries up to wire.FWD_BURST_FRAMES successive halvings.
OUTBOX_MSGS_PER_PASS = 4
#: End-to-end dedup window per origin: the owner remembers this many
#: recent (origin, fwd_seq) identities. Duplicates only arise inside the
#: re-route race window (a rollback-resend racing a delivered-but-unacked
#: original), which is far narrower than this; the bound keeps dedup
#: state O(origins), and the whole window transfers at handoff.
DEDUP_WINDOW = 1024
#: How often an owner re-floods its ``own`` route announces (heals routes
#: purged by link deaths; late joiners learn the reverse path).
ANNOUNCE_SEC = 2.0
#: Per-link transport send-queue depth this node runs with — MUST equal
#: the native default (sttransport.cpp ``int32_t queue_depth = 8``) and
#: TransportNode's python default; _queue_room's control-traffic headroom
#: math reads it, and a silent drift would either starve the FWD pump or
#: let it fill the very slots the cumulative ACKs need (JAX's tools/lint_abi.py
#: pins the three declarations together).
QUEUE_DEPTH = 8
#: ho_state chunk payload (base64 of f32 slices), sized well under the
#: DIGEST_MAX_BYTES control-message cap after JSON framing.
HO_CHUNK_ELEMS = 8192


def shard_enabled() -> bool:
    """ST_SHARD=0 force-disables the capability end to end (the A/B
    escape hatch, like ST_SHM/ST_SIGN2/ST_WIRE_TRACE)."""
    return os.environ.get("ST_SHARD", "1") != "0"


class ShardFallback(Exception):
    """The parent is not sharded (a classic peer, or n_shards=0): the caller must
    fall back to the classic full-replica protocol."""


class ShardRejected(ConnectionError):
    """The cluster refused this node (claim denied, layout mismatch)."""


class _Member:
    """One ledgered member link (uplink or sharded child): the per-hop
    go-back-N state for the FWD plane."""

    __slots__ = (
        "tx_seq", "rx_count", "unacked", "progress_t", "retx_rounds",
        "ack_due",
    )

    def __init__(self):
        self.tx_seq = 0
        self.rx_count = 0
        self.unacked: list[list] = []  # [seq, bytearray, enqueue_t]
        self.progress_t = time.monotonic()
        self.retx_rounds = 0
        self.ack_due = False


class _Sub:
    """One read-only subscriber link served from an owned shard."""

    __slots__ = ("wlo", "wcnt", "tx_seq", "last_fresh_t")

    def __init__(self, wlo: int, wcnt: int):
        self.wlo = wlo
        self.wcnt = wcnt
        self.tx_seq = 0
        self.last_fresh_t = 0.0


class ShardNode:
    """One sharded cluster member (see the module docstring). Construct
    via :func:`shared_tensor_tpu.shard.create_or_fetch_sharded`, which
    handles the classic-protocol fallback."""

    def __init__(
        self,
        host: str,
        port: int,
        template: Any,
        config: Config | None = None,
    ):
        self.config = config or Config()
        scfg = self.config.shard
        if scfg.n_shards <= 0:
            raise ValueError(
                "ShardNode needs ShardConfig.n_shards > 0 "
                "(use create_or_fetch_sharded for the n_shards=0 fallback)"
            )
        if self.config.transport.wire_compat:
            raise ValueError(
                "the sharded tensor needs the native protocol (the "
                "reference compat wire has no capability hello)"
            )
        self.spec = make_spec(template)
        #: the address this node's OwnerEntry advertises (gather legs and
        #: takeover peers dial it): the configured reachable address, or
        #: the rendezvous host when unset (single-host clusters)
        self._adv_host = scfg.advertise_host or host
        if self.spec.total // 32 < scfg.n_shards:
            raise ValueError(
                f"{self.spec.total // 32} words cannot split into "
                f"{scfg.n_shards} shards"
            )
        self.scfg = scfg
        self.state = ShardState(self.spec)
        #: the engine lane: when chosen, the FWD hot loop (outbox pump,
        #: verbatim relay, owner dedup+apply, go-back-N) runs in the
        #: native shard plane (shard/engine_lane.py); Python keeps the
        #: control plane. Created once the shard map exists (the plane's
        #: slice geometry is the map's fixed partition). ST_SHARD_ENGINE=0
        #: / ShardConfig.engine_lane=False pin the Python plane. The
        #: library loads here, before any socket opens: a build or load
        #: failure raises instead of falling back.
        self._lane_want = shard_engine_eligible(self.config)
        if self._lane_want:
            load_shard_lib()
        self._lane: Optional[ShardLane] = None
        self._lane_links: set[int] = set()
        #: lane-mode subscriber serving: link -> [SliceCodec of the
        #: subscribed range, conveyed values copy, owning shard]. The
        #: residual is (current slice - conveyed) computed on demand —
        #: error-feedback-equivalent without per-apply feeding, since the
        #: owned slice lives in C
        self._lane_subs: dict[int, list] = {}
        self._host = host
        self._wire_version = wire_protocol_version(self.config)
        self._codecs: dict[int, SliceCodec] = {}
        self.map: Optional[ShardMap] = None
        self._members: dict[int, _Member] = {}
        self._subs: dict[int, _Sub] = {}
        self._pending: dict[int, dict] = {}  # link -> handshake staging
        self._deferred_done: list[int] = []  # children awaiting our map
        self._route: dict[int, int] = {}  # shard -> next-hop link
        self._route_epoch: dict[int, int] = {}
        self._parked: deque = deque()  # (shard, bytearray)
        self._uplink: Optional[int] = None
        self._fwd_seq = 0
        #: origin -> (seen set, fifo of seen) — the end-to-end dedup window.
        #: Mutated by the loop thread (apply, handoff merge); _dedup_mu
        #: makes save_shards' caller-thread capture consistent — a torn
        #: window restores without a just-applied seq and double-applies.
        self._dedup: dict[int, tuple[set, deque]] = {}
        self._dedup_mu = threading.Lock()
        self._retx_total = 0
        self._claim_nonce = f"{os.getpid()}-{time.monotonic_ns()}"
        self._claim_sent_t = 0.0
        self._claim_first_t = 0.0
        self._granted = threading.Event()
        self._fallback = False
        self._error: Optional[Exception] = None
        self._leaving = False
        self._ho_stage: dict[int, dict] = {}  # shard -> incoming handoff
        self._ho_acked: set[int] = set()
        #: shards whose OUTGOING handoff state has shipped (ho_done sent,
        #: ho_ack pending): the slice snapshot already left, so applying
        #: a late FWD here would die with the released slice while the
        #: sender's ledger was ACK-debited — debited-mass conservation
        #: (JAX's spec_shard model's apply_during_handoff mutation) requires routing
        #: those frames onward instead
        self._ho_sent: set[int] = set()
        self._announce_last = 0.0
        self._digest_last = 0.0
        self._child_digests: dict[int, dict] = {}
        # fleet health plane: per-shard apply counts (the heat-rate
        # numerator — loop thread writes, collector reads; GIL-atomic dict
        # ops), the simulated-skew knob, and the clock-probe beat state.
        self._shard_applies: dict[int, int] = {}
        # writer-side heat twins: raw outbox deposits BEFORE residual
        # coalescing (user threads write under _dep_mu, collector reads) —
        # the post-coalesce st_shard_fwd_msgs_out_total rate saturates at
        # the drain rate, so this is the only honest write-pressure signal
        self._dep_mu = threading.Lock()
        self._shard_deposits: dict[int, int] = {}
        self._shard_deposit_bytes: dict[int, int] = {}
        skew_env = os.environ.get("ST_CLOCK_SKEW_SEC", "")
        self._skew_ns = int(
            float(skew_env if skew_env else self.config.obs.clock_skew_sim_sec)
            * 1e9
        )
        self._clock_interval = self.config.obs.clock_sync_interval_sec
        self._clock_last = 0.0
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._wake = threading.Event()
        self._handoff_wanted: Optional[list[int]] = None

        # restart-restore state, loaded BEFORE joining (slices adopt at
        # grant time). The load-bearing piece is the restored DEDUP
        # WINDOWS: still-alive origins' re-routed resends keep being
        # discarded across our restart. The restored fwd_seq is only
        # forward-compat: obs ids are pid-seeded, so a reborn node mints
        # a NEW origin id and its (origin, seq) identities can't collide
        # with the old ones regardless of the counter.
        self._restored: dict[int, tuple[int, int, np.ndarray]] = {}
        self._restore_outboxes: dict[int, tuple[int, np.ndarray]] = {}
        self._takeover = False
        if scfg.restore_dir:
            self._load_restore(scfg.restore_dir)
        #: the shards this node claims: its shard_index, then every other
        #: shard its restored file holds (a successor of a handoff owned
        #: more than one at the capture). JAX's node claims shard_index
        #: alone, and a restart after a handoff there leaves the moved
        #: shard unowned; the claims are the same messages either way.
        self._claims = ([scfg.shard_index] if scfg.shard_index >= 0 else []) + sorted(
            k for k in self._restored if k != scfg.shard_index
        )
        self._claim_pending = set(self._claims)

        self.node = TransportNode(
            host,
            port,
            self.config.transport,
            frame_bytes=wire.frame_wire_bytes(self.spec),
            queue_depth=QUEUE_DEPTH,
            max_children=scfg.max_children,
            keepalive_sec=min(
                1.0, max(0.05, self.config.transport.peer_timeout_sec / 4)
            ),
        )
        self.is_master = self.node.is_master
        self.obs_id = int(self.node.obs_id)
        # master = tree root = the clock reference (offset pinned
        # 0/0); the root with a health sink runs the analyzer per beat.
        self._clock = ClockSync(self._now_ns, is_root=self.is_master)
        self._health = None
        if self.is_master and self.config.obs.health_json_path:
            from ..obs.health import HealthAnalyzer

            ocfg = self.config.obs
            self._health = HealthAnalyzer(
                path=ocfg.health_json_path,
                history=ocfg.health_history,
                objective_sec=ocfg.staleness_slo_sec,
                budget=ocfg.slo_budget,
                windows=ocfg.slo_windows,
                skew_ratio=ocfg.heat_skew_ratio,
                emit=self._health_event,
            )

        self._obs_on = _obs.obs_enabled() and self.config.obs.enabled
        self._hub = _obs.hub() if self._obs_on else None
        self._reg = _obs.Registry()
        if self._lane_want:
            # engine lane: the FWD counters live in the C plane and reach
            # the registry through _collect (a registered instrument would
            # shadow the collector's value, obs/registry.py snapshot)
            self._m_fwd_out = _NullCounter()
            self._m_fwd_in = _NullCounter()
            self._m_relayed = _NullCounter()
            self._m_dedup = _NullCounter()
            self._m_park_drops = _NullCounter()
            self._m_updates = _NullCounter()
        else:
            self._register_py_counters()
        self._m_handoffs = self._reg.counter(
            "st_shard_handoffs_total",
            help="shard ownership handoffs completed (either side)",
        )
        self._reg.register_collector(self._collect)
        self._label = f"shard-{self.obs_id}"
        if self._hub is not None:
            self._hub.register_registry(self._label, self._reg)

        if self.is_master:
            words = self.spec.total // 32
            self.map = ShardMap(words, scfg.n_shards)
            try:
                self._ensure_lane()
            except BaseException:
                if self._hub is not None:
                    self._hub.unregister_registry(self._label)
                self.node.close()
                raise
            # shard_index=-1 is documented as "owns no shard" for the
            # master too: it minds the map and routes, holds no slice
            # (shard 0 stays claimable by a later joiner)
            for k in self._claims:
                entry = OwnerEntry(
                    1, self.obs_id, self._adv_host, self.node.listen_port
                )
                self.map.merge_entry(k, entry)
            self._restore_pending_outboxes()
            for k in self._claims:
                self._adopt(k)
            self._claim_pending.clear()
            self._ready.set()

        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="st-shard"
        )
        self._thread.start()

    # -- user API ------------------------------------------------------------

    def add(self, delta: Any) -> None:
        """Merge an additive update: the in-shard part applies exactly to
        the owned slices (and feeds subscriber residuals); every
        out-of-shard part accumulates into its target shard's outbox
        residual, to be drained as owner-routed FWD frames."""
        if self._leaving:
            raise RuntimeError("node is leaving (sealed)")
        m = self.map
        if m is None:
            raise RuntimeError("node not ready (no shard map yet)")
        flat = flatten_np(delta, self.spec)
        self._admit_add(flat)
        if self._lane is not None:
            # deposit twins ride a python-side scan (the native plane
            # coalesces inside add_flat); the owns() read is racy vs a
            # concurrent adopt, which can only misattribute one beat's
            # worth of deposits — fine for a gauge
            for k in range(m.n_shards):
                elo, ehi = m.element_range(k)
                seg = flat[elo:ehi]
                if np.any(seg) and not self._lane.owns(k):
                    self._track_deposit(k, seg.size * 4)
            # engine lane: ONE native call splits in-shard (exact apply)
            # from out-of-shard (outbox deposit) under the plane's mutex
            self._lane.add_flat(
                np.ascontiguousarray(flat, np.float32)
            )
            self._wake.set()
            return
        for k in range(m.n_shards):
            elo, ehi = m.element_range(k)
            seg = flat[elo:ehi]
            if not np.any(seg):
                continue
            # ONE lock acquisition decides owned-vs-outbox AND writes: a
            # separate owns() check here would race the loop thread's
            # adopt()/release() into a stranded outbox or a spurious raise
            if self.state.add_delta(k, lambda k=k: self._codec(k), elo, seg):
                self._track_deposit(k, seg.size * 4)
        self._m_updates.inc()
        self._wake.set()

    def read_owned(self) -> dict[int, tuple[int, int, np.ndarray]]:
        """{shard: (word_lo, word_cnt, values copy)} of the owned slices —
        a node's whole resident view. Full/partial cluster views ride
        :mod:`shared_tensor_tpu.shard.gather`."""
        if self._lane is not None:
            out = {}
            for s in self.owned_shards():
                vals = self._lane.read_shard(s)
                if vals is not None:
                    wlo, wcnt = self.map.word_range(s)
                    out[s] = (wlo, wcnt, vals)
            return out
        return self.state.snapshot_owned()

    def owned_shards(self) -> list[int]:
        if self._lane is not None:
            return [
                s
                for s in range(self.map.n_shards if self.map else 0)
                if self._lane.owns(s)
            ]
        with self.state._lock:
            return sorted(self.state.owned)

    def owned_words(self) -> int:
        """Words of the table this node currently owns (lane-blind)."""
        if self._lane is not None:
            return self._lane.owned_words()
        return self.state.owned_words()

    def map_doc(self) -> dict:
        """The node's current shard-map document (geometry + owners)."""
        m = self.map
        if m is None:
            raise RuntimeError("no shard map yet")
        return m.as_doc()

    def wait_ready(self, timeout: float = 30.0) -> None:
        # the caller's explicit timeout governs this wait; ShardConfig.
        # claim_timeout_sec bounds the claim round trip itself (in
        # _maybe_claim), so a larger timeout here is never silently capped
        if not self._ready.wait(timeout):
            raise TimeoutError(
                f"shard claim/handshake incomplete after {timeout}s"
            )
        if self._fallback:
            raise ShardFallback(
                "parent is not sharded — fall back to the classic protocol"
            )
        if self._error is not None:
            raise self._error

    def drained(self, tol: float = 0.0) -> bool:
        """True when every outbox residual is idle AND every ledger is
        empty AND nothing is parked — this node owes the cluster nothing."""
        if self._lane is not None:
            return self._lane.idle(tol)
        if not self.state.outboxes_idle(tol):
            return False
        if self._parked:
            return False
        # list() snapshots: the loop thread adds/pops members (welcome,
        # link-down teardown) while this caller-thread poll iterates
        return all(not m.unacked for m in list(self._members.values()))

    def drain(self, timeout: float = 60.0, tol: float = 0.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.drained(tol):
                return True
            self._wake.set()
            time.sleep(0.02)
        return False

    def alloc_bytes(self) -> int:
        """Resident f32 state bytes (the chaos harness's per-node bound)."""
        if self._lane is not None:
            # C-resident slices/outboxes + the python-side conveyed
            # copies backing lane-mode subscriber serving
            extra = sum(
                ent[1].nbytes for ent in list(self._lane_subs.values())
            )
            return self._lane.alloc_bytes() + extra
        return self.state.alloc_bytes()

    def metrics(self) -> dict:
        return self._reg.snapshot()

    def leave(self, timeout: float = 60.0) -> bool:
        """Graceful departure: seal local adds, drain everything owed,
        hand every owned shard to the parent (ownership + slice + dedup
        state), then close. Returns False if any phase timed out (the
        node still closes; un-handed shards need a takeover restore).
        The master cannot leave a cluster that still has members —
        there is no map-authority handoff (documented limitation)."""
        self._leaving = True
        ok = self.drain(timeout=timeout * 0.5)
        shards = self.owned_shards()
        if shards and self._uplink is not None:
            self._ho_acked.clear()
            self._wake.set()
            deadline = time.monotonic() + timeout * 0.5
            # the loop thread runs the handoff (serialized with every
            # other protocol action); we just wait for the acks
            self._handoff_wanted = list(shards)
            while time.monotonic() < deadline:
                if all(s in self._ho_acked for s in shards):
                    break
                self._wake.set()
                time.sleep(0.02)
            ok = ok and all(s in self._ho_acked for s in shards)
            # frames that arrived mid-handoff were relayed/unparked onto
            # the uplink ledger — they are mass we still OWE the
            # successor; closing before their ACKs drops them
            ok = ok and self.drain(
                timeout=max(1.0, deadline - time.monotonic())
            )
        elif shards:
            ok = False  # nowhere to hand off (master / orphan)
        self.close()
        return ok

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)
        if self._hub is not None:
            self._hub.unregister_registry(self._label)
        if self._lane is not None:
            # the plane's threads block inside the node's queues/condvars:
            # stop+destroy strictly BEFORE TransportNode.close (the
            # engine/peer.py teardown ordering)
            self._lane.destroy()
        self.node.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- checkpoint ----------------------------------------------------------

    def save_shards(self, dirpath: str) -> Optional[dict]:
        """Write this node's sharded checkpoint (owned slices + outbox
        residuals + dedup windows + fwd_seq) and return its manifest
        entry, or None when the node owns nothing and owes nothing.
        Quiesce first (``drain()``) for an exact capture."""
        from ..utils import checkpoint as ckpt

        if self._lane is not None:
            # the plane captures slices + outboxes + windows under its
            # ONE mutex (st_shard_snapshot) — same no-torn-pair contract
            lowned, loutboxes, ldedup = self._lane.snapshot()
            owned = {}
            for s, vals in lowned.items():
                wlo, wcnt = self.map.word_range(s)
                owned[s] = (wlo, wcnt, vals)
            outboxes = {
                s: (self.map.word_range(s)[0], r)
                for s, r in loutboxes.items()
            }
            dedup = {str(o): sorted(seqs) for o, seqs in ldedup.items()}
            fwd_seq = self._lane.fwd_seq()
        else:
            with self._dedup_mu:
                # one mutex covers slices AND windows (_apply_fwd commits
                # both under it), so even a live capture can't persist a
                # window seq whose mass missed the slice
                owned = self.state.snapshot_owned()
                outboxes = self.state.snapshot_outboxes()
                dedup = {
                    str(origin): sorted(seen)
                    for origin, (seen, _fifo) in self._dedup.items()
                }
            fwd_seq = self._fwd_seq
        if not owned and not outboxes:
            return None
        return ckpt.save_shard_state(
            dirpath,
            self.node_name,
            self.spec.layout_digest(),
            owned,
            outboxes,
            dedup,
            fwd_seq,
        )

    @property
    def node_name(self) -> str:
        name = self.config.lifecycle.node_name
        return name if name else f"node-{self.obs_id}"

    def _load_restore(self, dirpath: str) -> None:
        from ..utils import checkpoint as ckpt

        name = self.config.lifecycle.node_name
        if not name:
            raise ValueError(
                "restore_dir needs a stable LifecycleConfig.node_name "
                "(obs ids are not stable across restarts)"
            )
        path = os.path.join(dirpath, ckpt.shard_filename(name))
        doc = ckpt.load_shard_state(path)
        if doc["layout"] != self.spec.layout_digest():
            raise ValueError(
                "sharded checkpoint layout does not match this table"
            )
        self._restored = dict(doc["owned"])
        self._restore_outboxes = dict(doc["outboxes"])
        for origin, seqs in doc["dedup"].items():
            fifo = deque(seqs)
            self._dedup[int(origin)] = (set(seqs), fifo)
        self._fwd_seq = int(doc["fwd_seq"])
        self._takeover = True

    # -- observability -------------------------------------------------------

    def _track_deposit(self, shard: int, nbytes: int) -> None:
        with self._dep_mu:
            self._shard_deposits[shard] = (
                self._shard_deposits.get(shard, 0) + 1
            )
            self._shard_deposit_bytes[shard] = (
                self._shard_deposit_bytes.get(shard, 0) + nbytes
            )

    def _collect(self) -> dict:
        if self._lane is not None:
            c = self._lane.counters()
            out = {
                "st_shard_owned_words": self._lane.owned_words(),
                "st_shard_alloc_bytes": self.alloc_bytes(),
                "st_shard_routes": len(self._route),
                "st_shard_parked_msgs": int(c[5]),
                # engine-tier counter twins, served off the C plane's
                # counters ABI under the SAME canonical names the python
                # tier registers — obs.top's shard column and the chaos
                # harness's tallies stay lane-blind
                "st_shard_fwd_msgs_out_total": int(c[0]),
                "st_shard_fwd_msgs_in_total": int(c[1]),
                "st_shard_fwd_relayed_total": int(c[2]),
                "st_shard_fwd_dedup_total": int(c[3]),
                "st_shard_park_drops_total": int(c[4]),
                "st_shard_fwd_frames_in_total": int(c[9]),
                "st_shard_fwd_retx_total": int(c[6]),
                "st_updates_total": int(c[7]),
                "st_shard_outbox_bytes": self._lane.outbox_bytes(),
            }
            # heat numerator, lane mode: the counters ABI keeps one
            # apply total; the lane attributes it across the owned shards
            # (exact in the one-owned-shard topology)
            for s, n in self._lane.heat_applies_by_shard(
                int(c[1]), self.owned_shards()
            ).items():
                out[_schema.shard_key("st_shard_heat_applies", s)] = n
        else:
            out = {
                "st_shard_owned_words": self.state.owned_words(),
                "st_shard_alloc_bytes": self.state.alloc_bytes(),
                "st_shard_routes": len(self._route),
                "st_shard_parked_msgs": len(self._parked),
                "st_shard_fwd_frames_in_total": self.state.applies,
                "st_shard_fwd_retx_total": self._retx_total,
                "st_shard_outbox_bytes": self.state.outbox_bytes(),
            }
            # heat numerators, python tier: exact per-shard apply
            # counts (tracked in _apply_fwd) and the live nonzero outbox
            # backlog destined to each non-owned shard
            for s, n in list(self._shard_applies.items()):
                out[_schema.shard_key("st_shard_heat_applies", s)] = n
            for s, b in self.state.outbox_backlog_by_shard().items():
                out[_schema.shard_key("st_shard_heat_outbox_bytes", s)] = b
        # pre-coalesce deposit twins (lane-blind, writer-side): the
        # raw deposit rate vs the st_shard_fwd_msgs_out_total drain rate
        # is the coalescing ratio — a saturated writer shows deposits
        # racing ahead while msgs_out flatlines at the drain ceiling
        with self._dep_mu:
            deposits = dict(self._shard_deposits)
            deposit_bytes = dict(self._shard_deposit_bytes)
        for s, n in deposits.items():
            out[_schema.shard_key("st_shard_heat_deposit_msgs", s)] = n
        for s, b in deposit_bytes.items():
            out[_schema.shard_key("st_shard_heat_deposit_bytes", s)] = b
        out["st_shard_outbox_limit_bytes"] = self.scfg.outbox_limit_bytes
        if self._clock.known:
            out["st_clock_offset_seconds"] = self._clock.offset_seconds
            out["st_clock_uncertainty_seconds"] = (
                self._clock.uncertainty_seconds
            )
        out["st_clock_probes_total"] = self._clock.probes
        if self._health is not None:
            out.update(self._health.metrics())
        return out

    def _event(self, name: str, link: int = 0, arg: int = 0) -> None:
        if self._hub is not None:
            self._hub.emit(name, node=self.obs_id, link=link, arg=arg)

    def _now_ns(self) -> int:
        """Monotonic ns plus the simulated clock skew (the comm/peer.py
        twin): every cross-node-comparable stamp routes through here."""
        return time.monotonic_ns() + self._skew_ns

    def _health_event(self, name: str, arg: int, detail: str) -> None:
        if self._hub is not None:
            self._hub.emit(name, node=self.obs_id, arg=arg, detail=detail)

    # -- codec / slices ------------------------------------------------------

    def _codec(self, shard: int) -> SliceCodec:
        c = self._codecs.get(shard)
        if c is None:
            wlo, wcnt = self.map.word_range(shard)
            c = self._codecs[shard] = SliceCodec(self.spec, wlo, wcnt)
        return c

    def _owns(self, shard: int) -> bool:
        """Lane-blind ownership check (control-plane call sites)."""
        if self._lane is not None:
            return self._lane.owns(shard)
        return self.state.owns(shard)

    # -- engine lane -----------------------------------------------------

    def _register_py_counters(self) -> None:
        """The Python plane's registry instruments, created at init when
        the configuration pins the Python plane."""
        self._m_fwd_out = self._reg.counter(
            "st_shard_fwd_msgs_out_total",
            help="FWD frames this node originated onto the wire",
        )
        self._m_fwd_in = self._reg.counter(
            "st_shard_fwd_msgs_in_total",
            help="FWD frames applied to an owned shard",
        )
        self._m_relayed = self._reg.counter(
            "st_shard_fwd_relayed_total",
            help="FWD frames forwarded verbatim toward their owner",
        )
        self._m_dedup = self._reg.counter(
            "st_shard_fwd_dedup_total",
            help="FWD frames discarded by the owner's (origin, fwd_seq) dedup",
        )
        self._m_park_drops = self._reg.counter(
            "st_shard_park_drops_total",
            help="parked FWD frames dropped at the park-buffer cap",
        )
        self._m_updates = self._reg.counter(
            "st_updates_total", help="local add() calls merged"
        )

    def _ensure_lane(self, newmap: Optional[ShardMap] = None) -> None:
        """Create the native shard plane once the map exists (its slice
        geometry is the map's fixed partition), seed it with any restored
        dedup windows / fwd_seq, and attach every member the handshake
        already admitted. Joiners pass the JUST-DECODED map BEFORE
        publishing self.map: add() gates on `map is not None` from the
        caller's thread, so the lane must exist by the time the map is
        visible or a racing add() would deposit into the Python-plane
        outboxes nothing ever pumps. A plane that fails to start raises
        (the master's constructor; a joiner's wait_ready): the Python
        plane runs only where the configuration asks for it."""
        m = newmap if newmap is not None else self.map
        if not self._lane_want or self._lane is not None or m is None:
            return
        from ..comm.engine import _POLICY_CODE

        lane = ShardLane(
            self.node,
            self.spec,
            [m.word_range(s) for s in range(m.n_shards)],
            _POLICY_CODE[self.config.codec.scale_policy],
            wire.frame_wire_bytes(self.spec),
            self.config.transport.ack_timeout_sec,
            self.config.transport.ack_retry_limit,
            self.scfg.park_cap,
            self.obs_id,
        )
        self._lane = lane
        with self._dedup_mu:
            for origin, (seen, _fifo) in self._dedup.items():
                lane.dedup_merge(origin, seen)
        lane.set_fwd_seq(self._fwd_seq)
        if self._uplink is not None:
            lane.set_uplink(self._uplink)
        for link, m in self._members.items():
            if lane.member_attach(link, m.tx_seq, m.rx_count):
                self._lane_links.add(link)

    def _lane_attach(self, link: int) -> None:
        m = self._members.get(link)
        if self._lane is not None and m is not None:
            if self._lane.member_attach(link, m.tx_seq, m.rx_count):
                self._lane_links.add(link)

    def _admit_add(self, flat: np.ndarray) -> None:
        """Library-side writer admission control: with
        ShardConfig.outbox_limit_bytes set, an add() whose out-of-shard
        deposits would push resident outbox bytes past the limit BLOCKS
        until the FWD plane drains room (or raises, per outbox_overflow).
        The projection is conservative at slice granularity: each target
        shard of this delta counts one full outbox slice, whether or not
        one is already allocated."""
        limit = self.scfg.outbox_limit_bytes
        if limit <= 0:
            return
        m = self.map
        need = 0
        for k in range(m.n_shards):
            elo, ehi = m.element_range(k)
            if not np.any(flat[elo:ehi]):
                continue
            if self._lane is not None:
                owned = self._lane.owns(k)
            else:
                owned = self.state.owns(k)
            if not owned:
                need += (ehi - elo) * 4
        if need == 0:
            return
        outbox_bytes = (
            self._lane.outbox_bytes
            if self._lane is not None
            else self.state.outbox_bytes
        )
        if outbox_bytes() + need <= limit:
            return
        if self.scfg.outbox_overflow == "raise":
            raise ShardBackpressure(
                f"outbox {outbox_bytes()} B + {need} B new > "
                f"limit {limit} B"
            )
        deadline = time.monotonic() + self.scfg.outbox_block_timeout_sec
        while time.monotonic() < deadline:
            if outbox_bytes() + need <= limit:
                return
            self._wake.set()
            time.sleep(0.002)
        raise ShardBackpressure(
            f"outbox stayed over {limit} B for "
            f"{self.scfg.outbox_block_timeout_sec}s (link stalled?)"
        )

    def _restore_pending_outboxes(self) -> None:
        """Re-seat checkpointed outbox residuals once the map exists
        (their geometry needs the shard ranges). Outboxes toward shards
        we end up owning fold at adopt time instead."""
        for s, (_wlo, resid) in list(self._restore_outboxes.items()):
            if self._lane is not None:
                if not self._lane.owns(s):
                    self._lane.restore_outbox(s, resid)
            elif not self.state.owns(s):
                self.state.restore_outbox(s, self._codec(s), resid)
            self._restore_outboxes.pop(s, None)

    def _adopt(self, shard: int) -> None:
        wlo, wcnt = self.map.word_range(shard)
        rest = self._restored.pop(shard, None)
        vals = rest[2] if rest is not None else None
        if self._lane is not None:
            self._lane.adopt(shard, vals)
        else:
            self.state.adopt(shard, wlo, wcnt, vals)
        self._route.pop(shard, None)
        self._event("shard_adopt", arg=shard)

    def _release_owned(self, shard: int):
        """Release ownership of one shard AND close every subscriber link
        served from its range: the slice will never update here again, so
        a surviving sub link would keep receiving FRESH beats over frozen
        values — silently-stale verified reads, the exact failure the
        serving tier refuses. A dropped link makes the subscriber
        resync/redial against the new owner."""
        if self._lane is not None:
            released = self._lane.release(shard)
        else:
            released = self.state.release(shard)
        if released is None or self.map is None:
            return released
        wlo, wcnt = self.map.word_range(shard)
        for l, sub in list(self._subs.items()):
            if wlo <= sub.wlo < wlo + wcnt:
                self._subs.pop(l, None)
                self.state.drop_sub(l)
                self.node.drop_link(l)
        for l, ent in list(self._lane_subs.items()):
            if ent[2] == shard:
                self._lane_subs.pop(l, None)
                self._subs.pop(l, None)
                self.node.drop_link(l)
        return released

    # -- control-plane sends -------------------------------------------------

    def _send_ctrl(self, link: int, payload: bytes) -> bool:
        for _ in range(40):
            if self._stop.is_set():
                return False
            try:
                if self.node.send(link, payload, timeout=0.05):
                    return True
            except BrokenPipeError:
                return False
        return False

    def _all_links(self) -> list[int]:
        out = list(self._members)
        for l in (self._uplink,):
            if l is not None and l not in out:
                out.append(l)
        return out

    def _flood_shard(self, doc: dict, exclude: Optional[int] = None) -> None:
        doc.setdefault("from", self.obs_id)
        payload = wire.encode_shard(doc)
        for link in self._all_links():
            if link != exclude:
                self._send_ctrl(link, payload)

    def _announce_owned(self, only_link: Optional[int] = None) -> None:
        for shard in self.owned_shards():
            e = self.map.owners[shard]
            doc = {
                "t": "own", "shard": shard, "epoch": e.epoch,
                "owner": self.obs_id, "from": self.obs_id,
            }
            payload = wire.encode_shard(doc)
            targets = [only_link] if only_link is not None else self._all_links()
            for link in targets:
                self._send_ctrl(link, payload)

    # -- FWD plane: ledger / routing ----------------------------------------

    def _ledger_send(self, link: int, payload) -> bool:
        """Ledger + send one FWD on a member link. False = window full or
        unknown link (the caller keeps the mass where it was)."""
        m = self._members.get(link)
        if m is None or len(m.unacked) >= SEND_WINDOW:
            return False
        m.tx_seq += 1
        buf = bytearray(payload)
        wire.fwd_restamp(buf, m.tx_seq)
        if not m.unacked:
            m.progress_t = time.monotonic()
        m.unacked.append([m.tx_seq, buf, time.monotonic()])
        self._send_raw(link, buf)
        return True

    def _send_raw(self, link: int, buf: bytearray) -> None:
        """Best-effort wire write: a bounce (backpressure) is fine — the
        entry is already ledgered, and the go-back-N retransmission path
        re-sends the head until ACK progress resumes."""
        try:
            self.node.send(link, memoryview(buf), timeout=0.05)
        except BrokenPipeError:
            pass  # LINK_DOWN will re-route the ledger

    def _fwd_shard_of(self, buf) -> int:
        (word_lo,) = struct.unpack_from("<I", buf, 5)
        return self.map.shard_of_word(word_lo)

    def _next_hop(self, shard: int, exclude: Optional[int] = None):
        link = self._route.get(shard)
        if link is not None and link != exclude and link in self._members:
            return link
        up = self._uplink
        if up is not None and up != exclude and up in self._members:
            return up
        return None

    def _park(self, shard: int, buf: bytearray) -> None:
        self._parked.append((shard, buf))
        while len(self._parked) > self.scfg.park_cap:
            self._parked.popleft()
            # loud bounded loss, never unbounded memory (ShardConfig
            # .park_cap); the origin's mass is gone — count it
            self._m_park_drops.inc()
            self._event("shard_park_drop")

    def _unpark(self, shard: Optional[int] = None) -> None:
        if not self._parked:
            return
        keep: deque = deque()
        for s, buf in self._parked:
            if shard is not None and s != shard:
                keep.append((s, buf))
                continue
            if not self._dispatch_fwd(s, buf, arrival=None):
                keep.append((s, buf))
        self._parked = keep

    def _dispatch_fwd(self, shard: int, buf: bytearray, arrival) -> bool:
        """Apply locally (owner), relay toward the owner, or fail (caller
        parks). Never sends back on the arrival link. A shard mid-
        outgoing-handoff is NOT locally applicable (its snapshot already
        shipped); the frame relays toward the successor — per-link FIFO
        puts it behind the ho_done on the uplink, so the successor owns
        the slice before the frame lands — or parks until the
        successor's announce supplies the route."""
        if self.state.owns(shard) and shard not in self._ho_sent:
            try:
                self._apply_fwd(buf, shard)
            except (ValueError, struct.error) as e:
                # relays forward verbatim without decoding, so a frame a
                # fault corrupted upstream is first DECODED here — at the
                # owner, possibly straight out of the park buffer or a
                # link-down re-dispatch, where no per-message guard wraps
                # us. Drop it loudly instead of killing the loop thread.
                log.warning(
                    "dropping undecodable FWD frame for shard %d: %s",
                    shard, e,
                )
            return True
        link = self._next_hop(shard, exclude=arrival)
        if link is None:
            return False
        if self._ledger_send(link, buf):
            if arrival is not None:
                self._m_relayed.inc()
            return True
        return False

    def _apply_fwd(self, buf, shard: int) -> None:
        """Owner-side apply with end-to-end dedup. Only the loop thread
        calls this (right after _dispatch_fwd's ownership check, with no
        release possible in between — one thread owns the protocol), so
        ownership is a precondition, not a race."""
        frames, word_lo, _seq, origin, fwd_seq = wire.decode_fwd(
            bytes(buf), self.spec
        )
        with self._dedup_mu:
            # the dedup-add and the slice apply commit TOGETHER under
            # this mutex (lock order: _dedup_mu -> state._lock), so
            # save_shards' capture under the same mutex always persists
            # a consistent pair — a window seq whose mass is missing
            # from the slice would make the restored owner discard that
            # frame's re-routed resend: silent cluster mass loss
            seen, fifo = self._dedup.setdefault(origin, (set(), deque()))
            if fwd_seq in seen:
                self._m_dedup.inc()
                return
            seen.add(fwd_seq)
            fifo.append(fwd_seq)
            while len(fifo) > DEDUP_WINDOW:
                seen.discard(fifo.popleft())
            applied = False
            for scales, words in frames:
                # the burst's halvings apply in order — one dedup
                # identity covers the whole message (one ledger entry,
                # one apply-or-discard decision)
                applied |= self.state.apply_owned(scales, words, word_lo)
        if applied:
            self._m_fwd_in.inc()
            # exact per-shard attribution — the heat-rate numerator
            self._shard_applies[shard] = self._shard_applies.get(shard, 0) + 1

    def _queue_room(self, link: int, keep: int = 3) -> bool:
        """True when the transport send queue has at least ``keep`` free
        slots. The data pumps must never fill the queue to the brim: the
        cumulative ACKs and shard control messages share it, and a pump
        that races them for the last slot starves the very ACKs that let
        its own ledger drain (the first drain smoke wedged exactly
        there — both ends idle, ack_due stuck on a full queue)."""
        st = self.node.stats(link)
        if st is None:
            return False
        return st.send_queue <= QUEUE_DEPTH - keep

    def _pump_outboxes(self) -> None:
        for shard in self.state.outbox_shards():
            if self.state.owns(shard):
                continue  # adopt() folds; nothing to send
            link = self._next_hop(shard)
            if link is None:
                continue  # mass stays in the residual until a route heals
            if not self._queue_room(link):
                continue
            m = self._members.get(link)
            for _ in range(OUTBOX_MSGS_PER_PASS):
                if m is None or len(m.unacked) >= SEND_WINDOW:
                    break
                out = self.state.drain_outbox_frames(
                    shard,
                    self.config.codec.scale_policy,
                    wire.fwd_frames_cap(self.spec, self._codec(shard).word_cnt),
                )
                if out is None:
                    break
                frames, wlo = out
                self._fwd_seq += 1
                payload = wire.encode_fwd(
                    frames, wlo, 0, self.obs_id, self._fwd_seq
                )
                self._ledger_send(link, payload)
                self._m_fwd_out.inc()

    def _check_retransmit(self) -> None:
        timeout = self.config.transport.ack_timeout_sec
        if timeout <= 0:
            return
        limit = max(1, self.config.transport.ack_retry_limit)
        now = time.monotonic()
        for link, m in list(self._members.items()):
            if not m.unacked:
                continue
            if now - m.progress_t < timeout * (1 + m.retx_rounds):
                continue
            m.retx_rounds += 1
            if m.retx_rounds > limit:
                log.warning(
                    "link %d: %d retransmission rounds with no ACK "
                    "progress — tearing down for re-route", link,
                    m.retx_rounds - 1,
                )
                self.node.drop_link(link)  # LINK_DOWN re-routes the ledger
                continue
            m.progress_t = now
            self._retx_total += min(len(m.unacked), RETX_PREFIX)
            for seq, buf, _t in m.unacked[:RETX_PREFIX]:
                self._send_raw(link, buf)

    def _flush_acks(self) -> None:
        for link, m in self._members.items():
            if m.ack_due:
                try:
                    # ack_due stays set on a backpressure bounce — a
                    # silently dropped cumulative ACK would strand the
                    # sender's tail until its go-back-N gives up (found
                    # by the first drain smoke: ~10 frames wedged per
                    # link with both ends idle)
                    if self.node.send(
                        link, wire.encode_ack(m.rx_count), timeout=0.05
                    ):
                        m.ack_due = False
                except BrokenPipeError:
                    m.ack_due = False

    # -- serve tier ----------------------------------------------------------

    def _attach_sub(self, link: int, rng: Optional[tuple[int, int]]) -> None:
        words = self.spec.total // 32
        wlo, wcnt = rng if rng is not None else (0, words)
        try:
            if self._lane is not None:
                seed = self._lane_attach_sub(link, wlo, wcnt)
            else:
                seed = self.state.attach_sub(link, wlo, wcnt)
        except ValueError as e:
            self._send_ctrl(link, wire.encode_reject(
                f"{e} (a sharded owner serves subscriptions only within "
                f"its owned shards)"
            ))
            self.node.drop_link_flushed(link)
            return
        self._subs[link] = sub = _Sub(wlo, wcnt)
        self._send_ctrl(link, wire.encode_welcome())
        for chunk in wire.encode_snapshot_chunks(seed):
            self._send_ctrl(link, chunk)
        sub.last_fresh_t = time.monotonic()
        self._send_ctrl(
            link, wire.encode_fresh(self._now_ns(), sub.tx_seq)
        )
        self._event("sub_attach", link, wcnt)

    def _lane_attach_sub(self, link: int, wlo: int, wcnt: int) -> np.ndarray:
        """Lane-mode subscriber attach: the owned slice lives in C, so the
        serve-tier residual is tracked as (current - conveyed) instead of
        per-apply feeding — error-feedback-equivalent and self-correcting
        (the quantize ladder drains the DIFFERENCE, whatever path the
        slice took). Returns the seed snapshot; raises ValueError when no
        owned shard covers the range (the REJECT path)."""
        for s in self.owned_shards():
            swlo, swcnt = self.map.word_range(s)
            if swlo <= wlo and wlo + wcnt <= swlo + swcnt:
                vals = self._lane.read_shard(s)
                if vals is None:
                    break
                i0 = (wlo - swlo) * 32
                seed = vals[i0:i0 + wcnt * 32].copy()
                sc = SliceCodec(self.spec, wlo, wcnt)
                self._lane_subs[link] = [sc, seed.copy(), s]
                return seed
        raise ValueError(
            f"subscription [{wlo}, {wlo + wcnt}) not within any owned shard"
        )

    def _lane_sub_frame(self, link: int):
        """One RDATA frame off a lane-mode subscriber's conveyed-diff
        residual (None = idle/unknown), plus idle bookkeeping."""
        ent = self._lane_subs.get(link)
        if ent is None:
            return None
        sc, conveyed, shard = ent
        vals = self._lane.read_shard(shard)
        if vals is None:
            return None
        swlo, _sw = self.map.word_range(shard)
        i0 = (sc.word_lo - swlo) * 32
        cur = vals[i0:i0 + sc.n_el]
        r = cur - conveyed
        if not np.any(r):
            return None
        scales, words, new_r = sc.quantize(
            r, self.config.codec.scale_policy
        )
        if not scales.any():
            return None
        ent[1] = cur - new_r  # conveyed advances by exactly what shipped
        return scales, words, sc.word_lo, sc.word_cnt

    def _lane_sub_idle(self, link: int) -> bool:
        ent = self._lane_subs.get(link)
        if ent is None:
            return True
        sc, conveyed, shard = ent
        vals = self._lane.read_shard(shard)
        if vals is None:
            return True
        swlo, _sw = self.map.word_range(shard)
        i0 = (sc.word_lo - swlo) * 32
        return bool(np.array_equal(vals[i0:i0 + sc.n_el], conveyed))

    def _pump_subs(self) -> None:
        fresh_iv = self.config.serve.fresh_interval_sec
        now = time.monotonic()
        for link, sub in list(self._subs.items()):
            if not self._queue_room(link):
                # a bounced RDATA is a LOST frame on the unledgered link
                # (the residual was already debited) — don't even
                # quantize until there is room
                continue
            if self._lane is not None:
                out = self._lane_sub_frame(link)
            else:
                out = self.state.sub_frame(
                    link, self.config.codec.scale_policy
                )
            if out is not None:
                scales, words, wlo, wcnt = out
                sub.tx_seq += 1
                payload = wire.encode_rdata(
                    TableFrame(scales, words),
                    0,
                    wcnt,
                    sub.tx_seq,
                    trace=(self.obs_id, self._now_ns(), 0),
                )
                # encode_rdata slices [word_lo:word_lo+cnt] out of the
                # frame's words; our words ARE the slice already, so the
                # wire range header is patched to the true word_lo
                buf = bytearray(payload)
                struct.pack_into("<I", buf, 5, wlo)
                try:
                    self.node.send(link, memoryview(buf), timeout=0.05)
                except BrokenPipeError:
                    continue
            elif (
                (
                    self._lane_sub_idle(link)
                    if self._lane is not None
                    else self.state.sub_idle(link)
                )
                and now - sub.last_fresh_t >= fresh_iv
            ):
                sub.last_fresh_t = now
                try:
                    self.node.send(
                        link,
                        wire.encode_fresh(self._now_ns(), sub.tx_seq),
                        timeout=0.05,
                    )
                except BrokenPipeError:
                    continue

    # -- handoff -------------------------------------------------------------

    def _run_handoffs(self) -> None:
        wanted = getattr(self, "_handoff_wanted", None)
        if not wanted or self._uplink is None:
            return
        up = self._uplink
        send_dedup = True
        for shard in list(wanted):
            if self._lane is not None:
                # conservation across the capture/send window: the C
                # receiver applies CONCURRENTLY with this thread (the
                # python tier is safe by its single loop thread), so the
                # relay-onward flag must be up BEFORE the slice is read —
                # a frame applied after the read would die with the
                # released slice (JAX's spec_shard model's apply_during_handoff)
                self._lane.set_handoff(shard, True)
                vals = self._lane.read_shard(shard)
                if vals is None:
                    self._lane.set_handoff(shard, False)
                    wanted.remove(shard)
                    continue
                c = self._codec(shard)
            else:
                ent = self.state.owned_entry(shard)
                if ent is None:
                    wanted.remove(shard)
                    continue
                c, vals = ent
            epoch = self.map.owners[shard].epoch + 1
            ok = self._send_ctrl(up, wire.encode_shard({
                "t": "ho_meta", "shard": shard, "word_lo": c.word_lo,
                "word_cnt": c.word_cnt, "epoch": epoch,
                "from": self.obs_id,
            }))
            raw = np.ascontiguousarray(vals, "<f4").tobytes()
            step = HO_CHUNK_ELEMS * 4
            for off in range(0, len(raw), step):
                if not ok:
                    break
                ok = self._send_ctrl(up, wire.encode_shard({
                    "t": "ho_state", "shard": shard, "off": off,
                    "data": base64.b64encode(raw[off:off + step]).decode(),
                    "from": self.obs_id,
                }))
            # the dedup windows ride along: without them, a
            # retransmission of a frame WE applied but never acked
            # would double-apply at the successor (the mutation JAX's spec_shard
            # red team seeds). They are per-ORIGIN node state, not
            # per-shard — ship them once per leave (with the first shard
            # of the batch); the successor merges into its global window
            # at that shard's ho_done, before any adopted slice can see
            # a replayed frame
            if ok and send_dedup:
                if self._lane is not None:
                    # windows alone — the full snapshot would copy every
                    # owned slice under the plane mutex just to discard it
                    windows = {
                        int(o): sorted(seqs)
                        for o, seqs in self._lane.dedup_windows().items()
                    }
                else:
                    with self._dedup_mu:
                        windows = {
                            int(origin): sorted(seen)
                            for origin, (seen, _fifo) in self._dedup.items()
                        }
                for origin, seqs in windows.items():
                    for off in range(0, len(seqs), 4096):
                        if not ok:
                            break
                        ok = self._send_ctrl(up, wire.encode_shard({
                            "t": "ho_dedup", "shard": shard,
                            "origin": origin,
                            "seqs": seqs[off:off + 4096],
                            "from": self.obs_id,
                        }))
            if ok:
                ok = self._send_ctrl(up, wire.encode_shard({
                    "t": "ho_done", "shard": shard, "from": self.obs_id,
                }))
            if not ok:
                # a bounced control send means the staged transfer has a
                # hole — ho_done would let the successor adopt a zero-
                # filled slice and ho_ack would release the true one
                # (silent mass loss). Leave the shard in `wanted` and
                # retry next pass: the fresh ho_meta resets the stage.
                log.warning(
                    "shard %d handoff send bounced; retrying next pass",
                    shard,
                )
                if self._lane is not None:
                    # resume local ownership: frames relayed upstream in
                    # the window self-heal (routes still point here)
                    self._lane.set_handoff(shard, False)
                return
            send_dedup = False
            self._ho_sent.add(shard)
            wanted.remove(shard)

    def _on_ho(self, link: int, doc: dict) -> None:
        t = doc["t"]
        shard = int(doc.get("shard", -1))
        if t == "ho_meta":
            self._ho_stage[shard] = {
                "word_lo": int(doc["word_lo"]),
                "word_cnt": int(doc["word_cnt"]),
                "epoch": int(doc["epoch"]),
                "buf": bytearray(int(doc["word_cnt"]) * 32 * 4),
                "dedup": {},
                "link": link,
            }
        elif t == "ho_state":
            st = self._ho_stage.get(shard)
            if st is not None:
                off = int(doc["off"])
                data = base64.b64decode(doc["data"])
                st["buf"][off:off + len(data)] = data
        elif t == "ho_dedup":
            st = self._ho_stage.get(shard)
            if st is not None:
                st["dedup"].setdefault(
                    int(doc["origin"]), []
                ).extend(int(s) for s in doc.get("seqs", ()))
        elif t == "ho_done":
            st = self._ho_stage.pop(shard, None)
            if st is None:
                return
            vals = np.frombuffer(bytes(st["buf"]), "<f4").copy()
            if self._lane is not None:
                self._lane.adopt(shard, vals)
                for origin, seqs in st["dedup"].items():
                    self._lane.dedup_merge(origin, seqs)
            else:
                self.state.adopt(shard, st["word_lo"], st["word_cnt"], vals)
                for origin, seqs in st["dedup"].items():
                    with self._dedup_mu:
                        seen, fifo = self._dedup.setdefault(
                            origin, (set(), deque())
                        )
                        merged = sorted(set(seqs) | seen)[-DEDUP_WINDOW:]
                        seen.clear()
                        seen.update(merged)
                        fifo.clear()
                        fifo.extend(merged)
            entry = OwnerEntry(
                st["epoch"], self.obs_id, self._adv_host, self.node.listen_port
            )
            self.map.merge_entry(shard, entry)
            self._route.pop(shard, None)
            self._flood_shard({
                "t": "grant", "shard": shard, "e": entry.as_doc(),
                "nonce": "",
            })
            self._announce_owned()
            self._send_ctrl(link, wire.encode_shard({
                "t": "ho_ack", "shard": shard, "from": self.obs_id,
            }))
            self._m_handoffs.inc()
            self._event("shard_handoff", link, shard)
            self._unpark(shard)
        elif t == "ho_ack":
            released = self._release_owned(shard)
            if released is not None:
                self._event("shard_release", link, shard)
                self._m_handoffs.inc()
            self._ho_sent.discard(shard)
            self._ho_acked.add(shard)

    # -- shard control plane -------------------------------------------------

    def _on_shard_msg(self, link: int, doc: dict) -> None:
        t = doc.get("t")
        if t == "map":
            changed = False
            if self.map is None:
                newmap = ShardMap.from_doc(doc["map"])
                # lane BEFORE the map publishes: add() gates on the map
                # from the caller's thread, and a delta deposited into
                # the Python-plane outboxes in the gap would be stranded
                # (lane mode never pumps them)
                try:
                    self._ensure_lane(newmap)
                except Exception as e:
                    self._error = RuntimeError(f"the native shard plane did not start: {e}")
                    self._ready.set()
                    return
                self.map = newmap
                self._restore_pending_outboxes()
                changed = True
            else:
                changed = self.map.merge_doc(doc["map"])
            self._maybe_claim()
            for child in list(self._deferred_done):
                self._deferred_done.remove(child)
                self._welcome_member(child)
            if changed:
                self._wake.set()
        elif t == "claim":
            if self.is_master:
                self._arbitrate(doc)
            elif self._uplink is not None:
                self._send_ctrl(self._uplink, wire.encode_shard(doc))
            # uplink down mid-claim: drop — the claimer retries every 1 s
        elif t == "grant":
            shard = int(doc["shard"])
            entry = OwnerEntry.from_doc(doc["e"])
            if self.map is not None and self.map.merge_entry(shard, entry):
                self._flood_shard(dict(doc), exclude=link)
            # act on the DIRECTORY's current entry, not the message's: the
            # master's flood and a handoff successor's flood are separate
            # minters with no cross-link ordering, so a stale duplicate
            # grant can arrive AFTER the handoff that moved the shard
            # elsewhere — adopting (or releasing) on its say-so would
            # re-create two-owner split-brain
            cur = (
                self.map.owner_of_shard(shard)
                if self.map is not None
                and 0 <= shard < self.map.n_shards
                else entry
            )
            if cur is not None and cur.owner == self.obs_id:
                if not self._owns(shard):
                    self._adopt(shard)
                    self._announce_owned()
                self._claim_pending.discard(shard)
                if not self._claim_pending:
                    self._granted.set()
                    self._ready.set()
            elif cur is not None and self._owns(shard):
                # a takeover re-granted our shard elsewhere (we were
                # presumed dead): release — exactly-one-owner wins
                self._release_owned(shard)
                self._event("shard_release", link, shard)
        elif t == "deny":
            if doc.get("nonce") == self._claim_nonce:
                self._error = ShardRejected(
                    f"claim denied: {doc.get('reason', '')}"
                )
                self._ready.set()
            else:
                self._flood_shard(dict(doc), exclude=link)
        elif t == "own":
            shard = int(doc["shard"])
            epoch = int(doc["epoch"])
            owner = int(doc["owner"])
            if owner == self.obs_id:
                return
            if self._owns(shard):
                my_e = self.map.owners[shard].epoch if self.map else 0
                if epoch > my_e:
                    self._release_owned(shard)
                    self._event("shard_release", link, shard)
                else:
                    return
            prev = self._route_epoch.get(shard, 0)
            if epoch < prev:
                return
            self._route[shard] = link
            self._route_epoch[shard] = epoch
            if self._lane is not None:
                self._lane.set_route(shard, link)
            # ALWAYS re-flood (tree: flood-except-arrival terminates; no
            # cycles, no storm): an epoch-gated forward would starve any
            # node whose route a link death purged — its neighbors, still
            # holding the same epoch, would never pass the periodic
            # re-announce along
            self._flood_shard(dict(doc), exclude=link)
            self._unpark(shard)
        elif t in ("ho_meta", "ho_state", "ho_dedup", "ho_done", "ho_ack"):
            self._on_ho(link, doc)
        else:
            log.warning("unknown shard control message %r", t)

    def _arbitrate(self, doc: dict) -> None:
        """Root-side claim arbitration (the ONE grant minter)."""
        shard = int(doc["shard"])
        if self.map is None or not 0 <= shard < self.map.n_shards:
            self._flood_shard({
                "t": "deny", "shard": shard, "nonce": doc.get("nonce"),
                "reason": f"no such shard {shard}",
            })
            return
        cur = self.map.owners[shard]
        claimer = int(doc["owner"])
        if cur.epoch == 0 or bool(doc.get("takeover")) or cur.owner == claimer:
            entry = OwnerEntry(
                cur.epoch + 1, claimer, str(doc["host"]), int(doc["port"])
            )
            self.map.merge_entry(shard, entry)
            if self._owns(shard) and claimer != self.obs_id:
                self._release_owned(shard)
            self._flood_shard({
                "t": "grant", "shard": shard, "e": entry.as_doc(),
                "nonce": doc.get("nonce"),
            })
            self._event("shard_grant", arg=shard)
        else:
            self._flood_shard({
                "t": "deny", "shard": shard, "nonce": doc.get("nonce"),
                "reason": (
                    f"shard {shard} is owned (epoch {cur.epoch}); restart "
                    f"with restore_dir for takeover semantics"
                ),
            })

    def _maybe_claim(self) -> None:
        """(Re-)send our claim up the tree until granted/denied — the
        claim is idempotent at the arbiter (a re-grant to the same owner
        just mints the next epoch), so a lost grant heals by retry."""
        if (
            self.is_master
            or self.map is None
            or self._uplink is None
            or self._granted.is_set()
            or self._error is not None
        ):
            return
        if not self._claim_pending:
            self._ready.set()  # member that owns no shard: ready on map
            return
        now = time.monotonic()
        if self._claim_first_t == 0.0:
            self._claim_first_t = now
        elif now - self._claim_first_t > self.scfg.claim_timeout_sec:
            # the documented join budget: unanswered claims fail the
            # creation instead of retrying forever (wait_ready honors
            # the CALLER's timeout; this knob bounds the claim itself)
            self._error = ShardRejected(
                f"no grant for shard(s) {sorted(self._claim_pending)} "
                f"after {self.scfg.claim_timeout_sec}s of claims"
            )
            self._ready.set()
            return
        if now - self._claim_sent_t < 1.0:
            return
        self._claim_sent_t = now
        for idx in sorted(self._claim_pending):
            self._send_ctrl(self._uplink, wire.encode_shard({
                "t": "claim", "shard": idx, "owner": self.obs_id,
                "host": self._adv_host, "port": self.node.listen_port,
                "nonce": self._claim_nonce, "takeover": self._takeover,
                "from": self.obs_id,
            }))

    # -- handshake -----------------------------------------------------------

    def _welcome_member(self, link: int) -> None:
        """Accept a sharded child: WELCOME with the flag, then the
        current map (per-link FIFO: the child sees WELCOME -> map before
        any data), then our route announces so its reverse paths exist."""
        self._send_ctrl(link, wire.encode_welcome(SYNC_FLAG_SHARD))
        self._members[link] = _Member()
        self._lane_attach(link)
        self._send_ctrl(
            link,
            wire.encode_shard({
                "t": "map", "map": self.map.as_doc(), "from": self.obs_id,
            }),
        )
        self._announce_owned(only_link=link)
        # routes we LEARNED (owners elsewhere) propagate to the new child,
        # so its reverse paths exist before its first out-of-shard write
        for shard in sorted(self._route):
            if not self._owns(shard):
                e = self.map.owners[shard]
                if e.epoch > 0:
                    self._send_ctrl(link, wire.encode_shard({
                        "t": "own", "shard": shard, "epoch": e.epoch,
                        "owner": e.owner, "from": self.obs_id,
                    }))

    def _start_join(self, uplink: int) -> None:
        claim = self.scfg.shard_index
        self._send_ctrl(
            uplink,
            wire.encode_sync(
                self.spec,
                self._wire_version,
                SYNC_FLAG_SHARD,
                shard=claim,
            ),
        )
        self._send_ctrl(uplink, bytes([wire.DONE]))

    # -- message dispatch ----------------------------------------------------

    def _on_message(self, link: int, payload: bytes) -> None:
        kind = payload[0]
        if kind == wire.FWD:
            if self._lane is not None:
                # a stray consumed in the attach race window: drop
                # unacked — the sender's go-back-N re-delivers into the
                # plane's receiver (its rx_count never saw this seq)
                return
            m = self._members.get(link)
            if m is None:
                return  # not a member link (mid-handshake stray)
            seq = struct.unpack_from("<I", payload, 1)[0]
            if seq != (m.rx_count + 1) & 0xFFFFFFFF:
                # dup or gap: discard unapplied; the sender's go-back-N
                # re-delivers in order (never mis-acked). RE-ANNOUNCE the
                # cumulative ACK either way: a duplicate here usually
                # means our ACK was lost (e.g. bounced on backpressure),
                # and a sender whose retransmissions are silently
                # discarded without a fresh ACK is wedged forever
                m.ack_due = True
                return
            m.rx_count += 1
            m.ack_due = True
            buf = bytearray(payload)
            shard = self._fwd_shard_of(buf)
            if not self._dispatch_fwd(shard, buf, arrival=link):
                self._park(shard, buf)
        elif kind == wire.ACK:
            m = self._members.get(link)
            if m is None:
                return
            count = wire.decode_ack(payload)
            popped = False
            while m.unacked and m.unacked[0][0] <= count:
                m.unacked.pop(0)
                popped = True
            if popped:
                m.progress_t = time.monotonic()
                m.retx_rounds = 0
                self._wake.set()  # window opened: outboxes may drain
        elif kind == wire.SHARD:
            self._on_shard_msg(link, wire.decode_shard(payload))
        elif kind == wire.SYNC:
            self._on_sync(link, payload)
        elif kind == wire.RANGE:
            st = self._pending.get(link)
            if st is not None and st.get("sub"):
                st["range"] = wire.decode_range(payload)
        elif kind == wire.DONE:
            st = self._pending.pop(link, None)
            if st is None:
                return
            if st.get("sub"):
                self._attach_sub(link, st.get("range"))
            elif self.map is None:
                self._deferred_done.append(link)  # answered once map lands
            else:
                claim = st.get("claim")
                if claim is not None and not (
                    -1 <= claim < self.map.n_shards
                ):
                    # the SYNC claim tail fails a misconfigured joiner
                    # (n_shards disagreement) at the hello boundary,
                    # before it spends a join on a claim the master's
                    # arbitration can only deny
                    self._send_ctrl(link, wire.encode_reject(
                        f"shard-index claim {claim} is out of range "
                        f"for this cluster's n_shards="
                        f"{self.map.n_shards}"
                    ))
                    self.node.drop_link_flushed(link)
                else:
                    self._welcome_member(link)
        elif kind == wire.WELCOME:
            if not wire.welcome_flags(payload) & SYNC_FLAG_SHARD:
                # pre-/ unsharded parent: the tolerant-fallback arm —
                # the caller tears this node down and joins classic
                self._fallback = True
                self._ready.set()
                return
            self._members[link] = _Member()
            self._lane_attach(link)  # lane exists on a re-grafted member
            # map + claim follow (the parent sends its map right behind);
            # a RE-GRAFTED member re-announces its shards so the new
            # subtree's routes point here again
            self._announce_owned(only_link=link)
        elif kind == wire.REJECT:
            self._error = ShardRejected(wire.decode_reject(payload))
            self._ready.set()
        elif kind == wire.DIGEST:
            self._child_digests[link] = wire.decode_digest(payload)
        elif kind == wire.CLOCK:
            # clock plane (comm/peer.py twin): answer a child's probe
            # down its own link; fold an uplink reply into the estimator
            doc = wire.decode_clock(payload)
            if doc.get("op") == "probe":
                try:
                    self.node.send(
                        link,
                        wire.encode_clock(self._clock.reply_payload(doc)),
                        timeout=0.05,
                    )
                except BrokenPipeError:
                    pass
            elif doc.get("op") == "reply" and link == self._uplink:
                self._clock.on_reply(doc)
        elif kind in (wire.CHUNK,):
            pass  # no snapshot uploads in the sharded handshake
        elif kind in (wire.DATA, wire.BURST, wire.RDATA, wire.FRESH):
            pass  # classic stream from a parent we are abandoning (fallback)
        else:
            log.warning("unknown message kind %d on link %d", kind, link)

    def _on_sync(self, link: int, payload: bytes) -> None:
        k, n, digest = wire.decode_sync(payload)
        if digest != self.spec.layout_digest():
            self._send_ctrl(link, wire.encode_reject(
                f"table layout mismatch: yours ({k} leaves, {n} elems) "
                f"is not byte-compatible with ours "
                f"({self.spec.num_leaves}, {self.spec.total_n})"
            ))
            self.node.drop_link_flushed(link)
            return
        flags = wire.sync_flags(payload)
        if flags & SYNC_FLAG_READ_ONLY:
            self._pending[link] = {"sub": True}
            if not flags & SYNC_FLAG_RANGE:
                self._pending[link]["range"] = None
            return
        if not flags & SYNC_FLAG_SHARD:
            # the detectably-broken-not-silently-wrong rule: no node
            # in a sharded cluster holds the full replica, so a classic
            # writer cannot be seeded — fail it loudly with the remedy
            self._send_ctrl(link, wire.encode_reject(
                "this cluster runs the cluster-sharded tensor; a "
                "full-replica writer cannot join (set ShardConfig."
                "n_shards/shard_index to join sharded, or start the "
                "cluster with n_shards=0 / ST_SHARD=0 for the classic "
                "protocol)"
            ))
            self.node.drop_link_flushed(link)
            return
        self._pending[link] = {"sub": False, "claim": wire.sync_shard(payload)}

    # -- membership events ---------------------------------------------------

    def _on_link_down(self, link: int, is_uplink: bool) -> None:
        m = self._members.pop(link, None)
        if self._lane is not None and link in self._lane_links:
            # the plane re-dispatches every unacked FWD under its
            # unchanged end-to-end identity (apply/relay/park) — the
            # python redispatch below is the non-lane twin
            self._lane.member_detach(link)
            self._lane_links.discard(link)
            m = None
        self._lane_subs.pop(link, None)
        self._subs.pop(link, None)
        self.state.drop_sub(link)
        self._pending.pop(link, None)
        self._child_digests.pop(link, None)
        # abandoned incoming handoffs: a leaver that died mid-transfer
        # never sends ho_done, and the stage holds a slice-sized buffer —
        # purge it or repeated aborted handoffs accumulate ~a full table
        # invisible to alloc_bytes()
        for k in [
            k for k, st in self._ho_stage.items() if st.get("link") == link
        ]:
            del self._ho_stage[k]
        if link in self._deferred_done:
            self._deferred_done.remove(link)
        for shard in [s for s, l in self._route.items() if l == link]:
            del self._route[shard]
        if is_uplink:
            self._uplink = None
            if self._lane is not None:
                self._lane.set_uplink(None)
                for s in list(self._ho_sent):
                    self._lane.set_handoff(s, False)
            # un-acked outgoing handoffs: the successor may never have
            # adopted — we still hold the slice (release only happens on
            # ho_ack), so resume local applies; if the successor DID
            # adopt, its epoch+1 announce releases us when the tree heals
            self._ho_sent.clear()
        if m is not None:
            # every unacked FWD re-routes under its UNCHANGED end-to-end
            # identity (byte-identical past the link-seq field) — a copy
            # that was actually delivered dies in the owner's dedup
            # window instead of double-applying
            for _seq, buf, _t in m.unacked:
                shard = self._fwd_shard_of(buf)
                if not self._dispatch_fwd(shard, buf, arrival=None):
                    self._park(shard, buf)

    def _handle_events(self) -> bool:
        busy = False
        for ev in self.node.poll_events(timeout=0.0):
            busy = True
            if ev.kind == EventKind.LINK_UP:
                if ev.is_uplink:
                    self._uplink = ev.link_id
                    if self._lane is not None:
                        self._lane.set_uplink(ev.link_id)
                    self._start_join(ev.link_id)
                # children speak first (SYNC); nothing to do yet
            elif ev.kind == EventKind.LINK_DOWN:
                self._on_link_down(ev.link_id, ev.is_uplink)
            elif ev.kind == EventKind.BECAME_MASTER:
                # the old root died: we are the tree root now, and with
                # it the map's grant-minting authority (the merged map is
                # the authority state; exactly-one-owner is preserved
                # because only the CURRENT root arbitrates)
                self._uplink = None
                if self._lane is not None:
                    self._lane.set_uplink(None)
                self.is_master = True
            elif ev.kind == EventKind.REJOIN_FAILED:
                self._error = ConnectionError("rejoin failed (tree gone)")
                self._ready.set()
        return busy

    # -- digests -------------------------------------------------------------

    def _publish_digest(self) -> None:
        from ..obs import aggregate

        doc = aggregate.from_snapshot(
            self.obs_id, self._reg.snapshot(), self._now_ns()
        )
        ent = doc["nodes"].get(str(self.obs_id))
        if ent is not None:
            ent["name"] = self.node_name
        for child in list(self._child_digests.values()):
            aggregate.merge(doc, child)
        aggregate.bounded(doc)
        up = self._uplink
        if up is not None:
            try:
                self.node.send(up, wire.encode_digest(doc), timeout=0.05)
            except BrokenPipeError:
                pass
        else:
            if self._health is not None:
                # the root analyzer samples every digest beat
                try:
                    self._health.beat(doc, self._now_ns())
                except Exception as e:
                    log.debug("health beat failed: %s", e)
            if self.config.obs.cluster_json_path:
                import json as _json

                path = self.config.obs.cluster_json_path
                tmp = f"{path}.tmp.{os.getpid()}"
                try:
                    with open(tmp, "w") as f:
                        _json.dump(doc, f)
                        f.write("\n")
                    os.replace(tmp, path)
                except OSError as e:
                    log.debug("cluster digest write failed: %s", e)

    # -- the loop ------------------------------------------------------------

    def _loop(self) -> None:
        digest_iv = (
            self.config.obs.digest_interval_sec if self._obs_on else 0.0
        )
        while not self._stop.is_set():
            busy = self._handle_events()
            for link in list(self.node.links or ()):
                if link in self._lane_links:
                    continue  # the plane's receiver thread consumes these
                for _ in range(256):
                    try:
                        payload = self.node.recv(link, timeout=0.0)
                    except BrokenPipeError:
                        break
                    if payload is None:
                        break
                    busy = True
                    try:
                        self._on_message(link, payload)
                    except Exception as e:
                        log.warning("dropping bad message: %s", e)
                    if link in self._lane_links:
                        # _ensure_lane attached this link mid-drain (the
                        # map just landed): the plane's receiver owns the
                        # stream from here
                        break
            if self._lane is not None:
                # control-plane messages the plane deferred (it owns only
                # FWD/ACK on member links — the engine/peer.py split)
                while True:
                    c = self._lane.poll_ctrl()
                    if c is None:
                        break
                    busy = True
                    try:
                        self._on_message(c[0], c[1])
                    except Exception as e:
                        log.warning("dropping bad ctrl message: %s", e)
            else:
                self._flush_acks()
                self._unpark()  # frames parked on a full window retry here
                self._pump_outboxes()
                self._check_retransmit()
            self._pump_subs()
            self._run_handoffs()
            self._maybe_claim()
            now = time.monotonic()
            if (
                self.owned_shards()
                and now - self._announce_last >= ANNOUNCE_SEC
            ):
                self._announce_last = now
                self._announce_owned()
            if digest_iv > 0 and now - self._digest_last >= digest_iv:
                self._digest_last = now
                try:
                    self._publish_digest()
                except Exception as e:
                    log.debug("digest failed: %s", e)
            if (
                self._clock_interval > 0
                and not self.is_master
                and self._uplink is not None
                and now - self._clock_last >= self._clock_interval
            ):
                # clock-probe beat (comm/peer.py twin): lossy — a
                # bounced send waits for the next interval
                self._clock_last = now
                try:
                    self.node.send(
                        self._uplink,
                        wire.encode_clock(self._clock.probe_payload()),
                        timeout=0.05,
                    )
                except BrokenPipeError:
                    pass
            if self._hub is not None:
                self._hub.poll_native(
                    self.config.obs.native_drain_interval_sec
                )
            if not busy:
                if self._wake.wait(0.002):
                    self._wake.clear()
