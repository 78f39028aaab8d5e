"""The peer: a complete shared-tensor node on PyTorch.

The counterpart of ``shared_tensor_tpu/comm/peer.py``. It composes the
layers below it into the user-facing object (``create_or_fetch`` /
``read`` / ``add``):

- ``core.SharedTensor``: replica, per-link residuals and the in-flight
  ledger, with the codec on the GPU (kernels A and B of
  ``ops/codec_cuda.py``), or on the host tier (``host_tier=True``) in the
  C loops of ``native/stcodec.c``;
- ``comm.engine.EngineTensor``: on the host tier by default, the native
  engine (``native/stengine.cpp``) in place of the SharedTensor: two C
  threads run the whole steady state (quantize, encode, send, receive,
  flood apply, ACK ledger) of every attached link, and the Python
  threads below keep the handshakes, membership and the control messages
  the engine hands back (``poll_ctrl``); ``Config.native_engine=False``
  selects the Python host tier instead;
- ``comm.transport.TransportNode``: the native TCP tree;
- ``comm.wire``: the messages between them, byte-identical to the JAX
  package's, so JAX and PyTorch peers share one tree.

Two host threads per node. On the device tier the send thread keeps up
to ``Config.send_pipeline_depth`` quantized frames per link in flight,
each a burst of ``device_frame_burst`` halvings whose device-to-host copy
started at dispatch; it encodes the oldest into a pooled slot, ledgers it
and sends it. On the Python host tier it quantizes a burst of
``frame_burst`` halvings synchronously per message. On both, a burst
follows the native engine's cascade schedule when
``CodecConfig.cascade_frames`` > 1 (the default; ``core.SharedTensor``),
except on reference-wire links. The receive thread is
the only consumer of transport events and the only writer of handshake
state: it batches consecutive DATA/BURST messages of a link into one flood
apply, acknowledges them cumulatively, and handles the join handshake.
Sends are woken by ``add`` and by incoming frames and stop when the
residuals are exactly zero. On the native engine (``host_tier=True``) the
engine's two C threads carry each link's data plane once its handshake
is done, and the peer runs the receive thread alone: handshakes and the
control messages the engine hands back.

Delivery: a frame stays in the core's ledger until the receiver's ACK; a
link that dies rolls its unacknowledged frames back into its residual,
which an uplink keeps as the carry (``CARRY_LINK``) that the re-grafted
uplink then owes the tree. Messages carry a per-link seq; the receiver
accepts only the next one (go-back-N) and the sender re-sends the head
of its unacknowledged tail after ``ack_timeout_sec``.

Read-only subscribers (``serve.Subscriber``, the JAX package's too)
attach to a peer on any tier: their SYNC carries ``SYNC_FLAG_READ_ONLY``
(and ``SYNC_FLAG_RANGE`` with a RANGE message for a word range); the peer
seeds them over the control plane (WELCOME, its snapshot of their words as
CHUNKs, DONE, a FRESH mark stamped at the snapshot) and then streams to
them unledgered: no ACK, no window, no re-send. On the device and Python
host tiers the peer's sub-push thread (not the send loop) quantizes a
subscriber link's burst (up to 32 frames, by the cascade), never
pipelined, and sends it one message a frame with at most
``SUB_QUEUED_MSGS`` queued, the rest as the link drains; the link's
sockets hold about ``SUB_SOCKET_FRAMES`` frames each way, so the link has
a few frames in flight, not the kernel buffers' hundreds. A FRESH mark
("as of t you have everything") is sent only when the link's residual is
drained and nothing quantized is left unsent; a ranged link gets one
RDATA per frame and its residual masked to its range. On the engine the C sender runs the
same branch (``EngineTensor.new_link_sub``), with the kernel's buffers.
A lost message shows at the subscriber as a seq gap, which it repairs by
re-running the handshake; a dead subscriber link leaves no carry.

Fault injection (``Config.faults``, ``comm/faults.py``): the plan sees
every DATA, BURST and RDATA message at the send boundary
(``_send_blocking(..., data=True)``, re-sends included) and nothing else,
and the crash points fire at mid-join-walk, mid-burst and
between-apply-and-ack. On the engine the wire faults come from the
``ST_FAULT_PLAN`` environment string read at node creation.

Wire capabilities, negotiated per link in the SYNC and WELCOME tails
(``compat.SYNC_FLAG_*``), so a peer that does not speak one just ignores
it and the link keeps what both ends speak:

- sign2 (``SYNC_FLAG_SIGN2``): native engines only. An engine peer
  advertises it unless ``ST_SIGN2=0`` or ``CodecConfig.adaptive_precision``
  is off, and arms the engine's governor on a link whose peer advertised
  it too (``_arm_sign2``); the device and Python host tiers never
  advertise it and never receive a 2-bit frame.
- The same-host shared-memory lane (``SYNC_FLAG_SHM``), on every tier: a
  joiner sends its host id, a parent on the same host creates the link's
  /dev/shm segment and offers it in WELCOME, the child maps it, and the
  transport moves the link's data plane onto its rings while TCP stays
  the control and liveness channel. A failed attach keeps TCP, and is
  logged at WARNING and counted (``st_shm_fallback_total``). The flag also
  says "I decode the aligned v3 framing", which an engine then emits
  toward that peer; every tier here decodes it. Subscriber links keep TCP,
  v2 and 1 bit. ``ST_SHM=0`` or ``TransportConfig.shm_enabled`` off turns
  it all off.
- Link striping (``TransportConfig.stripe_count``) lives in the transport;
  the peer reports it per link in ``metrics()``.

The reference wire format (``TransportConfig.wire_compat``): one flat
tensor, raw frames, no handshake, no seq and no ACK. A child link is
seeded with the whole replica at LINK_UP; an uplink opens at once (with
the carry as its residual after a re-graft) and the peer is ready at the
first frame from it, keepalives included. Frames count as delivered when
queued. A leaf that lost its uplink re-grafts as one atomic step: its
replica becomes exactly its carry, which the new uplink owes (the parent
re-seeds it with its whole replica); an interior node keeps its state and
may double the re-seed, which the protocol cannot avoid (logged).

The observability plane (``obs/``, ``Config.obs``), as the JAX peer's
``_PeerObs``: each peer keeps a metrics registry (``metrics()`` is its
snapshot; ``_obs_collect`` samples everything that is not a live
instrument) registered with the process hub under ``peer-<obs_id>``. Its
histograms ``st_ack_rtt_seconds``, ``st_encode_seconds`` and
``st_apply_seconds`` are observed on the device and Python host tiers (on
the device tier they time the host work around kernels A and B and their
copies, never device time; the engine reports none of them per message),
and those tiers also keep the live ``st_retransmit_msgs_total``,
``st_dedup_discards_total`` and ``st_update_hops``. Its receive thread
runs the housekeeping beat: the native ring's drain every
``native_drain_interval_sec``, the subtree's metrics digest up the tree
(DIGEST) every ``digest_interval_sec``, the uplink's clock probe (CLOCK)
every ``clock_sync_interval_sec``, and at a root the ``cluster_json_path``
write and the health analyzer (``health_json_path``). A parent merges its
children's digests (JAX children's too) and answers their probes; on the
engine both arrive through ``poll_ctrl``. Digests and probes are off on
the reference wire and under v1 framing. Every stamp another node compares
(trace stamps, probes, digest times, FRESH marks) reads ``_now_ns``, the
monotonic clock plus the simulated skew (``ST_CLOCK_SKEW_SEC`` or
``ObsConfig.clock_skew_sim_sec``); the engine stamps its own adds on the
native clock, as JAX's does. A go-back-N teardown and a receive-thread
exception dump a postmortem.

The cluster lifecycle (``Config.lifecycle``), as the JAX peer's:

- ``snapshot_cluster`` at the root: a consistent cut with empty channels.
  The root pauses its own production; each node that enters the barrier
  pauses (synchronously: the Python send loop's in-flight pass and the
  engine's are waited out), and once every frame it sent before the pause
  is acknowledged floods a SNAP marker down its writer links, so per-link
  FIFO puts the marker behind its last pre-cut data. A node whose
  children have all acked (SNAP_ACK) and whose ledgers and send queues
  are empty writes its shard (``utils/checkpoint.save_cluster_shard``, the
  device tier's tensors taken to the host once, at the cut) and acks up;
  the root writes ``MANIFEST.json`` and releases the tree with RESUME. A
  barrier past its budget, or a node whose RESUME never comes, resumes
  anyway: a lifecycle operation may fail, the cluster never stays paused.
- ``restore_cluster``: the same barrier, with each node loading its shard
  at the cut instead (``SharedTensor.restore_state``, or the engine's
  ``restore_ex``); subscriber links are re-seeded from the restored
  replica. ``LifecycleConfig.restore_path`` restarts a node from its shard
  before the data plane starts: the replica, and on a joiner the uplink's
  residual and the carry as the re-graft carry.
- ``drain_node``: a CTL routed down the tree to the named node, which runs
  ``leave()``; the root also polls ``LifecycleConfig.ctl_dir`` for the
  commands of ``python -m shared_tensor_tpu_torch.ctl``.

All barrier state belongs to the receive thread (``_lc_tick`` on each of
its passes, and the SNAP, SNAP_ACK, RESUME and CTL handlers; on the engine
these kinds come through ``poll_ctrl``); the public calls queue a request
and wait for its verdict.

A joiner that asks for the cluster-sharded tensor (``SYNC_FLAG_SHARD`` and
a claim in its SYNC tail) is attached as a plain writer child, as JAX's
classic peer does: the claim is ignored, the WELCOME carries no shard flag,
and the joiner falls back to this protocol (``shard/``). Any message kind
the peer does not speak is logged, counted and dropped.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

import numpy as np

from .. import compat
from .. import obs as _obs
from ..config import Config
from ..obs import aggregate
from ..obs import events as _events
from ..obs import schema as _schema
from ..obs.clock import ClockSync
from ..obs.health import HealthAnalyzer
from ..core import SharedTensor, resolve_device
from ..ops.table import make_spec
from . import faults, wire
from .engine import EngineTensor, engine_eligible
from .transport import SHM_JOIN_FAILURES, SHM_SERVE_FAILURES, EventKind, TransportNode

log = logging.getLogger("shared_tensor_tpu_torch.peer")

#: Pseudo-link id of the re-graft carry: a dead uplink's residual (its
#: unacknowledged frames rolled back) parks here as a live slot that keeps
#: absorbing add() and flood mass while the node is orphaned, and the next
#: uplink's handshake hands it on. Never a transport link id (those start
#: at 1); the send loop and drain skip it.
CARRY_LINK = -1
#: Go-back-N send window: most unacknowledged DATA/BURST messages per link
#: before the send loop stops producing frames for it.
SEND_WINDOW = 32
#: Messages re-sent per retransmission round (the head of the tail is what
#: restores in-order progress at the receiver).
RETX_PREFIX = 4
#: Most frames a subscriber link's burst quantizes in one pass (the
#: engine's kSubBurstCap, whose message carries them all).
SUB_BURST_CAP = 32
#: Most messages a subscriber link of either Python tier has in its
#: transport send queue: its bursts go out one message a frame, and the
#: frames the queue cannot take yet wait, quantized, for the peer's sub-push
#: thread, so the subscriber's backlog is a few frames, not a few bursts,
#: and the send thread never waits on a slow subscriber.
SUB_QUEUED_MSGS = 2
#: Frames a subscriber link's sockets hold, each way's kernel buffer: the
#: writer caps its socket's send buffer at this many of the link's frames,
#: and the subscriber its receive buffer (``serve.Subscriber``). With the
#: send queue's cap and the subscriber's 2-message receive queue, a link's
#: in flight is a few frames, so what the subscriber applies is a few
#: frames' apply time behind the writer (the kernel's autotuned buffers
#: held hundreds of small frames).
SUB_SOCKET_FRAMES = 2
#: Least bytes a subscriber link's socket buffers each way: a kernel buffer
#: of a few hundred bytes stalled the link's TCP flow for seconds.
SUB_SOCKET_MIN_BYTES = 8192


def sub_socket_bytes(spec, word_cnt: Optional[int] = None) -> int:
    """The kernel buffer each socket of a subscriber link asks for:
    SUB_SOCKET_FRAMES of its frames (a range's RDATA with ``word_cnt``),
    at least SUB_SOCKET_MIN_BYTES."""
    return max(SUB_SOCKET_FRAMES * wire.sub_frame_wire_bytes(spec, word_cnt), SUB_SOCKET_MIN_BYTES)


#: Host seconds by stage of the data path, under their metric names.
_TIMERS = (
    "st_send_loop_busy_seconds_total",
    "st_encode_seconds_total",
    "st_send_seconds_total",
    "st_decode_seconds_total",
    "st_apply_seconds_total",
)
#: Buckets of the st_update_hops histogram (the JAX peer's).
HOPS_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


_HOST_ID: Optional[bytes] = None


def _shm_host_id() -> bytes:
    """This host's 16-byte id for the shared-memory lane: the Linux boot
    id (a hash of the host name where it cannot be read). Two peers whose
    ids collide but cannot open each other's /dev/shm fail the segment's
    token check and keep TCP."""
    global _HOST_ID
    if _HOST_ID is None:
        try:
            import uuid

            with open("/proc/sys/kernel/random/boot_id") as f:
                _HOST_ID = uuid.UUID(f.read().strip()).bytes
        except (OSError, ValueError):
            import hashlib
            import socket

            _HOST_ID = hashlib.sha256(socket.gethostname().encode()).digest()[:16]
    return _HOST_ID


class SpecMismatch(ConnectionError):
    """The tree holds a different table layout, or refused this joiner."""


class _PeerObs:
    """One peer's observability bundle: a metrics registry (the live
    instruments below plus the peer's collector) registered with the
    process hub, and the peer's handle on the hub (flight recorder, native
    ring drain, postmortems). A peer with obs off holds None in its place.

    The histograms time host work per message on the device and Python
    host tiers; the engine's C threads never call into Python, and export
    their aggregates through the counters instead. So the live
    retransmit and dedup counters and the hops histogram exist on the
    Python tiers only: an engine peer's truth comes from the collector, and
    a live instrument of the same name would shadow it."""

    def __init__(self, peer: "SharedTensorPeer"):
        self.hub = _obs.hub()
        self.registry = _obs.Registry()
        h = self.registry.histogram
        self.ack_rtt = h("st_ack_rtt_seconds", help="ledger-append to cumulative-ACK-pop round trip")
        self.encode = h("st_encode_seconds", help="wire-encode latency per DATA/BURST")
        self.apply = h("st_apply_seconds", help="decode+apply latency per received batch")
        self.retransmits = self.dedup = self.hops = None
        if peer._engine is None:
            self.retransmits = self.registry.counter(
                "st_retransmit_msgs_total", help="go-back-N messages re-sent byte-identical"
            )
            self.dedup = self.registry.counter(
                "st_dedup_discards_total", help="duplicate/out-of-order data messages discarded unapplied"
            )
            self.hops = h("st_update_hops", buckets=HOPS_BUCKETS,
                          help="tree hops traversed by applied traced updates")
        self.digest_out = self.registry.counter(
            "st_digest_sends_total", help="cluster metrics digests sent up the tree"
        )
        self.digest_in = self.registry.counter(
            "st_digest_msgs_in_total", help="cluster metrics digests received from subtree links"
        )
        self.cluster_nodes = self.registry.gauge(
            "st_cluster_nodes", help="nodes represented in the latest merged cluster digest"
        )
        self.registry.register_collector(peer._obs_collect)
        self.label = f"peer-{peer.node.obs_id}"
        self.hub.register_registry(self.label, self.registry)
        ocfg = peer.config.obs
        self.drain_interval = ocfg.native_drain_interval_sec
        if ocfg.jsonl_path:
            self.registry.start_jsonl_sink(ocfg.jsonl_path, ocfg.jsonl_interval_sec)
        # on the engine, the C receiver's trace_apply ring events carry
        # (origin << 8 | hop): a drain tap takes this peer's out of each
        # batch, so the origin of each link's freshest update is known
        # there too (the Python tiers note it in _note_trace)
        self._peer = peer
        self._tap = self._on_native_batch if peer._engine is not None else None
        if self._tap is not None:
            self.hub.add_tap(self._tap)

    def _on_native_batch(self, batch) -> None:
        peer = self._peer
        me = peer.node.obs_id
        for e in batch:
            if e.name == "trace_apply" and e.node == me:
                peer._stale_origin[e.link] = e.extra >> 8

    def event(self, name: str, node: int = 0, link: int = 0, arg: int = 0, detail: str = "",
              extra: int = 0) -> None:
        self.hub.emit(name, node=node, link=link, arg=arg, detail=detail, extra=extra)

    def close(self) -> None:
        self.registry.stop_jsonl_sink()
        if self._tap is not None:
            self.hub.remove_tap(self._tap)
        self.hub.poll_native()  # the last drain: no event stays stranded in the ring
        self.hub.unregister_registry(self.label)


#: Frames a device-tier burst takes by default (``device_frame_burst=0``),
#: and a cascading Python host tier's (``frame_burst=0``), each capped by
#: ``wire.burst_frames_cap``.
AUTO_BURST = 16


def _python_tier_auto_burst(spec) -> int:
    """The Python host tier's auto burst without a cascade: each burst
    frame is a full synchronous rescan under the state lock, so only small
    tables, where the per-message cost dominates, burst. A cascading peer
    bursts :data:`AUTO_BURST` frames at any size: a round of up to
    ``cascade_frames`` frames is one pass."""
    if spec.total <= (1 << 15):
        return max(24, min(128, (1 << 19) // max(1, spec.total)))
    return 1


class SharedTensorPeer:
    """One node of the shared tensor: joins the tree at (host, port), or
    becomes its master if nobody answers, then streams codec frames.

    The master seeds the shared state from ``template``; a joiner's
    ``template`` (torch tensors or numpy arrays) only gives the layout,
    and the state streams in from the tree. ``device=None`` is the GPU and
    raises without one; the tests pass ``device="cpu"``. ``host_tier=True``
    runs the host tier on the CPU: the native engine, unless one of the
    engine's conditions (``engine_eligible``) is unmet, which puts the peer
    on the Python host tier: ``Config.native_engine`` False,
    ``CodecConfig.suppress_zero_frames`` False (the engine sends no idle
    frames) or ``Config.sync_interval_sec`` > 0 (its sender does not
    pace). The tier is logged at creation. A failed build of the engine (or
    of the codec) raises; nothing falls back to another tier."""

    def __init__(
        self, host: str, port: int, template: Any, config: Config | None = None, device=None,
        host_tier: bool = False,
    ):
        self.config = config or Config()
        tcfg = self.config.transport
        codec = self.config.codec
        dev = resolve_device(device, host_tier)  # before any socket: no GPU, no node
        spec = make_spec(template)
        self._compat = tcfg.wire_compat
        if self._compat and spec.num_leaves != 1:
            raise ValueError("wire-compat mode syncs one flat tensor per port; use the native wire for tables")
        # the DATA/BURST framing emitted: v2 (traced) unless ST_WIRE_TRACE=0
        self._wire_version = compat.WIRE_VERSION_V1 if self._compat else compat.wire_protocol_version(self.config)
        self._trace_wire = self._wire_version >= compat.WIRE_VERSION_V2
        cap = wire.burst_frames_cap(spec)
        use_engine = engine_eligible(self.config, host_tier)
        # frames a burst quantizes per pass (the engine's cascade); a
        # reference frame is re-measured every frame
        cascade = 1 if self._compat else codec.cascade_frames
        # bursts have no idle frames to send: without suppression, stream
        burstable = codec.suppress_zero_frames
        if not burstable:
            self._burst = 1
        elif self._compat:
            # K reference frames back to back in one message are K frames
            # to any reference peer: only the engine bursts them, within
            # the BURST byte budget
            ccap = wire.compat_burst_frames_cap(spec.total_n)
            self._burst = (ccap if self.config.frame_burst == 0 else min(max(1, self.config.frame_burst), ccap)) \
                if use_engine else 1
        elif self.config.frame_burst == 0 and use_engine:
            self._burst = cap  # the engine fills the wire message budget
        elif self.config.frame_burst == 0:
            # a cascading Python host tier bursts as the device tier does;
            # without a cascade it bursts small tables only
            self._burst = min(AUTO_BURST, cap) if cascade > 1 else _python_tier_auto_burst(spec)
        else:
            self._burst = max(1, self.config.frame_burst)
        if not self._compat:
            self._burst = min(self._burst, cap)  # every peer's receive bound
        if host_tier or not burstable or self._compat:
            self._burst_device = 1
        elif self.config.device_frame_burst == 0:
            self._burst_device = min(AUTO_BURST, cap)
        else:
            self._burst_device = max(1, min(cap, self.config.device_frame_burst))
        # one receive batch (one flood apply) takes at most one full burst
        self._batch_cap = cap
        # every peer sizes its receive buffer for the largest message of
        # this spec any peer may send (handshake-identical layout); under
        # compat the transport frames by the reference frame's size
        frame_bytes = wire.compat_frame_bytes(spec.total_n) if self._compat else wire.frame_wire_bytes(spec)
        self.node = TransportNode(
            host,
            port,
            tcfg,
            frame_bytes=frame_bytes,
            max_children=tcfg.max_children,
            keepalive_sec=min(1.0, max(0.05, tcfg.peer_timeout_sec / 4)),
        )
        self.is_master = self.node.is_master
        # fault injection at the data send boundary (None when off: a send
        # pays one None check); corrupt() is given the frame geometry and
        # the v2 trace, so its flips land in sign words
        self._faults: Optional[faults.FaultPlan] = (
            faults.FaultPlan(
                self.config.faults, scale_bytes=4 * spec.num_leaves, wire_compat=self._compat,
                trace_bytes=wire.TRACE_BYTES if self._trace_wire else 0,
            )
            if self.config.faults.enabled
            else None
        )
        # sign2 on the engine's native-framing links only (compat.sign2_mode
        # is the config and ST_SIGN2 policy); advertised in SYNC and WELCOME
        self._sign2_mode = compat.sign2_mode(self.config) if use_engine and not self._compat else 0
        self._sign2 = self._sign2_mode != 0
        # the native engine's links (its receiver consumes their DATA, BURST
        # and ACK; the Python loops leave them alone)
        self._engine: Optional[EngineTensor] = None
        self._engine_links: set[int] = set()
        try:
            if use_engine:
                self.st = self._engine = EngineTensor(
                    template, codec, seed_values=self.is_master, node=self.node,
                    burst=self._burst, recv_cap=frame_bytes,
                    quarantine_send_failures=tcfg.quarantine_send_failures,
                    ack_timeout_sec=tcfg.ack_timeout_sec, ack_retry_limit=tcfg.ack_retry_limit,
                    cascade_frames=cascade,
                    compat_frame_bytes=frame_bytes if self._compat else 0,
                    trace_wire=self._trace_wire, precision_mode=self._sign2_mode,
                    precision_up_ratio=codec.precision_up_ratio, precision_down_ratio=codec.precision_down_ratio,
                    precision_interval_sec=codec.precision_interval_sec,
                )
            else:
                self.st = SharedTensor(
                    template, self.config.codec, seed_values=self.is_master, device=dev, host_tier=host_tier,
                    cascade=cascade,
                )
        except BaseException:
            self.node.close()
            raise
        log.info(
            "peer on the %s", "native engine" if use_engine else ("Python host tier" if host_tier else f"{dev} tier")
        )
        fcfg = self.config.faults
        if use_engine and fcfg.enabled and not os.environ.get("ST_FAULT_PLAN") and any((
            fcfg.drop_pct, fcfg.dup_pct, fcfg.truncate_pct, fcfg.corrupt_pct, fcfg.delay_pct,
            fcfg.stall_after_frames >= 0, fcfg.sever_after_frames,
        )):
            # the engine's C sender never crosses the Python send boundary:
            # a chaos run that forgot the env string would inject nothing
            log.warning(
                "FaultConfig wire faults are set but the native engine owns this peer's data plane: they inject "
                "nothing on engine links; render them into the environment with faults.to_env() around the "
                "node's creation (crash points still fire)"
            )
        # the cluster lifecycle. Barrier state belongs to the receive thread
        # (_lc_tick and the SNAP/SNAP_ACK/RESUME handlers); the public calls
        # queue a request and wait on _lc_done. _paused gates new production
        # on every tier while what is in flight keeps draining: the cut is
        # "paused + every ledger empty". _send_pass counts the Python send
        # loop's passes, so a pause waits out the pass in flight (_set_paused)
        self._lc_requests: deque = deque()
        self._lc_api_mu = threading.Lock()  # one barrier request at a time
        self._lc_op: Optional[dict] = None
        self._lc_done = threading.Event()
        self._lc_result: Optional[dict] = None
        self._paused = False
        self._pause_deadline = 0.0
        self._send_pass = 0
        self._snap_total = 0
        self._snap_acks = 0
        self._snap_last_dur = 0.0
        self._restore_total = 0
        self._drain_total = 0
        self._draining = False
        self._lc_errors = 0
        self._ctl_last_poll = 0.0
        self._restored_from: Optional[str] = None
        if self.config.lifecycle.restore_path:
            # the full-cluster restart: this node's shard loads before the
            # data plane starts (no thread runs yet)
            try:
                self._restore_at_startup(self.config.lifecycle.restore_path)
            except BaseException:
                if self._engine is not None:
                    self._engine.stop()
                self.node.close()
                if self._engine is not None:
                    self._engine.destroy()
                raise
        # v2 trace stamp (origin node, origin monotonic ns, hops) sent with
        # every DATA/BURST: re-seeded by add(), advanced by each applied
        # traced message. A tuple, assigned whole.
        self._trace_stamp: Optional[tuple[int, int, int]] = None
        # _sub_stamp: the newest origin stamp of every update folded in so
        # far, own and relayed: what a subscriber link's frames carry
        self._sub_stamp: Optional[tuple[int, int, int]] = None
        self._ready = threading.Event()
        self._error: Optional[Exception] = None
        if self.is_master:
            self._ready.set()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._close_mu = threading.Lock()
        self._closed = False
        # parent side of the handshake: link -> snapshot being received
        self._pending: dict[int, bytearray] = {}
        # child side: the snapshot sent to the parent ("state the tree has
        # from us" = replica - carry), kept until WELCOME seeds the uplink
        # with replica_now - snapshot; and, if the uplink died mid-
        # handshake, that snapshot as the base of the carry (values - base,
        # computed at the next join so orphan-period adds are in it)
        self._sent_snapshot = None
        self._mid_handshake_base = None
        self._sealed = False  # leave(): discard incoming data unacknowledged
        # compat: a leaf that lost its uplink resets to its carry at the
        # re-graft (set at LINK_DOWN, consumed at the next LINK_UP)
        self._compat_reset_on_regraft = False
        # compat: links whose LINK_UP opened their codec link. The receive
        # loop leaves a link's frames queued until then: a child's frame
        # applied before its link is seeded with the whole replica would
        # come back to it in that seed
        self._compat_open: set[int] = set()
        # capabilities the peer on each link advertised, gathered in the
        # handshake and consumed at the attach: it decodes sign2; it is on
        # our host and its lane is wanted; it decodes v3 (the SHM flag)
        self._peer_sign2: dict[int, bool] = {}
        self._peer_shm: dict[int, bool] = {}
        self._peer_r14: dict[int, bool] = {}
        self._shm_ok = (
            tcfg.shm_enabled
            and not self._compat
            and sys.platform.startswith("linux")
            and os.path.isdir("/dev/shm")
            and os.environ.get("ST_SHM", "1") != "0"
        )
        self._shm_host = _shm_host_id() if self._shm_ok else b""
        self._shm_fallbacks = 0
        self._uplink: Optional[int] = None
        # a severed uplink's applied prefix (wire.SYNC_FLAG_PREV_LINK),
        # between the peers of this package, every tier: the roll-back at
        # LINK_DOWN puts every unacknowledged frame into the carry, yet
        # the parent may have applied some (its ACK lost with the link, or
        # never sent). The child keeps those frames by wire seq (_kept: the
        # severed link's token and [(seq, frames)]; on the engine the
        # frames stay in C, _kept[1] is None) until the next WELCOME, which
        # reports how many the parent applied, and retracts them. A parent
        # records each child link's SYNC tokens (_link_token: its own and
        # its previous link's) and, once the link is down, the messages it
        # applied (_gone_applied; on the engine the count C kept until the
        # link's detach). The reference wire has no ledger to keep
        self._prev_link_ok = not self._compat
        self._uplink_token = 0
        self._kept: Optional[tuple[int, Optional[list]]] = None
        self._link_token: dict[int, tuple[int, int]] = {}
        self._gone_applied: dict[int, int] = {}
        self._carry_frames_rolled = 0
        self._carry_frames_retracted = 0
        # the serving tier's writer side. _sub_links: attached read-only
        # links -> their word range (None: the whole table); unledgered
        # (no ACK ever comes), and set BEFORE the codec link opens so the
        # send loop never takes the ledgered path for one. _pending_sub:
        # a read-only SYNC's handshake until its DONE (the RANGE received
        # so far). _sub_fresh: the last FRESH mark's time per link.
        # _sub_mask_ver: state_version at a ranged link's last mask.
        # _sub_mu: a lock per subscriber link, under which its send pass
        # (quantize to send), its (re-)attach and its LINK_DOWN cleanup
        # exclude each other, so a frame of the old residual is never sent
        # after the re-seed that supersedes it. Per link, so a send pass
        # that waits on one subscriber's full queue never holds up the
        # receive thread's handling of another (link ids are not reused).
        self._sub_links: dict[int, Optional[tuple[int, int]]] = {}
        self._pending_sub: dict[int, Optional[tuple[int, int]]] = {}
        self._sub_fresh: dict[int, float] = {}
        self._sub_mask_ver: dict[int, int] = {}
        self._sub_mu: dict[int, threading.Lock] = {}
        # _sub_held: a device-tier subscriber burst's frames not yet queued
        # (ledger seq, payloads in wire order), until the last goes
        self._sub_held: dict[int, tuple[int, deque]] = {}
        self._sub_push_wake = threading.Event()
        self._sub_msgs_out = 0
        self._sub_fresh_out = 0
        # delivery ledger per link: (ledger seq, wire seq, payload, slot,
        # sent at) in wire-seq order. The send thread appends, the receive
        # thread pops on ACK; the payload is a view of its pool slot, kept
        # for byte-identical retransmission.
        self._ack_mu = threading.Lock()
        self._unacked: dict[int, list] = {}
        per = wire.frame_payload_bytes(spec)
        k_max = max(self._burst_device, self._burst if host_tier else 1)
        self._tx_pool = wire.FramePool(
            max(wire.DATA_HDR_T + per, wire.BURST_HDR_T + k_max * per),
            keep=max(1, int(self.config.frame_pool_keep)),
        )
        self._tx_seq: dict[int, int] = {}
        self._acked: dict[int, int] = {}
        self._rx_count: dict[int, int] = {}
        self._ack_sent: dict[int, int] = {}
        self._ack_progress: dict[int, float] = {}
        self._retx_rounds: dict[int, int] = {}
        # counters and host-side seconds by stage, for metrics()
        self._retransmits = 0
        self._dedup = 0
        self._unknown_msgs = 0
        # faults the receive path survives: frames dropped because their
        # apply raised (acknowledged all the same, so never re-sent),
        # messages whose handler raised, and restarts of the recv loop
        self._apply_dropped = 0
        self._msg_errors = 0
        self._recv_restarts = 0
        self._data_bytes_out = 0
        self._data_bytes_in = 0
        self._link_frames_out: dict[int, int] = {}
        self._secs = dict.fromkeys(_TIMERS, 0.0)
        # the observability plane. Per link: the origin generation stamp and
        # hops of the latest traced apply (the Python tiers; the collector
        # ages it live, so a stalled link's staleness grows) and the origin
        # node of that update (on the engine too, through the ring's tap);
        # each child link's latest digest, merged at the next build
        ocfg = self.config.obs
        self._staleness: dict[int, tuple[int, int]] = {}
        self._stale_origin: dict[int, int] = {}
        self._traced_in = 0
        self._child_digests: dict[int, dict] = {}
        # digests and probes ride typed control messages, which the
        # reference wire has not, and presume a peer of the v2 framing: a
        # peer pinned to v1 must not send kinds an older parent would log
        # as unknown every beat
        beats = not self._compat and self._wire_version >= compat.WIRE_VERSION_V2
        self._digest_interval = ocfg.digest_interval_sec if beats else 0.0
        self._clock_interval = ocfg.clock_sync_interval_sec if beats else 0.0
        self._digest_last = 0.0
        self._clock_last = 0.0
        # the simulated skew of this node's cross-node stamps (tests and
        # benches: a real skew for the offset estimator on one host)
        skew_env = os.environ.get("ST_CLOCK_SKEW_SEC", "")
        self._skew_ns = int(float(skew_env if skew_env else ocfg.clock_skew_sim_sec) * 1e9)
        # a master is the tree's root (offset 0 +- 0); a joiner probes its
        # uplink. The health analyzer runs at a root with a health path
        self._clock = ClockSync(self._now_ns, is_root=self.is_master)
        self._health = None
        if self.is_master and ocfg.health_json_path:
            self._health = HealthAnalyzer(
                path=ocfg.health_json_path, history=ocfg.health_history, objective_sec=ocfg.staleness_slo_sec,
                budget=ocfg.slo_budget, windows=ocfg.slo_windows, skew_ratio=ocfg.heat_skew_ratio,
                emit=self._health_event,
            )
        self._obs: Optional[_PeerObs] = None
        if _obs.obs_enabled() and ocfg.enabled:
            self._obs = _PeerObs(self)
        # on the engine, its own sender thread sends on every link
        self._threads = (threading.Thread(target=self._recv_loop, daemon=True, name="st-recv"),)
        self._send_thread: Optional[threading.Thread] = None
        if self._engine is None:
            self._send_thread = threading.Thread(target=self._send_loop, daemon=True, name="st-send")
            self._threads += (self._send_thread,)
            self._threads += (threading.Thread(target=self._sub_push_loop, daemon=True, name="st-sub-push"),)
        for t in self._threads:
            t.start()

    # -- user API ----------------------------------------------------------------

    def read(self) -> Any:
        """A copy of the shared state: the template's tree of torch tensors
        on this peer's device (the CPU on the host tier)."""
        return self.st.read()

    def add(self, delta: Any) -> None:
        """Merge an additive update: visible here at once, streamed to every
        peer asynchronously."""
        self.st.add(delta)
        if self._engine is None:  # the engine stamps inside its add
            self._trace_stamp = self._sub_stamp = (self.node.obs_id, self._now_ns(), 0)
        self._wake.set()
        self._sub_push_wake.set()

    def wait_ready(self, timeout: float = 30.0) -> None:
        """Block until joined and the state stream is flowing."""
        if not self._ready.wait(timeout):
            if self._error is not None:
                raise self._error
            raise TimeoutError(f"not ready after {timeout}s")
        if self._error is not None:
            raise self._error

    def drain(self, timeout: float = 60.0, tol: float = 0.0) -> bool:
        """Block until every link's residual is down to ``tol`` RMS, the
        send queues are empty and every sent message is acknowledged: then
        every local update lives in the neighbours' replicas and close()
        loses nothing. A node below the root is not drained while its
        uplink has no codec link: orphaned, it holds what it owes the tree
        in its carry, and mid-handshake in what its snapshot did not claim,
        neither of which any link carries until the re-graft's WELCOME.
        Sealed by :meth:`leave`, such a node owes only its uplink, and each
        poll drops its children's links from the codec. The pow2 scale
        flushes subnormal RMS to 0, so after long add sequences pass a tiny
        ``tol`` (1e-30)."""
        deadline = time.time() + timeout
        # the engine quiesces in microseconds; the Python tiers need the
        # coarser poll to stay off their state lock
        poll = 0.005 if self._engine is not None else 0.05

        def owes_nothing(links) -> bool:
            return all(self.st.residual_rms(l) <= tol for l in (*links, CARRY_LINK))

        while time.time() < deadline and not self._stop.is_set():
            if self._sealed and not self.is_master:
                self._drop_child_links()  # leave(): a child may have joined since the seal
            links = [l for l in self.st.link_ids if l >= 0]
            if (self.is_master or self._uplink in links) and owes_nothing(links):
                stats = [self.node.stats(l) for l in self.node.links]
                # the receive thread moves a dead uplink's unacknowledged
                # frames into the carry: the residuals are read again after
                # the ledger, over the same links, so frames that left the
                # ledger between the two reads are seen where they went
                if all(s is None or s.send_queue == 0 for s in stats) and self.st.inflight_total() == 0 \
                        and [l for l in self.st.link_ids if l >= 0] == links and owes_nothing(links):
                    return True
            time.sleep(poll)
        return False

    def leave(self, timeout: float = 60.0, tol: float = 1e-30) -> bool:
        """Graceful exit that loses nothing mid-stream: seal (incoming data
        is discarded unacknowledged, so its senders re-deliver it around
        us), drain what we owe, close. Below the root we owe only our
        uplink: the drain drops the children's links from the codec (those
        that join after the seal too), since each child re-grafts with a
        diff handshake that brings it what the tree holds and it lacks, and
        a child that is leaving too discards our frames unacknowledged, so
        waiting on it would wait out the timeout. The root drains every
        link. Returns the drain's verdict."""
        if self._engine is not None:
            self._engine.seal()  # the engine puts its seal on the ring
        elif self._obs is not None:
            self._obs.event("seal", self.node.obs_id)
        self._sealed = True
        ok = self.drain(timeout=timeout, tol=tol)
        self.close()
        return ok

    def _drop_child_links(self) -> None:
        """A sealed node's children's links leave the codec, their residuals
        and ledgers with them; the transport links stay up until close().
        An engine link goes back to the Python receive loop, which discards
        its data while sealed. Subscriber links stay: unledgered, they
        drain without waiting on anyone."""
        for link in [l for l in self.st.link_ids if l >= 0 and l != self._uplink and l not in self._sub_links]:
            if self._engine is not None:
                self._engine.drop_link(link)
                self._engine_links.discard(link)
                continue
            self.st.drop_link(link)
            with self._ack_mu:
                purged = self._unacked.pop(link, ())
            self._release_slots(purged)

    def close(self) -> None:
        """Leave the tree; the other peers re-graft and carry on. Once: a
        second call (a routed drain closes the peer on a thread of its own)
        waits for the first to finish and returns."""
        self._stop.set()
        self._wake.set()
        self._sub_push_wake.set()
        with self._close_mu:
            if self._closed:
                return
            for t in self._threads:
                t.join(timeout=5.0)
            if self._engine is not None:
                # its threads wait inside the node's queues: stop them first
                self._engine.stop()
            if self._obs is not None:
                # the last drain and the registry's teardown, before the node
                # closes, so the close path's events merge in
                self._obs.close()
            self.node.close()
            if self._engine is not None:
                self._engine.destroy()
            self._closed = True

    def pause(self, paused: bool = True) -> None:
        """Stop (or resume) producing new frames; what is already quantized
        (the device tier's pipeline) still goes out, and what is in flight
        is still delivered and acknowledged. Returns once the sender's pass
        in flight is over (the engine's, or the Python send loop's), so no
        new frame is quantized after this returns. A lifecycle barrier's
        release resumes the peer too."""
        self._set_paused(paused, expire=False)

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def threads_alive(self) -> bool:
        """The peer's Python threads are running: receive and send (and on
        the device tier sub-push), or on the engine receive only."""
        return all(t.is_alive() for t in self._threads)

    def metrics(self, cluster: bool = False) -> dict:
        """The peer's metrics under the schema's names (``obs/schema.py``):
        the registry's snapshot (its live histograms and counters, and the
        collector :meth:`_obs_collect`), or the collector alone with obs
        off. ``cluster=True`` returns the merged digest of this node's
        subtree instead (:meth:`cluster_metrics`); at the root, the whole
        tree's.

        The counters: ``st_frames_*`` count non-idle codec frames,
        ``st_msgs_*`` DATA/BURST messages, ``st_link_*`` the transport's
        per-link totals of live links, control messages and framing
        included. The port's own names (the schema's last section) add the
        non-idle frames sent per link, ever; the receive faults survived
        (``st_apply_dropped_total``, ``st_msg_errors_total``,
        ``st_recv_restarts_total``, ``st_unknown_msgs_total``; 0 on a healthy
        peer); the shared-memory lane's ring bytes and failed attaches; the
        frames of severed uplinks rolled into the carry and those retracted
        as already applied (``st_carry_frames_*_total``); and
        the host seconds spent per stage of the data path
        (``st_*_seconds_total``)."""
        if cluster:
            return self.cluster_metrics()
        if self._obs is not None:
            return self._obs.registry.snapshot()
        return self._obs_collect()

    def _obs_collect(self) -> dict:
        """The registry's collector: everything the peer reports that is
        not a live instrument, sampled at each snapshot."""
        if self._engine is not None:
            # one counter snapshot: separate reads would mix instants
            c = self._engine.counters()
            frames_out, frames_in, updates, msgs_out, msgs_in = (int(x) for x in c[:5])
            retransmits, dedup = int(c[8]), int(c[9])
        elif self._compat:
            # no ledger in the reference protocol: one frame, one message
            frames_out, frames_in, updates = self.st.frames_out, self.st.frames_in, self.st.updates
            msgs_out, msgs_in = frames_out, frames_in
            retransmits, dedup = self._retransmits, self._dedup
        else:
            with self._ack_mu:
                msgs_out = sum(self._acked.values()) + sum(len(v) for v in self._unacked.values())
                msgs_in = sum(self._rx_count.values())
            frames_out, frames_in, updates = self.st.frames_out, self.st.frames_in, self.st.updates
            retransmits, dedup = self._retransmits, self._dedup
        out = {
            "st_frames_out_total": frames_out,
            "st_frames_in_total": frames_in,
            "st_updates_total": updates,
            "st_msgs_out_total": msgs_out,
            "st_msgs_in_total": msgs_in,
            "st_inflight_msgs": self.st.inflight_total(),
            "st_retransmit_msgs_total": retransmits,
            "st_dedup_discards_total": dedup,
            "st_unknown_msgs_total": self._unknown_msgs,
            "st_apply_dropped_total": self._apply_dropped,
            "st_msg_errors_total": self._msg_errors,
            "st_recv_restarts_total": self._recv_restarts,
            "st_data_bytes_out_total": self._data_bytes_out,
            "st_data_bytes_in_total": self._data_bytes_in,
            "st_corrupt_scales_zeroed_total": wire.corrupt_scales_zeroed(),
            "st_obs_events_dropped_total": _events.native_dropped(),
            "st_fetch_wait_seconds_total": self.st.fetch_wait_s,
            "st_h2d_seconds_total": self.st.h2d_s,
            "st_apply_lock_wait_seconds_total": self.st.apply_lock_wait_s,
            "st_sub_links": len(self._sub_links),
            "st_sub_msgs_out_total": self._sub_msgs_out,
            "st_sub_fresh_out_total": self._sub_fresh_out,
            "st_shm_fallback_total": self._shm_fallbacks,
            "st_carry_frames_rolled_total": self._carry_frames_rolled,
            "st_carry_frames_retracted_total": self._carry_frames_retracted,
            "st_wire_version": self._wire_version,
            "st_clock_probes_total": self._clock.probes,
        }
        # the lifecycle rows (obs.top's, and ctl versions reads the wire
        # version above from the digest's per-node breakdown)
        op = self._lc_op
        out["st_lifecycle_paused"] = 1 if self._paused else 0
        out["st_snapshot_in_progress"] = (
            1 if op is not None and op.get("op") == "save" and op.get("release") is None else 0
        )
        out["st_snapshot_shards_acked"] = self._snap_acks
        out["st_snapshot_total"] = self._snap_total
        out["st_snapshot_last_duration_seconds"] = self._snap_last_dur
        out["st_restore_total"] = self._restore_total
        out["st_drain_in_progress"] = 1 if self._draining else 0
        out["st_drain_total"] = self._drain_total
        out["st_lifecycle_errors_total"] = self._lc_errors
        out.update(self._secs)
        tp = self.node.pool_stats()
        out["st_transport_tx_acquires_total"] = tp["tx_acquires"]
        out["st_transport_tx_misses_total"] = tp["tx_misses"]
        out["st_transport_rx_acquires_total"] = tp["rx_acquires"]
        out["st_transport_rx_misses_total"] = tp["rx_misses"]
        out["st_transport_zc_msgs_total"] = tp["zc_msgs"]
        # the L2 norm over every residual, the carry's too (owed mass): 0
        # when quiesced. The engine keeps its carry outside its link list
        links = list(self.st.link_ids)
        if self._engine is not None:
            links.append(CARRY_LINK)
        n = self.st.spec.total_n
        out["st_residual_norm"] = math.sqrt(sum(self.st.residual_rms(l) ** 2 * n for l in links))
        if self._engine is not None:
            out.update(self._engine.obs_stats())
            p = self._engine.pool_stats()
            out["st_tx_slot_acquires_total"] = p["tx_slot_acquires"]
            out["st_tx_slot_alloc_events_total"] = p["tx_slot_alloc_events"]
            out["st_tx_slots_allocated"] = p["tx_slots_allocated"]
            # staleness and hops of each link's latest traced apply, as the
            # C receiver recorded them (its age at the apply)
            for link in self.st.link_ids:
                lo = self._engine.link_obs(link) if link >= 0 else None
                if lo is not None and lo[1] > 0:
                    out[_schema.link_key("st_staleness_seconds", link)] = lo[0]
                    out[_schema.link_key("st_update_hops_last", link)] = lo[1]
                prec = self._engine.link_precision(link) if link >= 0 else 0
                if prec > 0:
                    out[_schema.link_key("st_link_precision", link)] = prec
        else:
            # aged now: a stalled link's staleness grows between applies
            now_ns = self._now_ns()
            for link, (gen, hop) in list(self._staleness.items()):
                out[_schema.link_key("st_staleness_seconds", link)] = max(0.0, (now_ns - gen) / 1e9)
                out[_schema.link_key("st_update_hops_last", link)] = hop
            out["st_traced_msgs_in_total"] = self._traced_in
        # the origin node of each link's freshest update and this node's
        # offset to the root: the health analyzer corrects staleness with both
        for link, origin in list(self._stale_origin.items()):
            out[_schema.link_key("st_staleness_origin", link)] = origin
        if self._clock.known:
            out["st_clock_offset_seconds"] = self._clock.offset_seconds
            out["st_clock_uncertainty_seconds"] = self._clock.uncertainty_seconds
        if self._health is not None:
            out.update(self._health.metrics())
        for link, n_frames in list(self._link_frames_out.items()):
            out[_schema.link_key("st_link_frames_out_total", link)] = n_frames
        for link in self.node.links:
            s = self.node.stats(link)
            if s is not None:
                out[_schema.link_key("st_link_bytes_out_total", link)] = s.bytes_out
                out[_schema.link_key("st_link_bytes_in_total", link)] = s.bytes_in
                out[_schema.link_key("st_link_wire_msgs_out_total", link)] = s.frames_out
                out[_schema.link_key("st_link_wire_msgs_in_total", link)] = s.frames_in
                out[_schema.link_key("st_link_residual_rms", link)] = self.st.residual_rms(link)
                out[_schema.link_key("st_link_send_queue", link)] = s.send_queue
                out[_schema.link_key("st_link_recv_queue", link)] = s.recv_queue
            # the link's sockets (when striped) and its shared-memory lane
            # (when mapped: its share of the link's traffic)
            st = self.node.stripe_stats(link)
            if st is not None and st["stripes"] > 1:
                out[_schema.link_key("st_stripe_count", link)] = st["stripes"]
                out[_schema.link_key("st_stripe_live", link)] = st["live"]
                out["st_stripe_deaths_total"] = out.get("st_stripe_deaths_total", 0) + st["deaths"]
                out["st_stripe_reroutes_total"] = out.get("st_stripe_reroutes_total", 0) + st["reroutes"]
            sh = self.node.shm_stats(link)
            if sh is not None and sh["state"] > 0:
                out[_schema.link_key("st_shm_active", link)] = sh["state"]
                out[_schema.link_key("st_shm_ring_bytes", link)] = sh["ring_bytes"]
                out["st_shm_msgs_out_total"] = out.get("st_shm_msgs_out_total", 0) + sh["msgs_out"]
                out["st_shm_msgs_in_total"] = out.get("st_shm_msgs_in_total", 0) + sh["msgs_in"]
                out["st_shm_bytes_out_total"] = out.get("st_shm_bytes_out_total", 0) + sh["bytes_out"]
                out["st_shm_bytes_in_total"] = out.get("st_shm_bytes_in_total", 0) + sh["bytes_in"]
        return out

    # -- the cluster lifecycle ----------------------------------------------------
    #
    # The consistent cut. The root pauses its own production and floods a
    # SNAP marker down every writer link; each node on SNAP pauses, forwards
    # the marker, waits for (a) every child's SNAP_ACK and (b) its own
    # ledgers to drain empty, then writes its shard (or loads it: op "load"
    # is the in-place restore) and acks up. The marker follows the sender's
    # last pre-pause data on its link, a child's SNAP_ACK follows its last
    # pre-capture data, and "ledger empty" means that everything sent was
    # applied: at every capture both ends of every link agree on the stream
    # and nothing is in flight, so a restore needs no seq surgery and no
    # re-send. Control messages are outside the fault plan's classes, so a
    # barrier completes under data-plane chaos too.
    #
    # The release. RESUME floods down the same links; the root returns only
    # once every port node below it has left its pause. A port parent asks
    # for it in its SNAP marker (``confirm_release``, a field JAX's decoder
    # ignores), a port child that was asked says so in its SNAP_ACK
    # (``confirms_release``) and, once resumed and once each of its own
    # confirming children has confirmed, sends one more SNAP_ACK up with
    # ``released`` set. A JAX child never confirms and is never waited for,
    # nor is a subtree under one; a child that dies mid-release, or is
    # still unconfirmed at the barrier's deadline, is named in the result's
    # ``unreleased``. JAX's root returns once its RESUME is sent.

    @property
    def node_name(self) -> str:
        """The stable lifecycle name (``LifecycleConfig.node_name``, else
        ``node-<obs_id>``, unique in the process)."""
        return self.config.lifecycle.node_name or f"node-{self.node.obs_id}"

    def snapshot_cluster(self, dirpath: str, snap_id: Optional[str] = None, timeout: Optional[float] = None) -> dict:
        """A consistent-cut snapshot of the whole tree into ``dirpath``, from
        the root: one shard per node and ``MANIFEST.json`` with each shard's
        sha256. Blocks until the barrier is over; the tree is resumed before
        this returns, on success, failure or timeout. Returns the result
        (``manifest``, ``duration_sec``, ``nodes``, ...)."""
        if self._uplink is not None:
            raise RuntimeError(
                "snapshot_cluster is root-initiated: this node has an uplink (use ctl against the root, or call it "
                "there)"
            )
        return self._lc_request(
            {"op": "save", "dir": str(dirpath), "id": str(snap_id or f"snap-{time.monotonic_ns():x}")}, timeout
        )

    def restore_cluster(self, dirpath: str, timeout: Optional[float] = None) -> dict:
        """An in-place restore of the live tree to the cut under ``dirpath``,
        from the root: the barrier of :meth:`snapshot_cluster`, but at the
        quiesced instant every node loads its shard (replica, the residuals
        of the links that still exist, the carry, the engine's precision
        state) instead of writing one. Wire seqs are never rewound: the
        drained ledgers make the restored residuals consistent pairwise.
        Subscriber links are re-seeded from the restored replica, so no FRESH
        mark verifies a read across the cut. Full fidelity needs the
        membership of the snapshot: residuals of links that are gone are
        dropped (their subtrees' own diff handshakes repaired that mass)."""
        from ..utils import checkpoint as ckpt

        problems = ckpt.verify_manifest(dirpath)
        if problems:
            raise ValueError(f"snapshot at {dirpath} fails its manifest audit: " + "; ".join(problems))
        if self._uplink is not None:
            raise RuntimeError("restore_cluster is root-initiated")
        return self._lc_request(
            {"op": "load", "dir": str(dirpath), "id": str(ckpt.load_manifest(dirpath).get("snap_id", "?"))}, timeout
        )

    def drain_node(self, target: str) -> None:
        """A planned migration: route a drain command (CTL) down the tree to
        ``target``, which then leaves gracefully (seal, drain what it owes,
        close); its children re-graft with no loss of mass. Fire and
        forget: ``obs.top``'s drain row and the membership events show the
        end."""
        if self._uplink is not None:
            raise RuntimeError("drain_node is root-initiated")
        if self._compat:
            raise RuntimeError("drain routing needs the native protocol's control plane")
        if str(target) == self.node_name:
            raise ValueError("cannot drain the root from itself: fail the root over first, or drain its children")
        if self._obs is not None:
            self._obs.event("ctl_cmd", self.node.obs_id, detail="drain")
        self._ctl_forward({"op": "drain", "target": str(target), "from": self.node_name}, exclude=None)

    def _lc_request(self, req: dict, timeout: Optional[float]) -> dict:
        """Queue a barrier for the receive thread and wait for its verdict.
        One request at a time (``_lc_api_mu``), and results are matched to
        requests by a uid: a caller that timed out leaves its barrier
        running, and that barrier's late verdict is never handed to the
        next caller."""
        if self._compat:
            raise RuntimeError(
                "the lifecycle barrier needs the native protocol's typed control plane: the reference wire "
                "format cannot carry it"
            )
        budget = timeout if timeout is not None else self.config.lifecycle.snapshot_timeout_sec
        req["req"] = uuid.uuid4().hex
        with self._lc_api_mu:
            req["deadline"] = time.monotonic() + budget
            req["budget_sec"] = budget
            self._lc_done.clear()
            self._lc_result = None
            self._lc_requests.append(req)
            self._wake.set()
            deadline = time.monotonic() + budget + 10.0
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"lifecycle {req['op']} barrier did not complete inside {budget} s (+grace)")
                if not self._lc_done.wait(min(remaining, 1.0)):
                    continue
                res = self._lc_result
                if res is not None and res.get("req") == req["req"]:
                    break
                self._lc_done.clear()  # an abandoned barrier's late verdict
        if not res.get("ok"):
            raise RuntimeError(f"lifecycle {req['op']} failed: {res.get('error')}")
        return res

    def _set_paused(self, paused: bool, expire: bool = True) -> None:
        """Quiesce (or resume) data production, synchronously across the
        sender's pass in flight on every tier: the engine's pause waits out
        its sender's pass, and here the Python send loop's pass counter must
        advance twice, since a pass already past its paused check when the
        flag lands may still quantize and send from pre-pause state, and the
        SNAP marker must follow the last such message on its link. With
        ``expire`` a pause that outlives ``pause_timeout_sec`` with no
        barrier is lifted by ``_lc_tick``."""
        if paused == self._paused:
            return
        self._paused = paused
        if self._engine is not None:
            self._engine.pause(paused)
        elif paused and self._send_thread is not None and self._send_thread.is_alive():
            g0 = self._send_pass
            deadline = time.monotonic() + 2.0
            while self._send_pass < g0 + 2 and time.monotonic() < deadline and not self._stop.is_set():
                self._wake.set()
                time.sleep(0.001)
        self._pause_deadline = time.monotonic() + self.config.lifecycle.pause_timeout_sec if paused and expire else 0.0
        if self._obs is not None:
            self._obs.event("lifecycle_pause" if paused else "lifecycle_resume", self.node.obs_id)
        self._wake.set()

    def _lc_children(self, exclude: Optional[int] = None) -> list[int]:
        """The writer links a barrier or a CTL floods: every attached codec
        link but the uplink, subscriber links (no shard, no drain: they
        re-seed from scratch) and ``exclude`` (the marker's source)."""
        up = self._uplink
        return [l for l in self.st.link_ids if l >= 0 and l != up and l != exclude and l not in self._sub_links]

    def _ctl_forward(self, doc: dict, exclude: Optional[int]) -> None:
        payload = wire.encode_lifecycle(wire.CTL, doc)
        for link in self._lc_children(exclude):
            try:
                self._send_blocking(link, payload)
            except Exception:
                log.exception("CTL forward failed on link %d", link)

    def _lc_begin(self, doc: dict, from_link: Optional[int]) -> None:
        """Enter a barrier (the receive thread). ``from_link`` is the uplink
        the SNAP marker came on; None at the root."""
        if self._lc_op is not None and self._lc_op.get("release") is not None:
            self._lc_release_done()  # a new barrier ends the last one's release wait
        if self._lc_op is not None:
            if doc.get("id") == self._lc_op["id"]:
                return  # a duplicate marker: already in it
            msg = f"{self.node_name}: lifecycle barrier overlap ({self._lc_op['id']} active, {doc.get('id')} refused)"
            log.warning(msg)
            self._lc_errors += 1
            if from_link is None:
                self._lc_result = {"ok": False, "error": msg, "req": doc.get("req")}
                self._lc_done.set()
            else:
                # a NACK, so the parent's barrier ends with the error named
                # instead of waiting on this subtree
                self._send_blocking(
                    from_link, wire.encode_lifecycle(wire.SNAP_ACK, {"id": doc.get("id"), "nodes": [], "errors": [msg]})
                )
            return
        lc = self.config.lifecycle
        op = {
            "op": doc.get("op", "save"),
            "id": str(doc.get("id")),
            "dir": str(doc.get("dir", "")),
            "req": doc.get("req"),
            "from": from_link,
            "t0": time.monotonic(),
            "deadline": doc.get("deadline"),
            # the root's remaining budget, as the marker carries it; a marker
            # without one falls back to the local pause timeout
            "budget": float(
                doc.get("budget_sec", lc.snapshot_timeout_sec if from_link is None else lc.pause_timeout_sec)
            ),
            "waiting": set(self._lc_children(from_link)),
            "entries": [],
            "errors": [],
            "marked": False,  # markers flood from _lc_tick once every pre-cut frame is delivered
            "captured": False,
            "acked": False,  # SNAP_ACK delivered (re-tried until it is)
            # the release (the comment above snapshot_cluster): whether our
            # parent asked us to confirm it, the children that will confirm
            # theirs, and each child's nodes (named if it never does)
            "confirm": bool(doc.get("confirm_release")) and from_link is not None,
            "confirming": set(),
            "subtree": {},
            "release": None,
        }
        self._lc_op = op
        self._set_paused(True)
        # the pause's safety deadline covers the barrier's whole budget (and
        # 5 s for the RESUME to come down): a captured child that resumed
        # mid-barrier would tear the cut the root then reports as good
        self._pause_deadline = time.monotonic() + op["budget"] + 5.0
        if self._obs is not None:
            self._obs.event("snap_begin", self.node.obs_id, arg=len(op["waiting"]), detail=op["op"])

    def _lc_mark_children(self, op: dict) -> None:
        """Flood the SNAP marker down, only once every data message this node
        sends before the cut has been delivered: the pause waited out the
        send pass in flight, and the ledger must be empty. On the device
        tier a frame enters the core's ledger when it is quantized
        (``begin_frame*``), so a frame still in the send loop's pipeline, its
        fetch pending, counts in ``inflight_total`` too: an empty ledger
        means an empty pipeline, and no separate gauge of it is kept. The
        ledger condition makes the cut sound under loss: a dropped frame's
        re-send would otherwise arrive after the marker, past the
        receiver's capture while our shard records it delivered."""
        if self.st.inflight_total() != 0:
            return  # undelivered pre-cut data; the re-send timer is on it
        op["marked"] = True
        now = time.monotonic()
        remaining = (
            op["deadline"] - now if op["from"] is None and op.get("deadline") else op["budget"] - (now - op["t0"])
        )
        fwd = wire.encode_lifecycle(
            wire.SNAP,
            {
                "op": op["op"], "id": op["id"], "dir": op["dir"], "parent": self.node_name,
                # the root's remaining budget rides the marker, so every
                # node's pause deadline covers the whole barrier
                "budget_sec": max(5.0, remaining),
                "confirm_release": True,
            },
        )
        for link in list(op["waiting"]):
            if not self._send_blocking(link, fwd):
                op["waiting"].discard(link)
                op["errors"].append(f"{self.node_name}: SNAP marker send failed on link {link}")

    def _lc_quiesced(self) -> bool:
        """Paused and nothing in flight: every ledger empty (our sends were
        applied) and every transport send queue drained (our markers and
        acks left)."""
        if self.st.inflight_total() != 0:
            return False
        for link in self.node.links:
            s = self.node.stats(link)
            if s is not None and s.send_queue != 0:
                return False
        return True

    def _lc_tick(self) -> None:
        """One pass of the barrier (the receive thread, every loop)."""
        while self._lc_requests:
            self._lc_begin(self._lc_requests.popleft(), None)
        op = self._lc_op
        now = time.monotonic()
        if op is not None and op.get("release") is not None:
            self._lc_release_tick(op, now)
            return
        if op is None:
            if self._paused and self._pause_deadline and now > self._pause_deadline:
                log.warning("lifecycle pause expired with no barrier; resuming")
                self._lc_errors += 1
                self._set_paused(False)
            self._ctl_poll(now)
            return
        if op["from"] is None:
            if op.get("deadline") and now > op["deadline"]:
                missing = sorted(op["waiting"])
                op["errors"].append(
                    f"{self.node_name}: barrier timeout (awaiting links {missing})" if missing
                    else f"{self.node_name}: barrier timeout (quiesce)"
                )
                self._lc_finish(ok=False)
                return
        elif now > self._pause_deadline:
            # no RESUME (the root or the parent died mid-barrier): resume
            # rather than stay frozen; the barrier is abandoned
            log.warning("lifecycle barrier %s: no RESUME before the pause deadline; resuming", op["id"])
            self._lc_errors += 1
            self._lc_op = None
            self._set_paused(False)
            return
        if not op["marked"]:
            self._lc_mark_children(op)
        if op["captured"]:
            if op["from"] is not None and not op["acked"]:
                self._lc_send_ack(op)  # re-try until delivered or abandoned
            return
        if not op["marked"] or op["waiting"] or not self._lc_quiesced():
            return
        # the subtree is done and this node is quiesced: its cut instant
        try:
            if op["op"] == "save":
                op["entries"].append(self._write_shard(op["dir"], op["id"]))
                self._snap_total += 1
            else:
                self._load_shard_inplace(op["dir"])
                op["entries"].append({"node": self.node_name, "restored": True})
                self._restore_total += 1
        except Exception as e:
            log.exception("lifecycle %s failed at %s", op["op"], self.node_name)
            op["errors"].append(f"{self.node_name}: {e!r}")
            self._lc_errors += 1
        op["captured"] = True
        if op["from"] is not None:
            self._lc_send_ack(op)  # and stay paused until the root's RESUME
        else:
            self._lc_finish(ok=not op["errors"])

    def _lc_send_ack(self, op: dict) -> None:
        # a parent that asked learns that this node will confirm its release
        extra = {"confirms_release": True} if op["confirm"] else {}
        doc = {"id": op["id"], "nodes": op["entries"], "errors": op["errors"], **extra}
        try:
            payload = wire.encode_lifecycle(wire.SNAP_ACK, doc)
        except ValueError:
            # the subtree's manifest is over the wire cap: the verdict goes
            # up without the entries, and the root fails the barrier naming
            # this node
            doc = {
                "id": op["id"], "nodes": [],
                "errors": op["errors"][:8] + [
                    f"{self.node_name}: subtree manifest exceeded the wire cap ({len(op['entries'])} shard entries "
                    "dropped)"
                ],
                **extra,
            }
            payload = wire.encode_lifecycle(wire.SNAP_ACK, doc)
        if self._send_blocking(op["from"], payload):
            op["acked"] = True

    def _lc_release(self, op: dict, result: Optional[dict] = None) -> None:
        """Resumed: wait for the confirming children's releases (the root
        then hands ``result`` over), up to the barrier's deadline."""
        deadline = op["deadline"] if op["from"] is None and op.get("deadline") else op["t0"] + op["budget"]
        op["release"] = {"waiting": set(op["confirming"]), "deadline": deadline, "unreleased": [], "result": result}
        self._lc_release_tick(op, time.monotonic())

    def _lc_release_tick(self, op: dict, now: float) -> None:
        rel = op["release"]
        alive = set(self.node.links)
        dead = sorted(link for link in rel["waiting"] if link not in alive)
        rel["waiting"].difference_update(dead)
        for link in dead:  # died mid-release: named, not waited for
            rel["unreleased"].extend(op["subtree"].get(link) or [f"link {link}"])
        if not rel["waiting"] or now > rel["deadline"]:
            self._lc_release_done()

    def _lc_release_done(self) -> None:
        """The release is over, or cut short by the deadline or a new
        barrier: name the children that did not confirm, then confirm it up
        if our parent asked, or hand the root's verdict over."""
        op, self._lc_op = self._lc_op, None
        rel = op["release"]
        for link in sorted(rel["waiting"]):
            rel["unreleased"].extend(op["subtree"].get(link) or [f"link {link}"])
        if op["from"] is None:
            result = rel["result"]
            if rel["unreleased"]:
                result["unreleased"] = rel["unreleased"]
            self._lc_result = result
            self._lc_done.set()
        elif op["confirm"]:
            doc = {"id": op["id"], "released": True, "nodes": [], "errors": [], "unreleased": rel["unreleased"]}
            try:
                self._send_blocking(op["from"], wire.encode_lifecycle(wire.SNAP_ACK, doc))
            except Exception:
                log.exception("release confirmation failed on link %d", op["from"])

    def _lc_finish(self, ok: bool) -> None:
        """The root's end of a barrier on every path: write the manifest (a
        save), release the tree, resume, and hand the verdict over once the
        port subtree has confirmed its release."""
        op = self._lc_op
        dur = time.monotonic() - op["t0"]
        result: dict = {
            "ok": ok, "op": op["op"], "id": op["id"], "req": op.get("req"), "dir": op["dir"], "duration_sec": dur,
            "nodes": len(op["entries"]), "errors": op["errors"],
        }
        if op["errors"]:
            result["error"] = "; ".join(str(e) for e in op["errors"])
        if ok and op["op"] == "save":
            from ..utils import checkpoint as ckpt

            try:
                result["manifest"] = ckpt.write_manifest(
                    op["dir"], op["id"], op["entries"], extra={"root": self.node_name, "duration_sec": dur}
                )
            except OSError as e:
                result["ok"] = False
                result["error"] = f"manifest write failed: {e}"
        self._snap_last_dur = dur
        resume = wire.encode_lifecycle(wire.RESUME, {"id": op["id"]})
        for link in self._lc_children():
            self._send_blocking(link, resume)
        self._set_paused(False)
        if self._obs is not None:
            self._obs.event("snap_done", self.node.obs_id, arg=result["nodes"], detail=op["op"])
        self._lc_release(op, result)  # the verdict goes out once the port subtree is released

    def _write_shard(self, dirpath: str, snap_id: str) -> dict:
        """This node's shard at the quiesced cut. The engine's capture is one
        native lock (``snapshot_ex``); the SharedTensor's is one state lock
        (``snapshot_all``), whose device tensors are taken to the host here,
        once. The per-link wire state comes from the ledger's seqs."""
        from ..utils import checkpoint as ckpt

        up = self._uplink
        if self._engine is not None:
            values, links, meta = self._engine.snapshot_ex()
        else:
            values, links = self.st.snapshot_all()
            with self._ack_mu:
                tx = dict(self._tx_seq)
            meta = {
                lid: {"tx_seq": tx.get(lid, 0), "rx_count": self._rx_count.get(lid, 0), "prec": 1,
                      "sub": lid in self._sub_links}
                for lid in links if lid >= 0
            }
        entries = []
        for lid, resid in links.items():
            if lid < 0:
                entries.append({"id": lid, "role": "carry", "resid": resid.cpu().numpy()})
                continue
            m = meta.get(lid, {})
            sub = bool(m.get("sub")) or lid in self._sub_links
            entries.append({
                "id": lid,
                "role": "up" if lid == up else ("sub" if sub else "child"),
                "tx_seq": m.get("tx_seq", 0),
                "rx_count": m.get("rx_count", 0),
                "prec": m.get("prec", 1),
                # a subscriber link keeps its meta only: it re-seeds from scratch
                "resid": None if sub else resid.cpu().numpy(),
            })
        entry = ckpt.save_cluster_shard(
            dirpath, self.node_name, snap_id, self.st.spec.layout_digest(), values.cpu().numpy(), entries,
            wire_version=self._wire_version,
        )
        if self._obs is not None:
            self._obs.event("snap_shard", self.node.obs_id, arg=len(entries))
        return entry

    def _load_shard_inplace(self, dirpath: str) -> None:
        """The in-place restore at the quiesced cut: the replica, the
        residuals of the writer links that still exist, the carry and the
        engine's precision state from this node's shard, through
        ``restore_state`` (``restore_ex`` on the engine); then every
        subscriber link is re-seeded from the restored replica, since across
        the cut its state is superseded and no seq gap would show it. On the
        device tier the restored residuals are new tensors, so each link's
        burst graph is captured anew at its next burst."""
        from ..utils import checkpoint as ckpt

        path = os.path.join(dirpath, ckpt.shard_filename(self.node_name))
        shard = ckpt.load_cluster_shard(path)
        if shard["layout"] != self.st.spec.layout_digest():
            raise ValueError(f"shard {path} was written for a different table layout")
        live = set(self.st.link_ids)
        links: dict[int, np.ndarray] = {}
        meta: dict[int, dict] = {}
        for lid, ent in shard["links"].items():
            if ent.get("role") == "carry":
                if ent.get("resid") is not None:
                    links[CARRY_LINK] = ent["resid"]
                continue
            if ent.get("role") == "sub" or ent.get("resid") is None:
                continue
            if lid in live:
                links[lid] = ent["resid"]
                meta[lid] = {"prec": ent.get("prec", 1)}
        if self._engine is not None:
            self._engine.restore_ex(shard["values"], links, meta)
        else:
            self.st.restore_state(shard["values"], links)
        for lid, rng in list(self._sub_links.items()):
            self._attach_sub(lid, rng)
        self._wake.set()

    def _restore_at_startup(self, path: str) -> None:
        """The full-cluster restart (``LifecycleConfig.restore_path``), before
        the data plane starts. The values load into the replica; a joiner's
        checkpointed uplink residual (and carry) becomes the re-graft carry,
        so its join handshake re-delivers exactly the up-flow it owed (the
        snapshot it sends claims ``values - carry``). The master drops its
        carry: its replica is the seed, and every child's diff join pulls
        what it misses from it. Child-link residuals are dropped on both:
        the children's own diff joins re-derive the down-flow."""
        from ..utils import checkpoint as ckpt

        shard = ckpt.load_cluster_shard(path)
        if shard["layout"] != self.st.spec.layout_digest():
            raise ValueError(f"restore shard {path} was written for a different table layout")
        carry = None if self.is_master else ckpt.restore_carry_from_shard(shard)
        self.st.restore_state(shard["values"], {} if carry is None else {CARRY_LINK: carry})
        self._restored_from = path
        self._restore_total += 1
        log.info("restored %s from shard %s (snap %s)%s", self.node_name, path, shard["meta"].get("snap_id"),
                 "" if carry is None else " with a re-graft carry")

    def _start_drain(self) -> None:
        """This node is a CTL drain's target: leave gracefully on a thread of
        its own (``leave`` joins the receive thread, so it never runs on
        it)."""
        if self._draining:
            return
        self._draining = True
        self._drain_total += 1
        if self._obs is not None:
            self._obs.event("drain_begin", self.node.obs_id)
        grace = self.config.lifecycle.drain_grace_sec

        def run():
            try:
                ok = self.leave(timeout=grace)
                log.info("drain of %s %s", self.node_name, "complete" if ok else "timed out (closed anyway)")
            except Exception:
                log.exception("drain of %s failed", self.node_name)

        threading.Thread(target=run, daemon=True, name="st-drain").start()

    def _handle_ctl_msg(self, doc: dict, from_link: Optional[int]) -> None:
        op = doc.get("op")
        if op == "drain":
            if doc.get("target") == self.node_name:
                self._start_drain()
            else:
                self._ctl_forward(doc, exclude=from_link)
        else:
            log.warning("ignoring unknown CTL op %r", op)

    def _ctl_poll(self, now: float) -> None:
        """The root's operator channel: take a ``cmd.json`` that
        ``python -m shared_tensor_tpu_torch.ctl`` wrote into
        ``LifecycleConfig.ctl_dir`` and run it on a thread of its own (a
        snapshot waits on the barrier this receive thread drives)."""
        lc = self.config.lifecycle
        if not lc.ctl_dir or self._uplink is not None or now - self._ctl_last_poll < 0.25:
            return
        self._ctl_last_poll = now
        cmd_path = os.path.join(lc.ctl_dir, "cmd.json")
        try:
            with open(cmd_path) as f:
                cmd = json.load(f)
            os.unlink(cmd_path)  # claimed
        except (OSError, ValueError):
            return  # absent, or mid-write: the next poll takes it
        if self._obs is not None:
            self._obs.event("ctl_cmd", self.node.obs_id, detail=str(cmd.get("op")))
        threading.Thread(target=self._ctl_execute, args=(cmd,), daemon=True, name="st-ctl").start()

    def _ctl_execute(self, cmd: dict) -> None:
        from ..utils.checkpoint import atomic_write_json

        res: dict = {"req_id": cmd.get("req_id"), "op": cmd.get("op")}
        try:
            op = cmd.get("op")
            if op == "snapshot":
                r = self.snapshot_cluster(cmd["dir"], cmd.get("id"))
                res.update(ok=True, id=r["id"], nodes=r["nodes"], duration_sec=r["duration_sec"],
                           manifest=r.get("manifest"))
            elif op == "restore":
                r = self.restore_cluster(cmd["dir"])
                res.update(ok=True, id=r["id"], nodes=r["nodes"], duration_sec=r["duration_sec"])
            elif op == "drain":
                self.drain_node(cmd["target"])
                res.update(ok=True, target=cmd["target"], initiated=True)
            else:
                res.update(ok=False, error=f"unknown ctl op {op!r}")
        except Exception as e:
            res.update(ok=False, error=str(e))
        path = os.path.join(self.config.lifecycle.ctl_dir, "result.json")
        try:
            atomic_write_json(path, res)
        except Exception as e:
            # the CLI waits for some verdict: a result that does not
            # serialize must not leave it timing out with no reason
            log.exception("ctl result write failed")
            try:
                atomic_write_json(path, {"req_id": res.get("req_id"), "ok": False, "error": f"result write failed: {e}"})
            except Exception:
                pass

    # -- the cluster digest and the clock probe -----------------------------------

    def _now_ns(self) -> int:
        """The monotonic clock plus the simulated skew: every stamp another
        node compares (trace generations, probes, digest times, FRESH
        marks) reads it, so a skewed node looks like a skewed host."""
        return time.monotonic_ns() + self._skew_ns

    def _health_event(self, name: str, arg: int, detail: str) -> None:
        """The analyzer's events, onto the timeline."""
        obs = self._obs
        if obs is not None:
            obs.event(name, self.node.obs_id, 0, arg, detail=detail)

    def _build_digest(self) -> dict:
        """This subtree's merged digest: our own snapshot folded with each
        child link's latest digest, bounded before it reaches the wire."""
        doc = aggregate.from_snapshot(self.node.obs_id, self.metrics(), self._now_ns())
        # the lifecycle name in the node's breakdown: ctl drain and ctl
        # versions address nodes by it
        doc["nodes"][str(int(self.node.obs_id))]["name"] = self.node_name
        for child in list(self._child_digests.values()):
            aggregate.merge(doc, child)
        aggregate.bounded(doc)
        if self._obs is not None:
            self._obs.cluster_nodes.set(aggregate.cluster_nodes(doc))
        return doc

    def _publish_digest(self) -> dict:
        """One digest beat: the subtree's digest to the uplink, or at the
        root the health analyzer's beat and the ``cluster_json_path``
        write. Lossy: a beat that meets backpressure is skipped, and the
        next one carries fresher totals."""
        doc = self._build_digest()
        up = self._uplink
        if up is not None:
            try:
                # 50 ms, not 0: a busy data plane keeps the transport queue
                # full, and a zero-timeout beat would never get through
                if self.node.send(up, wire.encode_digest(doc), timeout=0.05) and self._obs is not None:
                    self._obs.digest_out.inc()
            except BrokenPipeError:
                pass  # the uplink died; the next beat goes to the new one
        else:
            if self._health is not None:
                try:
                    self._health.beat(doc, self._now_ns())
                except Exception as e:  # the beat must not take the receive loop down
                    log.debug("health beat failed: %s", e)
            path = self.config.obs.cluster_json_path
            if path:
                tmp = f"{path}.tmp.{os.getpid()}"
                try:
                    with open(tmp, "w") as f:
                        json.dump(doc, f)
                        f.write("\n")
                    os.replace(tmp, path)  # never a torn read
                except OSError as e:
                    log.debug("cluster digest write failed: %s", e)
        return doc

    def push_digest(self) -> dict:
        """One digest beat now (the periodic beat goes on): tests and
        quiescent accounting move exact totals up without waiting out the
        interval."""
        self._digest_last = time.monotonic()
        return self._publish_digest()

    def cluster_metrics(self) -> dict:
        """The merged digest of this node's subtree: its own registry and
        every digest its children reported. At the root, the cluster."""
        return self._build_digest()

    def cluster_prometheus_text(self) -> str:
        """Prometheus text of :meth:`cluster_metrics`."""
        return aggregate.prometheus_text(self._build_digest())

    def _housekeeping(self) -> None:
        """The receive thread's beat: drain the native ring (rate-limited
        inside ``poll_native``), send the digest or publish the root's view,
        and probe the uplink's clock. Gated on the run-time obs switch too,
        so the overhead bench's off arm runs none of it."""
        obs = self._obs
        if obs is None:
            return
        obs.hub.poll_native(obs.drain_interval)
        if self._digest_interval <= 0 or not _obs.obs_enabled():
            return
        now = time.monotonic()
        # a root with nowhere to publish builds its view on demand only
        if now - self._digest_last >= self._digest_interval and (
            self._uplink is not None or self.config.obs.cluster_json_path or self._health is not None
        ):
            self._digest_last = now
            try:
                self._publish_digest()
            except Exception as e:  # a lossy beat: the next one retries
                log.debug("digest publish failed: %s", e)
        self._clock_beat(now)

    def _clock_beat(self, now: float) -> None:
        """Probe the uplink's clock every ``clock_sync_interval_sec`` (the
        root never probes; it is the reference). Lossy like the digest."""
        if self._clock_interval <= 0 or self.is_master or now - self._clock_last < self._clock_interval:
            return
        up = self._uplink
        if up is None:
            return
        self._clock_last = now
        try:
            self.node.send(up, wire.encode_clock(self._clock.probe_payload()), timeout=0.05)
        except BrokenPipeError:
            pass  # the uplink died; the next probe goes to the new one

    def _note_trace(self, link: int, payload) -> None:
        """The trace bookkeeping of one accepted data message on the Python
        tiers (the engine's receiver does the same in C): advance the
        pending stamp one hop, note the link's staleness, hops and origin,
        and put a trace_apply event on the timeline. With obs off only the
        stamp advance remains, which propagation needs."""
        obs = self._obs
        if obs is None and not self._trace_wire:
            return
        tr = wire.data_trace(payload, self.st.spec)
        if tr is None:
            return
        origin, gen, hops = tr
        hop = min(hops + 1, 255)
        if self._trace_wire:
            self._trace_stamp = (origin, gen, hop)
            if self._sub_stamp is None or gen > self._sub_stamp[1]:
                self._sub_stamp = self._trace_stamp
        if obs is None:
            return
        self._staleness[link] = (gen, hop)
        self._stale_origin[link] = origin
        self._traced_in += 1
        if obs.hops is not None:
            obs.hops.observe(hop)
        obs.event("trace_apply", self.node.obs_id, link, gen, extra=(origin << 8) | hop)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- send side ---------------------------------------------------------------

    def _send_loop(self) -> None:
        try:
            self._send_loop_inner()
        except Exception as e:
            # a dead sender strands every link: make it loud (wait_ready
            # raises it, threads_alive() turns false)
            log.exception("send thread died")
            self._error = e
            self._ready.set()
            raise

    def _send_loop_inner(self) -> None:
        interval = self.config.sync_interval_sec
        # the host tier's frames are synchronous work: a pipeline would only
        # hold the state lock longer
        host = self.st.host_tier
        depth = 1 if host else max(1, int(self.config.send_pipeline_depth))
        k = self._burst_device
        spec = self.st.spec
        pipe: dict[int, deque] = {}
        hot: set[int] = set()  # links whose last finished frame carried data

        def finish(df):
            return self.st.finish_frame_burst(df) if k > 1 else self.st.finish_frame(df)

        while not self._stop.is_set():
            self._send_pass += 1  # a pass boundary (_set_paused waits for two)
            t_pass = time.perf_counter()
            sent_any = False
            links = [l for l in self.st.link_ids if l >= 0]  # not the carry
            for stale in [l for l in pipe if l not in links]:
                del pipe[stale]  # the link's drop already rolled its ledger back
                hot.discard(stale)
            for link in links:
                if link in self._sub_links:
                    continue  # the sub-push thread serves subscriber links
                if self._paused and not pipe.get(link):
                    continue  # paused: what is in the pipeline still goes out
                if not self._compat and self._window_full(link):
                    continue  # residual mass waits until ACKs reopen the window
                if host and self._burst > 1:
                    # the host burst: K halvings quantized in one call, one
                    # message, one ledger entry, one ACK
                    out = self.st.begin_frame_burst(link, self._burst)
                    if out is None:
                        continue  # link dropped concurrently
                    seq, burst = out
                    if not burst:
                        self.st.ack_frame(link, seq)  # idle: a no-op burst
                        continue
                    self._link_frames_out[link] = self._link_frames_out.get(link, 0) + len(burst)
                    payload = self._register_data(
                        link, seq, lambda buf, s, t: wire.encode_burst_into(burst, spec, s, buf, trace=t)
                    )
                    # ledgered, error feedback applied, not on the wire yet
                    self._fault_point("mid-burst")
                    if self._send_blocking(link, payload, data=True):
                        sent_any = True
                    # else the link died: its LINK_DOWN rolls the ledger back
                    continue
                q = pipe.setdefault(link, deque())
                # a cold link risks one speculative frame, a hot one keeps
                # the whole pipeline of fetches in flight, and a paused one
                # only drains it
                while len(q) < (0 if self._paused else depth if link in hot else 1):
                    df = self.st.begin_frame_burst_device(link, k) if k > 1 else self.st.begin_frame(link)
                    if df is None:
                        break  # link dropped concurrently
                    q.append(df)
                if not q:
                    continue
                seq, df = q.popleft()
                frame = finish(df)
                while frame is None:
                    # idle (every scale 0, a no-op): forget it, and finish
                    # (not drop) the speculative frames behind it, since an
                    # add may have made them carry data
                    self.st.ack_frame(link, seq)
                    hot.discard(link)
                    if not q:
                        break
                    seq, df = q.popleft()
                    frame = finish(df)
                if frame is None:
                    continue
                hot.add(link)
                self._link_frames_out[link] = self._link_frames_out.get(link, 0) + (len(frame) if k > 1 else 1)
                # ledgered with its wire seq BEFORE the send: the ACK must
                # never overtake the ledger entry it acknowledges
                if self._compat:
                    payload = wire.encode_compat_frame(frame, spec)
                    self._data_bytes_out += len(payload)
                elif k > 1:
                    payload = self._register_data(
                        link, seq, lambda buf, s, t: wire.encode_burst_into(frame, spec, s, buf, trace=t)
                    )
                else:
                    payload = self._register_data(
                        link, seq, lambda buf, s, t: wire.encode_frame_into(frame, s, buf, trace=t)
                    )
                self._fault_point("mid-burst")  # ledgered, not on the wire yet
                if self._send_blocking(link, payload, data=True):
                    if self._compat:
                        self.st.ack_frame(link, seq)  # no ACK in the protocol: delivered when queued
                    sent_any = True
                else:
                    # the link died with this frame (and its successors in
                    # the pipeline) undelivered. Their error feedback is
                    # rolled back once, by the link's LINK_DOWN on the
                    # receive thread, which also reads the ACKs: a roll-back
                    # here could take back a frame whose ACK that thread
                    # has just read, and the carry would owe it twice
                    pipe.pop(link, None)
                    hot.discard(link)
            self._check_retransmit(links)
            self._secs["st_send_loop_busy_seconds_total"] += time.perf_counter() - t_pass
            if self._stop.is_set():
                return
            if interval > 0:
                time.sleep(interval)
            elif not sent_any:
                self._wake.wait(0.05)  # until an add or an incoming frame
                self._wake.clear()

    def _send_sub(self, link: int) -> bool:
        """One pass of a subscriber link, on the sub-push thread
        (:meth:`_sub_push_loop`). Unledgered: a message counts as delivered
        once it is queued (``ack_frame`` at once); a message the wire loses
        shows at the subscriber as a seq gap, and its resync re-seeds the
        link. A pass quantizes a burst of up to SUB_BURST_CAP frames by the
        cascade (with ``cascade`` 1 the device tier takes one frame; the
        device tier waits for its copy here) and sends one message a frame,
        queueing at most SUB_QUEUED_MSGS on the link: the frames left over
        are held and go out as the link's queue drains; the link's next
        burst waits for the last.
        The FRESH mark goes only from a pass that holds nothing and finds the
        residual drained, so nothing of the link is then quantized and
        unsent, and the mark covers exactly what went out. A ranged link's
        residual is masked to its range first (only when the replica moved)
        and each frame goes out as one RDATA. Returns True if data was
        sent."""
        mu = self._sub_mu.get(link)
        if mu is None:
            return False
        with mu:
            rng = self._sub_links.get(link)
            if link not in self._sub_links:
                return False  # detached while the pass began
            if link in self._sub_held:
                return False  # the sub-push thread is still queueing its last burst
            if rng is not None:
                ver = self.st.state_version()
                if ver != self._sub_mask_ver.get(link):
                    wlo, wcnt = rng
                    self.st.mask_link_residual(link, wlo * 32, (wlo + wcnt) * 32)
                    self._sub_mask_ver[link] = ver
            # the FRESH candidate and the frames' trace are read under the
            # state lock, just before the quantize reads the residual
            # (``at_lock``): no add or apply lands in between. So a mark
            # (sent only if the quantize finds the residual drained) covers
            # no add that lands after it, and the trace, the newest origin
            # stamp of every update folded in (own or relayed, _sub_stamp),
            # is set only after that update's mass is in the residuals: the
            # frames carry that update and everything folded in before it.
            # Read before waiting for the lock, it aged by the wait. With no
            # stamp yet the frames go untraced: a stamp of our own clock
            # would claim updates we never received.
            at: list = []

            def mark() -> None:
                at.extend((self._now_ns(), self._sub_stamp if self._trace_wire else None))

            if self.st.host_tier:
                out = self.st.begin_frame_burst(link, min(self._burst, SUB_BURST_CAP), at_lock=mark)
                if out is None:
                    return False
                seq, frames = out
            elif self.st.cascade > 1:
                # the cascade drains a residual of any bound to the exact
                # zero a FRESH mark needs in tens of frames; single frames
                # re-measure every frame and leave outliers for thousands
                out = self.st.begin_frame_burst_device(link, min(self._burst_device, SUB_BURST_CAP), at_lock=mark)
                if out is None:
                    return False
                seq, df = out
                frames = self.st.finish_frame_burst(df) or []
            else:
                out = self.st.begin_frame(link, at_lock=mark)
                if out is None:
                    return False
                seq, df = out
                f = self.st.finish_frame(df)
                frames = [f] if f is not None and f.scales.any() else []
            fresh_t, trace = at[0], at[1]
            if not frames:
                self.st.ack_frame(link, seq)  # idle: a no-op
                self._sub_fresh_mark(link, fresh_t)
                return False
            self._link_frames_out[link] = self._link_frames_out.get(link, 0) + len(frames)
            with self._ack_mu:
                base = self._tx_seq.get(link, 0)
                self._tx_seq[link] = base + len(frames)
            # encoded here, before the next quantize may reuse the frames'
            # buffers (the host tier's are views)
            if rng is not None:
                wlo, wcnt = rng
                payloads = [wire.encode_rdata(f, wlo, wcnt, base + i + 1, trace=trace) for i, f in enumerate(frames)]
            else:
                payloads = [wire.encode_frame(f, base + i + 1, trace=trace) for i, f in enumerate(frames)]
            self._sub_held[link] = (seq, deque(payloads))
            return self._push_sub_held(link)

    def _sub_fresh_mark(self, link: int, fresh_t: int) -> None:
        """Send one FRESH mark, at most one per ``fresh_interval_sec``, with
        the link's last data seq (a subscriber that has not applied exactly
        that many resyncs instead of trusting the mark). ``fresh_t`` was
        stamped before the caller found the residual drained. Lossy: a full
        queue skips this mark, and the next pass tries again."""
        now = time.monotonic()
        if now - self._sub_fresh.get(link, 0.0) < self.config.serve.fresh_interval_sec:
            return
        with self._ack_mu:
            last_seq = self._tx_seq.get(link, 0)
        try:
            if self.node.send(link, wire.encode_fresh(fresh_t, last_seq), timeout=0.0):
                self._sub_fresh[link] = now
                self._sub_fresh_out += 1
        except BrokenPipeError:
            pass  # LINK_DOWN cleans the link up

    def _sub_fresh_beat(self, link: int) -> None:
        """A paused sender's FRESH mark: only for a drained residual,
        stamped before the check (which reads the residual under the state
        lock, so no add that lands after the stamp is covered), and none
        while an in-place restore holds the pause: until the link's re-seed
        (:meth:`_load_shard_inplace`) the replica may already be the cut's
        while the subscriber still holds the state after it, and a mark
        would verify that state across the cut."""
        op = self._lc_op
        if op is not None and op["op"] == "load":
            return
        fresh_t = self._now_ns()
        if link in self._sub_held or self.st.residual_rms(link) > 0.0:
            return
        self._sub_fresh_mark(link, fresh_t)

    def _sub_push_loop(self) -> None:
        """The Python tiers' sub-push thread, which serves every subscriber
        link apart from the send thread: a link that holds frames gets them
        into its send queue as far as :meth:`_push_sub_held` lets them
        (every millisecond while any are held, paused or not); one that
        holds none gets its next burst or FRESH mark from :meth:`_send_sub`,
        or, paused, only its FRESH beat (a drained link keeps its mark; one
        that still owes mass gets none, so a read across the pause refuses
        instead of verifying falsely). So a burst reaches a slow subscriber
        at the subscriber's pace, and a link's next burst follows its last
        at once, not after the send thread's pass: a CPU writer's pass
        quantizes its ledgered links' bursts for seconds."""
        try:
            while not self._stop.is_set():
                sent = False
                for link in list(self._sub_links):
                    if link in self._sub_held:
                        mu = self._sub_mu.get(link)
                        if mu is not None:
                            with mu:
                                if link in self._sub_held:
                                    sent |= self._push_sub_held(link)
                    elif self._paused:
                        self._sub_fresh_beat(link)
                    else:
                        sent |= self._send_sub(link)
                if self._sub_held:
                    time.sleep(0.001)
                elif not sent:
                    # until an add, an applied flood or an attach (a link's
                    # FRESH marks need a pass at least this often)
                    self._sub_push_wake.wait(0.05 if self._sub_links else None)
                    self._sub_push_wake.clear()
        except Exception as e:
            log.exception("sub-push thread died")
            self._error = e
            self._ready.set()
            raise

    def _push_sub_held(self, link: int) -> bool:
        """Queue a subscriber link's held frames while its send
        queue holds fewer than SUB_QUEUED_MSGS messages; once the last is
        queued, the burst's ledger entry goes (delivered on enqueue). The
        caller holds the link's ``_sub_mu``. Returns True if data was
        sent."""
        seq, held = self._sub_held[link]
        sent = False
        while held:
            st = self.node.stats(link)
            if st is None or st.send_queue >= SUB_QUEUED_MSGS:
                return sent  # the rest waits for the subscriber to drain its queue
            payload = held.popleft()
            self._data_bytes_out += len(payload)
            if not self._send_blocking(link, payload, data=True):
                del self._sub_held[link]
                self.st.nack_frame(link)
                return sent
            self._sub_msgs_out += 1
            sent = True
        del self._sub_held[link]
        self.st.ack_frame(link, seq)  # delivered on enqueue
        return sent

    def _register_data(self, link: int, ledger_seq: int, encode_into):
        """Allocate the link's next wire seq, encode the message into a pool
        slot (``encode_into(buf, seq, trace)`` returns its length) and
        append it to the link's unacknowledged ledger. The encode runs
        outside the lock, so it never holds up the receive thread's ACKs;
        this thread is the only one that allocates seqs and appends."""
        with self._ack_mu:
            txs = self._tx_seq.get(link, 0) + 1
            self._tx_seq[link] = txs
        trace = self._trace_stamp
        if not self._trace_wire:
            trace = None  # v1 framing (ST_WIRE_TRACE=0)
        elif trace is None:
            trace = (self.node.obs_id, self._now_ns(), 0)
        slot = self._tx_pool.acquire()
        t0 = time.perf_counter()
        payload = slot[: encode_into(slot, txs, trace)]
        dt = time.perf_counter() - t0
        self._secs["st_encode_seconds_total"] += dt
        if self._obs is not None:
            self._obs.encode.observe(dt)
        self._data_bytes_out += len(payload)
        with self._ack_mu:
            if link not in self._tx_seq:
                # the link's LINK_DOWN purge ran between the two lock
                # windows: no ledger entry for a dead link; the slot can go
                # back at once (only this thread re-acquires slots)
                self._tx_pool.release(slot)
                return payload
            q = self._unacked.setdefault(link, [])
            now = time.monotonic()
            if not q:
                self._ack_progress[link] = now
            q.append((ledger_seq, txs, payload, slot, now))
        return payload

    def _window_full(self, link: int) -> bool:
        with self._ack_mu:
            return len(self._unacked.get(link, ())) >= SEND_WINDOW

    def _check_retransmit(self, links) -> None:
        """The go-back-N timer: when a link's oldest unacknowledged message
        has waited past ``ack_timeout_sec`` (doubling per fruitless round,
        at most 8x), re-send the head of the tail byte for byte; after
        ``ack_retry_limit`` rounds without progress tear the link down, so
        rollback, carry and re-graft recover its frames. Also sweeps
        ledger state of links that are gone."""
        tcfg = self.config.transport
        purged = []
        with self._ack_mu:
            live = set(links)
            for stale in [l for l in self._unacked if l not in live]:
                purged.extend(self._unacked.pop(stale, ()))
                for d in (self._tx_seq, self._acked, self._ack_progress, self._retx_rounds):
                    d.pop(stale, None)
        self._release_slots(purged)
        if tcfg.ack_timeout_sec <= 0:
            return
        now = time.monotonic()
        for link in links:
            with self._ack_mu:
                q = self._unacked.get(link)
                wait = tcfg.ack_timeout_sec * min(1 << self._retx_rounds.get(link, 0), 8)
                if not q or now - self._ack_progress.get(link, now) < wait:
                    continue
                rounds = self._retx_rounds.get(link, 0) + 1
                self._retx_rounds[link] = rounds
                self._ack_progress[link] = now
                # views of ledger-held slots: safe to send after the lock
                # drops, since only this thread can reuse a released slot
                tail = [e[2] for e in q[:RETX_PREFIX]]
            if rounds > max(1, tcfg.ack_retry_limit):
                log.warning("link %d: no ACK progress after %d retransmission rounds; tearing down for re-graft",
                            link, rounds - 1)
                if self._obs is not None:
                    # the verdict a postmortem should explain
                    self._obs.event("blackhole_teardown", self.node.obs_id, link, rounds - 1)
                    self._obs.hub.dump("goback_teardown")
                self.node.drop_link(link)
                continue
            log.info("link %d: retransmitting %d unacked message(s), round %d", link, len(tail), rounds)
            self._retransmits += len(tail)
            if self._obs is not None:
                self._obs.retransmits.inc(len(tail))
                self._obs.event("retransmit", self.node.obs_id, link, len(tail))
            for payload in tail:
                self._data_bytes_out += len(payload)
                if not self._send_blocking(link, payload, data=True):
                    break

    def _release_slots(self, entries) -> None:
        for entry in entries:
            self._tx_pool.release(entry[3])

    def _fault_point(self, name: str) -> None:
        """A named protocol point of the fault plan's crash schedule."""
        plan = self._faults
        if plan is not None:
            plan.point(name)

    def _send_blocking(self, link: int, payload, data: bool = False) -> bool:
        """Deliver one message, riding out backpressure. False on a dead
        link, or after ``quarantine_send_failures`` consecutive refusals
        (~0.1 s each: the peer stopped draining), when the link is torn
        down for re-graft.

        ``data=True`` marks a DATA, BURST or RDATA message (a re-send
        too): the fault plan, when there is one, may drop, delay,
        duplicate, truncate, corrupt, stall or sever it here. A message the
        plan swallowed reports success: the sender believes it delivered,
        which is the fault its ledger (or the subscriber's gap check)
        recovers from."""
        plan = self._faults  # one load: a test may detach the plan meanwhile
        if plan is not None and data:
            payloads, delay, sever = plan.on_send(link, payload)
            if delay > 0:
                time.sleep(delay)
            ok = True
            for p in payloads:
                ok = self._send_raw(link, p)
                if not ok:
                    break
            if sever:
                self.node.drop_link(link)
                return False
            return ok
        return self._send_raw(link, payload)

    def _send_raw(self, link: int, payload) -> bool:
        quarantine = self.config.transport.quarantine_send_failures
        fails = 0
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                try:
                    if self.node.send(link, payload, timeout=0.1):
                        return True
                except BrokenPipeError:
                    return False
                fails += 1
                if quarantine > 0 and fails >= quarantine:
                    log.warning("quarantining link %d after %d consecutive send failures; tearing down for re-graft",
                                link, fails)
                    if self._obs is not None:
                        self._obs.event("quarantine", self.node.obs_id, link, fails)
                    self.node.drop_link(link)
                    return False
            return False
        finally:
            self._secs["st_send_seconds_total"] += time.perf_counter() - t0

    # -- receive side --------------------------------------------------------------

    def _recv_loop(self) -> None:
        """Restarts the loop after an unhandled exception, at most twice;
        the third failure is the peer's error (wait_ready raises it)."""
        failures = 0
        while not self._stop.is_set():
            try:
                self._recv_loop_inner()
                return
            except Exception as e:
                failures += 1
                self._recv_restarts += 1
                log.exception("recv thread hit an unhandled exception (restart %d/3)", failures)
                if self._obs is not None:
                    self._obs.hub.poll_native()
                    self._obs.hub.dump("recv_thread_exception")
                if failures >= 3:
                    self._error = e
                    self._ready.set()
                    raise
                time.sleep(0.1)

    def _recv_loop_inner(self) -> None:
        spec = self.st.spec
        while not self._stop.is_set():
            self._housekeeping()
            busy = self._handle_events()
            try:
                # an active barrier and the operator channel; a failed
                # lifecycle step ends through its own error path, never
                # the loop
                self._lc_tick()
            except Exception:
                log.exception("lifecycle tick failed (the receive thread goes on)")
            if self._compat and self._engine is not None and not self._ready.is_set() and self._uplink is not None:
                # the engine consumes the uplink's reference frames: ready
                # once the transport counts one in, keepalives included
                s = self.node.stats(self._uplink)
                if s is not None and s.frames_in > 0:
                    self._ready.set()
            if self._engine is not None:
                # control messages the engine's receiver handed back
                while (c := self._engine.poll_ctrl()) is not None:
                    busy = True
                    try:
                        self._on_message(*c)
                    except Exception:
                        self._msg_errors += 1
                        log.exception("dropping message of kind %d on link %d", c[1][0], c[0])
            for link in list(self.node.links):
                if link in self._engine_links or (self._compat and link not in self._compat_open):
                    continue  # the engine's receiver consumes these; a compat link waits for its LINK_UP
                # Consecutive DATA/BURST messages of a link go into ONE flood
                # apply; a control message flushes them first (order). msgs
                # counts accepted messages (what the ACK acknowledges).
                batch: list = []
                traced: list = []
                msgs = 0
                for _ in range(256):  # bounded so other links are not starved
                    if self._stop.is_set():
                        break  # closing: a streaming link must not hold close() up for 256 applies
                    try:
                        payload = self.node.recv(link, timeout=0.0)
                    except BrokenPipeError:
                        break
                    if payload is None:
                        break
                    busy = True
                    if self._compat:
                        # every message is a reference frame: no seq, no ACK
                        if link == self._uplink:
                            self._ready.set()  # the parent's stream flows, keepalives too
                        try:
                            frame = wire.decode_compat_frame(payload, spec)
                        except ValueError as e:
                            log.warning("dropping bad frame on link %d: %s", link, e)
                            continue
                        if frame is not None:  # None: a keepalive or a non-finite scale
                            if batch and len(batch) >= self._batch_cap:
                                self._flush_frames(link, batch, 0, [])
                                batch = []
                            batch.append(frame)
                            self._data_bytes_in += len(payload)
                        continue
                    if payload[0] in (wire.DATA, wire.BURST):
                        if self._sealed:
                            continue  # leaving: the sender re-delivers it elsewhere
                        # go-back-N: only the next seq is applied; a duplicate
                        # or anything after a gap is discarded unacknowledged
                        # (the sender re-sends), and so is a message that does
                        # not decode, without consuming its seq
                        t0 = time.perf_counter()
                        try:
                            seq = wire.data_seq(payload, spec)
                            want = (self._rx_count.get(link, 0) + msgs + 1) & 0xFFFFFFFF
                            if seq != want:
                                log.debug("link %d: discarding out-of-order data (seq %d, expected %d)",
                                          link, seq, want)
                                self._dedup += 1
                                if self._obs is not None:
                                    # an engine peer may meet one before a
                                    # link's handoff: it has no live counter
                                    if self._obs.dedup is not None:
                                        self._obs.dedup.inc()
                                    self._obs.event("dedup_discard", self.node.obs_id, link, seq)
                                continue
                            if payload[0] == wire.DATA:
                                frames = [wire.decode_frame(payload, spec)]
                            else:
                                frames = wire.decode_burst(payload, spec)
                        except ValueError as e:
                            log.warning("dropping bad frame on link %d: %s", link, e)
                            continue
                        finally:
                            self._secs["st_decode_seconds_total"] += time.perf_counter() - t0
                        if batch and len(batch) + len(frames) > self._batch_cap:
                            self._flush_frames(link, batch, msgs, traced)
                            batch, traced, msgs = [], [], 0
                        batch.extend(frames)
                        traced.append(payload)
                        msgs += 1
                        self._data_bytes_in += len(payload)
                        continue
                    self._flush_frames(link, batch, msgs, traced)
                    batch, traced, msgs = [], [], 0
                    try:
                        self._on_message(link, payload)
                    except Exception:
                        self._msg_errors += 1
                        log.exception("dropping message of kind %d on link %d", payload[0], link)
                    if link in self._engine_links:
                        # the handshake just gave the link to the engine:
                        # its next message is the engine's
                        break
                self._flush_frames(link, batch, msgs, traced)
                self._flush_acks(link)  # retry an ACK that met backpressure
            if not busy:
                time.sleep(0.002)

    def _flush_frames(self, link: int, batch: list, msgs: int, traced: list) -> None:
        if batch:
            t0 = time.perf_counter()
            try:
                self.st.receive_frames(link, batch)
            except Exception:
                # one bad frame costs only itself: a discarded good frame
                # would never be re-sent (the sender's ACK clears it)
                for f in batch:
                    try:
                        self.st.receive_frame(link, f)
                    except Exception as e:
                        self._apply_dropped += 1
                        log.warning("dropping bad frame on link %d: %s", link, e)
            dt = time.perf_counter() - t0
            self._secs["st_apply_seconds_total"] += dt
            if self._obs is not None:
                self._obs.apply.observe(dt)
            self._wake.set()  # the flood refilled the other links' residuals
            self._sub_push_wake.set()
        if msgs:
            # mass applied and flooded, ACK not sent: the sender re-delivers
            self._fault_point("between-apply-and-ack")
            self._ack_received(link, msgs)
        for p in traced:
            self._note_trace(link, p)

    def _ack_received(self, link: int, n: int) -> None:
        self._rx_count[link] = self._rx_count.get(link, 0) + n
        self._flush_acks(link)

    def _flush_acks(self, link: int) -> None:
        """Send the cumulative ACK if it moved; one refused by backpressure
        is retried on the next pass (else a burst's last ACK could be lost
        and the sender's ledger never drain)."""
        count = self._rx_count.get(link, 0)
        if count <= self._ack_sent.get(link, 0):
            return
        try:
            if self.node.send(link, wire.encode_ack(count), timeout=0.0):
                self._ack_sent[link] = count
        except BrokenPipeError:
            self._ack_sent[link] = count  # link dead; nothing left to ack

    # -- membership ----------------------------------------------------------------

    #: Transport event -> timeline event name (the native codes 1..4, so
    #: every native membership event pairs with a later Python-tier twin)
    _EVENT_NAMES = {
        EventKind.LINK_UP: "link_up",
        EventKind.LINK_DOWN: "link_down",
        EventKind.BECAME_MASTER: "became_master",
        EventKind.REJOIN_FAILED: "isolated",
    }

    def _handle_events(self) -> bool:
        evs = self.node.poll_events(timeout=0.0)
        for ev in evs:
            if self._obs is not None:
                self._obs.event(self._EVENT_NAMES[ev.kind], self.node.obs_id, ev.link_id, int(ev.is_uplink))
            try:
                if ev.kind == EventKind.LINK_UP:
                    self._on_link_up(ev)
                else:
                    self._on_membership_event(ev)
            except Exception:
                # never kill the receive thread; a half-attached link would
                # ACK frames it never applied, so tear it down for re-graft
                log.exception("event %s for link %d failed; dropping the link", ev.kind.name, ev.link_id)
                if ev.kind == EventKind.LINK_UP:
                    self.node.drop_link(ev.link_id)
        return bool(evs)

    def _on_link_up(self, ev) -> None:
        # A child link needs nothing here: its SYNC opens the handshake. The
        # receive loop reads every link the transport lists, which may be
        # before the link's LINK_UP is polled, so the child's SYNC and
        # CHUNKs may already be in: resetting the snapshot buffer here would
        # make its DONE attach nothing, and the child would never receive
        # the tree's state.
        if ev.is_uplink:
            self._uplink = ev.link_id
            self._error = None  # a re-graft supersedes an isolation verdict
            if self._compat:
                self._compat_open_uplink(ev.link_id)
                self._compat_open.add(ev.link_id)
            else:
                self._start_join(ev.link_id)
        elif self._compat:
            # the reference join: the child is seeded with our whole
            # replica through the codec stream
            if self._engine is not None:
                self._engine.new_link(ev.link_id, seed=True)
                self._engine_links.add(ev.link_id)
            else:
                self.st.new_link(ev.link_id, seed=True)
            self._compat_open.add(ev.link_id)

    def _compat_open_uplink(self, link: int) -> None:
        """The reference protocol has no handshake: stream up at once. A
        re-grafting leaf resets its replica to exactly its carry, the mass
        the tree does not have yet, since the new parent re-seeds it with
        its whole replica (as a fresh joiner holding pending adds in its
        replica and its residual); a reset to zero would lose the carry
        here, as it floods everywhere else and split horizon never brings
        it back. Otherwise the uplink's residual is the carry (and what
        was added since), or 0 on a first join."""
        if self._compat_reset_on_regraft:
            self._compat_reset_on_regraft = False
            if self._engine is not None:
                self._engine.compat_regraft(link)
            else:
                self.st.regraft_reset_to_carry(CARRY_LINK, link)
        elif self._engine is not None:
            # the diff against live values keeps what lands between the two calls
            carry, snap = self._engine.take_carry_and_snapshot()
            if carry is not None:
                self._engine.new_link_diff(link, snap - carry)
            else:
                self._engine.new_link(link, seed=False)
        else:
            carry, _ = self.st.take_link_and_snapshot(CARRY_LINK)
            self.st.new_link(link, seed=False, residual=carry)
        if self._engine is not None:
            self._engine_links.add(link)

    def _on_membership_event(self, ev) -> None:
        if ev.kind == EventKind.LINK_DOWN:
            self._pending.pop(ev.link_id, None)
            self._pending_sub.pop(ev.link_id, None)
            mu = self._sub_mu.pop(ev.link_id, None)
            if mu is not None:
                # a read-only leaf owes the tree nothing and re-seeds when
                # it comes back: its residual goes (the drop below), with
                # no carry
                with mu:
                    self._sub_links.pop(ev.link_id, None)
                    self._sub_fresh.pop(ev.link_id, None)
                    self._sub_mask_ver.pop(ev.link_id, None)
                    self._sub_held.pop(ev.link_id, None)
            self._engine_links.discard(ev.link_id)
            self._compat_open.discard(ev.link_id)
            for d in (self._peer_sign2, self._peer_shm, self._peer_r14, self._staleness, self._stale_origin,
                      self._child_digests):
                d.pop(ev.link_id, None)
            tokens = self._link_token.pop(ev.link_id, None)
            if tokens is not None:
                self._record_applied(tokens[0], self._applied_count(ev.link_id))
            with self._ack_mu:
                purged = self._unacked.pop(ev.link_id, ())
                for d in (self._tx_seq, self._acked, self._rx_count, self._ack_sent, self._ack_progress,
                          self._retx_rounds):
                    d.pop(ev.link_id, None)
            self._release_slots(purged)
            if ev.is_uplink:
                # keep what we owe upward in the live carry slot; if the
                # handshake never finished there was no codec link, and what
                # we owe is values - the snapshot we sent (lazily, at re-join)
                if self._engine is not None:
                    rolled = self._engine.stash_carry(ev.link_id)
                    stashed = rolled is not None
                    if stashed and self._uplink_token:
                        self._kept = (self._uplink_token, None)
                        self._carry_frames_rolled += rolled
                else:
                    kept = self.st.inflight_frames(ev.link_id, [e[0] for e in purged])
                    stashed = self.st.stash_carry(ev.link_id, CARRY_LINK)
                    if stashed and self._uplink_token:
                        # the ledger in wire-seq order, each message's
                        # frames now in the carry
                        self._kept = (self._uplink_token, [(e[1], f) for e, f in zip(purged, kept) if f])
                        self._carry_frames_rolled += sum(len(f) for _, f in self._kept[1])
                self._uplink_token = 0
                if not stashed and self._sent_snapshot is not None:
                    self._mid_handshake_base = self._sent_snapshot
                self._sent_snapshot = None
                self._uplink = None
                if self._compat:
                    # the new parent will re-seed us with its whole replica
                    # (there is no diff handshake): a leaf resets to its
                    # carry at the re-graft (not now: the rejoin may make
                    # us the master, whose state is then the seed); an
                    # interior node keeps its state, as a reset would
                    # double its children's
                    if not [l for l in self.st.link_ids if l >= 0]:
                        self._compat_reset_on_regraft = True
                    else:
                        log.warning("wire-compat interior node lost its uplink: the re-seed may double state "
                                    "(the reference protocol has no diff handshake)")
            else:
                self.st.drop_link(ev.link_id)
        elif ev.kind == EventKind.BECAME_MASTER:
            # the parent died and nobody held the rendezvous: we are the new
            # root; our replica is the authoritative seed, and the carry's
            # mass is already in it
            if self._engine is not None:
                self._engine.drop_carry()
                self._engine.retract_kept(0)
            else:
                self.st.take_link_and_snapshot(CARRY_LINK)
            self._mid_handshake_base = None
            self._kept = None
            self._compat_reset_on_regraft = False
            self._uplink = None
            self.is_master = True
            self._error = None
            self._ready.set()
        elif ev.kind == EventKind.REJOIN_FAILED:
            # a status: the transport keeps retrying, and the next LINK_UP
            # or BECAME_MASTER clears it
            self._error = ConnectionError("uplink lost and rejoin failed; node is isolated (still retrying)")
            self._ready.set()

    def _start_join(self, uplink: int) -> None:
        """Child side of the handshake: SYNC, then our replica minus what
        we still owe the tree (the carry), so the parent's diff seed never
        erases it. The carry and the snapshot are taken under one lock."""
        if self._engine is not None:
            carry, snap = self._engine.take_carry_and_snapshot()
        else:
            carry, snap = self.st.take_link_and_snapshot(CARRY_LINK)
        if carry is None and self._mid_handshake_base is not None:
            carry = snap - self._mid_handshake_base
        self._mid_handshake_base = None
        if carry is not None:
            snap = snap - carry
        self._sent_snapshot = snap
        # capabilities: sign2 decoding (engine), and the shared-memory lane
        # with our host id (which also says we decode v3)
        flags = (compat.SYNC_FLAG_SIGN2 if self._sign2 else 0) | (compat.SYNC_FLAG_SHM if self._shm_ok else 0)
        prev = (0, 0)
        if self._prev_link_ok:
            # this uplink's token, and the severed one's whose frames we keep
            self._uplink_token = int.from_bytes(os.urandom(8), "little") | 1
            prev = (self._uplink_token, self._kept[0] if self._kept is not None else 0)
            flags |= wire.SYNC_FLAG_PREV_LINK
        self._send_blocking(uplink, wire.encode_sync(self.st.spec, self._wire_version, flags, self._shm_host,
                                                     prev_link=prev))
        # SYNC sent, snapshot not: the parent holds a pending handshake
        self._fault_point("mid-join-walk")
        for chunk in wire.encode_snapshot_chunks(snap.cpu().numpy()):
            if not self._send_blocking(uplink, chunk):
                return  # uplink died mid-handshake; LINK_DOWN keeps the base

    def _on_message(self, link: int, payload: bytes) -> None:
        kind = payload[0]
        if kind == wire.ACK:
            # cumulative: every ledger entry at or below the count arrived
            count = wire.decode_ack(payload)
            popped = []
            with self._ack_mu:
                self._acked[link] = count
                q = self._unacked.get(link, [])
                while q and q[0][1] <= count:
                    popped.append(q.pop(0))
                if popped:
                    self._ack_progress[link] = time.monotonic()
                    self._retx_rounds.pop(link, None)
            self._release_slots(popped)
            if self._obs is not None and popped:
                now = time.monotonic()
                for entry in popped:
                    self._obs.ack_rtt.observe(now - entry[4])  # entry[4]: the ledger append
            for entry in popped:
                self.st.ack_frame(link, entry[0])
        elif kind == wire.SYNC:
            self._on_sync(link, payload)
        elif kind == wire.RANGE:
            self._on_range(link, payload)
        elif kind == wire.CHUNK:
            buf = self._pending.get(link)
            if buf is not None:
                wire.decode_chunk_into(payload, buf)
        elif kind == wire.DONE:
            buf = self._pending.pop(link, None)
            if link in self._pending_sub:
                # a subscriber's handshake (or resync) uploads no snapshot:
                # the parent pushes its own down the control plane
                self._attach_sub(link, self._pending_sub.pop(link))
                self._wake.set()
            elif buf is not None:
                snap = np.frombuffer(bytes(buf), "<f4")
                # WELCOME goes out BEFORE the codec link opens: per-link FIFO
                # then puts it ahead of our first DATA, which the child would
                # otherwise apply AND count again in its attach diff. It
                # carries our capabilities and, for a child on our host, the
                # lane's segment, created before the offer goes out
                flags = (compat.SYNC_FLAG_SIGN2 if self._sign2 else 0) | (compat.SYNC_FLAG_SHM if self._shm_ok else 0)
                applied = self._applied_on(self._link_token.get(link, (0, 0))[1], link)
                if applied is not None:
                    flags |= wire.SYNC_FLAG_PREV_LINK
                offer = None
                if self._peer_shm.pop(link, False):
                    served, code = self.node.shm_serve(link, self._shm_ring_bytes())
                    if served is not None:
                        offer = (self._shm_host, served[1], served[0])
                    else:
                        # the library puts no event on the ring for this side
                        self._shm_fallback(link, SHM_SERVE_FAILURES.get(code, f"serve code {code}"), code)
                self._send_blocking(link, wire.encode_welcome(flags, offer, applied or 0))
                self._attach_diff(link, snap)
                self._wake.set()
        elif kind == wire.WELCOME:
            wflags = wire.welcome_flags(payload)
            self._peer_sign2[link] = bool(wflags & compat.SYNC_FLAG_SIGN2)
            # the flag marks a v3 decoder; gated on our own lane switch so
            # ST_SHM=0 pins v2 emission too
            self._peer_r14[link] = bool(self._shm_ok and wflags & compat.SYNC_FLAG_SHM)
            offer = wire.welcome_shm(payload)
            if offer is not None and self._shm_ok and offer[0] == self._shm_host:
                code = self.node.shm_join(link, offer[2], offer[1])
                if code != 0:
                    self._shm_fallback(link, SHM_JOIN_FAILURES.get(code, f"join code {code}"))
            snap, self._sent_snapshot = self._sent_snapshot, None
            if snap is not None:
                self._retract_applied(wire.welcome_applied(payload))
                # owed upward: everything the snapshot did not claim (the
                # carry plus adds and floods during the handshake)
                self._attach_diff(link, snap)
            elif self._engine is not None:  # a duplicate WELCOME
                self._engine.new_link(link, seed=False, rx_init=self._rx_count.get(link, 0))
                self._engine_links.add(link)
                self._arm_sign2(link)
            else:
                self.st.new_link(link, seed=False)
            self._ready.set()
            self._wake.set()
        elif kind == wire.REJECT:
            self._error = SpecMismatch(wire.decode_reject(payload))
            self._ready.set()
        elif kind == wire.DIGEST:
            # a subtree's digest: the latest per link, merged at the next build
            self._child_digests[link] = wire.decode_digest(payload)
            if self._obs is not None:
                self._obs.digest_in.inc()
        elif kind == wire.CLOCK:
            # a child's probe (answered at once on the same link: the
            # turnaround is inside the child's round trip either way), or
            # our uplink's reply. Control traffic: faults never touch it
            doc = wire.decode_clock(payload)
            if doc.get("op") == "probe":
                try:
                    self.node.send(link, wire.encode_clock(self._clock.reply_payload(doc)), timeout=0.05)
                except BrokenPipeError:
                    pass  # the prober died
            elif doc.get("op") == "reply" and link == self._uplink:
                self._clock.on_reply(doc)
        elif kind == wire.SNAP:
            # a barrier marker from our parent: per-link FIFO has every
            # pre-pause data message of the link applied before this runs
            self._lc_begin(wire.decode_lifecycle(payload), link)
        elif kind == wire.SNAP_ACK:
            doc = wire.decode_lifecycle(payload)
            op = self._lc_op
            if op is None or str(doc.get("id")) != op["id"]:
                log.warning("stray SNAP_ACK on link %d (id %s)", link, doc.get("id"))
                return
            if doc.get("released"):
                # a confirming child's subtree left its pause
                if op.get("release") is not None and link in op["release"]["waiting"]:
                    op["release"]["waiting"].discard(link)
                    op["release"]["unreleased"].extend(doc.get("unreleased", []))
                    self._lc_release_tick(op, time.monotonic())
                return
            if doc.get("confirms_release"):
                op["confirming"].add(link)
            op["subtree"][link] = [e.get("node") for e in doc.get("nodes", []) if isinstance(e, dict)]
            op["waiting"].discard(link)
            op["entries"].extend(doc.get("nodes", []))
            op["errors"].extend(doc.get("errors", []))
            self._snap_acks += max(1, len(doc.get("nodes", [])))
        elif kind == wire.RESUME:
            doc = wire.decode_lifecycle(payload)
            op = self._lc_op
            if op is not None and str(doc.get("id")) != op["id"]:
                # the release of a barrier we refused (and so our subtree
                # never entered): ours, or the pause deadline, releases us
                log.warning("ignoring RESUME for foreign barrier %s (active: %s)", doc.get("id"), op["id"])
                return
            for child in self._lc_children(exclude=link):  # the subtree first
                self._send_blocking(child, payload)
            self._set_paused(False)
            if op is None or op.get("release") is not None:
                return
            self._lc_release(op)  # confirmed up once our confirming children are
        elif kind == wire.CTL:
            self._handle_ctl_msg(wire.decode_lifecycle(payload), link)
        else:
            self._unknown_msgs += 1
            log.warning("link %d: ignoring message kind %d, which this peer does not speak", link, kind)

    def _record_applied(self, token: int, applied: int) -> None:
        """Parent side: a child link is gone, having had ``applied`` of its
        data messages applied here. The last 256 are kept."""
        self._gone_applied[token] = applied
        while len(self._gone_applied) > 256:
            self._gone_applied.pop(next(iter(self._gone_applied)))

    def _applied_on(self, token: int, link: int) -> Optional[int]:
        """Parent side, at a joiner's DONE: how many data messages of its
        previous link (``token``) were applied here, or None if that link
        was never ours. A previous link still up here (its end is dead at
        the child, its death not yet seen here) is dropped first, so that
        no message of it is applied after the count."""
        if not token:
            return None
        for old, (tok, _) in list(self._link_token.items()):
            if tok == token and old != link:
                applied = self._applied_count(old)
                self.node.drop_link(old)
                self._link_token.pop(old)
                self._record_applied(token, applied)
        return self._gone_applied.get(token)

    def _applied_count(self, link: int) -> int:
        """Parent side: the data messages applied from a child link that is
        leaving. On the engine the link is detached first, and the count
        read under the lock that removes it, so none is applied after it;
        a link the engine never took has Python's count."""
        applied = self._engine.detach_applied(link) if self._engine is not None else None
        return self._rx_count.get(link, 0) if applied is None else applied

    def _retract_applied(self, applied: Optional[int]) -> None:
        """Child side, at WELCOME: the frames of the severed uplink's first
        ``applied`` messages left through the parent, which rolled into our
        carry all the same and which the diff handshake brings back from
        it, so take them out of our state; None (no record, or a parent
        that does not speak the flag) leaves the carry as it is."""
        kept, self._kept = self._kept, None
        if self._engine is not None:
            # the record is in C, and dropped there whatever the WELCOME says
            n = self._engine.retract_kept(applied if kept is not None and applied is not None else 0)
        elif kept is None or applied is None:
            return
        else:
            frames = [f for seq, fs in kept[1] if seq <= applied for f in fs]
            self.st.retract_frames(frames)
            n = len(frames)
        self._carry_frames_retracted += n
        if n:
            log.info("re-join: %d frame(s) of the severed uplink were applied by the parent; retracted from the carry",
                     n)

    def _attach_diff(self, link: int, snap) -> None:
        """Open the codec link with residual = replica - ``snap``. On the
        engine this hands the link's data plane to C, with the count of
        messages Python already acknowledged on it, so the ACK stream stays
        monotonic across the handoff."""
        if self._engine is not None:
            self._engine.new_link_diff(link, snap, rx_init=self._rx_count.get(link, 0))
            self._engine_links.add(link)
        else:
            self.st.new_link_diff(link, snap)
        self._arm_sign2(link)

    def _arm_sign2(self, link: int) -> None:
        """On the engine: let the governor upshift the link when both ends
        advertised sign2, and emit v3 toward a peer that advertised the
        SHM flag. The Python tiers emit neither."""
        sign2 = self._peer_sign2.pop(link, False)
        r14 = self._peer_r14.pop(link, False)
        if self._engine is None:
            return
        if self._sign2 and sign2:
            self._engine.link_allow_sign2(link)
        if r14:
            self._engine.link_wire_v3(link)

    def _shm_ring_bytes(self) -> int:
        """One ring's bytes for this table: twice the largest traced sign2
        burst (the widest message an engine emits), so the lane holds two
        messages, at least 1 MiB and at most
        ``TransportConfig.shm_ring_bytes``."""
        spec = self.st.spec
        want = 2 * (wire.HDR_V3 + wire.burst_frames_cap(spec) * wire.frame_payload2_bytes(spec) + 64)
        return min(self.config.transport.shm_ring_bytes, max(1 << 20, want))

    def _shm_fallback(self, link: int, reason: str, serve_code: int = 0) -> None:
        """A same-host link whose lane did not attach stays on TCP. A failed
        join is on the timeline already (the transport's ring event, its
        arg the reason); a failed serve is put there here, with the
        library's code as its arg and the reason as its detail."""
        self._shm_fallbacks += 1
        log.warning("link %d keeps TCP: the shared-memory lane did not attach (%s)", link, reason)
        if serve_code and self._obs is not None:
            self._obs.event("shm_fallback", self.node.obs_id, link, serve_code, detail=reason)

    def _on_sync(self, link: int, payload: bytes) -> None:
        n_leaves, n, digest = wire.decode_sync(payload)
        if wire.sync_wire_version(payload) != self._wire_version:
            log.info("link %d joins with wire framing v%d (ours: v%d); decoders take every framing",
                     link, wire.sync_wire_version(payload), self._wire_version)
        mine = self.st.spec
        flags = wire.sync_flags(payload)
        if digest != mine.layout_digest():
            reason = (
                f"table layout mismatch: yours ({n_leaves} leaves, {n} elems) is not byte-compatible"
                f" with ours ({mine.num_leaves}, {mine.total_n})"
            )
        elif flags & compat.SYNC_FLAG_READ_ONLY:
            # a subscriber's handshake, or its resync on a live link: a
            # RANGE may follow before the DONE
            self._pending_sub[link] = None
            log.info("link %d joins read-only (subscriber handshake)", link)
            return
        else:
            # the joiner's capabilities, for its attach at DONE: sign2;
            # v3 decoding (the SHM flag, host match or not); a lane when
            # it is on our host
            self._peer_sign2[link] = bool(flags & compat.SYNC_FLAG_SIGN2)
            self._peer_r14[link] = bool(self._shm_ok and flags & compat.SYNC_FLAG_SHM)
            self._peer_shm[link] = bool(self._shm_ok and wire.sync_shm_host(payload) == self._shm_host)
            prev = wire.sync_prev_link(payload)
            if prev is not None and self._prev_link_ok:
                self._link_token[link] = prev
            self._pending[link] = bytearray(mine.total * 4)
            return
        self._reject(link, reason)

    def _reject(self, link: int, reason: str) -> None:
        log.warning("rejecting link %d: %s", link, reason)
        self._pending.pop(link, None)
        self._pending_sub.pop(link, None)
        self._send_blocking(link, wire.encode_reject(reason))
        self.node.drop_link_flushed(link)

    def _on_range(self, link: int, payload: bytes) -> None:
        """A subscriber's word range, between its SYNC and its DONE."""
        wlo, wcnt = wire.decode_range(payload)
        words = self.st.spec.total // 32
        if link not in self._pending_sub:
            log.warning("ignoring RANGE on link %d outside a subscriber handshake", link)
        elif not (0 <= wlo and 0 < wcnt and wlo + wcnt <= words):
            self._reject(link, f"range [{wlo}, {wlo + wcnt}) outside the {words}-word table")
        else:
            self._pending_sub[link] = (wlo, wcnt)

    def _attach_sub(self, link: int, rng: Optional[tuple[int, int]]) -> None:
        """Attach, or re-seed (a resync), a subscriber link, in this order:
        a resync first detaches the old residual (the snapshot about to go
        out supersedes it); the link's wire seq restarts at 1; the link is
        marked a subscriber link BEFORE its codec link opens; WELCOME, the
        snapshot of its words as CHUNKs, DONE and a FRESH mark stamped at
        the snapshot are queued BEFORE the attach, so per-link FIFO has the
        subscriber seeded before any data. The seed rides the control
        plane, which faults never touch, so a resync completes however
        lossy the data plane is. On the engine, attach and subscriber mode
        are one native call."""
        for d in (self._peer_sign2, self._peer_shm, self._peer_r14):
            d.pop(link, None)  # a subscriber link keeps TCP, v2 and 1 bit
        with self._sub_mu.setdefault(link, threading.Lock()):
            resync = link in self._sub_links
            if resync:
                self.st.drop_link(link)
                self._sub_held.pop(link, None)  # superseded by the re-seed
            with self._ack_mu:
                purged = self._unacked.pop(link, ())
                for d in (self._tx_seq, self._acked, self._ack_progress, self._retx_rounds):
                    d.pop(link, None)
            self._release_slots(purged)
            wlo, wcnt = rng if rng is not None else (0, 0)
            self._sub_links[link] = rng
            self._sub_fresh[link] = 0.0
            self._sub_mask_ver.pop(link, None)
            if self._engine is None:
                # the link's sockets hold a few of its frames, not the
                # kernel's autotuned megabytes (SUB_SOCKET_FRAMES); the
                # engine's subscriber branch paces itself in C
                self.node.cap_inflight(link, sub_socket_bytes(self.st.spec, None if rng is None else rng[1]))
            t_snap = self._now_ns()
            vals = self.st.snapshot_flat().cpu().numpy()
            self._send_blocking(link, bytes([wire.WELCOME]))
            for chunk in wire.encode_snapshot_chunks(vals[wlo * 32 : (wlo + wcnt) * 32] if rng is not None else vals):
                self._send_blocking(link, chunk)
            # last seq 0: the post-seed stream has not started
            self._send_blocking(link, wire.encode_fresh(t_snap, 0))
            if self._engine is not None:
                self._engine.new_link_sub(
                    link, vals, rx_init=self._rx_count.get(link, 0), word_lo=wlo, word_cnt=wcnt,
                    fresh_interval_sec=self.config.serve.fresh_interval_sec,
                )
                self._engine_links.add(link)
            else:
                # residual = the adds and floods that raced the snapshot
                # (usually none); _send_sub masks a range each pass
                self.st.new_link_diff(link, vals)
                self._sub_push_wake.set()
        if self._obs is not None:
            self._obs.event("sub_resync" if resync else "sub_attach", self.node.obs_id, link, wcnt)
        log.info(
            "link %d attached read-only%s%s", link,
            f" (words [{wlo}, {wlo + wcnt}))" if rng is not None else " (the whole table)",
            ", a resync re-seed" if resync else "",
        )


def create_or_fetch(
    host: str,
    port: int,
    template: Any,
    config: Config | None = None,
    timeout: float = 30.0,
    device=None,
    host_tier: bool = False,
) -> SharedTensorPeer:
    """Create the shared tensor at ``host:port`` if nobody owns it yet (the
    master, seeded from ``template``), else join the tree there (``template``
    gives only the layout). Blocks until the node is ready: a master at
    once, a joiner after the state-transfer handshake. ``device=None`` is
    the GPU and raises without one; ``host_tier=True`` runs on the CPU, on
    the native engine unless ``config.native_engine`` is False."""
    peer = SharedTensorPeer(host, port, template, config, device=device, host_tier=host_tier)
    try:
        peer.wait_ready(timeout)
    except BaseException:
        peer.close()
        raise
    return peer
