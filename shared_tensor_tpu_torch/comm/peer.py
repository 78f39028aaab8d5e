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
``frame_burst`` halvings synchronously per message. The receive thread is
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

Not ported (later slices): the reference wire format, subscribers, the
shared-memory lane, sign2, lifecycle and operator commands, sharding,
fault injection and the observability plane. A joiner that asks for one
of them in its SYNC is refused with a REJECT that names it; metrics
digests and clock probes from a JAX child are counted and dropped; any
other message kind the port does not speak is logged, counted and
dropped.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np

from ..config import Config
from ..core import SharedTensor, resolve_device
from ..ops.table import make_spec
from . import wire
from .engine import EngineTensor, engine_eligible
from .transport import EventKind, TransportNode

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
#: SYNC flags the port refuses, with what each asks for.
_UNSERVED = {
    wire.SYNC_FLAG_READ_ONLY: "read-only subscribers",
    wire.SYNC_FLAG_RANGE: "range subscriptions",
    wire.SYNC_FLAG_SHARD: "the cluster-sharded tensor",
}
#: Control kinds a JAX child sends on its own (metrics digests, clock
#: probes): dropped and counted.
_IGNORED_KINDS = (wire.DIGEST, wire.CLOCK)
_TIMERS = ("send_loop_busy", "encode", "send", "decode", "apply")


class SpecMismatch(ConnectionError):
    """The tree holds a different table layout, or refused this joiner."""


def _python_tier_auto_burst(spec) -> int:
    """The Python host tier's auto burst: each burst frame is a full
    synchronous rescan under the state lock, so only small tables, where
    the per-message cost dominates, burst."""
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
        dev = resolve_device(device, host_tier)  # before any socket: no GPU, no node
        spec = make_spec(template)
        cap = wire.burst_frames_cap(spec)
        use_engine = engine_eligible(self.config, host_tier)
        # bursts have no idle frames to send: without suppression, stream
        burstable = self.config.codec.suppress_zero_frames
        if not burstable:
            self._burst = 1
        elif self.config.frame_burst == 0:
            # the engine fills the wire message budget; the Python host
            # tier bursts small tables only
            self._burst = cap if use_engine else _python_tier_auto_burst(spec)
        else:
            self._burst = max(1, self.config.frame_burst)
        self._burst = min(self._burst, cap)  # every peer's receive bound
        if host_tier or not burstable:
            self._burst_device = 1
        elif self.config.device_frame_burst == 0:
            self._burst_device = min(16, cap)
        else:
            self._burst_device = max(1, min(cap, self.config.device_frame_burst))
        # one receive batch (one flood apply) takes at most one full burst
        self._batch_cap = cap
        # every peer sizes its receive buffer for the largest message of
        # this spec any peer may send (handshake-identical layout)
        self.node = TransportNode(
            host,
            port,
            tcfg,
            frame_bytes=wire.frame_wire_bytes(spec),
            max_children=tcfg.max_children,
            keepalive_sec=min(1.0, max(0.05, tcfg.peer_timeout_sec / 4)),
        )
        self.is_master = self.node.is_master
        # the native engine's links (its receiver consumes their DATA, BURST
        # and ACK; the Python loops leave them alone)
        self._engine: Optional[EngineTensor] = None
        self._engine_links: set[int] = set()
        try:
            if use_engine:
                self.st = self._engine = EngineTensor(
                    template, self.config.codec, seed_values=self.is_master, node=self.node,
                    burst=self._burst, recv_cap=wire.frame_wire_bytes(spec),
                    quarantine_send_failures=tcfg.quarantine_send_failures,
                    ack_timeout_sec=tcfg.ack_timeout_sec, ack_retry_limit=tcfg.ack_retry_limit,
                    cascade_frames=self.config.codec.cascade_frames,
                )
            else:
                self.st = SharedTensor(
                    template, self.config.codec, seed_values=self.is_master, device=dev, host_tier=host_tier
                )
        except BaseException:
            self.node.close()
            raise
        log.info(
            "peer on the %s", "native engine" if use_engine else ("Python host tier" if host_tier else f"{dev} tier")
        )
        # v2 trace stamp (origin node, origin monotonic ns, hops) sent with
        # every DATA/BURST: re-seeded by add(), advanced by each applied
        # traced message. A tuple, assigned whole.
        self._trace_stamp: Optional[tuple[int, int, int]] = None
        self._ready = threading.Event()
        self._error: Optional[Exception] = None
        if self.is_master:
            self._ready.set()
        self._stop = threading.Event()
        self._wake = threading.Event()
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
        self._paused = False  # pause(): produce no new frames
        self._uplink: Optional[int] = None
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
        self._ctrl_ignored = 0
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
        # on the engine, its own sender thread sends on every link
        self._threads = (threading.Thread(target=self._recv_loop, daemon=True, name="st-recv"),)
        if self._engine is None:
            self._threads += (threading.Thread(target=self._send_loop, daemon=True, name="st-send"),)
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
            self._trace_stamp = (self.node.obs_id, time.monotonic_ns(), 0)
        self._wake.set()

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
        loses nothing. The pow2 scale flushes subnormal RMS to 0, so after
        long add sequences pass a tiny ``tol`` (1e-30)."""
        deadline = time.time() + timeout
        # the engine quiesces in microseconds; the Python tiers need the
        # coarser poll to stay off their state lock
        poll = 0.005 if self._engine is not None else 0.05
        while time.time() < deadline and not self._stop.is_set():
            links = [l for l in self.st.link_ids if l >= 0]
            if all(self.st.residual_rms(l) <= tol for l in links):
                stats = [self.node.stats(l) for l in self.node.links]
                if all(s is None or s.send_queue == 0 for s in stats) and self.st.inflight_total() == 0:
                    return True
            time.sleep(poll)
        return False

    def leave(self, timeout: float = 60.0, tol: float = 1e-30) -> bool:
        """Graceful exit that loses nothing mid-stream: seal (incoming data
        is discarded unacknowledged, so its senders re-deliver it around
        us), drain what we owe, close. Returns the drain's verdict."""
        if self._engine is not None:
            self._engine.seal()
        self._sealed = True
        ok = self.drain(timeout=timeout, tol=tol)
        self.close()
        return ok

    def close(self) -> None:
        """Leave the tree; the other peers re-graft and carry on."""
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._engine is not None:
            # its threads wait inside the node's queues: stop them first
            self._engine.stop()
        self.node.close()
        if self._engine is not None:
            self._engine.destroy()

    def pause(self, paused: bool = True) -> None:
        """Stop (or resume) producing new frames; what is in flight is
        still delivered and acknowledged. On the engine this returns once
        the sender's current pass is over; the Python send loop checks the
        flag at each link."""
        self._paused = paused
        if self._engine is not None:
            self._engine.pause(paused)
        if not paused:
            self._wake.set()

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    def threads_alive(self) -> bool:
        """The peer's Python threads are running: receive and send, or on
        the engine receive only."""
        return all(t.is_alive() for t in self._threads)

    def metrics(self) -> dict:
        """Counters under the JAX package's names (``st_frames_*``: non-idle
        codec frames; ``st_msgs_*``: DATA/BURST messages; ``st_link_*``:
        the transport's per-link totals of live links, control messages and
        framing included), the port's own counters (non-idle frames sent
        per link, ever; the receive faults survived, 0 on a healthy peer:
        ``st_apply_dropped_total``, ``st_msg_errors_total``,
        ``st_recv_restarts_total``), and the host seconds spent per stage of the data
        path (``st_*_seconds_total``)."""
        if self._engine is not None:
            # one counter snapshot: separate reads would mix instants
            c = self._engine.counters()
            frames_out, frames_in, updates, msgs_out, msgs_in = (int(x) for x in c[:5])
            retransmits, dedup = int(c[8]), int(c[9])
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
            "st_ctrl_ignored_total": self._ctrl_ignored,
            "st_unknown_msgs_total": self._unknown_msgs,
            "st_apply_dropped_total": self._apply_dropped,
            "st_msg_errors_total": self._msg_errors,
            "st_recv_restarts_total": self._recv_restarts,
            "st_data_bytes_out_total": self._data_bytes_out,
            "st_data_bytes_in_total": self._data_bytes_in,
            "st_corrupt_scales_zeroed_total": wire.corrupt_scales_zeroed(),
            "st_fetch_wait_seconds_total": self.st.fetch_wait_s,
            "st_h2d_seconds_total": self.st.h2d_s,
            "st_apply_lock_wait_seconds_total": self.st.apply_lock_wait_s,
        }
        out.update({f"st_{k}_seconds_total": v for k, v in self._secs.items()})
        if self._engine is not None:
            out.update(self._engine.obs_stats())
            p = self._engine.pool_stats()
            out["st_tx_slot_acquires_total"] = p["tx_slot_acquires"]
            out["st_tx_slot_alloc_events_total"] = p["tx_slot_alloc_events"]
            out["st_tx_slots_allocated"] = p["tx_slots_allocated"]
        for link, n in list(self._link_frames_out.items()):
            out[f'st_link_frames_out_total{{link="{link}"}}'] = n
        for link in self.node.links:
            s = self.node.stats(link)
            if s is not None:
                out[f'st_link_bytes_out_total{{link="{link}"}}'] = s.bytes_out
                out[f'st_link_bytes_in_total{{link="{link}"}}'] = s.bytes_in
                out[f'st_link_wire_msgs_out_total{{link="{link}"}}'] = s.frames_out
                out[f'st_link_wire_msgs_in_total{{link="{link}"}}'] = s.frames_in
        return out

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
            t_pass = time.perf_counter()
            sent_any = False
            links = [l for l in self.st.link_ids if l >= 0]  # not the carry
            for stale in [l for l in pipe if l not in links]:
                del pipe[stale]  # the link's drop already rolled its ledger back
                hot.discard(stale)
            for link in links:
                if self._paused and not pipe.get(link):
                    continue  # paused: what is in the pipeline still goes out
                if self._window_full(link):
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
                    if self._send_blocking(link, payload):
                        sent_any = True
                    else:
                        self.st.nack_frame(link)
                    continue
                q = pipe.setdefault(link, deque())
                # a cold link risks one speculative frame, a hot one keeps
                # the whole pipeline of fetches in flight
                while len(q) < (depth if link in hot else 1):
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
                if k > 1:
                    payload = self._register_data(
                        link, seq, lambda buf, s, t: wire.encode_burst_into(frame, spec, s, buf, trace=t)
                    )
                else:
                    payload = self._register_data(
                        link, seq, lambda buf, s, t: wire.encode_frame_into(frame, s, buf, trace=t)
                    )
                if self._send_blocking(link, payload):
                    sent_any = True
                else:
                    # the link died with this frame (and its successors in
                    # the pipeline) undelivered: roll their error feedback
                    # back, so the drop or carry sees all that is owed
                    pipe.pop(link, None)
                    hot.discard(link)
                    self.st.nack_frame(link)
            self._check_retransmit(links)
            self._secs["send_loop_busy"] += time.perf_counter() - t_pass
            if self._stop.is_set():
                return
            if interval > 0:
                time.sleep(interval)
            elif not sent_any:
                self._wake.wait(0.05)  # until an add or an incoming frame
                self._wake.clear()

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
        if trace is None:
            trace = (self.node.obs_id, time.monotonic_ns(), 0)
        slot = self._tx_pool.acquire()
        t0 = time.perf_counter()
        payload = slot[: encode_into(slot, txs, trace)]
        self._secs["encode"] += time.perf_counter() - t0
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
                self.node.drop_link(link)
                continue
            log.info("link %d: retransmitting %d unacked message(s), round %d", link, len(tail), rounds)
            self._retransmits += len(tail)
            for payload in tail:
                self._data_bytes_out += len(payload)
                if not self._send_blocking(link, payload):
                    break

    def _release_slots(self, entries) -> None:
        for entry in entries:
            self._tx_pool.release(entry[3])

    def _send_blocking(self, link: int, payload) -> bool:
        """Deliver one message, riding out backpressure. False on a dead
        link, or after ``quarantine_send_failures`` consecutive refusals
        (~0.1 s each: the peer stopped draining), when the link is torn
        down for re-graft."""
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
                    self.node.drop_link(link)
                    return False
            return False
        finally:
            self._secs["send"] += time.perf_counter() - t0

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
                if failures >= 3:
                    self._error = e
                    self._ready.set()
                    raise
                time.sleep(0.1)

    def _recv_loop_inner(self) -> None:
        spec = self.st.spec
        while not self._stop.is_set():
            busy = self._handle_events()
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
                if link in self._engine_links:
                    continue  # the engine's receiver consumes these
                # Consecutive DATA/BURST messages of a link go into ONE flood
                # apply; a control message flushes them first (order). msgs
                # counts accepted messages (what the ACK acknowledges).
                batch: list = []
                traced: list = []
                msgs = 0
                for _ in range(256):  # bounded so other links are not starved
                    try:
                        payload = self.node.recv(link, timeout=0.0)
                    except BrokenPipeError:
                        break
                    if payload is None:
                        break
                    busy = True
                    if payload[0] in (wire.DATA, wire.BURST):
                        if self._sealed:
                            continue  # leaving: the sender re-delivers it elsewhere
                        # go-back-N: only the next seq is applied; a duplicate
                        # or anything after a gap is discarded unacknowledged
                        # (the sender re-sends), and so is a message that does
                        # not decode, without consuming its seq
                        t0 = time.perf_counter()
                        try:
                            seq = wire.data_seq(payload)
                            want = (self._rx_count.get(link, 0) + msgs + 1) & 0xFFFFFFFF
                            if seq != want:
                                log.debug("link %d: discarding out-of-order data (seq %d, expected %d)",
                                          link, seq, want)
                                self._dedup += 1
                                continue
                            if payload[0] == wire.DATA:
                                frames = [wire.decode_frame(payload, spec)]
                            else:
                                frames = wire.decode_burst(payload, spec)
                        except ValueError as e:
                            log.warning("dropping bad frame on link %d: %s", link, e)
                            continue
                        finally:
                            self._secs["decode"] += time.perf_counter() - t0
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
            self._secs["apply"] += time.perf_counter() - t0
            self._wake.set()  # the flood refilled the other links' residuals
        if msgs:
            self._ack_received(link, msgs)
        for p in traced:
            tr = wire.data_trace(p, self.st.spec)
            if tr is not None:
                origin, gen, hops = tr
                self._trace_stamp = (origin, gen, min(hops + 1, 255))

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

    def _handle_events(self) -> bool:
        evs = self.node.poll_events(timeout=0.0)
        for ev in evs:
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
            self._start_join(ev.link_id)

    def _on_membership_event(self, ev) -> None:
        if ev.kind == EventKind.LINK_DOWN:
            self._pending.pop(ev.link_id, None)
            self._engine_links.discard(ev.link_id)
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
                    stashed = self._engine.stash_carry(ev.link_id)
                else:
                    stashed = self.st.stash_carry(ev.link_id, CARRY_LINK)
                if not stashed and self._sent_snapshot is not None:
                    self._mid_handshake_base = self._sent_snapshot
                self._sent_snapshot = None
                self._uplink = None
            else:
                self.st.drop_link(ev.link_id)
        elif ev.kind == EventKind.BECAME_MASTER:
            # the parent died and nobody held the rendezvous: we are the new
            # root; our replica is the authoritative seed, and the carry's
            # mass is already in it
            if self._engine is not None:
                self._engine.drop_carry()
            else:
                self.st.take_link_and_snapshot(CARRY_LINK)
            self._mid_handshake_base = None
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
        self._send_blocking(uplink, wire.encode_sync(self.st.spec, wire.WIRE_VERSION_V2))
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
            for entry in popped:
                self.st.ack_frame(link, entry[0])
        elif kind == wire.SYNC:
            self._on_sync(link, payload)
        elif kind == wire.CHUNK:
            buf = self._pending.get(link)
            if buf is not None:
                wire.decode_chunk_into(payload, buf)
        elif kind == wire.DONE:
            buf = self._pending.pop(link, None)
            if buf is not None:
                snap = np.frombuffer(bytes(buf), "<f4")
                # WELCOME goes out BEFORE the codec link opens: per-link FIFO
                # then puts it ahead of our first DATA, which the child would
                # otherwise apply AND count again in its attach diff
                self._send_blocking(link, wire.encode_welcome(0))
                self._attach_diff(link, snap)
                self._wake.set()
        elif kind == wire.WELCOME:
            snap, self._sent_snapshot = self._sent_snapshot, None
            if snap is not None:
                # owed upward: everything the snapshot did not claim (the
                # carry plus adds and floods during the handshake)
                self._attach_diff(link, snap)
            elif self._engine is not None:  # a duplicate WELCOME
                self._engine.new_link(link, seed=False, rx_init=self._rx_count.get(link, 0))
                self._engine_links.add(link)
            else:
                self.st.new_link(link, seed=False)
            self._ready.set()
            self._wake.set()
        elif kind == wire.REJECT:
            self._error = SpecMismatch(wire.decode_reject(payload))
            self._ready.set()
        elif kind in _IGNORED_KINDS:
            self._ctrl_ignored += 1
        else:
            self._unknown_msgs += 1
            log.warning("link %d: ignoring message kind %d, which this peer does not speak", link, kind)

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

    def _on_sync(self, link: int, payload: bytes) -> None:
        n_leaves, n, digest = wire.decode_sync(payload)
        if wire.sync_wire_version(payload) != wire.WIRE_VERSION_V2:
            log.info("link %d joins with wire framing v%d (ours: v2); decoders take both",
                     link, wire.sync_wire_version(payload))
        mine = self.st.spec
        flags = wire.sync_flags(payload)
        if digest != mine.layout_digest():
            reason = (
                f"table layout mismatch: yours ({n_leaves} leaves, {n} elems) is not byte-compatible"
                f" with ours ({mine.num_leaves}, {mine.total_n})"
            )
        elif flags & sum(_UNSERVED):
            asked = ", ".join(v for f, v in _UNSERVED.items() if flags & f)
            reason = f"this peer does not serve {asked}"
        else:
            self._pending[link] = bytearray(mine.total * 4)
            return
        log.warning("rejecting link %d: %s", link, reason)
        self._send_blocking(link, wire.encode_reject(reason))
        self.node.drop_link_flushed(link)
        self._pending.pop(link, None)


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
