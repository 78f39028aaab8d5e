"""The read-only subscriber: a leaf of the tree that receives the table (or
a range of it) and serves reads whose staleness it has verified.

The counterpart of ``shared_tensor_tpu/serve/subscriber.py``, wire for
wire, so a port subscriber attaches under a JAX writer and a JAX
subscriber under a port writer.

1. Join: the transport grafts the subscriber under some writer; on
   LINK_UP of its uplink it sends SYNC with ``SYNC_FLAG_READ_ONLY`` (with
   ``SYNC_FLAG_RANGE`` and a RANGE message for a range) and DONE. The
   parent answers WELCOME, its snapshot of the subscribed words as CHUNKs,
   DONE and a FRESH mark stamped at the snapshot, and then streams. The
   seed rides the control plane, which fault injection never touches, so
   a join or a resync completes however lossy the data plane is.
2. Steady state: the parent streams unledgered DATA/BURST (the whole
   table) or RDATA (a range), each with its origin's trace stamp; applying
   one advances the verified freshness to that stamp. An idle parent sends
   FRESH marks ("as of t you have everything I have"), so a quiet tree
   does not read as ever staler.
3. Loss: nothing re-sends on a subscriber link, so a lost message shows as
   a seq gap (or as a FRESH whose last seq is not the last one applied).
   The subscriber desyncs, so reads past the bound refuse, and re-runs the
   handshake on the same link (at most once per
   ``ServeConfig.resync_min_interval_sec``), which re-seeds it.

Reads never touch the data plane: the receive thread publishes each
applied message through a ``core.SnapshotPublisher``, and ``read`` is a
lock-free reference read plus the staleness check. The subscriber is
host numpy, as the JAX package's is: it unpacks and applies each frame to
its pages on the CPU; ``serve.ServingHandle`` moves a verified snapshot to
the card.

Observability, as the JAX subscriber's: a registry under the
``st_read_*``/``st_sub_*`` names (``metrics()``), with the
``st_read_staleness_seconds`` histogram of the staleness each served read
verified; with obs on, the registry is registered with the process hub,
a DIGEST of it goes up the tree every ``ObsConfig.digest_interval_sec``
(so the root's cluster view counts the subscriber), and the receive loop
drains the native event ring.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from typing import Any, Optional

import numpy as np

from .. import compat
from .. import obs as _obs
from ..comm import wire
from ..comm.peer import sub_socket_bytes
from ..comm.transport import EventKind, TransportNode
from ..config import Config
from ..core import SnapshotPublisher
from ..obs import aggregate
from ..ops.codec import SAT
from ..ops.codec_np import _layout, unflatten_np
from ..ops.table import make_spec

log = logging.getLogger("shared_tensor_tpu_torch.serve")

#: A sign bit's value: bit 0 adds +scale, bit 1 adds -scale.
_SIGN = np.array([1.0, -1.0], np.float32)
#: What a malformed message raises in decode (a short one: struct.error).
_MALFORMED = (ValueError, struct.error)
#: Seconds a handshake may wait for its WELCOME or its seed before it is
#: run again (a parent that died mid-handshake must not wedge the
#: subscriber).
HANDSHAKE_RETRY_S = 5.0
#: Messages the subscriber's transport receive queue holds. With its
#: socket's receive buffer of a few frames (``comm.peer.sub_socket_bytes``,
#: set before the connect) and the writer's caps, a frame waits a few
#: frames' apply time before it is applied.
RECV_QUEUE_MSGS = 2


def epoch() -> int:
    """A freshness epoch: CLOCK_MONOTONIC nanoseconds, the clock of the
    trace stamps and FRESH marks. Take one AFTER a write, then
    ``Subscriber.wait_fresh(epoch)``; valid within one host."""
    return time.monotonic_ns()


class StalenessError(RuntimeError):
    """A read's staleness bound could not be verified: the subscriber is
    desynced, still seeding, or its newest verified instant is older than
    the bound. Raised instead of returning weights that may be stale."""

    def __init__(self, msg: str, staleness: float = float("inf")):
        super().__init__(msg)
        #: Seconds since the newest verified instant (inf: never verified,
        #: or desynced).
        self.staleness = staleness


class _Pages:
    """The subscribed words of the table and their apply: the receive
    half of the sign codec restricted to [elo, elo + 32 * wcnt),
    bit for bit the JAX subscriber's ``_apply_frame`` (value +=
    scale[leaf] * live * (1 - 2 bit), then clamped to +-SAT, so padding
    elements get +-0)."""

    def __init__(self, spec, word_lo: int, word_cnt: int):
        self.wlo, self.wcnt = word_lo, word_cnt
        elo, ehi = 32 * word_lo, 32 * (word_lo + word_cnt)
        offs, ns, padded = _layout(spec)
        # the leaves' runs inside [elo, ehi), and each element's liveness
        lo = np.clip(offs, elo, ehi)
        hi = np.clip(offs + padded, elo, ehi)
        keep = hi > lo
        self.run_leaf = np.nonzero(keep)[0]
        self.run_len = (hi - lo)[keep]
        live = np.zeros(ehi - elo, np.float32)
        for leaf, a in zip(self.run_leaf, lo[keep]):
            b = min(offs[leaf] + ns[leaf], hi[leaf])
            live[a - elo : max(a, b) - elo] = 1.0
        self.live = live
        self.vals = np.zeros(ehi - elo, np.float32)

    def apply(self, scales: np.ndarray, words: np.ndarray, word_lo: int) -> bool:
        """Apply one frame's (scales, words from ``word_lo``); False for an
        all-zero-scale no-op. A frame of the whole table covers any range;
        an RDATA of another range is a protocol error."""
        if not scales.any():
            return False
        if word_lo != self.wlo or words.size != self.wcnt:
            if word_lo == 0 and words.size >= self.wlo + self.wcnt:
                words = words[self.wlo : self.wlo + self.wcnt]
            else:
                raise ValueError(
                    f"frame words [{word_lo}, {word_lo + words.size}) do not cover the subscription "
                    f"[{self.wlo}, {self.wlo + self.wcnt})"
                )
        bits = np.unpackbits(np.ascontiguousarray(words, "<u4").view(np.uint8), bitorder="little")
        step = np.repeat(np.asarray(scales, np.float32)[self.run_leaf], self.run_len)
        step *= self.live
        step *= _SIGN[bits]
        self.vals += step
        np.clip(self.vals, -SAT, SAT, out=self.vals)
        return True


class Subscriber:
    """One read-only leaf: joins the tree at (host, port), subscribes to the
    whole table or to ``config.serve.range``, and serves verified
    bounded-staleness reads. It has no write API."""

    def __init__(self, host: str, port: int, template: Any, config: Config | None = None):
        self.config = config or Config()
        tcfg = self.config.transport
        scfg = self.config.serve
        if tcfg.wire_compat:
            raise ValueError(
                "the serving tier needs the native protocol (the reference wire format has no handshake to "
                "advertise a read-only subscriber on)"
            )
        self.spec = make_spec(template)
        words = self.spec.total // 32
        if scfg.range is not None:
            lo, hi = scfg.range
            if not (0 <= lo < hi <= self.spec.total):
                raise ValueError(f"serve range [{lo}, {hi}) outside the {self.spec.total}-element table")
            wlo, wcnt = lo // 32, -(-hi // 32) - lo // 32
        else:
            wlo, wcnt = 0, words
        self._ranged = wlo > 0 or wcnt < words
        # the only buffered state: the subscribed pages (and the published
        # copies); a ranged subscriber never allocates the whole table
        self._pages = _Pages(self.spec, wlo, wcnt)
        self._vals = self._pages.vals
        self._wlo, self._wcnt, self._elo = wlo, wcnt, 32 * wlo
        self._pub = SnapshotPublisher()
        self._version = 0
        self._fresh_ns = 0  # the newest verified instant (stamp or FRESH)
        self._synced = False  # the seq gap check is armed (after the seed)
        self._await_welcome = False
        self._seeding = False  # WELCOME seen, the CHUNK seed in flight
        self._staging = bytearray()
        self._expected_seq = 1
        self._last_resync = 0.0
        self._handshake_t0 = 0.0
        self._uplink: Optional[int] = None
        self._error: Optional[Exception] = None
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._digest_last = 0.0
        # host seconds and frames of the page apply (the serving tier's
        # cost on the CPU, for the benches)
        self.apply_s = 0.0
        self.frames_applied = 0
        self.node = TransportNode(
            host, port, tcfg, frame_bytes=wire.frame_wire_bytes(self.spec), max_children=1,
            queue_depth=RECV_QUEUE_MSGS, keepalive_sec=min(1.0, max(0.05, tcfg.peer_timeout_sec / 4)),
            rcvbuf_bytes=sub_socket_bytes(self.spec, wcnt if self._ranged else None),
        )
        if self.node.is_master:
            # a read-only replica has nothing to seed a tree with: claiming
            # an empty rendezvous would serve zeros forever
            self.node.close()
            raise ConnectionError(
                f"no tree to subscribe to at {host}:{port}: a read-only subscriber cannot become master; "
                "start a writer first"
            )
        # the JAX subscriber's registry and names; its instruments lock
        # themselves, as reads count from any thread
        self._obs_on = _obs.obs_enabled() and self.config.obs.enabled
        self._hub = _obs.hub() if self._obs_on else None
        self._reg = _obs.Registry()
        self._m_reads = self._reg.counter("st_read_total", help="serving reads served (bound verified)")
        self._m_stale = self._reg.counter("st_read_stale_total", help="reads refused: staleness bound not verifiable")
        self._m_staleness = self._reg.histogram(
            "st_read_staleness_seconds", buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0),
            help="verified staleness observed at read time",
        )
        self._m_resyncs = self._reg.counter("st_sub_resyncs_total", help="re-seed handshakes")
        self._m_gaps = self._reg.counter("st_sub_gap_discards_total", help="data messages discarded while desynced")
        self._m_fresh = self._reg.counter("st_sub_fresh_marks_total", help="FRESH drain marks applied")
        self._reg.register_collector(self._collect)
        self._label = f"sub-{self.node.obs_id}"
        if self._hub is not None:
            self._hub.register_registry(self._label, self._reg)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="st-sub")
        self._thread.start()

    # -- user API ------------------------------------------------------------

    def read(self, max_staleness: Optional[float] = None) -> Any:
        """The subscribed state verified at most ``max_staleness`` seconds
        behind (default ``ServeConfig.max_staleness_sec``), or raise
        :class:`StalenessError`: the template's tree of numpy arrays for
        the whole table, the raw f32 page array for a range. Lock-free."""
        flat, _staleness, _ver = self.read_flat(max_staleness)
        if self._ranged:
            return flat
        return unflatten_np(flat, self.spec)

    def read_flat(self, max_staleness: Optional[float] = None) -> tuple[np.ndarray, float, int]:
        """(flat f32 snapshot of the subscribed pages, verified staleness
        seconds, snapshot version), all three from ONE acquire, so the
        version always labels the array returned. Do not write into the
        array: it is the published snapshot. Raises StalenessError when the
        bound cannot be verified."""
        bound = self.config.serve.max_staleness_sec if max_staleness is None else float(max_staleness)
        err = self._error
        if err is not None:
            self._m_stale.inc()
            raise StalenessError(f"subscriber failed: {err}") from err
        arr, fresh_ns, ver = self._pub.acquire()
        if arr is None or fresh_ns <= 0:
            self._m_stale.inc()
            raise StalenessError("no verified-fresh state yet (still seeding)")
        staleness = max(0.0, (time.monotonic_ns() - fresh_ns) / 1e9)
        if staleness > bound:
            self._m_stale.inc()
            raise StalenessError(
                f"state is {staleness:.3f}s behind, bound {bound:.3f}s (desynced or writer unreachable: reads "
                "refuse rather than serve silently stale weights)",
                staleness,
            )
        self._m_reads.inc()
        self._m_staleness.observe(staleness)
        return arr, staleness, ver

    def wait_fresh(self, epoch_ns: int, timeout: float = 30.0) -> None:
        """Block until the state provably includes every update that
        originated at or before ``epoch_ns`` (an :func:`epoch` taken after
        the write): until the verified instant reaches it. TimeoutError
        past ``timeout``; StalenessError if the subscriber failed."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            err = self._error
            if err is not None:
                raise StalenessError(f"subscriber failed: {err}") from err
            if self._pub.acquire()[1] >= epoch_ns:
                return
            time.sleep(0.002)
        behind = (epoch_ns - self._pub.acquire()[1]) / 1e9
        raise TimeoutError(f"state did not reach the epoch within {timeout}s (behind by {behind:.3f}s)")

    def wait_ready(self, timeout: float = 30.0) -> None:
        """Block until seeded and verified fresh once (a read can succeed)."""
        if not self._ready.wait(timeout):
            if self._error is not None:
                raise self._error
            raise TimeoutError(f"subscriber not ready after {timeout}s")
        if self._error is not None:
            raise self._error

    def staleness(self) -> float:
        """Seconds since the newest verified instant (inf before the first)."""
        fresh_ns = self._pub.acquire()[1]
        if fresh_ns <= 0:
            return float("inf")
        return max(0.0, (time.monotonic_ns() - fresh_ns) / 1e9)

    @property
    def version(self) -> int:
        """Monotone snapshot version (one per applied message)."""
        return self._pub.acquire()[2]

    @property
    def range_elements(self) -> tuple[int, int]:
        """The buffered element range [lo, hi), word aligned (the whole
        padded table without a range)."""
        return self._elo, self._elo + self._vals.size

    @property
    def buffered_bytes(self) -> int:
        """Bytes of the page buffer (the published copies are as large)."""
        return self._vals.nbytes

    def serving_handle(self, max_staleness: Optional[float] = None, device=None):
        """A :class:`serve.ServingHandle` over this subscription: verified
        snapshots as torch tensors on ``device`` (None: the GPU)."""
        from .handle import ServingHandle

        return ServingHandle(self, max_staleness=max_staleness, device=device)

    def metrics(self) -> dict:
        """The registry's snapshot under the JAX subscriber's names: the
        counters ``st_read_total``, ``st_read_stale_total``,
        ``st_sub_resyncs_total``, ``st_sub_gap_discards_total`` and
        ``st_sub_fresh_marks_total``, the ``st_read_staleness_seconds``
        histogram, and the gauges ``st_sub_freshness_seconds`` (-1 before
        the first verification) and ``st_sub_range_words``."""
        return self._reg.snapshot()

    def _collect(self) -> dict:
        fresh_ns = self._pub.acquire()[1]
        return {
            "st_sub_freshness_seconds": (time.monotonic_ns() - fresh_ns) / 1e9 if fresh_ns > 0 else -1.0,
            "st_sub_range_words": self._wcnt,
        }

    def close(self) -> None:
        """Stop the receive thread and leave the tree; reads go on serving
        the last published snapshot within their bound. The node is closed
        only once the thread that uses it has stopped (it checks between
        messages, each at most one frame's apply)."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise RuntimeError("the subscriber's receive thread did not stop; its node is left open")
        if self._hub is not None:
            self._hub.poll_native()  # the last drain: no event stays stranded in the ring
            self._hub.unregister_registry(self._label)
        self.node.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- protocol ------------------------------------------------------------

    def _event(self, name: str, link: int = 0, arg: int = 0) -> None:
        if self._hub is not None:
            self._hub.emit(name, node=self.node.obs_id, link=link, arg=arg)

    def _send_ctrl(self, link: int, payload: bytes) -> bool:
        """A small control send, retried a bounded number of times."""
        for _ in range(50):
            if self._stop.is_set():
                return False
            try:
                if self.node.send(link, payload, timeout=0.1):
                    return True
            except BrokenPipeError:
                return False
        return False

    def _start_handshake(self, uplink: int, resync: bool) -> None:
        """SYNC (+ RANGE) + DONE; the parent answers with its snapshot of
        our pages over the control plane (module docstring)."""
        self._synced = False
        self._seeding = False
        self._await_welcome = True
        self._handshake_t0 = time.monotonic()
        # no SIGN2 and no SHM: a subscriber link stays 1-bit, v2 and on TCP
        flags = compat.SYNC_FLAG_READ_ONLY | (compat.SYNC_FLAG_RANGE if self._ranged else 0)
        ok = self._send_ctrl(uplink, wire.encode_sync(self.spec, compat.WIRE_VERSION_V2, flags))
        if ok and self._ranged:
            ok = self._send_ctrl(uplink, wire.encode_range(self._wlo, self._wcnt))
        if ok:
            ok = self._send_ctrl(uplink, bytes([wire.DONE]))
        if ok and resync:
            self._m_resyncs.inc()
            self._event("sub_resync", uplink)
        elif ok:
            # this side's scope of the link: attached first, so that its
            # resyncs follow an attach as the protocol model requires (the
            # JAX subscriber emits its resyncs alone)
            self._event("sub_attach", uplink, self._wcnt)
        if not ok:
            log.warning("subscriber handshake send failed (uplink down?)")

    def _desync(self, why: str, seq: int = 0) -> None:
        if self._synced:
            log.info("subscriber desynced (%s, seq %d): will resync", why, seq)
        self._synced = False

    def _maybe_resync(self) -> None:
        up = self._uplink
        if up is None or self._synced:
            return
        now = time.monotonic()
        if (self._await_welcome or self._seeding) and now - self._handshake_t0 < HANDSHAKE_RETRY_S:
            return
        if now - self._last_resync < self.config.serve.resync_min_interval_sec:
            return
        self._last_resync = now
        self._start_handshake(up, resync=True)

    def _publish(self) -> None:
        self._version += 1
        self._pub.publish(self._vals.copy(), self._fresh_ns, self._version)
        if self._fresh_ns > 0:
            self._ready.set()

    def _apply(self, scales, words, word_lo: int) -> bool:
        t0 = time.perf_counter()
        changed = self._pages.apply(np.asarray(scales), np.asarray(words), word_lo)
        self.apply_s += time.perf_counter() - t0
        self.frames_applied += changed
        return changed

    def _on_data(self, payload: bytes) -> bool:
        """One DATA, BURST or RDATA message; True if the state changed."""
        seq = wire.data_seq(payload)
        if not self._synced:
            self._m_gaps.inc()
            return False
        if seq != self._expected_seq & 0xFFFFFFFF:
            if seq == (self._expected_seq - 1) & 0xFFFFFFFF:
                return False  # a duplicate: drop it quietly
            # nothing re-delivers on this link: desync and re-seed
            self._m_gaps.inc()
            self._desync("seq gap", seq)
            return False
        kind = payload[0]
        changed = False
        try:
            if kind == wire.RDATA:
                scales, words, wlo, _wcnt, trace = wire.decode_rdata(payload, self.spec)
                changed = self._apply(scales, words, wlo)
            elif kind == wire.DATA:
                f = wire.decode_frame(payload, self.spec)
                trace = wire.data_trace(payload, self.spec)
                changed = self._apply(f.scales, f.words, 0)
            else:  # BURST
                trace = wire.data_trace(payload, self.spec)
                for f in wire.decode_burst(payload, self.spec):
                    changed |= self._apply(f.scales, f.words, 0)
        except _MALFORMED as e:
            # a sheared or garbled message: its seq is not consumed, and as
            # nothing re-sends it, only a re-seed repairs the loss
            log.warning("undecodable data message (seq %d): %s", seq, e)
            self._m_gaps.inc()
            self._desync("undecodable", seq)
            return False
        self._expected_seq += 1
        if trace is not None and trace[1] > self._fresh_ns:
            # the state now includes an update that originated at the stamp
            # (and, FIFO and in order, all the parent folded in before it)
            self._fresh_ns = trace[1]
        return changed

    def _on_message(self, link: int, payload: bytes) -> bool:
        kind = payload[0]
        if kind in (wire.DATA, wire.BURST, wire.RDATA):
            return self._on_data(payload)
        if kind == wire.WELCOME:
            # the parent's snapshot of our pages follows as CHUNKs
            self._await_welcome = False
            self._seeding = True
            self._staging = bytearray(self._vals.size * 4)
            return True
        if kind == wire.CHUNK:
            if self._seeding:
                wire.decode_chunk_into(payload, self._staging)
            return True
        if kind == wire.DONE:
            if self._seeding:
                # adopt the snapshot and arm the gap check at 1; freshness
                # comes back with the FRESH mark stamped at the snapshot
                self._vals[:] = np.frombuffer(self._staging, "<f4")
                self._staging = bytearray()
                self._seeding = False
                self._expected_seq = 1
                self._synced = True
                self._fresh_ns = 0
                self._publish()
            return True
        if kind == wire.FRESH:
            t, last_seq = wire.decode_fresh(payload)
            if not self._synced:
                return True
            if last_seq != (self._expected_seq - 1) & 0xFFFFFFFF:
                # the mark covers messages we never saw (the stream's tail
                # was lost, which no later data would show on an idle tree)
                self._m_gaps.inc()
                self._desync("fresh-mark seq mismatch", last_seq)
                return True
            if t > self._fresh_ns:
                self._fresh_ns = t
                self._m_fresh.inc()
                self._pub.touch(self._fresh_ns)
                self._ready.set()
            return True
        if kind == wire.REJECT:
            self._error = ConnectionError(f"parent rejected subscription: {wire.decode_reject(payload)}")
            self._ready.set()
            return True
        if kind == wire.SYNC:
            # a node tried to join below us: a read-only leaf seeds nobody
            self._send_ctrl(link, wire.encode_reject("read-only subscriber accepts no children"))
            self.node.drop_link_flushed(link)
            return True
        return False  # ACK, DIGEST, ...: not ours

    def _loop(self) -> None:
        while not self._stop.is_set():
            busy = False
            for ev in self.node.poll_events(timeout=0.0):
                busy = True
                if ev.kind == EventKind.LINK_UP:
                    if ev.is_uplink:
                        self._uplink = ev.link_id
                        self._error = None
                        self._start_handshake(ev.link_id, resync=False)
                    # a child link stays up just long enough for its SYNC
                    # to be refused (_on_message)
                elif ev.kind == EventKind.LINK_DOWN and ev.is_uplink:
                    self._uplink = None
                    self._desync("uplink down")
                elif ev.kind == EventKind.BECAME_MASTER:
                    self._error = ConnectionError(
                        "subscriber was elected master (every writer died): a read-only replica cannot serve the "
                        "tree; restart a writer and create the subscriber again"
                    )
                    self._desync("became master")
                    self._ready.set()
                elif ev.kind == EventKind.REJOIN_FAILED:
                    self._desync("rejoin failed")
            up = self._uplink
            if up is not None:
                for _ in range(256):
                    if self._stop.is_set():
                        break  # a backlog of frames may take seconds to apply
                    try:
                        payload = self.node.recv(up, timeout=0.0)
                    except BrokenPipeError:
                        break
                    if payload is None:
                        break
                    busy = True
                    try:
                        changed = self._on_message(up, payload)
                    except _MALFORMED as e:
                        log.warning("dropping bad message: %s", e)
                        continue
                    if changed:
                        # publish per applied message: under load the loop
                        # stays busy for seconds, and readers must see
                        # freshness move with every apply
                        self._publish()
            for link in self.node.links:
                if link == up:
                    continue
                try:
                    payload = self.node.recv(link, timeout=0.0)
                except BrokenPipeError:
                    continue
                if payload is not None:
                    busy = True
                    try:
                        self._on_message(link, payload)
                    except _MALFORMED as e:
                        log.warning("dropping bad child message: %s", e)
            self._maybe_resync()
            if self._hub is not None:
                self._beat()
            if not busy:
                time.sleep(0.002)

    def _beat(self) -> None:
        """The housekeeping of the loop with obs on: the digest up the
        tree every ``digest_interval_sec``, and the native ring's drain."""
        interval = self.config.obs.digest_interval_sec
        now = time.monotonic()
        if interval > 0 and self._uplink is not None and now - self._digest_last >= interval:
            self._digest_last = now
            doc = aggregate.from_snapshot(self.node.obs_id, self._reg.snapshot(), time.monotonic_ns())
            aggregate.bounded(doc)
            try:
                self.node.send(self._uplink, wire.encode_digest(doc), timeout=0.05)
            except BrokenPipeError:
                pass  # the uplink died; the next beat goes to the new one
        self._hub.poll_native(self.config.obs.native_drain_interval_sec)


def subscribe(host: str, port: int, template: Any, config: Config | None = None, timeout: float = 30.0) -> Subscriber:
    """Create a :class:`Subscriber` and block until its first verified read
    can succeed: the serving twin of ``create_or_fetch``."""
    sub = Subscriber(host, port, template, config)
    try:
        sub.wait_ready(timeout)
    except BaseException:
        sub.close()
        raise
    return sub
