"""ctypes binding of the native C++ TCP transport (``native/sttransport.cpp``).

The counterpart of ``shared_tensor_tpu/comm/transport.py``. The native
library owns the wire: the self-organising binary-tree overlay, framed
streaming, pacing, liveness and rejoin; messages are opaque bytes at this
layer and the peer (``comm/peer.py``) gives them meaning.

The library is the port's own build (``_build.build_transport``), loaded
at first use. It owns the process-wide native event ring that ``obs``
drains (``st_obs_drain``, ``st_obs_now_ns``, ``st_obs_dropped``); the ring,
and with it the engine's per-message trace bookkeeping, is on unless
``obs.obs_enabled()`` is false (``ST_OBS=0``, which the library also reads
itself, or ``obs.set_enabled(False)`` before the first load).

The node speaks the native framing or, with ``TransportConfig.wire_compat``,
the reference's raw frames of ``frame_bytes`` each; a link may run over
``stripe_count`` sockets (:meth:`TransportNode.stripe_stats`), and its
data plane may move onto a same-host shared-memory lane that the peer
negotiates (:meth:`TransportNode.shm_serve` on the parent,
:meth:`TransportNode.shm_join` on the child, :meth:`TransportNode.shm_stats`).

A node's methods may be called from several threads, and one of them may
close it (a routed drain closes its peer on a thread of its own): every
native call holds the handle (``_enter``/``_exit``), and :meth:`close`
takes the handle away at once and frees it only after the calls in
progress have returned, so no call runs on a freed node. On a closed node
``send`` and ``recv`` raise ``BrokenPipeError`` and the queries return
their empty answers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import threading
import time
from typing import Optional

from .. import _build
from ..config import TransportConfig


class _StConfigC(ctypes.Structure):
    _fields_ = [
        ("wire_compat", ctypes.c_int32),
        ("compat_frame_bytes", ctypes.c_int32),
        ("listen_backlog", ctypes.c_int32),
        ("bandwidth_cap_bps", ctypes.c_int64),
        ("peer_timeout_sec", ctypes.c_double),
        ("keepalive_sec", ctypes.c_double),
        ("max_children", ctypes.c_int32),
        ("queue_depth", ctypes.c_int32),
        ("max_rejoin_attempts", ctypes.c_int32),
        ("rejoin_backoff_sec", ctypes.c_double),
        ("connect_timeout_sec", ctypes.c_double),
        ("join_timeout_sec", ctypes.c_double),
        ("stripe_count", ctypes.c_int32),
        ("rcvbuf_bytes", ctypes.c_int32),
    ]


class _StEventC(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("link_id", ctypes.c_int32),
        ("is_uplink", ctypes.c_int32),
    ]


class _StStatsC(ctypes.Structure):
    _fields_ = [
        ("bytes_out", ctypes.c_uint64),
        ("bytes_in", ctypes.c_uint64),
        ("frames_out", ctypes.c_uint64),
        ("frames_in", ctypes.c_uint64),
        ("send_queue", ctypes.c_int32),
        ("recv_queue", ctypes.c_int32),
    ]


class EventKind(enum.IntEnum):
    LINK_UP = 1
    LINK_DOWN = 2
    BECAME_MASTER = 3
    REJOIN_FAILED = 4


@dataclasses.dataclass(frozen=True)
class Event:
    kind: EventKind
    link_id: int
    is_uplink: bool


@dataclasses.dataclass(frozen=True)
class LinkStats:
    """Per-link transport counters. ``frames_*`` count wire messages, data
    and control alike (keepalives excluded); ``bytes_*`` include framing
    headers and keepalives."""

    bytes_out: int
    bytes_in: int
    frames_out: int
    frames_in: int
    send_queue: int
    recv_queue: int


_lib: Optional[ctypes.CDLL] = None
_lib_mu = threading.Lock()

_VP, _I32 = ctypes.c_void_p, ctypes.c_int32
_SIGNATURES = {
    "st_node_create": (_VP, [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_StConfigC), ctypes.POINTER(_I32)]),
    "st_node_obs_id": (ctypes.c_uint32, [_VP]),
    "st_node_listen_port": (_I32, [_VP]),
    # c_void_p, not c_char_p, for the payload: it takes bytes and writable
    # buffers alike without a copy
    "st_node_send": (_I32, [_VP, _I32, _VP, _I32, ctypes.c_double]),
    "st_node_recv": (_I32, [_VP, _I32, _VP, _I32, ctypes.c_double]),
    "st_node_poll_events": (_I32, [_VP, ctypes.POINTER(_StEventC), _I32, ctypes.c_double]),
    "st_node_links": (_I32, [_VP, ctypes.POINTER(_I32), _I32]),
    "st_node_uplink": (_I32, [_VP]),
    "st_node_stats": (_I32, [_VP, _I32, ctypes.POINTER(_StStatsC)]),
    "st_node_drop_link": (_I32, [_VP, _I32]),
    "st_node_cap_inflight": (_I32, [_VP, _I32, _I32]),
    "st_node_close": (None, [_VP]),
    "st_obs_set_enabled": (None, [_I32]),
    "st_obs_drain": (_I32, [_VP, _I32]),
    "st_obs_now_ns": (ctypes.c_uint64, []),
    "st_obs_dropped": (ctypes.c_uint64, []),
    "st_obs_emit": (None, [ctypes.c_uint32, ctypes.c_uint32, _I32, ctypes.c_uint64]),
    "st_node_pool_stats": (None, [_VP, ctypes.POINTER(ctypes.c_uint64)]),
    "st_node_stripe_stats": (_I32, [_VP, _I32, ctypes.POINTER(ctypes.c_uint64)]),
    # link, ring bytes, name out, its capacity, token out
    "st_node_shm_serve": (_I32, [_VP, _I32, ctypes.c_int64, ctypes.c_char_p, _I32, ctypes.POINTER(ctypes.c_uint64)]),
    "st_node_shm_join": (_I32, [_VP, _I32, ctypes.c_char_p, ctypes.c_uint64]),
    "st_node_shm_stats": (_I32, [_VP, _I32, ctypes.POINTER(ctypes.c_uint64)]),
}

#: Why ``st_node_shm_serve`` / ``st_node_shm_join`` refused, by return code.
SHM_SERVE_FAILURES = {-1: "link, mode or state refuses a lane", -2: "could not create the /dev/shm segment"}
SHM_JOIN_FAILURES = {
    -1: "link, mode or state refuses a lane, or the segment would not open",
    -2: "could not map the segment",
    -3: "the segment's name, header or token does not match the offer",
}


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_mu:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_transport()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            from .. import obs

            if not obs.obs_enabled():
                lib.st_obs_set_enabled(0)
            _lib = lib
    return _lib


class TransportNode:
    """One peer's transport endpoint: joins the tree at (host, port), or
    becomes its master when nobody answers there."""

    def __init__(
        self,
        host: str,
        port: int,
        config: TransportConfig | None = None,
        frame_bytes: int = 0,
        max_children: int = 2,
        queue_depth: int = 8,
        keepalive_sec: float = 1.0,
        rcvbuf_bytes: int = 0,
    ):
        """``frame_bytes`` sizes the receive buffer; under ``wire_compat``
        it is the reference frame's size, which the transport frames by.
        ``rcvbuf_bytes`` > 0 sets the kernel receive buffer of every socket
        the node connects, before the connect (0: the kernel's autotuned
        size)."""
        cfg = config or TransportConfig()
        self._lib = _load()
        c = _StConfigC(
            wire_compat=1 if cfg.wire_compat else 0,
            compat_frame_bytes=frame_bytes,
            listen_backlog=cfg.listen_backlog,
            bandwidth_cap_bps=cfg.bandwidth_cap_bytes_per_sec,
            peer_timeout_sec=cfg.peer_timeout_sec,
            keepalive_sec=keepalive_sec,
            max_children=max_children,
            queue_depth=queue_depth,
            max_rejoin_attempts=cfg.max_rejoin_attempts,
            rejoin_backoff_sec=0.2,
            connect_timeout_sec=cfg.connect_timeout_sec,
            join_timeout_sec=cfg.join_timeout_sec,
            stripe_count=cfg.stripe_count,
            rcvbuf_bytes=rcvbuf_bytes,
        )
        is_master = _I32(0)
        self._h_cv = threading.Condition()  # guards _h and _h_users
        self._h_users = 0
        self._h = self._lib.st_node_create(host.encode(), port, ctypes.byref(c), ctypes.byref(is_master))
        if not self._h:
            raise ConnectionError(
                f"could not join or become master at {host}:{port} "
                f"within {cfg.join_timeout_sec or 30.0:.0f}s"
            )
        self.is_master = bool(is_master.value)
        #: Process-unique node id; the peer stamps it into traced messages.
        self.obs_id = int(self._lib.st_node_obs_id(self._h))
        self._recv_buf = ctypes.create_string_buffer(max(frame_bytes, 1 << 20))

    def _enter(self):
        """The native handle, held for one call (pair with :meth:`_exit`),
        or None once the node is closed."""
        with self._h_cv:
            if self._h:
                self._h_users += 1
            return self._h

    def _exit(self) -> None:
        with self._h_cv:
            self._h_users -= 1
            if not self._h_users:
                self._h_cv.notify_all()

    # -- wire ----------------------------------------------------------------

    def send(self, link_id: int, payload, timeout: float = 1.0) -> bool:
        """Enqueue one message; False means backpressure (retry). Raises
        ``BrokenPipeError`` on a dead link. ``payload`` is bytes or a
        writable buffer; the bytes are copied into the transport before
        this returns, so the caller may reuse the buffer at once."""
        n = len(payload)
        arg = payload if isinstance(payload, bytes) else (ctypes.c_char * n).from_buffer(payload)
        h = self._enter()
        if not h:
            raise BrokenPipeError("the node is closed")
        try:
            r = self._lib.st_node_send(h, link_id, arg, n, timeout)
        finally:
            self._exit()
        if r < 0:
            raise BrokenPipeError(f"link {link_id} is down")
        return r == 1

    def recv(self, link_id: int, timeout: float = 0.0) -> Optional[bytes]:
        """Dequeue one received message, or None. Raises ``BrokenPipeError``
        when the link is dead and drained."""
        h = self._enter()
        if not h:
            raise BrokenPipeError("the node is closed")
        try:
            n = self._lib.st_node_recv(h, link_id, self._recv_buf, len(self._recv_buf), timeout)
        finally:
            self._exit()
        if n < 0:
            raise BrokenPipeError(f"link {link_id} is down")
        if n == 0:
            return None
        # the message only (``.raw`` would copy the whole receive buffer,
        # which is sized for the largest message of the table)
        return ctypes.string_at(self._recv_buf, n)

    # -- topology ------------------------------------------------------------

    def poll_events(self, timeout: float = 0.0, cap: int = 16) -> list[Event]:
        arr = (_StEventC * cap)()
        h = self._enter()
        if not h:
            return []
        try:
            n = self._lib.st_node_poll_events(h, arr, cap, timeout)
        finally:
            self._exit()
        return [Event(EventKind(arr[i].kind), arr[i].link_id, bool(arr[i].is_uplink)) for i in range(n)]

    @property
    def links(self) -> list[int]:
        arr = (_I32 * 64)()
        h = self._enter()
        if not h:
            return []
        try:
            n = self._lib.st_node_links(h, arr, 64)
        finally:
            self._exit()
        return [arr[i] for i in range(n)]

    @property
    def uplink(self) -> Optional[int]:
        h = self._enter()
        if not h:
            return None
        try:
            u = self._lib.st_node_uplink(h)
        finally:
            self._exit()
        return None if u < 0 else u

    @property
    def listen_port(self) -> int:
        h = self._enter()
        if not h:
            return -1
        try:
            return self._lib.st_node_listen_port(h)
        finally:
            self._exit()

    def stats(self, link_id: int) -> Optional[LinkStats]:
        s = _StStatsC()
        h = self._enter()
        if not h:
            return None
        try:
            r = self._lib.st_node_stats(h, link_id, ctypes.byref(s))
        finally:
            self._exit()
        if r < 0:
            return None
        return LinkStats(s.bytes_out, s.bytes_in, s.frames_out, s.frames_in, s.send_queue, s.recv_queue)

    def pool_stats(self) -> dict:
        """The transport's buffer pools: tx and rx buffer acquires against
        misses (fresh allocations), and zero-copy sends. In steady state
        the acquires grow and the misses stay flat."""
        out = (ctypes.c_uint64 * 5)()
        h = self._enter()
        if h:
            try:
                self._lib.st_node_pool_stats(h, out)
            finally:
                self._exit()
        return {"tx_acquires": out[0], "tx_misses": out[1], "rx_acquires": out[2], "rx_misses": out[3],
                "zc_msgs": out[4]}

    def stripe_stats(self, link_id: int) -> Optional[dict]:
        """The link's sockets: negotiated (``stripes``) and alive
        (``live``), stripe deaths and messages re-routed off a dying
        stripe. None for an unknown link or a closed node."""
        out = (ctypes.c_uint64 * 4)()
        h = self._enter()
        if not h:
            return None
        try:
            r = self._lib.st_node_stripe_stats(h, link_id, out)
        finally:
            self._exit()
        if r < 0:
            return None
        return {"stripes": int(out[0]), "live": int(out[1]), "deaths": int(out[2]), "reroutes": int(out[3])}

    def shm_serve(self, link_id: int, ring_bytes: int) -> tuple[Optional[tuple[str, int]], int]:
        """The parent's half of the shared-memory lane: create the link's
        /dev/shm segment (two rings of ``ring_bytes``, clamped to 64 KiB..1
        GiB by the library). Returns ((name, token), 0) to offer the child,
        or (None, the library's code) when no lane can be served (see
        ``SHM_SERVE_FAILURES``): the link then stays on TCP."""
        name = ctypes.create_string_buffer(96)
        token = ctypes.c_uint64(0)
        h = self._enter()
        if not h:
            return None, -1
        try:
            r = self._lib.st_node_shm_serve(h, link_id, int(ring_bytes), name, len(name), ctypes.byref(token))
        finally:
            self._exit()
        if r != 0:
            return None, int(r)
        return (name.value.decode(), int(token.value)), 0

    def shm_join(self, link_id: int, name: str, token: int) -> int:
        """The child's half: map and validate the parent's segment. 0 on
        success, else the library's code (``SHM_JOIN_FAILURES``), and the
        link stays on TCP."""
        h = self._enter()
        if not h:
            return -1
        try:
            return int(self._lib.st_node_shm_join(h, link_id, name.encode(), token))
        finally:
            self._exit()

    def shm_stats(self, link_id: int) -> Optional[dict]:
        """The link's lane: ``state`` 0 (TCP only), 1 (segment mapped) or 2
        (sending on the rings), messages and bytes each way over it, the
        ring's bytes and futex sleeps each way. None for an unknown link
        or a closed node."""
        out = (ctypes.c_uint64 * 8)()
        h = self._enter()
        if not h:
            return None
        try:
            r = self._lib.st_node_shm_stats(h, link_id, out)
        finally:
            self._exit()
        if r < 0:
            return None
        keys = ("state", "msgs_out", "msgs_in", "bytes_out", "bytes_in", "ring_bytes", "tx_waits", "rx_waits")
        return {k: int(v) for k, v in zip(keys, out)}

    def cap_inflight(self, link_id: int, nbytes: int) -> bool:
        """Bound what the sending side of the link holds in flight: the
        transport writes its queued messages one at a time (not in batches
        of up to 16), and each of the link's sockets buffers about
        ``nbytes`` (its kernel send buffer), so that a write waits for the
        peer to read. False for an unknown link, a closed node or no socket
        capped."""
        h = self._enter()
        if not h:
            return False
        try:
            return self._lib.st_node_cap_inflight(h, link_id, int(nbytes)) > 0
        finally:
            self._exit()

    def drop_link(self, link_id: int) -> None:
        h = self._enter()
        if h:
            try:
                self._lib.st_node_drop_link(h, link_id)
            finally:
                self._exit()

    def drop_link_flushed(self, link_id: int, timeout: float = 0.5) -> None:
        """Drop a link after its send queue has drained (bounded wait), so
        a REJECT enqueued just before reaches the peer instead of racing
        the socket's teardown."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            s = self.stats(link_id)
            if s is None or s.send_queue == 0:
                break
            time.sleep(0.005)
        time.sleep(0.05)
        self.drop_link(link_id)

    def close(self) -> None:
        """Close the node: other threads see it closed at once, and it is
        freed once their calls in progress have returned."""
        with self._h_cv:
            h, self._h = self._h, None
            while self._h_users:
                self._h_cv.wait()
        if h:
            self._lib.st_node_close(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
