"""ctypes binding of the native C++ TCP transport (``native/sttransport.cpp``).

The counterpart of ``shared_tensor_tpu/comm/transport.py``. The native
library owns the wire: the self-organising binary-tree overlay, framed
streaming, pacing, liveness and rejoin; messages are opaque bytes at this
layer and the peer (``comm/peer.py``) gives them meaning.

The library is the port's own build (``_build.build_transport``), loaded
at first use. Its process-wide event ring for observability is switched
off, since the port has no observability layer to drain it.

The node speaks the native framing or, with ``TransportConfig.wire_compat``,
the reference's raw frames of ``frame_bytes`` each; a link may run over
``stripe_count`` sockets (:meth:`TransportNode.stripe_stats`), and its
data plane may move onto a same-host shared-memory lane that the peer
negotiates (:meth:`TransportNode.shm_serve` on the parent,
:meth:`TransportNode.shm_join` on the child, :meth:`TransportNode.shm_stats`).
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
    "st_node_close": (None, [_VP]),
    "st_obs_set_enabled": (None, [_I32]),
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
    ):
        """``frame_bytes`` sizes the receive buffer; under ``wire_compat``
        it is the reference frame's size, which the transport frames by."""
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
        )
        is_master = _I32(0)
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

    # -- wire ----------------------------------------------------------------

    def send(self, link_id: int, payload, timeout: float = 1.0) -> bool:
        """Enqueue one message; False means backpressure (retry). Raises
        ``BrokenPipeError`` on a dead link. ``payload`` is bytes or a
        writable buffer; the bytes are copied into the transport before
        this returns, so the caller may reuse the buffer at once."""
        n = len(payload)
        arg = payload if isinstance(payload, bytes) else (ctypes.c_char * n).from_buffer(payload)
        r = self._lib.st_node_send(self._h, link_id, arg, n, timeout)
        if r < 0:
            raise BrokenPipeError(f"link {link_id} is down")
        return r == 1

    def recv(self, link_id: int, timeout: float = 0.0) -> Optional[bytes]:
        """Dequeue one received message, or None. Raises ``BrokenPipeError``
        when the link is dead and drained."""
        n = self._lib.st_node_recv(self._h, link_id, self._recv_buf, len(self._recv_buf), timeout)
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
        n = self._lib.st_node_poll_events(self._h, arr, cap, timeout)
        return [Event(EventKind(arr[i].kind), arr[i].link_id, bool(arr[i].is_uplink)) for i in range(n)]

    @property
    def links(self) -> list[int]:
        if not self._h:  # closed: no native call on a null handle
            return []
        arr = (_I32 * 64)()
        n = self._lib.st_node_links(self._h, arr, 64)
        return [arr[i] for i in range(n)]

    @property
    def uplink(self) -> Optional[int]:
        if not self._h:
            return None
        u = self._lib.st_node_uplink(self._h)
        return None if u < 0 else u

    @property
    def listen_port(self) -> int:
        return self._lib.st_node_listen_port(self._h)

    def stats(self, link_id: int) -> Optional[LinkStats]:
        if not self._h:
            return None
        s = _StStatsC()
        if self._lib.st_node_stats(self._h, link_id, ctypes.byref(s)) < 0:
            return None
        return LinkStats(s.bytes_out, s.bytes_in, s.frames_out, s.frames_in, s.send_queue, s.recv_queue)

    def stripe_stats(self, link_id: int) -> Optional[dict]:
        """The link's sockets: negotiated (``stripes``) and alive
        (``live``), stripe deaths and messages re-routed off a dying
        stripe. None for an unknown link or a closed node."""
        if not self._h:
            return None
        out = (ctypes.c_uint64 * 4)()
        if self._lib.st_node_stripe_stats(self._h, link_id, out) < 0:
            return None
        return {"stripes": int(out[0]), "live": int(out[1]), "deaths": int(out[2]), "reroutes": int(out[3])}

    def shm_serve(self, link_id: int, ring_bytes: int) -> tuple[Optional[tuple[str, int]], int]:
        """The parent's half of the shared-memory lane: create the link's
        /dev/shm segment (two rings of ``ring_bytes``, clamped to 64 KiB..1
        GiB by the library). Returns ((name, token), 0) to offer the child,
        or (None, the library's code) when no lane can be served (see
        ``SHM_SERVE_FAILURES``): the link then stays on TCP."""
        if not self._h:
            return None, -1
        name = ctypes.create_string_buffer(96)
        token = ctypes.c_uint64(0)
        r = self._lib.st_node_shm_serve(self._h, link_id, int(ring_bytes), name, len(name), ctypes.byref(token))
        if r != 0:
            return None, int(r)
        return (name.value.decode(), int(token.value)), 0

    def shm_join(self, link_id: int, name: str, token: int) -> int:
        """The child's half: map and validate the parent's segment. 0 on
        success, else the library's code (``SHM_JOIN_FAILURES``), and the
        link stays on TCP."""
        if not self._h:
            return -1
        return int(self._lib.st_node_shm_join(self._h, link_id, name.encode(), token))

    def shm_stats(self, link_id: int) -> Optional[dict]:
        """The link's lane: ``state`` 0 (TCP only), 1 (segment mapped) or 2
        (sending on the rings), messages and bytes each way over it, the
        ring's bytes and futex sleeps each way. None for an unknown link
        or a closed node."""
        if not self._h:
            return None
        out = (ctypes.c_uint64 * 8)()
        if self._lib.st_node_shm_stats(self._h, link_id, out) < 0:
            return None
        keys = ("state", "msgs_out", "msgs_in", "bytes_out", "bytes_in", "ring_bytes", "tx_waits", "rx_waits")
        return {k: int(v) for k, v in zip(keys, out)}

    def drop_link(self, link_id: int) -> None:
        if self._h:
            self._lib.st_node_drop_link(self._h, link_id)

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
        if self._h:
            self._lib.st_node_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
