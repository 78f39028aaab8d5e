"""ctypes binding of the native shard data plane (``st_shard_*`` in
``native/stengine.cpp``), on the port's own ``libstengine`` build.

The counterpart of ``shared_tensor_tpu/shard/engine_lane.py``.
:class:`ShardLane` is the engine-tier twin of the ShardNode FWD hot loop:
owned slices, per-target-shard outboxes, the per-link go-back-N ledgers,
the end-to-end (origin, fwd_seq) dedup windows and the park buffer all
live in C, pumped by two native threads over the same transport the
classic engine rides. Python keeps the CONTROL plane (claim, grant,
handoff, arbitration, announces): every non-FWD/ACK message on a member
link defers to :meth:`ShardLane.poll_ctrl`, the engine/peer split applied
to the sharded tier. The port's engine build already compiles these entry
points; nothing more is compiled for them.

Which plane runs: :func:`shard_engine_eligible`, which reads
``ShardConfig.engine_lane`` and the ``ST_SHARD_ENGINE=0`` pin only. JAX's
also asks its process-wide host-tier switch; the port has none (a peer's
tier is chosen per peer), and a sharded node holds no device state on
either plane. When the lane is chosen, the engine library must build and
load, and the plane must start: a failure raises, and nothing falls back
quietly to the Python plane. The Python plane is chosen only by the
configuration or the environment; it is the semantic reference, and the
two planes are wire-identical (byte-equal FWD frames on shared state), so
mixed trees interoperate in both orientations.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ..ops.codec_np import _layout
from ..ops.table import TableSpec

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C,ALIGNED")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C,ALIGNED")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C,ALIGNED")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C,ALIGNED")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C,ALIGNED")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C,ALIGNED")

_DECLARED = False
_DECLARE_MU = threading.Lock()


def _declare(lib) -> None:
    """st_shard_* ctypes declarations, as JAX's binding declares them
    (its ``tools/lint_abi.py`` checks those rows against the native
    definitions, counter widths included)."""
    global _DECLARED
    if _DECLARED:
        return
    lib.st_slice_quantize.restype = ctypes.c_int32
    lib.st_slice_quantize.argtypes = [
        _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, _f32p, _f32p, _u32p,
    ]
    lib.st_slice_apply.restype = ctypes.c_int32
    lib.st_slice_apply.argtypes = [
        _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _f32p, _f32p, _u32p,
    ]
    lib.st_slice_cascade.restype = ctypes.c_int32
    lib.st_slice_cascade.argtypes = [
        _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _f32p, _u8p,
    ]
    lib.st_shard_create.restype = ctypes.c_void_p
    lib.st_shard_create.argtypes = [
        ctypes.c_void_p, _i64p, _i64p, _i64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, _i64p, _i64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
    ]
    lib.st_shard_start.restype = None
    lib.st_shard_start.argtypes = [ctypes.c_void_p]
    lib.st_shard_stop.restype = None
    lib.st_shard_stop.argtypes = [ctypes.c_void_p]
    lib.st_shard_destroy.restype = None
    lib.st_shard_destroy.argtypes = [ctypes.c_void_p]
    lib.st_shard_member_attach.restype = ctypes.c_int32
    lib.st_shard_member_attach.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.st_shard_member_detach.restype = ctypes.c_int32
    lib.st_shard_member_detach.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.st_shard_set_uplink.restype = None
    lib.st_shard_set_uplink.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.st_shard_set_route.restype = None
    lib.st_shard_set_route.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.st_shard_set_handoff.restype = None
    lib.st_shard_set_handoff.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.st_shard_adopt.restype = None
    lib.st_shard_adopt.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.st_shard_release.restype = ctypes.c_int32
    lib.st_shard_release.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.st_shard_owns.restype = ctypes.c_int32
    lib.st_shard_owns.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.st_shard_read.restype = ctypes.c_int32
    lib.st_shard_read.argtypes = [ctypes.c_void_p, ctypes.c_int32, _f32p]
    lib.st_shard_add.restype = None
    lib.st_shard_add.argtypes = [ctypes.c_void_p, _f32p]
    lib.st_shard_restore_outbox.restype = None
    lib.st_shard_restore_outbox.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _f32p,
    ]
    lib.st_shard_dedup_merge.restype = ctypes.c_int32
    lib.st_shard_dedup_merge.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, _u64p, ctypes.c_int64,
    ]
    lib.st_shard_snapshot.restype = ctypes.c_int32
    lib.st_shard_snapshot.argtypes = [
        ctypes.c_void_p, _i32p, _f32p, _i32p, _f32p, _u32p, _u64p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.st_shard_dedup_size.restype = ctypes.c_int64
    lib.st_shard_dedup_size.argtypes = [ctypes.c_void_p]
    lib.st_shard_dedup_export.restype = ctypes.c_int64
    lib.st_shard_dedup_export.argtypes = [
        ctypes.c_void_p, _u32p, _u64p, ctypes.c_int64,
    ]
    lib.st_shard_fwd_seq.restype = ctypes.c_uint32
    lib.st_shard_fwd_seq.argtypes = [ctypes.c_void_p]
    lib.st_shard_set_fwd_seq.restype = None
    lib.st_shard_set_fwd_seq.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.st_shard_alloc_bytes.restype = ctypes.c_int64
    lib.st_shard_alloc_bytes.argtypes = [ctypes.c_void_p]
    lib.st_shard_outbox_bytes.restype = ctypes.c_int64
    lib.st_shard_outbox_bytes.argtypes = [ctypes.c_void_p]
    lib.st_shard_owned_words.restype = ctypes.c_int64
    lib.st_shard_owned_words.argtypes = [ctypes.c_void_p]
    lib.st_shard_idle.restype = ctypes.c_int32
    lib.st_shard_idle.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.st_shard_counters.restype = None
    lib.st_shard_counters.argtypes = [ctypes.c_void_p, _u64p]
    lib.st_shard_poll_ctrl.restype = ctypes.c_int32
    lib.st_shard_poll_ctrl.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int32,
    ]
    _DECLARED = True


def load_shard_lib() -> ctypes.CDLL:
    """The port's engine library with the st_shard_* surface declared,
    built on first use. Raises if it cannot be built or loaded."""
    from ..comm.engine import load_engine

    lib = load_engine()
    with _DECLARE_MU:
        _declare(lib)
    return lib


def shard_engine_eligible(config) -> bool:
    """Should a ShardNode with this configuration run the native FWD
    plane? ``ShardConfig.engine_lane`` on and the ``ST_SHARD_ENGINE=0`` pin
    unset. Loading the library is the lane's own step, and it raises."""
    if os.environ.get("ST_SHARD_ENGINE", "1") == "0":
        return False
    return bool(config.shard.engine_lane)


class ShardLane:
    """The native shard FWD plane for one ShardNode (see the module
    docstring). All slice/outbox/ledger/dedup state lives in C; methods
    marshal numpy views in and out. Thread-safe (the plane's own mutex)."""

    def __init__(
        self,
        node,  # TransportNode
        spec: TableSpec,
        ranges: list[tuple[int, int]],  # per-shard (word_lo, word_cnt)
        policy_code: int,
        recv_cap: int,
        ack_timeout_sec: float,
        ack_retry_limit: int,
        park_cap: int,
        origin: int,
    ):
        self.spec = spec
        self.ranges = list(ranges)
        self._lib = load_shard_lib()
        self._offs, self._ns, self._padded = _layout(spec)
        wlo = np.ascontiguousarray([r[0] for r in ranges], np.int64)
        wcnt = np.ascontiguousarray([r[1] for r in ranges], np.int64)
        self._h = self._lib.st_shard_create(
            node._h, self._offs, self._ns, self._padded,
            spec.num_leaves, spec.total, spec.total_n,
            len(ranges), wlo, wcnt, policy_code, recv_cap,
            ack_timeout_sec, ack_retry_limit, park_cap, origin,
        )
        if not self._h:
            raise RuntimeError("st_shard_create failed")
        self._ctrl_buf = ctypes.create_string_buffer(max(recv_cap, 1 << 16))
        self._stopped = False
        self._lib.st_shard_start(self._h)

    def _handle(self):
        h = self._h
        if not h:
            raise RuntimeError("ShardLane used after destroy()")
        return h

    def stop(self) -> None:
        """Stop the plane threads. MUST run before TransportNode.close()
        (they block inside the node's queues/condvars)."""
        if not self._stopped and self._h:
            self._stopped = True
            self._lib.st_shard_stop(self._h)

    def destroy(self) -> None:
        self.stop()
        if self._h:
            self._lib.st_shard_destroy(self._h)
            self._h = None

    # -- membership / routing ------------------------------------------------

    def member_attach(self, link: int, tx: int = 0, rx: int = 0) -> bool:
        return bool(
            self._lib.st_shard_member_attach(self._handle(), link, tx, rx)
        )

    def member_detach(self, link: int) -> bool:
        if not self._h:
            return False
        return bool(self._lib.st_shard_member_detach(self._h, link))

    def set_uplink(self, link: Optional[int]) -> None:
        if self._h:
            self._lib.st_shard_set_uplink(
                self._h, -1 if link is None else link
            )

    def set_route(self, shard: int, link: Optional[int]) -> None:
        if self._h:
            self._lib.st_shard_set_route(
                self._h, shard, -1 if link is None else link
            )

    def set_handoff(self, shard: int, on: bool) -> None:
        if self._h:
            self._lib.st_shard_set_handoff(self._h, shard, 1 if on else 0)

    # -- ownership / data ----------------------------------------------------

    def _n_el(self, shard: int) -> int:
        return self.ranges[shard][1] * 32

    def adopt(self, shard: int, values: Optional[np.ndarray]) -> None:
        ptr = None
        if values is not None:
            v = np.ascontiguousarray(values, np.float32)
            if v.shape != (self._n_el(shard),):
                raise ValueError(
                    f"adopt: values shape {v.shape} != ({self._n_el(shard)},)"
                )
            ptr = v.ctypes.data_as(ctypes.c_void_p)
        self._lib.st_shard_adopt(self._handle(), shard, ptr)

    def release(self, shard: int) -> Optional[np.ndarray]:
        out = np.empty(self._n_el(shard), np.float32)
        if not self._lib.st_shard_release(
            self._handle(), shard, out.ctypes.data_as(ctypes.c_void_p)
        ):
            return None
        return out

    def owns(self, shard: int) -> bool:
        if not self._h:
            return False
        return bool(self._lib.st_shard_owns(self._h, shard))

    def read_shard(self, shard: int) -> Optional[np.ndarray]:
        if not self._h:
            return None
        out = np.empty(self._n_el(shard), np.float32)
        if not self._lib.st_shard_read(self._h, shard, out):
            return None
        return out

    def add_flat(self, flat: np.ndarray) -> None:
        u = np.ascontiguousarray(flat, np.float32)
        self._lib.st_shard_add(self._handle(), u)

    def restore_outbox(self, shard: int, resid: np.ndarray) -> None:
        r = np.ascontiguousarray(resid, np.float32)
        if r.shape != (self._n_el(shard),):
            raise ValueError(
                f"outbox residual shape {r.shape} != ({self._n_el(shard)},)"
            )
        self._lib.st_shard_restore_outbox(self._handle(), shard, r)

    # -- dedup / checkpoint --------------------------------------------------

    def dedup_merge(self, origin: int, seqs) -> None:
        arr = np.ascontiguousarray(sorted(int(s) for s in seqs), np.uint64)
        if arr.size:
            self._lib.st_shard_dedup_merge(
                self._handle(), origin, arr, arr.size
            )

    def dedup_windows(self) -> dict[int, list[int]]:
        """{origin: sorted seqs} of the end-to-end dedup windows alone,
        the handoff ride-along (st_shard_dedup_export: no owned-slice
        copies, unlike the full snapshot). Sized from st_shard_dedup_size
        with a retry, so many-origin clusters never truncate."""
        for _ in range(3):
            cap = int(self._lib.st_shard_dedup_size(self._handle())) + 1024
            origins = np.zeros(cap, np.uint32)
            seqs = np.zeros(cap, np.uint64)
            n = int(
                self._lib.st_shard_dedup_export(
                    self._handle(), origins, seqs, cap
                )
            )
            if n < cap:
                out: dict[int, list[int]] = {}
                for i in range(n):
                    out.setdefault(int(origins[i]), []).append(int(seqs[i]))
                return out
        raise RuntimeError("dedup windows grew faster than the export")

    def fwd_seq(self) -> int:
        if not self._h:
            return 0
        return int(self._lib.st_shard_fwd_seq(self._h))

    def set_fwd_seq(self, seq: int) -> None:
        if self._h:
            self._lib.st_shard_set_fwd_seq(self._h, seq & 0xFFFFFFFF)

    def snapshot(self):
        """Atomic capture under the plane's one mutex: ({shard: values},
        {shard: outbox residual}, {origin: sorted seqs}); the window and
        slice pair can never tear."""
        n_shards = len(self.ranges)
        total_el = sum(c * 32 for _l, c in self.ranges)
        owned_ids = np.zeros(max(1, n_shards), np.int32)
        owned_vals = np.zeros(max(1, total_el), np.float32)
        ob_ids = np.zeros(max(1, n_shards), np.int32)
        ob_vals = np.zeros(max(1, total_el), np.float32)
        # size the window buffer from the plane (+slack for pairs
        # arriving between the size call and the capture; save_shards
        # documents quiesce-first for an exact capture anyway)
        dd_cap = int(self._lib.st_shard_dedup_size(self._handle())) + 4096
        dd_origins = np.zeros(dd_cap, np.uint32)
        dd_seqs = np.zeros(dd_cap, np.uint64)
        dd_n = ctypes.c_int64(0)
        n_ob = ctypes.c_int32(0)
        n_owned = self._lib.st_shard_snapshot(
            self._handle(), owned_ids, owned_vals, ob_ids, ob_vals,
            dd_origins, dd_seqs, dd_cap, ctypes.byref(dd_n),
            ctypes.byref(n_ob),
        )
        owned = {}
        off = 0
        for i in range(n_owned):
            s = int(owned_ids[i])
            n = self._n_el(s)
            owned[s] = owned_vals[off:off + n].copy()
            off += n
        outboxes = {}
        off = 0
        for i in range(int(n_ob.value)):
            s = int(ob_ids[i])
            n = self._n_el(s)
            outboxes[s] = ob_vals[off:off + n].copy()
            off += n
        dedup: dict[int, list[int]] = {}
        for i in range(int(dd_n.value)):
            dedup.setdefault(int(dd_origins[i]), []).append(int(dd_seqs[i]))
        return owned, outboxes, dedup

    # -- accounting / control ------------------------------------------------

    def alloc_bytes(self) -> int:
        if not self._h:
            return 0
        return int(self._lib.st_shard_alloc_bytes(self._h))

    def outbox_bytes(self) -> int:
        if not self._h:
            return 0
        return int(self._lib.st_shard_outbox_bytes(self._h))

    def owned_words(self) -> int:
        if not self._h:
            return 0
        return int(self._lib.st_shard_owned_words(self._h))

    def idle(self, tol: float = 0.0) -> bool:
        if not self._h:
            return True
        return bool(self._lib.st_shard_idle(self._h, tol))

    def counters(self) -> np.ndarray:
        """Counter snapshot; all-zero after destroy(). Layout
        (st_shard_counters): [fwd_msgs_out, fwd_msgs_in, relayed,
        dedup_discards, park_drops, parked, retx_msgs, updates,
        fwd_frames_out, fwd_frames_in, tx_slot_acquires,
        tx_slot_alloc_events, fwd_undecodable, inflight]."""
        out = np.zeros(14, np.uint64)
        if self._h:
            self._lib.st_shard_counters(self._h, out)
        return out

    def heat_applies_by_shard(self, fwd_in: int, owned) -> dict[int, int]:
        """The heat numerator: attribute the plane's single fwd_msgs_in
        total (``counters()[1]``) across the owned shards. The C plane
        keeps one apply counter, so this is EXACT in the common
        one-owned-shard topology and an even split otherwise (the python
        tier attributes exactly per shard; the health analyzer's zipf
        detector only needs owner-level resolution when a node owns one
        shard — the bench topology)."""
        owned = sorted(owned)
        if not owned:
            return {}
        share, rem = divmod(int(fwd_in), len(owned))
        return {
            s: share + (1 if i < rem else 0) for i, s in enumerate(owned)
        }

    def poll_ctrl(self) -> Optional[tuple[int, bytes]]:
        """One control-plane message the plane deferred to Python."""
        if not self._h:
            return None
        link = ctypes.c_int32(0)
        buf = self._ctrl_buf
        n = self._lib.st_shard_poll_ctrl(
            self._h, ctypes.byref(link), buf, len(buf)
        )
        if n <= 0:
            return None
        return int(link.value), buf.raw[:n]

    def __repr__(self) -> str:
        if not self._h:
            return "ShardLane(destroyed)"
        c = self.counters()
        return (
            f"ShardLane(shards={len(self.ranges)}, out={int(c[0])}, "
            f"in={int(c[1])}, relayed={int(c[2])})"
        )
