"""ctypes binding of the native link engine (``native/stengine.cpp``).

The counterpart of ``shared_tensor_tpu/comm/engine.py``. :class:`EngineTensor`
stands in for the host tier's ``core.SharedTensor`` once a peer's steady
state moves into C: the replica and the link residuals live in the
engine's own buffers, two C threads quantize, encode, send, receive,
flood-apply and keep the ACK ledger, and Python keeps the handshakes,
membership, checkpoints and metrics. The engine calls the same
``stcodec.c`` loops as ``ops/codec_np.py``, so given the same message
sequence the two data planes hold the same bits (a burst's later frames
take their scales from the cascade schedule, which the wire carries).

The library is the port's own build (``_build.build_engine``), linked
against the port's transport and codec builds, so the node handle this
module is given and the engine's transport calls share one mapped copy of
the transport. A failed build raises; nothing falls back to the Python
tier unless the configuration asks for it (``Config.native_engine``).

This binds links by snapshot diff, the re-graft carry, read-only
subscriber links (``new_link_sub``: unledgered, optionally
range-filtered, with the engine's own FRESH marks), seal, pause,
checkpoints and counters; the reference wire format
(``compat_frame_bytes`` > 0: raw frames of one flat tensor, no ACK ledger,
and ``compat_regraft`` for a leaf's re-graft); sign2 precision
(``precision_mode``: 0 fixed 1 bit, 1 the telemetry governor, 2 pinned),
emitted only on links marked ``link_allow_sign2`` (the peer advertised
it); and the aligned v3 framing toward links marked ``link_wire_v3``.
The shard-plane entry points of the C API wait for their slice.

Returned arrays are CPU torch tensors (zero-copy over numpy), as the host
tier's ``SharedTensor`` returns them.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import _build
from ..config import CodecConfig, ScalePolicy
from ..core import DuplicateLink
from ..ops import codec_np
from ..ops.table import TableFrame, TableSpec, make_spec, unflatten

_LIB: Optional[ctypes.CDLL] = None
_LIB_MU = threading.Lock()

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C,ALIGNED")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C,ALIGNED")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C,ALIGNED")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C,ALIGNED")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C,ALIGNED")
_VP, _I32, _I64, _F64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_double

_POLICY_CODE = {ScalePolicy.POW2_RMS: 0, ScalePolicy.RMS: 1, ScalePolicy.ABS_MEAN: 2}
#: Link slots the engine reports per call (its own bound on live links).
_MAX_LINKS = 64

_SIGNATURES = {
    # node, layout, init values (nullable), policy, per_leaf, burst,
    # recv_cap, compat_frame_bytes (0: native framing), quarantine,
    # ack_timeout_sec, ack_retry_limit, trace_wire
    "st_engine_create": (_VP, [_VP, _i64p, _i64p, _i64p, _I64, _I64, _I64, _VP,
                               _I32, _I32, _I32, _I32, _I32, _I32, _F64, _I32, _I32]),
    # precision mode, governor up/down ratios and beat, cascade frames
    "st_engine_set_codec": (None, [_VP, _I32, _F64, _F64, _F64, _I32]),
    "st_engine_start": (None, [_VP]),
    "st_engine_seal": (None, [_VP]),
    "st_engine_stop": (None, [_VP]),
    "st_engine_destroy": (None, [_VP]),
    "st_engine_pause": (None, [_VP, _I32]),
    "st_engine_add": (None, [_VP, _f32p]),
    "st_engine_read": (None, [_VP, _f32p]),
    # link, snapshot (nullable), seed, rx_init
    "st_engine_attach": (_I32, [_VP, _I32, _VP, _I32, ctypes.c_uint64]),
    # link, snapshot (nullable), rx_init, word lo, word count (0: the whole
    # table), FRESH interval seconds
    "st_engine_attach_sub": (_I32, [_VP, _I32, _VP, ctypes.c_uint64, _I64, _I64, _F64]),
    # link, residual out (nullable), applied messages out
    "st_engine_detach": (_I32, [_VP, _I32, _VP, _u64p]),
    # link, frames rolled out
    "st_engine_stash_carry": (_I32, [_VP, _I32, _u64p]),
    # the applied wire seq the WELCOME reported (0: drop the record)
    "st_engine_retract_kept": (_I64, [_VP, ctypes.c_uint64]),
    # both outputs nullable (drop_carry)
    "st_engine_take_carry_and_snapshot": (_I32, [_VP, _VP, _VP]),
    "st_engine_inject": (None, [_VP, _I32, _I32, _f32p, _u32p]),
    "st_engine_links": (_I32, [_VP, _i32p, _I32]),
    "st_engine_residual_rms": (_F64, [_VP, _I32]),
    "st_engine_inflight": (_I64, [_VP]),
    "st_engine_counters": (None, [_VP, _u64p]),
    "st_engine_link_obs": (_I32, [_VP, _I32, _u64p]),
    "st_engine_poll_ctrl": (_I32, [_VP, ctypes.POINTER(_I32), ctypes.c_char_p, _I32]),
    "st_engine_snapshot_ex": (_I32, [_VP, _f32p, _i32p, _f32p, _u64p, _I32]),
    # aux (nullable)
    "st_engine_restore_ex": (None, [_VP, _f32p, _I32, _i32p, _f32p, _VP]),
    "st_engine_restore": (None, [_VP, _f32p, _I32, _i32p, _f32p]),
    # link, allow
    "st_engine_link_allow_sign2": (_I32, [_VP, _I32, _I32]),
    "st_engine_link_wire_v3": (_I32, [_VP, _I32, _I32]),
    "st_engine_link_precision": (_I32, [_VP, _I32]),
    "st_engine_compat_regraft": (_I32, [_VP, _I32]),
}


def load_engine() -> ctypes.CDLL:
    """The port's ``libstengine``, built (with the transport and codec it
    links) on first use. Raises if it cannot be built or loaded."""
    global _LIB
    with _LIB_MU:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build.build_engine()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
    return _LIB


def engine_eligible(config, host_tier: bool) -> bool:
    """Does a peer with this configuration run the engine? The host tier,
    ``native_engine`` on, idle-frame suppression on (the engine has no
    idle-frame path: keepalives carry liveness) and no frame pacing (the
    engine's sender free-runs)."""
    return (
        host_tier
        and config.native_engine
        and config.codec.suppress_zero_frames
        and config.sync_interval_sec <= 0
    )


class EngineTensor:
    """The host tier's SharedTensor calls that a peer needs, over the
    native engine. All state (replica, residuals, ledgers, the carry) lives
    in C; these methods marshal numpy views in and out. Thread-safe (the
    engine's own mutex)."""

    def __init__(
        self,
        template: Any,
        codec: CodecConfig,
        seed_values: bool,
        node,  # comm.transport.TransportNode
        burst: int,
        recv_cap: int,
        quarantine_send_failures: int = 0,
        ack_timeout_sec: float = 0.0,
        ack_retry_limit: int = 8,
        cascade_frames: int = 1,
        compat_frame_bytes: int = 0,
        trace_wire: bool = True,
        precision_mode: int = 0,
        precision_up_ratio: float = 0.0,
        precision_down_ratio: float = 0.0,
        precision_interval_sec: float = 0.0,
    ):
        """``compat_frame_bytes`` > 0 speaks the reference wire format (a
        one-leaf table); ``trace_wire`` selects v2 framing over v1;
        ``precision_mode`` and the governor's knobs are
        ``compat.sign2_mode``'s and ``CodecConfig``'s (0: the engine's own
        defaults)."""
        self.spec: TableSpec = make_spec(template)
        self.codec = codec
        self.device = torch.device("cpu")
        self._lib = load_engine()
        self._offs, self._ns, self._padded = codec_np._layout(self.spec)
        init = codec_np.flatten_np(template, self.spec) if seed_values else None
        self._h = self._lib.st_engine_create(
            node._h, self._offs, self._ns, self._padded,
            self.spec.num_leaves, self.spec.total, self.spec.total_n,
            None if init is None else init.ctypes.data_as(ctypes.c_void_p),
            _POLICY_CODE[codec.scale_policy], 1 if codec.per_leaf_scale else 0,
            burst, recv_cap, compat_frame_bytes, quarantine_send_failures, ack_timeout_sec, ack_retry_limit,
            1 if trace_wire else 0,
        )
        if not self._h:
            raise RuntimeError("st_engine_create failed")
        # before start (the sender reads these unlocked)
        self._lib.st_engine_set_codec(
            self._h, precision_mode, precision_up_ratio, precision_down_ratio, precision_interval_sec, cascade_frames
        )
        # reused by poll_ctrl, sized for the largest wire message
        self._ctrl_buf = ctypes.create_string_buffer(max(recv_cap, 1 << 16))
        self._lib.st_engine_start(self._h)
        self._stopped = False
        # SharedTensor's staging and lock-wait seconds: the engine's threads
        # do this work outside Python
        self.fetch_wait_s = self.h2d_s = self.apply_lock_wait_s = 0.0

    # -- lifecycle ---------------------------------------------------------------

    def _handle(self):
        """The live native handle, or raise: a late call after destroy()
        must be a Python error, never a NULL passed into C."""
        h = self._h
        if not h:
            raise RuntimeError("EngineTensor used after destroy()")
        return h

    def seal(self) -> None:
        """Graceful leave, step 1: discard (never apply or ACK) further
        incoming DATA/BURST, so their senders re-deliver them around us."""
        if self._h:
            self._lib.st_engine_seal(self._h)

    def pause(self, paused: bool = True) -> None:
        """Stop (or resume) producing new data; delivery of what is in
        flight (ACKs, retransmission) and control traffic go on. Returns
        once the sender's current pass is over."""
        if self._h:
            self._lib.st_engine_pause(self._h, 1 if paused else 0)

    def stop(self) -> None:
        """Stop the engine's threads. Must run before the transport node
        closes (the threads wait inside its queues)."""
        if not self._stopped and self._h:
            self._stopped = True
            self._lib.st_engine_stop(self._h)

    def destroy(self) -> None:
        self.stop()
        if self._h:
            self._lib.st_engine_destroy(self._h)
            self._h = None

    # -- the SharedTensor calls ------------------------------------------------

    @property
    def host_tier(self) -> bool:
        return True

    def read(self) -> Any:
        """A copy of the replica as the template's tree of CPU tensors."""
        return unflatten(self.snapshot_flat(), self.spec)

    def snapshot_flat(self) -> torch.Tensor:
        out = np.empty(self.spec.total, np.float32)
        self._lib.st_engine_read(self._handle(), out)
        return torch.from_numpy(out)

    def add(self, delta: Any) -> None:
        """Merge an update into the replica and every residual (one fused
        pass each, in C); the engine stamps the trace itself."""
        self._lib.st_engine_add(self._handle(), codec_np.flatten_np(delta, self.spec))

    def new_link(self, link_id: int, seed: bool = True, rx_init: int = 0) -> None:
        """Attach a link: residual = the replica (``seed``) or 0. ``rx_init``
        is the count of messages Python already acknowledged on it."""
        if self._lib.st_engine_attach(self._handle(), link_id, None, 1 if seed else 0, rx_init) == 0:
            raise DuplicateLink(f"link {link_id} already exists")

    def new_link_diff(self, link_id: int, peer_snapshot, rx_init: int = 0) -> None:
        """Attach a link toward a peer whose replica is ``peer_snapshot``:
        residual = our replica - theirs."""
        snap = codec_np._f32(peer_snapshot)
        if snap.shape != (self.spec.total,):
            raise ValueError(f"snapshot shape {snap.shape} != ({self.spec.total},)")
        r = self._lib.st_engine_attach(self._handle(), link_id, snap.ctypes.data_as(ctypes.c_void_p), 0, rx_init)
        if r == 0:
            raise DuplicateLink(f"link {link_id} already exists")

    def new_link_sub(
        self, link_id: int, peer_snapshot, rx_init: int = 0, word_lo: int = 0, word_cnt: int = 0,
        fresh_interval_sec: float = 0.0,
    ) -> None:
        """Attach a read-only subscriber link: residual = our replica -
        ``peer_snapshot`` (None: the whole replica). Unledgered: the C
        sender keeps no unacknowledged entries, expects no ACK and never
        re-sends; with ``word_cnt`` > 0 it ships only words [word_lo,
        word_lo + word_cnt) of each frame, as RDATA, and masks the rest of
        the residual; an idle link gets a FRESH mark every
        ``fresh_interval_sec``. Attach and mode are one native call: a mark
        set after the attach would let the sender emit a ledgered message
        whose ACK never comes."""
        ptr = None
        if peer_snapshot is not None:
            snap = codec_np._f32(peer_snapshot)
            if snap.shape != (self.spec.total,):
                raise ValueError(f"snapshot shape {snap.shape} != ({self.spec.total},)")
            ptr = snap.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.st_engine_attach_sub(self._handle(), link_id, ptr, rx_init, word_lo, word_cnt, fresh_interval_sec)
        if r == 0:
            raise DuplicateLink(f"link {link_id} already exists")

    def link_allow_sign2(self, link_id: int, allow: bool = True) -> None:
        """The peer on the link advertised sign2 decoding: the governor may
        upshift the link. Without it a link stays 1-bit."""
        if self._h:
            self._lib.st_engine_link_allow_sign2(self._h, link_id, 1 if allow else 0)

    def link_wire_v3(self, link_id: int, allow: bool = True) -> None:
        """The peer on the link advertised ``SYNC_FLAG_SHM``: it decodes the
        aligned v3 framing, which the engine then emits to it. Without it a
        link stays on v2 (or v1)."""
        if self._h:
            self._lib.st_engine_link_wire_v3(self._h, link_id, 1 if allow else 0)

    def link_precision(self, link_id: int) -> int:
        """The link's wire precision in bits (1 or 2; 0: unknown link or a
        destroyed engine)."""
        if not self._h:
            return 0
        return int(self._lib.st_engine_link_precision(self._h, link_id))

    def compat_regraft(self, link_id: int) -> None:
        """The reference wire format's leaf re-graft, atomic in C: the
        replica becomes the carry and the new uplink's residual the carry
        (``core.SharedTensor.regraft_reset_to_carry``'s twin)."""
        if self._lib.st_engine_compat_regraft(self._handle(), link_id) == 0:
            raise DuplicateLink(f"link {link_id} already exists")

    def stash_carry(self, link_id: int) -> Optional[int]:
        """Park a dead uplink's residual (unacknowledged frames rolled back)
        in the engine's live carry slot, which keeps absorbing adds and
        floods while the node is orphaned. The rolled-back messages become
        the severed link's record, in place of any earlier one, until
        :meth:`retract_kept`. Returns their frames with a nonzero scale,
        or None if the link is unknown."""
        rolled = np.zeros(1, np.uint64)
        if self._lib.st_engine_stash_carry(self._handle(), link_id, rolled) == 0:
            return None
        return int(rolled[0])

    def retract_kept(self, applied: int) -> int:
        """The re-join's WELCOME reported the severed link's messages up to
        wire seq ``applied`` applied by the parent: take their frames out
        of the replica, every link's residual and the carry, then drop the
        record (``applied`` 0 drops it whole). Returns the frames
        retracted."""
        return int(self._lib.st_engine_retract_kept(self._handle(), applied))

    def take_carry_and_snapshot(self) -> tuple[Optional[torch.Tensor], torch.Tensor]:
        """Consume the carry and copy the replica under one lock."""
        carry = np.empty(self.spec.total, np.float32)
        values = np.empty(self.spec.total, np.float32)
        has = self._lib.st_engine_take_carry_and_snapshot(
            self._handle(), carry.ctypes.data_as(ctypes.c_void_p), values.ctypes.data_as(ctypes.c_void_p)
        )
        return (torch.from_numpy(carry) if has else None), torch.from_numpy(values)

    def drop_carry(self) -> None:
        """Consume the carry without copying anything (a new master: its
        mass is already in the replica)."""
        self._lib.st_engine_take_carry_and_snapshot(self._handle(), None, None)

    def drop_link(self, link_id: int) -> Optional[torch.Tensor]:
        """Detach a link; its residual with every unacknowledged frame
        rolled back, or None if unknown."""
        out = np.empty(self.spec.total, np.float32)
        applied = np.zeros(1, np.uint64)
        if self._lib.st_engine_detach(self._handle(), link_id, out.ctypes.data_as(ctypes.c_void_p), applied) == 0:
            return None
        return torch.from_numpy(out)

    def detach_applied(self, link_id: int) -> Optional[int]:
        """Detach a link and return the data messages applied from it, read
        under the lock that removes it (so none is applied after the
        count), or None if unknown; its residual is dropped."""
        applied = np.zeros(1, np.uint64)
        if self._lib.st_engine_detach(self._handle(), link_id, None, applied) == 0:
            return None
        return int(applied[0])

    @property
    def link_ids(self) -> tuple[int, ...]:
        if not self._h:
            return ()
        arr = np.empty(_MAX_LINKS, np.int32)
        n = self._lib.st_engine_links(self._h, arr, _MAX_LINKS)
        return tuple(int(x) for x in arr[:n])

    def inflight_total(self) -> int:
        return int(self._lib.st_engine_inflight(self._h)) if self._h else 0

    def residual_rms(self, link_id: int) -> float:
        """RMS of a link's residual; the carry is link -1 (0 if none)."""
        if not self._h:
            return 0.0
        return max(0.0, float(self._lib.st_engine_residual_rms(self._h, link_id)))

    def receive_frame(self, link_id: int, frame: TableFrame) -> None:
        """Apply one frame decoded outside the engine (before a link is
        attached); its ACK stays with the caller."""
        self.receive_frames(link_id, [frame])

    def receive_frames(self, link_id: int, frames: list[TableFrame]) -> None:
        if not frames:
            return
        scales = np.ascontiguousarray(np.concatenate([np.asarray(f.scales, np.float32).reshape(-1) for f in frames]))
        words = np.ascontiguousarray(np.concatenate([codec_np._u32(f.words).reshape(-1) for f in frames]))
        self._lib.st_engine_inject(self._handle(), link_id, len(frames), scales, words)

    def _resid_stack(self, links: dict) -> tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(sorted(links), np.int32)
        if len(ids):
            resids = np.ascontiguousarray(np.stack([codec_np._f32(links[i]) for i in ids]))
        else:
            resids = np.zeros((0, self.spec.total), np.float32)
        return ids, resids

    def snapshot_ex(self) -> tuple[torch.Tensor, dict[int, torch.Tensor], dict[int, dict]]:
        """The replica, every residual (the carry as link -1) and each
        link's wire state (``tx_seq``, the last DATA/BURST seq sent;
        ``rx_count``, the last in-order seq accepted; ``prec``, its wire
        precision; ``sub``, ``sign2`` and ``ranged``, its mode and its
        peer's sign2 capability; ``gov_prev``, the governor's last RMS
        sample), under one engine lock: the checkpoint primitive, atomic
        against cascade quantizes and sign2 frames in flight."""
        values = np.empty(self.spec.total, np.float32)
        ids = np.empty(_MAX_LINKS, np.int32)
        resids = np.empty((_MAX_LINKS, self.spec.total), np.float32)
        aux = np.zeros((_MAX_LINKS, 4), np.uint64)
        n = self._lib.st_engine_snapshot_ex(self._handle(), values, ids, resids.reshape(-1), aux.reshape(-1),
                                            _MAX_LINKS)
        links, meta = {}, {}
        for i in range(n):
            lid = int(ids[i])
            links[lid] = torch.from_numpy(resids[i].copy())
            if lid >= 0:
                packed = int(aux[i, 2])
                meta[lid] = {
                    "tx_seq": int(aux[i, 0]), "rx_count": int(aux[i, 1]), "prec": packed & 0xFF,
                    "sub": bool(packed >> 8 & 1), "sign2": bool(packed >> 9 & 1), "ranged": bool(packed >> 10 & 1),
                    "gov_prev": float(aux[i, 3:4].view(np.float64)[0]),
                }
        return torch.from_numpy(values), links, meta

    def snapshot_all(self) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
        values, links, _ = self.snapshot_ex()
        return values, links

    def restore_ex(self, values, links: dict, meta: Optional[dict] = None) -> None:
        """Restore the replica and the residuals of the given links that
        exist (and the carry, link -1) atomically in C, with each link's
        precision, capability flags and governor sample from ``meta``
        (:meth:`snapshot_ex`'s); live links keep their wire seqs. Restored
        links are marked to stream."""
        v = codec_np._f32(values)
        if v.shape != (self.spec.total,):
            raise ValueError(f"values shape {v.shape} != ({self.spec.total},)")
        ids, resids = self._resid_stack(links)
        aux_ptr = None
        if meta is not None:
            aux = np.zeros((max(1, len(ids)), 4), np.uint64)
            for i, lid in enumerate(ids):
                m = meta.get(int(lid))
                if m is not None:
                    flags = (1 if m.get("sub") else 0) | (2 if m.get("sign2") else 0) | (4 if m.get("ranged") else 0)
                    aux[i, 0] = m.get("tx_seq", 0)
                    aux[i, 1] = m.get("rx_count", 0)
                    aux[i, 2] = (m.get("prec", 0) & 0xFF) | flags << 8
                    aux[i, 3:4] = np.asarray([m.get("gov_prev", -1.0)], np.float64).view(np.uint64)
            aux_ptr = aux.ctypes.data_as(ctypes.c_void_p)
        self._lib.st_engine_restore_ex(self._handle(), v, len(ids), ids, resids.reshape(-1), aux_ptr)

    def restore_state(self, values, links: dict) -> None:
        """Checkpoint restore (the inverse of :meth:`snapshot_all`), atomic
        in C: residuals restore for links that exist (and the carry)."""
        v = codec_np._f32(values)
        if v.shape != (self.spec.total,):
            raise ValueError(f"values shape {v.shape} != ({self.spec.total},)")
        ids, resids = self._resid_stack(links)
        self._lib.st_engine_restore(self._handle(), v, len(ids), ids, resids.reshape(-1))

    def poll_ctrl(self) -> Optional[tuple[int, bytes]]:
        """One message the engine's receiver handed back to Python (it owns
        only DATA, BURST and ACK on attached links), if any."""
        if not self._h:
            return None
        link = _I32(0)
        n = self._lib.st_engine_poll_ctrl(self._h, ctypes.byref(link), self._ctrl_buf, len(self._ctrl_buf))
        if n <= 0:
            return None
        return int(link.value), self._ctrl_buf.raw[:n]

    # -- counters ----------------------------------------------------------------

    def counters(self) -> np.ndarray:
        """The engine's counters (all 0 after destroy(); never raises):
        [frames_out, frames_in, updates, msgs_out, msgs_in, tx slot
        acquires, tx slot alloc events, tx slots allocated, retransmitted
        msgs, dedup discards, ACK rtt ns sum, ACK rtt samples, hops sum,
        hop samples, staleness ns last, traced msgs in, subscriber msgs
        out, FRESH marks out, precision upshifts, downshifts, sign2 frames
        out, sign2 frames in]."""
        out = np.zeros(22, np.uint64)
        if self._h:
            self._lib.st_engine_counters(self._h, out)
        return out

    def link_obs(self, link_id: int) -> Optional[tuple[float, int]]:
        """(staleness seconds, hops) of the latest traced message applied
        from a link, or None."""
        if not self._h:
            return None
        out = np.zeros(2, np.uint64)
        if not self._lib.st_engine_link_obs(self._h, link_id, out):
            return None
        return float(out[0]) / 1e9, int(out[1])

    def pool_stats(self) -> dict:
        """The tx slot ring: in steady state ``acquires`` grows and
        ``alloc_events`` stays flat."""
        c = self.counters()
        return {"tx_slot_acquires": int(c[5]), "tx_slot_alloc_events": int(c[6]), "tx_slots_allocated": int(c[7])}

    def obs_stats(self) -> dict:
        """Aggregates under the JAX package's metric names."""
        c = self.counters()
        return {
            "st_retransmit_msgs_total": int(c[8]),
            "st_dedup_discards_total": int(c[9]),
            "st_ack_rtt_seconds_sum": int(c[10]) / 1e9,
            "st_ack_rtt_seconds_count": int(c[11]),
            "st_update_hops_sum": int(c[12]),
            "st_update_hops_count": int(c[13]),
            "st_traced_msgs_in_total": int(c[15]),
            "st_sub_msgs_out_total": int(c[16]),
            "st_sub_fresh_out_total": int(c[17]),
            "st_precision_upshifts_total": int(c[18]),
            "st_precision_downshifts_total": int(c[19]),
            "st_frames2_out_total": int(c[20]),
            "st_frames2_in_total": int(c[21]),
        }

    @property
    def frames_out(self) -> int:
        return int(self.counters()[0])

    @property
    def frames_in(self) -> int:
        return int(self.counters()[1])

    @property
    def updates(self) -> int:
        return int(self.counters()[2])

    def __repr__(self) -> str:
        if not self._h:
            return f"EngineTensor(destroyed, leaves={self.spec.num_leaves}, n={self.spec.total_n})"
        c = self.counters()
        return (
            f"EngineTensor(leaves={self.spec.num_leaves}, n={self.spec.total_n}, "
            f"links={list(self.link_ids)}, out={c[0]}, in={c[1]})"
        )
