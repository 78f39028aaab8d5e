"""Message encoding of the peer tier (native framing).

The counterpart of ``shared_tensor_tpu/comm/wire.py``, byte for byte, for
the messages the port speaks: every message is typed by its first byte
inside the transport's length-prefixed framing, little-endian throughout.

- DATA ``[0][u32 seq][trace?][scales L*f32][words W*u32]`` and BURST
  ``[7][u32 seq][u8 k][trace?][k x (scales||words)]`` carry codec frames.
  ``seq`` is the sender's per-link count of DATA/BURST messages from 1:
  the receiver applies a message only when ``seq`` is the next one it
  expects, acknowledges the count cumulatively (ACK ``[6][u64 count]``),
  and the sender re-sends the head of its unacknowledged tail byte for
  byte after a timeout (go-back-N), so loss, duplication and truncation
  neither lose nor double any mass.
- The optional 13-byte trace (v2 framing) is ``[u32 origin][u64 origin
  ns][u8 hops]``; decoders tell v1 from v2 by exact length, since a body
  is a multiple of 4 bytes.
- A joiner sends SYNC ``[1][u32 leaves][u64 elements][16-byte layout
  digest][u8 wire version][u8 flags]``, then its replica as CHUNKs ``[2][u64
  byte offset][f32 bytes]`` and DONE ``[3]``. The parent answers WELCOME
  ``[4][u8 flags]`` and seeds the link with (its replica - the snapshot),
  or REJECT ``[5][utf-8 reason]``.
- The serving tier: a read-only subscriber's SYNC carries
  ``SYNC_FLAG_READ_ONLY`` (and ``SYNC_FLAG_RANGE``, followed by RANGE
  ``[9][u32 word lo][u32 word count]`` before its DONE); the parent answers
  WELCOME, its snapshot of the subscribed words as CHUNKs and DONE, then
  FRESH ``[10][u64 t ns][u32 last seq]``, and streams unledgered DATA/BURST,
  or for a range RDATA ``[11][u32 seq][u32 word lo][u32 word count][trace?]
  [scales L*f32][words count*u32]``, one frame sliced to the range. FRESH
  says "as of t you have everything I have" and names the link's last
  data seq, so a subscriber that missed the stream's tail can tell.

- The aligned v3 framing, which a native engine emits toward a peer whose
  SYNC or WELCOME carried ``SYNC_FLAG_SHM``: one 24-byte header for DATA
  and BURST, ``[kind][u8 k][pad u16][u32 seq][u32 origin][u64 origin ns]
  [u8 hops][pad x3]``, so the frame bodies land 8-aligned. Every decoder
  here takes it, told apart by exact length (24 is a multiple of 4 and
  collides with neither 5/18 nor 6/19).
- sign2 frames (the kind byte's 0x80 bit, ``[scales][sign words][magnitude
  words]``) flow only between native engines that both advertised
  ``SYNC_FLAG_SIGN2``; the Python tiers never advertise it and so never
  receive one, but the receive bound (:func:`frame_wire_bytes`) counts
  them, because it must equal every other peer's.
- The same-host shared-memory lane: a joiner with ``SYNC_FLAG_SHM``
  appends its 16-byte host id to SYNC; a parent on the same host answers
  with the flag and a segment offer ``[host id][u64 token][u8 len][name]``
  in WELCOME's tail. Peers that do not speak it ignore the tails.
- A severed uplink's applied prefix (``SYNC_FLAG_PREV_LINK``, this
  package's only): a joiner's SYNC ends with two u64 link tokens, its new
  uplink's and the severed one's; a parent that recorded the severed link
  ends WELCOME with a u64, the count of that link's DATA/BURST messages it
  applied. The JAX package neither sends nor sets the bit.
- The observability plane's control messages: DIGEST ``[8][JSON]``, a
  subtree's bounded cluster metrics digest (``obs/aggregate.py``), sent up
  the tree once per ``ObsConfig.digest_interval_sec``; CLOCK ``[18][JSON]``,
  a four-stamp clock-offset probe or its reply (``obs/clock.py``). Both
  bodies are compact JSON (no spaces) of at most ``DIGEST_MAX_BYTES``.
- The cluster lifecycle's control messages, compact JSON under the same
  cap: SNAP ``[12]`` (the barrier marker, down), SNAP_ACK ``[13]`` (the
  subtree's shard entries, up), RESUME ``[14]`` (the barrier's release,
  down) and CTL ``[15]`` (a routed operator command, down).
- The cluster-sharded tensor: a sharded joiner's SYNC carries
  ``SYNC_FLAG_SHARD`` and a u16 shard-index claim after the shm tail; a
  sharded parent answers WELCOME with the same flag, then SHARD
  ``[16][JSON]`` control messages (the map, claims, grants, route
  announces, the handoff's state) and FWD ``[17][u32 link seq][u32 word
  lo][u32 word count][u32 origin][u32 fwd seq][k frames]`` messages, a
  writer's out-of-shard delta routed toward the shard's owner (see the
  section below).
- The reference (compat) wire format has no typed messages at all: one
  ``[f32 scale][ceil(n/8)-byte LSB-first bitmask]`` frame per transport
  message, of one flat tensor (:func:`encode_compat_frame`).

Frames are numpy f32 scales and uint32 words at this boundary, what
``SharedTensor.finish_frame`` returns.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
from typing import Iterator, Optional

import numpy as np

from ..ops.table import TableFrame, TableSpec

log = logging.getLogger("shared_tensor_tpu_torch.wire")

# message kinds (first payload byte)
DATA = 0
SYNC = 1
CHUNK = 2
DONE = 3
WELCOME = 4
REJECT = 5
ACK = 6
BURST = 7
DIGEST = 8  # child -> parent: a subtree's cluster metrics digest (JSON)
RANGE = 9  # serving tier: a subscriber's word range
FRESH = 10  # parent -> subscriber: drain mark
RDATA = 11  # parent -> subscriber: one frame sliced to the range
SNAP = 12  # parent -> child: lifecycle barrier marker (JSON)
SNAP_ACK = 13  # child -> parent: barrier ack + the subtree's shard entries (JSON)
RESUME = 14  # parent -> child: release the lifecycle barrier (JSON)
CTL = 15  # parent -> child: a routed operator command (JSON)
SHARD = 16  # the sharded tensor's control plane: claims, grants, routes, handoff (JSON)
FWD = 17  # an owner-routed slice of a writer's out-of-shard delta
CLOCK = 18  # clock-offset probe or reply (JSON)

# DATA/BURST framing versions, advertised in SYNC (compat.WIRE_VERSION_*)
WIRE_VERSION_V1 = 1
WIRE_VERSION_V2 = 2
# handshake capability flags (compat re-exports them as compat.SYNC_FLAG_*)
SYNC_FLAG_READ_ONLY = 0x01
SYNC_FLAG_RANGE = 0x02
SYNC_FLAG_SIGN2 = 0x04
SYNC_FLAG_SHM = 0x08
SYNC_FLAG_SHARD = 0x10
#: This package's own capability, a bit the JAX package does not use: a
#: joiner names its uplink and the uplink before it in SYNC, and a parent
#: that recorded that earlier link answers in WELCOME with how many of its
#: DATA/BURST messages it applied (the tails below).
SYNC_FLAG_PREV_LINK = 0x20
#: The bit that gates the SYNC and WELCOME shared-memory tails.
SHM_FLAG = SYNC_FLAG_SHM
#: The kind byte's bit that marks a sign2 (2-bit) DATA/BURST frame.
PRECISION_BIT = 0x80

_SYNC_FMT = "<IQ16s"  # num_leaves, total_n, layout digest
_CHUNK_HDR = "<Q"  # byte offset into the flat f32 snapshot
#: Snapshot chunk payload cap.
CHUNK_BYTES = 1 << 22

#: Most frames one BURST may carry, and the payload budget of one BURST:
#: every peer sizes its receive buffer from these and the spec.
BURST_MAX_FRAMES = 255
BURST_MAX_BYTES = 1 << 24

DATA_HDR = 5  # kind + u32 seq
BURST_HDR = 6  # kind + u32 seq + u8 k
TRACE_BYTES = 13
DATA_HDR_T = DATA_HDR + TRACE_BYTES
BURST_HDR_T = BURST_HDR + TRACE_BYTES
_TRACE_FMT = "<IQB"  # origin node id, origin monotonic ns, hop count
HDR_V3 = 24  # the aligned DATA/BURST framing a native engine emits
RDATA_HDR = 13  # kind + u32 seq + u32 word lo + u32 word count
RDATA_HDR_T = RDATA_HDR + TRACE_BYTES
_RANGE_FMT = "<II"  # word lo, word count
_FRESH_FMT = "<QI"  # t ns, last data seq
#: Cap of one JSON control message's body (DIGEST, CLOCK); every peer's
#: receive buffer carries at least this much (frame_wire_bytes).
DIGEST_MAX_BYTES = 1 << 16

# Process-wide count of non-finite scales zeroed at decode.
_corrupt_mu = threading.Lock()
_corrupt_scales_zeroed = 0


def corrupt_scales_zeroed() -> int:
    with _corrupt_mu:
        return _corrupt_scales_zeroed


def _count_corrupt_scales(n: int) -> None:
    global _corrupt_scales_zeroed
    with _corrupt_mu:
        _corrupt_scales_zeroed += n


# -- sizes ---------------------------------------------------------------------


def frame_payload_bytes(spec: TableSpec) -> int:
    """Bytes of one frame's wire body: scales + packed words."""
    return 4 * spec.num_leaves + 4 * (spec.total // 32)


def sub_frame_wire_bytes(spec: TableSpec, word_cnt: Optional[int] = None) -> int:
    """Bytes of one frame as a subscriber link carries it: a traced DATA
    of the whole table, or a traced RDATA of ``word_cnt`` words."""
    if word_cnt is None:
        return DATA_HDR_T + frame_payload_bytes(spec)
    return RDATA_HDR_T + 4 * spec.num_leaves + 4 * word_cnt


def frame_payload2_bytes(spec: TableSpec) -> int:
    """Bytes of one sign2 frame's wire body: scales, sign words and
    magnitude words."""
    return 4 * spec.num_leaves + 8 * (spec.total // 32)


def burst_frames_cap(spec: TableSpec) -> int:
    """Most frames one BURST may carry for this spec (>= 1), against the v2
    header."""
    per = frame_payload_bytes(spec)
    return max(1, min(BURST_MAX_FRAMES, (BURST_MAX_BYTES - BURST_HDR_T) // per))


def frame_wire_bytes(spec: TableSpec) -> int:
    """Largest message any peer of this spec may send: the receive buffer
    every peer sizes (a larger message would be cut by the transport)."""
    per = frame_payload_bytes(spec)
    sign2 = frame_payload2_bytes(spec)
    hdr = max(DATA_HDR_T, HDR_V3)
    burst = max(BURST_HDR_T, HDR_V3) + burst_frames_cap(spec) * per
    chunk = 1 + struct.calcsize(_CHUNK_HDR) + CHUNK_BYTES
    return max(hdr + per, hdr + sign2, RDATA_HDR_T + per, chunk, burst, 1 + DIGEST_MAX_BYTES)


# -- DATA / BURST --------------------------------------------------------------


def _is_v3(payload, spec: TableSpec) -> bool:
    """A v3 DATA/BURST message: k (byte 1) frames after a 24-byte header,
    of the width the kind byte's precision bit names."""
    n = len(payload)
    if n <= HDR_V3 or not payload[1]:
        return False
    per = frame_payload2_bytes(spec) if payload[0] & PRECISION_BIT else frame_payload_bytes(spec)
    return n == HDR_V3 + payload[1] * per


def data_seq(payload: bytes, spec: Optional[TableSpec] = None) -> int:
    """The per-link seq of a DATA, BURST or RDATA message: byte 1 in each
    framing but v3, where it is byte 4. Pass ``spec`` when the sender may
    be a native engine: only the exact length tells v3 apart."""
    if len(payload) < DATA_HDR:
        raise ValueError(f"{len(payload)}-byte data message is too short to carry a seq")
    if spec is not None and _is_v3(payload, spec):
        return struct.unpack_from("<I", payload, 4)[0]
    return struct.unpack_from("<I", payload, 1)[0]


def data_trace(payload: bytes, spec: TableSpec) -> Optional[tuple[int, int, int]]:
    """(origin, origin ns, hops) of a v2 or v3 DATA/BURST message, None for
    v1 and for RDATA, whose trace :func:`decode_rdata` returns."""
    per = frame_payload_bytes(spec)
    n = len(payload)
    if not n:
        return None
    if n > HDR_V3 and payload[1] and n == HDR_V3 + payload[1] * per:
        return struct.unpack_from(_TRACE_FMT, payload, 8)
    if payload[0] == DATA and n == DATA_HDR_T + per:
        return struct.unpack_from(_TRACE_FMT, payload, DATA_HDR)
    if payload[0] == BURST and n > BURST_HDR_T:
        k = payload[BURST_HDR - 1]
        if k and n == BURST_HDR_T + k * per:
            return struct.unpack_from(_TRACE_FMT, payload, BURST_HDR)
    return None


def _clamp_trace(trace) -> tuple[int, int, int]:
    origin, gen, hops = trace
    return origin & 0xFFFFFFFF, gen & 0xFFFFFFFFFFFFFFFF, min(int(hops), 255)


def _write_frame_body(buf: memoryview, off: int, frame: TableFrame) -> int:
    scales = np.ascontiguousarray(frame.scales, "<f4")
    words = np.ascontiguousarray(frame.words, "<u4")
    sb, wb = scales.nbytes, words.nbytes
    buf[off : off + sb] = memoryview(scales).cast("B")
    buf[off + sb : off + sb + wb] = memoryview(words).cast("B")
    return off + sb + wb


def _header(kind: int, seq: int, k: Optional[int], trace) -> bytes:
    hdr = bytes([kind]) + struct.pack("<I", seq & 0xFFFFFFFF)
    if k is not None:
        hdr += bytes([k])
    if trace is not None:
        hdr += struct.pack(_TRACE_FMT, *_clamp_trace(trace))
    return hdr


def _check_burst(n_frames: int, spec: TableSpec) -> None:
    cap = burst_frames_cap(spec)
    if not 1 <= n_frames <= cap:
        raise ValueError(
            f"burst of {n_frames} frames (this spec allows 1..{cap}, the bound "
            f"peers sized their receive buffers for)"
        )


def encode_frame_into(frame: TableFrame, seq: int, buf: memoryview, trace=None) -> int:
    """DATA written into ``buf`` (a pool slot); returns its length.
    ``trace`` = (origin, origin ns, hops) selects the v2 framing."""
    hdr = _header(DATA, seq, None, trace)
    buf[: len(hdr)] = hdr
    return _write_frame_body(buf, len(hdr), frame)


def encode_frame(frame: TableFrame, seq: int, trace=None) -> bytes:
    buf = memoryview(bytearray(DATA_HDR_T + 4 * (np.size(frame.scales) + np.size(frame.words))))
    return bytes(buf[: encode_frame_into(frame, seq, buf, trace)])


def encode_burst_into(frames, spec: TableSpec, seq: int, buf: memoryview, trace=None) -> int:
    """BURST of ``frames`` written into ``buf``; returns its length."""
    _check_burst(len(frames), spec)
    hdr = _header(BURST, seq, len(frames), trace)
    buf[: len(hdr)] = hdr
    off = len(hdr)
    for f in frames:
        off = _write_frame_body(buf, off, f)
    # a mis-sized burst would desync every decoder downstream
    if off != len(hdr) + len(frames) * frame_payload_bytes(spec):
        raise ValueError(f"encoded burst is {off} bytes, the layout wants "
                         f"{len(hdr) + len(frames) * frame_payload_bytes(spec)}")
    return off


def encode_burst(frames, spec: TableSpec, seq: int, trace=None) -> bytes:
    _check_burst(len(frames), spec)
    buf = memoryview(bytearray(BURST_HDR_T + len(frames) * frame_payload_bytes(spec)))
    return bytes(buf[: encode_burst_into(frames, spec, seq, buf, trace)])


def _decode_one_frame(payload, off: int, spec: TableSpec) -> TableFrame:
    """The scales are a copy with non-finite values zeroed: a NaN or inf
    scale would poison the replica and flood the whole tree, so the leaf
    becomes a no-op and the frame's mass is lost instead. The words are a
    read-only view of the message (possibly unaligned), which the receiver
    copies into its staging buffer."""
    k = spec.num_leaves
    w = spec.total // 32
    scales = np.frombuffer(payload, "<f4", count=k, offset=off).astype(np.float32)
    words = np.frombuffer(payload, "<u4", count=w, offset=off + 4 * k)
    bad = ~np.isfinite(scales)
    if bad.any():
        nbad = int(np.count_nonzero(bad))
        log.warning("zeroing %d non-finite scale(s) in received frame (corrupt link?)", nbad)
        _count_corrupt_scales(nbad)
        scales[bad] = np.float32(0.0)
    return TableFrame(scales, words)


def decode_frame(payload: bytes, spec: TableSpec) -> TableFrame:
    """One DATA message (v1, v2 or v3)."""
    per = frame_payload_bytes(spec)
    if len(payload) == DATA_HDR + per:
        off = DATA_HDR
    elif len(payload) == DATA_HDR_T + per:
        off = DATA_HDR_T
    elif len(payload) == HDR_V3 + per and payload[1] == 1:
        off = HDR_V3
    else:
        raise ValueError(
            f"DATA frame is {len(payload)} bytes, the spec wants {DATA_HDR + per}, "
            f"{DATA_HDR_T + per} or {HDR_V3 + per}: peer table layout mismatch"
        )
    return _decode_one_frame(payload, off, spec)


def decode_burst(payload: bytes, spec: TableSpec) -> list[TableFrame]:
    """One BURST message (v1, v2 or v3)."""
    if len(payload) < BURST_HDR:
        raise ValueError(f"BURST message of {len(payload)} bytes has no header")
    per = frame_payload_bytes(spec)
    if payload[1] > 0 and len(payload) == HDR_V3 + payload[1] * per:
        # v3 keeps k at byte 1 (byte 5 is inside its seq): checked first
        return [_decode_one_frame(payload, HDR_V3 + i * per, spec) for i in range(payload[1])]
    k = payload[BURST_HDR - 1]
    if k == 0:
        raise ValueError("BURST with k_frames == 0")  # would ACK a message that delivered nothing
    if len(payload) == BURST_HDR + k * per:
        hdr = BURST_HDR
    elif len(payload) == BURST_HDR_T + k * per:
        hdr = BURST_HDR_T
    else:
        raise ValueError(
            f"BURST of {k} frames is {len(payload)} bytes, the layout wants "
            f"{BURST_HDR + k * per} or {BURST_HDR_T + k * per}: peer table layout mismatch"
        )
    return [_decode_one_frame(payload, hdr + i * per, spec) for i in range(k)]


class FramePool:
    """Send-buffer slots of one message's size: a slot is encoded in place,
    kept as the ledger's byte-identical retransmission payload, and
    released when its ACK arrives (or its link dies). ``keep`` bounds the
    free slots held. Only the send thread acquires and writes slots; the
    lock covers the free list, which the receive thread's ACKs release to."""

    def __init__(self, slot_bytes: int, keep: int = 4):
        self.slot_bytes = int(slot_bytes)
        self._keep = keep
        self._free: list[memoryview] = []
        self._mu = threading.Lock()
        self.alloc_events = 0

    def acquire(self) -> memoryview:
        with self._mu:
            if self._free:
                return self._free.pop()
            self.alloc_events += 1
        return memoryview(bytearray(self.slot_bytes))

    def release(self, slot: memoryview) -> None:
        with self._mu:
            if len(self._free) < self._keep:
                self._free.append(slot)


# -- handshake -----------------------------------------------------------------


def encode_sync(
    spec: TableSpec, wire_version: int = WIRE_VERSION_V2, flags: int = 0, shm_host: bytes = b"", shard: int = -1,
    prev_link: tuple[int, int] = (0, 0),
) -> bytes:
    """Join request. With ``SYNC_FLAG_SHM`` the joiner's 16-byte host id
    (``shm_host``) follows the flags; with ``SYNC_FLAG_SHARD`` a u16
    shard-index claim follows that (0xFFFF: a member that owns no shard).
    A parent that is not sharded ignores the claim and attaches the joiner
    as a plain writer child; the joiner tells by the absent shard flag in
    WELCOME and falls back to the full-replica protocol. With
    ``SYNC_FLAG_PREV_LINK`` the last 16 bytes are ``prev_link``: two u64
    tokens, this uplink's and the severed one's before it (0: none).
    Parents that do not speak the flag read nothing past their own tails."""
    return (
        bytes([SYNC])
        + struct.pack(_SYNC_FMT, spec.num_leaves, spec.total_n, spec.layout_digest())
        + bytes([wire_version & 0xFF, flags & 0xFF])
        + (shm_host[:16] if flags & SHM_FLAG else b"")
        + (struct.pack("<H", shard & 0xFFFF) if flags & SYNC_FLAG_SHARD else b"")
        + (struct.pack("<QQ", *prev_link) if flags & SYNC_FLAG_PREV_LINK else b"")
    )


def decode_sync(payload: bytes) -> tuple[int, int, bytes]:
    """(num_leaves, total_n, layout digest)."""
    return struct.unpack_from(_SYNC_FMT, payload, 1)


def sync_wire_version(payload: bytes) -> int:
    base = 1 + struct.calcsize(_SYNC_FMT)
    return payload[base] if len(payload) > base else WIRE_VERSION_V1


def sync_flags(payload: bytes) -> int:
    base = 2 + struct.calcsize(_SYNC_FMT)
    return payload[base] if len(payload) > base else 0


def sync_shm_host(payload: bytes) -> Optional[bytes]:
    """The joiner's 16-byte host id, or None when its SYNC has no
    ``SYNC_FLAG_SHM`` (or the tail is cut)."""
    if not sync_flags(payload) & SHM_FLAG:
        return None
    base = 3 + struct.calcsize(_SYNC_FMT)
    return bytes(payload[base : base + 16]) if len(payload) >= base + 16 else None


def sync_shard(payload: bytes) -> Optional[int]:
    """The joiner's shard-index claim, or None when its SYNC has no
    ``SYNC_FLAG_SHARD`` (or the tail is cut); 0xFFFF reads as -1. The tail
    sits after the optional 16-byte shm host id."""
    flags = sync_flags(payload)
    if not flags & SYNC_FLAG_SHARD:
        return None
    base = 3 + struct.calcsize(_SYNC_FMT) + (16 if flags & SHM_FLAG else 0)
    if len(payload) < base + 2:
        return None
    (idx,) = struct.unpack_from("<H", payload, base)
    return -1 if idx == 0xFFFF else idx


def encode_welcome(flags: int = 0, shm_offer=None, applied: int = 0) -> bytes:
    """WELCOME with the parent's capability flags (``SYNC_FLAG_SIGN2``,
    ``SYNC_FLAG_SHM``, ``SYNC_FLAG_SHARD`` from a sharded parent) and, with the SHM flag, the shared-memory segment
    offer ``shm_offer = (host id, token, /dev/shm name)`` in its tail. With
    ``SYNC_FLAG_PREV_LINK`` the last 8 bytes are ``applied``, a u64: the
    DATA/BURST messages of the joiner's previous link that the parent
    applied."""
    out = bytes([WELCOME, flags & 0xFF])
    if flags & SHM_FLAG and shm_offer is not None:
        host, token, name = shm_offer
        nb = name.encode()
        out += host[:16].ljust(16, b"\0") + struct.pack("<Q", token & 0xFFFFFFFFFFFFFFFF) + bytes([len(nb) & 0xFF]) + nb
    if flags & SYNC_FLAG_PREV_LINK:
        out += struct.pack("<Q", applied)
    return out


def welcome_flags(payload: bytes) -> int:
    return payload[1] if len(payload) > 1 else 0


def sync_prev_link(payload: bytes) -> Optional[tuple[int, int]]:
    """The joiner's (this uplink's token, its previous uplink's token), or
    None when its SYNC has no ``SYNC_FLAG_PREV_LINK`` (or is too short)."""
    if not sync_flags(payload) & SYNC_FLAG_PREV_LINK or len(payload) < 3 + struct.calcsize(_SYNC_FMT) + 16:
        return None
    return struct.unpack_from("<QQ", payload, len(payload) - 16)


def welcome_applied(payload: bytes) -> Optional[int]:
    """The messages of our previous uplink that the parent applied, or None
    when its WELCOME has no ``SYNC_FLAG_PREV_LINK`` (it kept no record)."""
    if not welcome_flags(payload) & SYNC_FLAG_PREV_LINK or len(payload) < 2 + 8:
        return None
    return struct.unpack_from("<Q", payload, len(payload) - 8)[0]


def welcome_shm(payload: bytes) -> Optional[tuple[bytes, int, str]]:
    """The parent's segment offer (host id, token, name), or None when its
    WELCOME carries none (or the tail is cut): the link stays on TCP."""
    if not welcome_flags(payload) & SHM_FLAG or len(payload) < 2 + 16 + 8 + 1:
        return None
    host = bytes(payload[2:18])
    (token,) = struct.unpack_from("<Q", payload, 18)
    nlen = payload[26]
    if len(payload) < 27 + nlen:
        return None
    return host, token, bytes(payload[27 : 27 + nlen]).decode(errors="replace")


def encode_reject(reason: str) -> bytes:
    return bytes([REJECT]) + reason.encode("utf-8", "replace")


def decode_reject(payload: bytes) -> str:
    return payload[1:].decode("utf-8", "replace")


def encode_snapshot_chunks(flat: np.ndarray) -> Iterator[bytes]:
    """A flat f32 replica snapshot as CHUNK messages, then DONE."""
    raw = np.asarray(flat, dtype="<f4").tobytes()
    for off in range(0, len(raw), CHUNK_BYTES):
        yield bytes([CHUNK]) + struct.pack(_CHUNK_HDR, off) + raw[off : off + CHUNK_BYTES]
    yield bytes([DONE])


def decode_chunk_into(payload: bytes, buf: bytearray) -> None:
    (off,) = struct.unpack_from(_CHUNK_HDR, payload, 1)
    body = payload[1 + struct.calcsize(_CHUNK_HDR) :]
    if off + len(body) > len(buf):
        raise ValueError(f"snapshot chunk [{off}:{off + len(body)}] overruns {len(buf)}-byte snapshot buffer")
    buf[off : off + len(body)] = body


def encode_ack(count: int) -> bytes:
    """Cumulative count of DATA/BURST messages accepted on this link."""
    return bytes([ACK]) + struct.pack("<Q", count)


def decode_ack(payload: bytes) -> int:
    return struct.unpack_from("<Q", payload, 1)[0]


# -- observability plane ---------------------------------------------------------


def _encode_json(kind: int, doc: dict, what: str) -> bytes:
    body = json.dumps(doc, separators=(",", ":")).encode()
    if len(body) > DIGEST_MAX_BYTES:
        raise ValueError(f"{what} is {len(body)} bytes, cap {DIGEST_MAX_BYTES}")
    return bytes([kind]) + body


def _decode_json(payload: bytes, what: str) -> dict:
    doc = json.loads(payload[1:].decode("utf-8"))
    if not isinstance(doc, dict):
        raise ValueError(f"{what} body is not a JSON object")
    return doc


def encode_digest(doc: dict) -> bytes:
    """Child -> parent: one bounded cluster metrics digest (the caller
    bounds it first, ``obs.aggregate.bounded``)."""
    return _encode_json(DIGEST, doc, "digest")


def decode_digest(payload: bytes) -> dict:
    return _decode_json(payload, "digest")


def encode_clock(doc: dict) -> bytes:
    """One clock-offset probe or reply (``obs.clock.ClockSync``'s
    payloads)."""
    return _encode_json(CLOCK, doc, "clock message")


def decode_clock(payload: bytes) -> dict:
    return _decode_json(payload, "clock message")


def encode_lifecycle(kind: int, doc: dict) -> bytes:
    """One lifecycle control message (SNAP, SNAP_ACK, RESUME or CTL): the
    kind byte and a JSON body under ``DIGEST_MAX_BYTES``. A SNAP_ACK whose
    subtree manifest exceeds the cap raises rather than truncates: a
    partial manifest would verify as complete."""
    if kind not in (SNAP, SNAP_ACK, RESUME, CTL):
        raise ValueError(f"{kind} is not a lifecycle message kind")
    return _encode_json(kind, doc, "lifecycle message")


def decode_lifecycle(payload: bytes) -> dict:
    return _decode_json(payload, "lifecycle message")


# -- serving tier ----------------------------------------------------------------


def encode_range(word_lo: int, word_cnt: int) -> bytes:
    return bytes([RANGE]) + struct.pack(_RANGE_FMT, word_lo, word_cnt)


def decode_range(payload: bytes) -> tuple[int, int]:
    """(word lo, word count) of a RANGE message."""
    return struct.unpack_from(_RANGE_FMT, payload, 1)


def encode_fresh(t_ns: int, last_seq: int) -> bytes:
    return bytes([FRESH]) + struct.pack(_FRESH_FMT, t_ns & 0xFFFFFFFFFFFFFFFF, last_seq & 0xFFFFFFFF)


def decode_fresh(payload: bytes) -> tuple[int, int]:
    """(t ns, last data seq) of a FRESH mark."""
    return struct.unpack_from(_FRESH_FMT, payload, 1)


def encode_rdata(frame: TableFrame, word_lo: int, word_cnt: int, seq: int, trace=None) -> bytes:
    """One frame's scales (whole) and words [word_lo, word_lo + word_cnt)
    of it: the unit a ranged subscriber receives."""
    scales = np.asarray(frame.scales, dtype="<f4")
    words = np.asarray(frame.words, dtype="<u4")[word_lo : word_lo + word_cnt]
    if len(words) != word_cnt:
        raise ValueError(
            f"range [{word_lo}, {word_lo + word_cnt}) overruns the {np.asarray(frame.words).size}-word frame"
        )
    th = b"" if trace is None else struct.pack(_TRACE_FMT, *_clamp_trace(trace))
    return (
        bytes([RDATA]) + struct.pack("<I", seq & 0xFFFFFFFF) + struct.pack(_RANGE_FMT, word_lo, word_cnt)
        + th + scales.tobytes() + words.tobytes()
    )


def decode_rdata(payload: bytes, spec: TableSpec):
    """(scales f32[L], words u32[count], word lo, word count, trace or
    None) of an RDATA message (v1 or v2, told apart by exact length), with
    decode_frame's guard: non-finite scales are zeroed and counted."""
    k = spec.num_leaves
    word_lo, word_cnt = struct.unpack_from(_RANGE_FMT, payload, 5)
    if word_cnt <= 0 or word_lo + word_cnt > spec.total // 32:
        raise ValueError(f"RDATA range [{word_lo}, {word_lo + word_cnt}) outside the {spec.total // 32}-word table")
    body = 4 * k + 4 * word_cnt
    if len(payload) == RDATA_HDR + body:
        off, trace = RDATA_HDR, None
    elif len(payload) == RDATA_HDR_T + body:
        off = RDATA_HDR_T
        trace = struct.unpack_from(_TRACE_FMT, payload, RDATA_HDR)
    else:
        raise ValueError(f"RDATA is {len(payload)} bytes, its range wants {RDATA_HDR + body} or {RDATA_HDR_T + body}")
    scales = np.frombuffer(payload, "<f4", count=k, offset=off).copy()
    words = np.frombuffer(payload, "<u4", count=word_cnt, offset=off + 4 * k).copy()
    bad = ~np.isfinite(scales)
    if bad.any():
        nbad = int(np.count_nonzero(bad))
        log.warning("zeroing %d non-finite scale(s) in received RDATA (corrupt link?)", nbad)
        _count_corrupt_scales(nbad)
        scales[bad] = np.float32(0.0)
    return scales, words, word_lo, word_cnt, trace


# -- the cluster-sharded tensor -------------------------------------------------
#
# FWD ``[17][u32 link seq][u32 word lo][u32 word count][u32 origin][u32 fwd
# seq][k x (scales L*f32 || words count*u32)]``: k codec frames of a
# writer's out-of-shard delta, sliced to the target shard's word range and
# routed hop by hop toward its owner (``shard/node.py`` routes by word lo
# through the shard map). Each frame is the RDATA representation (the
# whole per-leaf scale row and the word slice); successive frames are
# successive halvings of the sender's outbox residual, and k comes from
# the message length. One message is one ledger entry and one end-to-end
# identity however many frames it carries:
#
# - the link seq is the per-link go-back-N seq (in-order accept,
#   cumulative ACK, byte-identical re-sends, as DATA/BURST); a relay
#   re-stamps it for its outgoing link and forwards the rest verbatim, so
#   owner-routed forwarding never re-quantizes;
# - (origin, fwd seq) never changes in flight. The owner deduplicates on
#   it: when a link dies every unacknowledged FWD re-routes byte-identical,
#   so a message delivered before the death is discarded instead of
#   applied twice.
#
# The sender caps k with fwd_frames_cap, inside frame_wire_bytes(spec),
# the receive bound every peer already passes to its transport.
#
# SHARD ``[16][JSON]``: the shard map's control plane (claims, grants,
# route announces, map documents, the drain-handoff's state transfer),
# under DIGEST_MAX_BYTES like every JSON control kind.

_FWD_FMT = "<IIIII"  # link seq, word lo, word count, origin, fwd seq
FWD_HDR = 21  # kind + the five u32 fields above
#: Most halving frames one FWD may carry, shared with BURST; the cap for a
#: shard's geometry is fwd_frames_cap.
FWD_BURST_FRAMES = BURST_MAX_FRAMES


def fwd_frames_cap(spec: TableSpec, word_cnt: int) -> int:
    """Most halving frames one FWD may carry for a shard of ``word_cnt``
    words (>= 1): FWD_HDR + k frames stays inside frame_wire_bytes(spec)."""
    per = 4 * spec.num_leaves + 4 * word_cnt
    return max(1, min(FWD_BURST_FRAMES, (frame_wire_bytes(spec) - FWD_HDR) // per))


def encode_fwd(frames: list, word_lo: int, seq: int, origin: int, fwd_seq: int) -> bytes:
    """``frames`` is 1..FWD_BURST_FRAMES (scales f32[L], words
    u32[word count]) pairs: successive halvings of one outbox residual,
    already sliced to the target shard's range."""
    if not 1 <= len(frames) <= FWD_BURST_FRAMES:
        raise ValueError(f"FWD burst of {len(frames)} frames (allowed 1..{FWD_BURST_FRAMES})")
    word_cnt = len(frames[0][1])
    parts = [bytes([FWD]) + struct.pack(
        _FWD_FMT, seq & 0xFFFFFFFF, word_lo & 0xFFFFFFFF, word_cnt & 0xFFFFFFFF, origin & 0xFFFFFFFF,
        fwd_seq & 0xFFFFFFFF,
    )]
    for scales, words in frames:
        if len(words) != word_cnt:
            raise ValueError("FWD burst frames must share one word range")
        parts.append(np.asarray(scales, dtype="<f4").tobytes())
        parts.append(np.asarray(words, dtype="<u4").tobytes())
    return b"".join(parts)


def fwd_restamp(payload: bytearray, seq: int) -> None:
    """Re-stamp a FWD's per-link seq for the next hop in place; every byte
    after byte 5 is forwarded verbatim."""
    struct.pack_into("<I", payload, 1, seq & 0xFFFFFFFF)


def decode_fwd(payload: bytes, spec: TableSpec) -> tuple[list, int, int, int, int]:
    """([(scales f32[L], words u32[count]), ...], word lo, link seq, origin,
    fwd seq), the frame count from the message length, with decode_frame's
    guard per frame: a non-finite scale is zeroed and counted, so a
    poisoned leaf is a no-op instead of NaN in the owner's shard."""
    n_leaves = spec.num_leaves
    seq, word_lo, word_cnt, origin, fwd_seq = struct.unpack_from(_FWD_FMT, payload, 1)
    if word_cnt <= 0 or word_lo + word_cnt > spec.total // 32:
        raise ValueError(f"FWD range [{word_lo}, {word_lo + word_cnt}) outside the {spec.total // 32}-word table")
    per = 4 * n_leaves + 4 * word_cnt
    nf, rem = divmod(len(payload) - FWD_HDR, per)
    if rem or not 1 <= nf <= FWD_BURST_FRAMES:
        raise ValueError(
            f"FWD is {len(payload)} bytes: not 1..{FWD_BURST_FRAMES} whole {per}-byte frames past the "
            f"{FWD_HDR}-byte header"
        )
    frames = []
    for i in range(nf):
        off = FWD_HDR + i * per
        scales = np.frombuffer(payload, "<f4", count=n_leaves, offset=off).copy()
        words = np.frombuffer(payload, "<u4", count=word_cnt, offset=off + 4 * n_leaves).copy()
        bad = ~np.isfinite(scales)
        if bad.any():
            nbad = int(np.count_nonzero(bad))
            log.warning("zeroing %d non-finite scale(s) in received FWD (corrupt link?)", nbad)
            _count_corrupt_scales(nbad)
            scales[bad] = np.float32(0.0)
        frames.append((scales, words))
    return frames, word_lo, seq, origin, fwd_seq


def encode_shard(doc: dict) -> bytes:
    """One shard control message (``{"t": "claim" | "grant" | "deny" |
    "map" | "own" | "ho_meta" | "ho_state" | "ho_dedup" | "ho_done" |
    "ho_ack", ...}``; ``shard/node.py`` owns the shapes). Past
    DIGEST_MAX_BYTES it raises: the handoff chunks its state under it."""
    return _encode_json(SHARD, doc, "shard control message")


def decode_shard(payload: bytes) -> dict:
    return _decode_json(payload, "shard control message")


# -- the reference (compat) wire format --------------------------------------------


def compat_frame_bytes(n: int) -> int:
    """A reference frame of an n-element tensor: the f32 scale and the
    ceil(n/8)-byte LSB-first bitmask."""
    return 4 + (n + 7) // 8


def compat_burst_frames_cap(n: int) -> int:
    """Most reference frames one wire message of the native engine may
    carry for an n-element tensor (>= 1): the BURST byte budget."""
    return max(1, min(BURST_MAX_FRAMES, BURST_MAX_BYTES // compat_frame_bytes(n)))


def encode_compat_frame(frame: TableFrame, spec: TableSpec) -> bytes:
    """A frame of a one-leaf table as reference bytes. The u32 LSB-first
    words laid out little-endian are the reference's byte packing
    (``data[i/8] |= 1 << (i%8)``), so the mask is a slice of them."""
    if spec.num_leaves != 1:
        raise ValueError("wire-compat mode syncs a single tensor, not a table")
    scale = float(np.asarray(frame.scales).reshape(-1)[0])
    mask = np.ascontiguousarray(frame.words, "<u4").tobytes()
    return struct.pack("<f", scale) + mask[: compat_frame_bytes(spec.total_n) - 4]


def decode_compat_frame(payload: bytes, spec: TableSpec) -> Optional[TableFrame]:
    """Reference bytes as a one-leaf frame, or None for a frame that must
    not be applied: an idle keepalive (scale 0) or a non-finite scale,
    which is dropped and counted as :func:`decode_frame` zeroes one."""
    if len(payload) != compat_frame_bytes(spec.total_n):
        raise ValueError(f"compat frame is {len(payload)} bytes, expected {compat_frame_bytes(spec.total_n)}")
    (scale,) = struct.unpack_from("<f", payload, 0)
    if scale == 0.0 or not np.isfinite(scale):
        if not np.isfinite(scale):
            log.warning("dropping compat frame with non-finite scale")
            _count_corrupt_scales(1)
        return None
    nwords = spec.total // 32
    raw = bytes(payload[4:]).ljust(nwords * 4, b"\x00")
    words = np.frombuffer(raw, "<u4", count=nwords)
    return TableFrame(np.full((1,), scale, np.float32), np.ascontiguousarray(words))
