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

Frames are numpy f32 scales and uint32 words at this boundary, what
``SharedTensor.finish_frame`` returns. The port emits neither the r14
aligned (v3) framing nor sign2 frames and never advertises them
(``SYNC_FLAG_SHM``, ``SYNC_FLAG_SIGN2``), so no peer sends either to it;
the receive-buffer bound (:func:`frame_wire_bytes`) still counts them,
because it must equal every other peer's.
"""

from __future__ import annotations

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
DIGEST = 8  # child -> parent metrics digest (not ported: dropped)
RANGE = 9  # serving tier (not ported)
FRESH = 10
RDATA = 11
SNAP = 12  # cluster lifecycle (not ported)
SNAP_ACK = 13
RESUME = 14
CTL = 15
SHARD = 16  # cluster-sharded tensor (not ported)
FWD = 17
CLOCK = 18  # clock-offset probe (not ported: dropped)

# DATA/BURST framing versions, advertised in SYNC (compat.WIRE_VERSION_*)
WIRE_VERSION_V1 = 1
WIRE_VERSION_V2 = 2
# handshake capability flags (compat.SYNC_FLAG_*)
SYNC_FLAG_READ_ONLY = 0x01
SYNC_FLAG_RANGE = 0x02
SYNC_FLAG_SIGN2 = 0x04
SYNC_FLAG_SHM = 0x08
SYNC_FLAG_SHARD = 0x10

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
# Headers of messages the port never emits, counted in the receive bound:
HDR_V3 = 24  # r14 aligned DATA/BURST framing
RDATA_HDR_T = 13 + TRACE_BYTES  # serving tier's ranged DATA, traced
DIGEST_MAX_BYTES = 1 << 16  # control messages with JSON bodies

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


def burst_frames_cap(spec: TableSpec) -> int:
    """Most frames one BURST may carry for this spec (>= 1), against the v2
    header."""
    per = frame_payload_bytes(spec)
    return max(1, min(BURST_MAX_FRAMES, (BURST_MAX_BYTES - BURST_HDR_T) // per))


def frame_wire_bytes(spec: TableSpec) -> int:
    """Largest message any peer of this spec may send: the receive buffer
    every peer sizes (a larger message would be cut by the transport)."""
    per = frame_payload_bytes(spec)
    sign2 = 4 * spec.num_leaves + 8 * (spec.total // 32)  # 2-bit frame body
    hdr = max(DATA_HDR_T, HDR_V3)
    burst = max(BURST_HDR_T, HDR_V3) + burst_frames_cap(spec) * per
    chunk = 1 + struct.calcsize(_CHUNK_HDR) + CHUNK_BYTES
    return max(hdr + per, hdr + sign2, RDATA_HDR_T + per, chunk, burst, 1 + DIGEST_MAX_BYTES)


# -- DATA / BURST --------------------------------------------------------------


def data_seq(payload: bytes) -> int:
    """The per-link seq of a DATA/BURST message."""
    if len(payload) < DATA_HDR:
        raise ValueError(f"{len(payload)}-byte data message is too short to carry a seq")
    return struct.unpack_from("<I", payload, 1)[0]


def data_trace(payload: bytes, spec: TableSpec) -> Optional[tuple[int, int, int]]:
    """(origin, origin ns, hops) of a v2 DATA/BURST message, None for v1."""
    per = frame_payload_bytes(spec)
    n = len(payload)
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
    """One DATA message (v1 or v2)."""
    per = frame_payload_bytes(spec)
    if len(payload) == DATA_HDR + per:
        off = DATA_HDR
    elif len(payload) == DATA_HDR_T + per:
        off = DATA_HDR_T
    else:
        raise ValueError(
            f"DATA frame is {len(payload)} bytes, the spec wants {DATA_HDR + per} or "
            f"{DATA_HDR_T + per}: peer table layout mismatch"
        )
    return _decode_one_frame(payload, off, spec)


def decode_burst(payload: bytes, spec: TableSpec) -> list[TableFrame]:
    """One BURST message (v1 or v2)."""
    if len(payload) < BURST_HDR:
        raise ValueError(f"BURST message of {len(payload)} bytes has no header")
    k = payload[BURST_HDR - 1]
    if k == 0:
        raise ValueError("BURST with k_frames == 0")  # would ACK a message that delivered nothing
    per = frame_payload_bytes(spec)
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


def encode_sync(spec: TableSpec, wire_version: int = WIRE_VERSION_V2, flags: int = 0) -> bytes:
    """Join request. The port never sets ``SYNC_FLAG_SHM`` or
    ``SYNC_FLAG_SHARD``, so the message has no tail after the flags."""
    if flags & (SYNC_FLAG_SHM | SYNC_FLAG_SHARD):
        raise ValueError("the port does not speak the shm lane or the sharded tensor")
    return (
        bytes([SYNC])
        + struct.pack(_SYNC_FMT, spec.num_leaves, spec.total_n, spec.layout_digest())
        + bytes([wire_version & 0xFF, flags & 0xFF])
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


def encode_welcome(flags: int = 0) -> bytes:
    """WELCOME with the parent's capability flags (0 from the port)."""
    return bytes([WELCOME, flags & 0xFF])


def welcome_flags(payload: bytes) -> int:
    return payload[1] if len(payload) > 1 else 0


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
