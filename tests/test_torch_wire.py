"""The port's peer-tier messages (shared_tensor_tpu_torch.comm.wire) against
shared_tensor_tpu.comm.wire on the same inputs.

Tolerance: none. Every message the port emits is byte-identical to the JAX
package's for the same frames, spec and seq; each decodes the other's
bytes to the same arrays; the receive bounds are equal."""

import numpy as np
import pytest

import chip_smoke
from shared_tensor_tpu.comm import wire as JW
from shared_tensor_tpu.ops import table as JT
from shared_tensor_tpu_torch.comm import wire as TW
from shared_tensor_tpu_torch.ops import table as TT


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(16, 8)).astype(np.float32),
        "b": rng.normal(size=(8,)).astype(np.float32),
        "deep": [rng.normal(size=(3, 5, 7)).astype(np.float32)],
    }


def _frames(spec, k, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        scales = (2.0 ** rng.integers(-8, 4, spec.num_leaves)).astype(np.float32)
        scales[rng.random(spec.num_leaves) < 0.3] = 0.0
        words = rng.integers(0, 2**32, spec.total // 32, dtype=np.uint64).astype(np.uint32)
        out.append((scales, words))
    return out


def _specs(tree):
    return JT.make_spec(tree), TT.make_spec(tree)


TRACE = (0x12345, 2**40 + 7, 3)


@pytest.mark.parametrize("trace", [None, TRACE], ids=["v1", "v2"])
@pytest.mark.parametrize("seq", [1, 2**32 + 5])
def test_data_bytes_identical(trace, seq):
    js, ts = _specs(_tree())
    (s, w), = _frames(ts, 1)
    want = JW.encode_frame(JT.TableFrame(s, w), seq, trace=trace)
    got = TW.encode_frame(TT.TableFrame(s, w), seq, trace=trace)
    assert got == want
    buf = memoryview(bytearray(TW.DATA_HDR_T + TW.frame_payload_bytes(ts)))
    n = TW.encode_frame_into(TT.TableFrame(s, w), seq, buf, trace=trace)
    assert bytes(buf[:n]) == want
    # each decodes the other's bytes
    f = TW.decode_frame(want, ts)
    np.testing.assert_array_equal(f.scales, s)
    np.testing.assert_array_equal(f.words, w)
    assert f.scales.dtype == np.float32 and f.words.dtype == np.uint32
    g = JW.decode_frame(got, js)
    np.testing.assert_array_equal(g.words, w)
    assert TW.data_seq(want) == JW.data_seq(want, js) == seq & 0xFFFFFFFF
    assert TW.data_trace(want, ts) == JW.data_trace(want, js)


@pytest.mark.parametrize("k", [1, 3, "cap"])
@pytest.mark.parametrize("trace", [None, TRACE], ids=["v1", "v2"])
def test_burst_bytes_identical(k, trace):
    js, ts = _specs(_tree())
    k = TW.burst_frames_cap(ts) if k == "cap" else k
    raw = _frames(ts, k, seed=k)
    want = JW.encode_burst([JT.TableFrame(s, w) for s, w in raw], js, 9, trace=trace)
    frames = [TT.TableFrame(s, w) for s, w in raw]
    assert TW.encode_burst(frames, ts, 9, trace=trace) == want
    buf = memoryview(bytearray(TW.BURST_HDR_T + k * TW.frame_payload_bytes(ts)))
    n = TW.encode_burst_into(frames, ts, 9, buf, trace=trace)
    assert bytes(buf[:n]) == want
    back = TW.decode_burst(want, ts)
    assert len(back) == k
    for f, (s, w) in zip(back, raw):
        np.testing.assert_array_equal(f.scales, s)
        np.testing.assert_array_equal(f.words, w)
    assert TW.data_trace(want, ts) == JW.data_trace(want, js)


def test_burst_bounds_are_enforced():
    _, ts = _specs(_tree())
    cap = TW.burst_frames_cap(ts)
    frames = [TT.TableFrame(s, w) for s, w in _frames(ts, cap + 1)]
    with pytest.raises(ValueError):
        TW.encode_burst(frames, ts, 1)
    with pytest.raises(ValueError):
        TW.encode_burst([], ts, 1)
    bad = bytearray(TW.encode_burst(frames[:2], ts, 1))
    bad[TW.BURST_HDR - 1] = 0
    with pytest.raises(ValueError):
        TW.decode_burst(bytes(bad), ts)
    with pytest.raises(ValueError):
        TW.decode_frame(TW.encode_frame(frames[0], 1)[:-4], ts)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("flags", [0, TW.SYNC_FLAG_READ_ONLY, TW.SYNC_FLAG_SIGN2])
def test_sync_bytes_identical_and_carry_the_layout_digest(version, flags):
    js, ts = _specs(_tree())
    want = JW.encode_sync(js, version, flags=flags)
    got = TW.encode_sync(ts, version, flags=flags)
    assert got == want
    n, total, digest = TW.decode_sync(want)
    assert (n, total, digest) == JW.decode_sync(got) == (ts.num_leaves, ts.total_n, js.layout_digest())
    assert TW.sync_wire_version(want) == version and TW.sync_flags(want) == flags
    # the shared-memory lane's host id rides the tail, and the sharded
    # claim's u16 after it (0xFFFF: a member that owns no shard)
    host = bytes(range(16))
    shm = TW.encode_sync(ts, version, flags=flags | TW.SYNC_FLAG_SHM, shm_host=host)
    assert shm == JW.encode_sync(js, version, flags=flags | TW.SYNC_FLAG_SHM, shm_host=host)
    assert TW.sync_shm_host(shm) == JW.sync_shm_host(shm) == host and TW.sync_shm_host(want) is None
    assert TW.sync_shard(want) is None and TW.sync_shard(shm) is None
    for extra in (0, TW.SYNC_FLAG_SHM):
        for claim in (0, 3, -1):
            f = flags | extra | TW.SYNC_FLAG_SHARD
            got = TW.encode_sync(ts, version, flags=f, shm_host=host, shard=claim)
            assert got == JW.encode_sync(js, version, flags=f, shm_host=host, shard=claim)
            assert got[-2:] == (claim & 0xFFFF).to_bytes(2, "little")
            assert TW.sync_shard(got) == JW.sync_shard(got) == claim
            assert TW.sync_shard(got[:-1]) is None


@pytest.mark.parametrize("extra", [0, TW.SYNC_FLAG_SHM, TW.SYNC_FLAG_SHM | TW.SYNC_FLAG_SHARD])
def test_prev_link_handshake_round_trip(extra):
    """The port's own capability: a bit no JAX flag uses; its SYNC tail
    (two link tokens) and WELCOME tail (the applied count) come last, so
    JAX's decoders read the tails they know exactly as without it."""
    from shared_tensor_tpu import compat

    jax_bits = [getattr(compat, n) for n in dir(compat) if n.startswith("SYNC_FLAG_")]
    assert jax_bits and all(TW.SYNC_FLAG_PREV_LINK & b == 0 for b in jax_bits)
    js, ts = _specs(_tree())
    host, tokens = bytes(range(16)), (0x1234_5678_9ABC_DEF1, 2**64 - 1)
    plain = TW.encode_sync(ts, 2, flags=extra, shm_host=host, shard=3)
    sync = TW.encode_sync(ts, 2, flags=extra | TW.SYNC_FLAG_PREV_LINK, shm_host=host, shard=3, prev_link=tokens)
    head = bytearray(plain)
    head[30] |= TW.SYNC_FLAG_PREV_LINK  # [kind][u32][u64][16-byte digest][version][flags]
    assert sync == bytes(head) + tokens[0].to_bytes(8, "little") + tokens[1].to_bytes(8, "little")
    assert TW.sync_prev_link(sync) == tokens and TW.sync_prev_link(plain) is None
    assert TW.sync_prev_link(sync[:31]) is None  # the flag, and no room for the tail
    assert JW.decode_sync(sync) == JW.decode_sync(plain)
    assert JW.sync_shm_host(sync) == JW.sync_shm_host(plain)
    assert JW.sync_shard(sync) == JW.sync_shard(plain)
    offer = (host, 99, "/st-test") if extra & TW.SYNC_FLAG_SHM else None
    for applied in (0, 7, 2**40):
        welcome = TW.encode_welcome(extra | TW.SYNC_FLAG_PREV_LINK, offer, applied)
        assert TW.welcome_applied(welcome) == applied
        assert welcome[:-8] == TW.encode_welcome(extra | TW.SYNC_FLAG_PREV_LINK, offer)[:-8]
        assert JW.welcome_shm(welcome) == JW.welcome_shm(JW.encode_welcome(extra, offer))
    # without the bit: JAX's bytes, and no count
    assert TW.encode_welcome(extra, offer) == JW.encode_welcome(extra, offer)
    assert TW.welcome_applied(JW.encode_welcome(extra, offer)) is None


def test_capability_flags_equal_the_jax_package():
    from shared_tensor_tpu import compat

    for name in ("SYNC_FLAG_READ_ONLY", "SYNC_FLAG_RANGE", "SYNC_FLAG_SIGN2", "SYNC_FLAG_SHM",
                 "SYNC_FLAG_SHARD", "WIRE_VERSION_V1", "WIRE_VERSION_V2"):
        assert getattr(TW, name) == getattr(compat, name), name
    for name in ("DATA", "SYNC", "CHUNK", "DONE", "WELCOME", "REJECT", "ACK", "BURST", "DIGEST", "RANGE",
                 "FRESH", "RDATA", "SNAP", "SNAP_ACK", "RESUME", "CTL", "SHARD", "FWD", "CLOCK"):
        assert getattr(TW, name) == getattr(JW, name), name


def test_control_messages_identical():
    assert TW.encode_welcome(0) == JW.encode_welcome(0)
    assert TW.welcome_flags(JW.encode_welcome(TW.SYNC_FLAG_SIGN2)) == TW.SYNC_FLAG_SIGN2
    assert TW.welcome_flags(bytes([TW.WELCOME])) == 0  # a bare WELCOME
    for count in (0, 1, 2**40):
        assert TW.encode_ack(count) == JW.encode_ack(count)
        assert TW.decode_ack(JW.encode_ack(count)) == count
    reason = "table layout mismatch: yours (1 leaves, 64 elems) — ours differs"
    assert TW.encode_reject(reason) == JW.encode_reject(reason)
    assert TW.decode_reject(JW.encode_reject(reason)) == reason


def test_snapshot_chunks_identical_and_reassemble():
    rng = np.random.default_rng(3)
    flat = rng.normal(size=(TW.CHUNK_BYTES // 4) * 2 + 333).astype(np.float32)  # three chunks
    want = list(JW.encode_snapshot_chunks(flat))
    got = list(TW.encode_snapshot_chunks(flat))
    assert got == want and len(got) == 4 and got[-1] == bytes([TW.DONE])
    buf = bytearray(flat.nbytes)
    for c in want[:-1]:
        TW.decode_chunk_into(c, buf)
    np.testing.assert_array_equal(np.frombuffer(bytes(buf), "<f4"), flat)
    with pytest.raises(ValueError):
        TW.decode_chunk_into(want[0], bytearray(8))


def test_non_finite_scales_are_zeroed():
    _, ts = _specs(_tree())
    (s, w), = _frames(ts, 1)
    s = s.copy()
    s[0], s[1] = np.nan, np.inf
    before = TW.corrupt_scales_zeroed()
    f = TW.decode_frame(JW.encode_frame(JT.TableFrame(s, w), 1), ts)
    assert f.scales[0] == 0.0 and f.scales[1] == 0.0
    np.testing.assert_array_equal(f.scales[2:], s[2:])
    bursts = TW.decode_burst(JW.encode_burst([JT.TableFrame(s, w)] * 2, JT.make_spec(_tree()), 1), ts)
    assert all(b.scales[0] == 0.0 and b.scales[1] == 0.0 for b in bursts)
    assert TW.corrupt_scales_zeroed() - before == 6


@pytest.mark.parametrize(
    "tree",
    [
        _tree(),
        {"x": np.zeros(240, np.float32)},
        {"x": np.zeros(1 << 20, np.float32)},
        {"x": np.zeros(1 << 24, np.float32), "b": np.zeros(3, np.float32)},
        chip_smoke.resnet18_template(8),
    ],
    ids=["small", "240", "1Mi", "16Mi", "resnet18-w8"],
)
def test_caps_equal_the_jax_package(tree):
    js, ts = _specs(tree)
    assert TW.frame_payload_bytes(ts) == JW.frame_payload_bytes(js)
    assert TW.burst_frames_cap(ts) == JW.burst_frames_cap(js)
    assert TW.frame_wire_bytes(ts) == JW.frame_wire_bytes(js)


def test_frame_pool_reuses_released_slots():
    pool = TW.FramePool(64, keep=1)
    a = pool.acquire()
    pool.release(a)
    assert pool.acquire() is a
    pool.release(a)
    pool.release(pool.acquire())
    b, c = pool.acquire(), pool.acquire()
    assert len(b) == len(c) == 64 and pool.alloc_events == 2
