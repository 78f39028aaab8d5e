"""Wire robustness of the port's peer: the cases of tests/test_wire_robustness.py
on port peers and the port's wire module. Garbage on a live link must not
kill or poison a node: the receive loop drops what does not decode (and
counts it), the decoder zeroes non-finite scales at the trust boundary, and
the node stays finite and keeps serving real peers.

The garbage case runs on each tier of a port master: the device tier
(device="cpu"), the Python host tier and the native engine. A last case
sends the lifecycle kinds (SNAP, SNAP_ACK, RESUME, CTL) with a body that is
not JSON to a port master and to a JAX master: both survive unchanged, and
the port's ``st_msg_errors_total`` counts what the JAX peer logs as
dropped, one per message. Every wait has its own deadline."""

import logging
import struct
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu.comm import wire as jwire
from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu.ops.table import make_spec as jax_make_spec
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.comm.peer import SEND_WINDOW
from shared_tensor_tpu_torch.comm.transport import TransportNode
from shared_tensor_tpu_torch.ops.table import TableFrame, make_spec
from tests._ports import free_port

TIERS = ("device", "host", "engine")
CFG = Config(transport=TransportConfig(peer_timeout_sec=10.0))


@pytest.fixture(scope="module", autouse=True)
def _built():
    build_native()


def _wait(cond, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _peer(port, tpl, tier, config=CFG):
    """A port peer on ``tier``: device (device="cpu"), host or engine."""
    if tier == "device":
        return create_or_fetch("127.0.0.1", port, tpl, config, device="cpu")
    cfg = Config(transport=config.transport, native_engine=tier == "engine")
    return create_or_fetch("127.0.0.1", port, tpl, cfg, host_tier=True)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("tier", TIERS)
def test_garbage_injection_survival_and_convergence(tier):
    port = free_port()
    tpl = {"w": np.ones((40, 64), np.float32), "b": np.zeros((64,), np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in tpl.items()}
    spec = make_spec(tpl)
    fb = wire.frame_wire_bytes(spec)
    with _peer(port, tpl, tier) as master:
        # a bare transport node joins the tree but speaks garbage instead of
        # the SYNC handshake
        with TransportNode("127.0.0.1", port, CFG.transport, frame_bytes=fb) as evil:
            assert _wait(lambda: len(evil.links) == 1)
            link = evil.links[0]
            k, w = spec.num_leaves, spec.total // 32
            rng = np.random.default_rng(7)
            nan_scales = struct.pack("<" + "f" * k, *([float("nan")] * k))
            noise_words = rng.integers(0, 256, 4 * w, dtype=np.uint8).tobytes()

            def seq(n):
                return struct.pack("<I", n)

            payloads = [
                b"\xff" + b"\x00" * 16,  # an unknown kind
                bytes([wire.DATA]) + b"\x01\x02\x03",  # a truncated DATA
                bytes([wire.ACK]),  # an ACK with no body
                b"\xfe" + rng.integers(0, 256, 511, dtype=np.uint8).tobytes(),
                # in order, NaN scales and random bits: decodes to a no-op
                bytes([wire.DATA]) + seq(1) + nan_scales + noise_words,
                bytes([wire.CHUNK]) + struct.pack("<Q", 1 << 60) + b"\xee",
                # a BURST whose count does not match its length (its seq is
                # not consumed: an undecodable message waits for its re-send)
                bytes([wire.BURST]) + seq(2) + b"\x09" + b"\x00" * 40,
                bytes([wire.BURST]) + seq(2) + b"\x01" + nan_scales + noise_words,
            ]
            for p in payloads:
                assert evil.send(link, p, timeout=2.0)
            time.sleep(1.0)
        got = _np(master.read())
        assert np.isfinite(got["w"]).all()
        np.testing.assert_array_equal(got["w"], np.ones((40, 64)))
        assert master.ready and master.threads_alive() and master._error is None
        # and it still serves a real joiner end to end
        with _peer(port, zeros, tier) as joiner:
            master.add({"w": np.full((40, 64), 0.5, np.float32), "b": np.zeros((64,), np.float32)})
            assert _wait(lambda: np.abs(_np(joiner.read())["w"] - 1.5).max() < 1e-5, timeout=30.0)


def test_compat_nonfinite_scale_is_keepalive():
    """The reference wire format: a frame with a non-finite scale is an idle
    keepalive, never applied."""
    spec = make_spec(np.zeros((64,), np.float32))
    for bad in (float("inf"), float("nan")):
        payload = struct.pack("<f", bad) + b"\xaa" * (wire.compat_frame_bytes(spec.total_n) - 4)
        assert wire.decode_compat_frame(payload, spec) is None


def test_native_nonfinite_scales_zeroed():
    """decode_frame zeroes exactly the non-finite scales and keeps finite
    ones (every finite f32 is a legal scale: residuals clamp at +-SAT)."""
    spec = make_spec({"a": np.zeros((8, 128), np.float32), "b": np.zeros((128,), np.float32)})
    w = spec.total // 32
    hdr = bytes([wire.DATA]) + struct.pack("<I", 1)
    frame = wire.decode_frame(hdr + struct.pack("<ff", float("nan"), 0.25) + b"\x00" * (4 * w), spec)
    np.testing.assert_array_equal(np.asarray(frame.scales), np.asarray([0.0, 0.25], np.float32))
    frame = wire.decode_frame(hdr + struct.pack("<ff", 2.0**120, 1.5) + b"\x00" * (4 * w), spec)
    np.testing.assert_array_equal(np.asarray(frame.scales), np.asarray([2.0**120, 1.5], np.float32))


def _rand_frames(spec, rng, k):
    return [
        TableFrame(
            rng.uniform(0.1, 2.0, spec.num_leaves).astype(np.float32),
            rng.integers(0, 1 << 32, spec.total // 32, dtype=np.uint64).astype(np.uint32),
        )
        for _ in range(k)
    ]


def test_encode_into_matches_bytes_encoders():
    """The pooled encoders fill the same bytes as the plain ones, and a
    decode round-trips them (the port's decoder allocates its arrays: it
    has no scratch pool to reuse); the burst cap still holds."""
    spec = make_spec({"a": np.zeros((40, 32), np.float32), "b": np.zeros((64,), np.float32)})
    rng = np.random.default_rng(3)
    pool = wire.FramePool(wire.frame_wire_bytes(spec))
    frames = _rand_frames(spec, rng, 5)
    slot = pool.acquire()
    n = wire.encode_frame_into(frames[0], 7, slot)
    assert bytes(slot[:n]) == wire.encode_frame(frames[0], 7)
    pool.release(slot)
    slot = pool.acquire()
    n = wire.encode_burst_into(frames, spec, 9, slot)
    assert bytes(slot[:n]) == wire.encode_burst(frames, spec, 9)
    for a, b in zip(wire.decode_burst(bytes(slot[:n]), spec), frames):
        np.testing.assert_array_equal(np.asarray(a.scales), b.scales)
        np.testing.assert_array_equal(np.asarray(a.words), b.words)
    with pytest.raises(ValueError, match="allows 1"):
        wire.encode_burst_into(_rand_frames(spec, rng, wire.burst_frames_cap(spec) + 1), spec, 1, pool.acquire())


def test_frame_pool_acquire_release_reuses_slots():
    """Released slots are handed out again (the port's pool counts its
    allocations, not its acquires)."""
    pool = wire.FramePool(1024, keep=2)
    a, b = pool.acquire(), pool.acquire()
    assert pool.alloc_events == 2
    pool.release(a)
    pool.release(b)
    c, d = pool.acquire(), pool.acquire()
    assert pool.alloc_events == 2  # both reused
    assert {id(c.obj), id(d.obj)} == {id(a.obj), id(b.obj)}
    assert len(c) == len(d) == 1024


def test_send_window_saturation_on_burst_path():
    """A link whose peer acknowledges nothing: the Python host tier's BURST
    path stops producing AT the send window (the ledger never exceeds
    SEND_WINDOW messages), the frame pool does not grow past the window's
    slots, and re-sends are byte-identical. The black hole is a send
    wrapper that records DATA/BURST and claims success."""
    port = free_port()
    seed = np.zeros((2048,), np.float32)
    cfg = Config(
        transport=TransportConfig(peer_timeout_sec=10.0, ack_timeout_sec=0.3, ack_retry_limit=100),
        native_engine=False,
        frame_burst=4,
    )
    m = create_or_fetch("127.0.0.1", port, seed, cfg, host_tier=True)
    j = create_or_fetch("127.0.0.1", port, seed, cfg, host_tier=True)
    real_send = j.node.send
    try:
        assert j._engine is None and j._burst > 1
        up = j._uplink
        assert up is not None
        recorded: dict[int, list[bytes]] = {}

        def blackhole(link, payload, timeout=0.1):
            b = bytes(payload)
            if link == up and b and b[0] in (wire.DATA, wire.BURST):
                recorded.setdefault(wire.data_seq(b), []).append(b)
                return True  # swallowed; ACKs and the handshake pass
            return real_send(link, payload, timeout=timeout)

        j.node.send = blackhole
        rng = np.random.default_rng(11)
        deadline = time.time() + 60.0
        peak = 0
        retx_seen = False
        while time.time() < deadline and not (peak >= SEND_WINDOW and retx_seen):
            j.add(rng.normal(size=2048).astype(np.float32))
            with j._ack_mu:
                depth = len(j._unacked.get(up, ()))
            assert depth <= SEND_WINDOW, f"ledger grew past the window: {depth}"
            peak = max(peak, depth)
            retx_seen = any(len(v) >= 2 for v in recorded.values())
            time.sleep(0.02)
        assert peak >= SEND_WINDOW, f"window never saturated (peak {peak})"
        assert retx_seen, "delivery timer never retransmitted"
        for seq, blobs in recorded.items():
            for b in blobs[1:]:
                assert b == blobs[0], f"retransmit of seq {seq} differs"
        assert any(blobs[0][0] == wire.BURST for blobs in recorded.values()), "no BURST crossed the wire"
        allocs_before = j._tx_pool.alloc_events
        assert allocs_before <= SEND_WINDOW + 2, allocs_before
        for _ in range(20):
            j.add(rng.normal(size=2048).astype(np.float32))
            time.sleep(0.01)
        assert j._tx_pool.alloc_events == allocs_before, "pool grew while the window was full"
    finally:
        j.node.send = real_send
        j.close()
        m.close()


def test_recv_bounds_cover_max_traced_burst():
    """The receive bound (frame_wire_bytes, which sizes the transport's
    buffer and the engine's) covers a max-size traced burst at every table
    size, stays inside the protocol's budget, and equals the JAX
    package's."""
    for n in (64, 2048, 1 << 17, 1 << 20, 1 << 24):
        spec = make_spec(np.zeros((n,), np.float32))
        worst = wire.BURST_HDR_T + wire.burst_frames_cap(spec) * wire.frame_payload_bytes(spec)
        assert wire.frame_wire_bytes(spec) >= worst, n
        assert wire.frame_wire_bytes(spec) >= wire.DATA_HDR_T + wire.frame_payload_bytes(spec), n
        assert worst <= wire.BURST_HDR_T + wire.BURST_MAX_BYTES, n
        assert wire.frame_wire_bytes(spec) == jwire.frame_wire_bytes(jax_make_spec(np.zeros((n,), np.float32))), n


@pytest.mark.parametrize("device", ["cpu", "host"])
def test_apply_saturates_no_absorbing_inf(device):
    """A max-scale frame applied to values at the +-SAT clamp saturates
    instead of overflowing to inf (an absorbing state: inf - inf = NaN),
    on the device tier and the host tier."""
    from shared_tensor_tpu_torch.core import SharedTensor
    from shared_tensor_tpu_torch.ops.codec import SAT

    tpl = np.full((256,), SAT, np.float32)
    st = (SharedTensor(tpl, seed_values=True, host_tier=True) if device == "host"
          else SharedTensor(tpl, seed_values=True, device="cpu"))
    w = st.spec.total // 32
    payload = bytes([wire.DATA]) + struct.pack("<I", 1) + struct.pack("<f", 2.0**127) + b"\x00" * (4 * w)
    st.receive_frame(1, wire.decode_frame(payload, st.spec))
    got = st.snapshot_flat().cpu().numpy()
    assert np.isfinite(got).all()
    assert got.max() <= SAT


def _bad_lifecycle_bodies():
    return [bytes([k]) + b"\x00not json{" for k in (wire.SNAP, wire.SNAP_ACK, wire.RESUME, wire.CTL)]


def test_non_json_lifecycle_bodies_leave_port_and_jax_masters_unchanged(caplog):
    """SNAP, SNAP_ACK, RESUME and CTL with a body that is not JSON, from a
    bare transport node, to a port master and to a JAX master: both stay
    finite, unchanged and alive, neither enters a barrier, and each counts
    every message as dropped: the port in ``st_msg_errors_total``, the JAX
    peer (which has no such counter) in its log."""
    tpl = {"w": np.ones((40, 64), np.float32), "b": np.zeros((64,), np.float32)}
    fb = wire.frame_wire_bytes(make_spec(tpl))
    counts = {}
    for impl in ("port", "jax"):
        port = free_port()
        if impl == "port":
            master = create_or_fetch("127.0.0.1", port, tpl, CFG, device="cpu")
        else:
            master = jax_create_or_fetch("127.0.0.1", port, tpl, JConfig(transport=JTransportConfig(peer_timeout_sec=10.0)))
        caplog.clear()
        try:
            with caplog.at_level(logging.WARNING), TransportNode("127.0.0.1", port, CFG.transport, frame_bytes=fb) as evil:
                assert _wait(lambda: len(evil.links) == 1)
                for p in _bad_lifecycle_bodies():
                    assert evil.send(evil.links[0], p, timeout=2.0)
                if impl == "port":
                    assert _wait(lambda: master.metrics()["st_msg_errors_total"] >= 4)
                    time.sleep(0.3)
                    counts[impl] = master.metrics()["st_msg_errors_total"]
                else:
                    def dropped():
                        return sum(1 for r in caplog.records if r.getMessage().startswith("dropping bad"))

                    assert _wait(lambda: dropped() >= 4)
                    time.sleep(0.3)
                    counts[impl] = dropped()
            got = {k: np.asarray(v) for k, v in master.read().items()}
            np.testing.assert_array_equal(got["w"], tpl["w"])
            np.testing.assert_array_equal(got["b"], tpl["b"])
            assert master._lc_op is None and not master._paused
            if impl == "port":
                assert master.threads_alive() and master._error is None
                assert master.metrics()["st_lifecycle_errors_total"] == 0
        finally:
            master.close()
    assert counts == {"port": 4, "jax": 4}, counts
