"""The port's engine-tier shard data plane (``st_shard_*`` of its own
``libstengine`` build, bound by shared_tensor_tpu_torch/shard/engine_lane.py):
the cases of tests/test_shard_engine.py, on port nodes.

- Kernel parity: the native slice codec (st_slice_quantize,
  st_slice_apply, st_slice_cascade) is byte-equal to the port's numpy
  SliceCodec on shared random state, across the three scale policies and
  whole drain ladders, so the two planes emit byte-identical FWD frames.
- Dedup decisions: an engine-lane owner discards an end-to-end
  (origin, fwd_seq) duplicate, driven through a real member handshake
  from a bare transport node, with the cumulative ACK re-announced on a
  link-level duplicate.
- Verbatim relay: a FWD for a shard the engine-lane node does not own is
  forwarded toward the owner with only its per-link seq re-stamped.
- Mixed planes: an engine-lane owner under a Python-plane writer and the
  reverse converge.
- Admission control: ShardConfig.outbox_limit_bytes bounds resident
  outbox bytes at add(), blocking then raising ShardBackpressure, or
  raising at once.

The cases skip only where JAX's skip: without a C++ compiler to build the
engine.
"""

import shutil
import time

import numpy as np
import pytest

from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.comm.transport import TransportNode
from shared_tensor_tpu_torch.compat import SYNC_FLAG_SHARD, wire_protocol_version
from shared_tensor_tpu_torch.config import (
    Config,
    ScalePolicy,
    ShardConfig,
    TransportConfig,
)
from shared_tensor_tpu_torch.ops.codec_np import _layout
from shared_tensor_tpu_torch.ops.table import make_spec
from shared_tensor_tpu_torch.shard import (
    ShardBackpressure,
    ShardGather,
    create_or_fetch_sharded,
)
from shared_tensor_tpu_torch.shard.engine_lane import (
    load_shard_lib,
    shard_engine_eligible,
)
from shared_tensor_tpu_torch.shard.state import SliceCodec
from tests._ports import free_port

TMPL = {
    "w": np.zeros(4096, np.float32),
    "b": np.zeros(512, np.float32),
}
SPEC = make_spec(TMPL)
WORDS = SPEC.total // 32

_POLICIES = [
    (ScalePolicy.POW2_RMS, 0),
    (ScalePolicy.RMS, 1),
    (ScalePolicy.ABS_MEAN, 2),
]


def _lib():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler to build the native engine")
    return load_shard_lib()


def _cfg(idx: int, n: int = 2, engine: bool = True, **shard_kw) -> Config:
    return Config(
        shard=ShardConfig(
            n_shards=n, shard_index=idx, engine_lane=engine, **shard_kw
        ),
        transport=TransportConfig(
            peer_timeout_sec=20.0, ack_timeout_sec=0.4
        ),
    )


# ---- kernel parity ---------------------------------------------------------


def test_slice_kernels_byte_equal_numpy():
    """st_slice_quantize / st_slice_apply == SliceCodec, bit for bit,
    through whole drain ladders on shared random state."""
    lib = _lib()
    offs, ns, padded = _layout(SPEC)
    for seed in range(3):
        rng = np.random.default_rng(seed)
        wlo = int(rng.integers(0, WORDS - 2))
        wcnt = int(rng.integers(1, WORDS - wlo))
        sc = SliceCodec(SPEC, wlo, wcnt)
        r0 = (
            rng.standard_normal(sc.n_el) * rng.uniform(0.1, 10)
        ).astype(np.float32) * sc.live
        for pol, code in _POLICIES:
            rp, rc = r0.copy(), r0.copy()
            for _ in range(80):
                s_py, w_py, rp = sc.quantize(rp, pol)
                s_c = np.zeros(SPEC.num_leaves, np.float32)
                w_c = np.zeros(wcnt, np.uint32)
                nz = lib.st_slice_quantize(
                    offs, ns, padded, SPEC.num_leaves, wlo, wcnt, code,
                    rc, s_c, w_c,
                )
                assert np.array_equal(s_py, s_c)
                assert nz == int(bool(s_py.any()))
                if not s_py.any():
                    break
                assert np.array_equal(w_py, w_c)
                assert np.array_equal(rp, rc)
            t_py = rng.standard_normal(sc.n_el).astype(np.float32)
            t_c = t_py.copy()
            s1 = np.abs(rng.standard_normal(SPEC.num_leaves)).astype(
                np.float32
            )
            w1 = rng.integers(0, 2**32, wcnt, dtype=np.uint32)
            sc.apply(t_py, s1, w1)
            lib.st_slice_apply(
                offs, ns, padded, SPEC.num_leaves, wlo, wcnt, t_c,
                np.ascontiguousarray(s1), np.ascontiguousarray(w1),
            )
            assert np.array_equal(t_py, t_c)


def test_cascade_message_byte_equal_numpy():
    """st_slice_cascade (the pump's whole message build: measure ->
    amax-anchored halving schedule -> fused quantize) emits frames
    byte-equal to state.py's measure + cascade_rows + quantize_at —
    the engine and python FWD planes put identical bytes on the wire."""
    lib = _lib()
    offs, ns, padded = _layout(SPEC)
    L = SPEC.num_leaves
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        wlo = int(rng.integers(0, WORDS - 4))
        wcnt = int(rng.integers(2, WORDS - wlo))
        sc = SliceCodec(SPEC, wlo, wcnt)
        per = L * 4 + wcnt * 4
        k = 16
        for pol, code in _POLICIES:
            rp = (
                rng.standard_normal(sc.n_el) * rng.uniform(0.5, 5)
            ).astype(np.float32) * sc.live
            rc = rp.copy()
            for _msg in range(6):  # several messages: the ladder re-anchors
                scales, amaxes = sc.measure(rp, pol)
                rows = sc.cascade_rows(scales, amaxes, k)
                py_frames = []
                for row in rows:
                    w_py, rp = sc.quantize_at(rp, row)
                    py_frames.append((row, w_py))
                buf = np.zeros(k * per, np.uint8)
                nf = lib.st_slice_cascade(
                    offs, ns, padded, L, wlo, wcnt, code, k, rc, buf
                )
                assert nf == len(py_frames)
                assert np.array_equal(rp, rc)  # residual after EF
                for f, (row, w_py) in enumerate(py_frames):
                    fs = buf[f * per:f * per + L * 4].view(np.float32)
                    fw = buf[f * per + L * 4:(f + 1) * per].view(np.uint32)
                    assert np.array_equal(row, fs)
                    assert np.array_equal(w_py, fw)
                if nf == 0:
                    break


# ---- dedup decisions + verbatim relay (crafted member) ---------------------


def _fake_member_join(node: TransportNode, cfg: Config, shard_claim=-1):
    """Run the real member handshake from a bare transport node: SYNC
    (shard flag + claim tail) + DONE, then drain until WELCOME."""
    node.send(
        node.uplink,
        wire.encode_sync(
            SPEC, wire_protocol_version(cfg), SYNC_FLAG_SHARD,
            shard=shard_claim,
        ),
        timeout=1.0,
    )
    node.send(node.uplink, bytes([wire.DONE]), timeout=1.0)
    deadline = time.time() + 10.0
    while time.time() < deadline:
        payload = node.recv(node.uplink, timeout=0.2)
        if payload and payload[0] == wire.WELCOME:
            assert wire.welcome_flags(payload) & SYNC_FLAG_SHARD
            return
    raise AssertionError("no WELCOME from the engine-lane owner")


def _drain_acks(node: TransportNode, link: int, budget=5.0):
    acks = []
    deadline = time.time() + budget
    while time.time() < deadline and len(acks) < 16:
        payload = node.recv(link, timeout=0.1)
        if payload and payload[0] == wire.ACK:
            acks.append(wire.decode_ack(payload))
        elif payload is None and acks:
            break
    return acks


def test_engine_owner_dedup_and_ack_reannounce():
    """An engine-lane owner applies a FWD once, discards the re-routed
    duplicate via the (origin, fwd_seq) window — counting it — and keeps
    the cumulative ACK advancing (re-announced on the link-level dup)."""
    _lib()
    assert shard_engine_eligible(_cfg(0))
    port = free_port()
    h0 = create_or_fetch_sharded(
        "127.0.0.1", port, TMPL, _cfg(0), timeout=30.0
    )
    member = None
    try:
        assert h0.node._lane is not None
        cfg = _cfg(1)
        member = TransportNode(
            "127.0.0.1", port, cfg.transport,
            frame_bytes=wire.frame_wire_bytes(SPEC),
        )
        _fake_member_join(member, cfg)
        up = member.uplink
        # shard 0 is the master's; quantize one frame of a known delta
        m = h0.node.map
        wlo, wcnt = m.word_range(0)
        sc = SliceCodec(SPEC, wlo, wcnt)
        rng = np.random.default_rng(7)
        delta = rng.standard_normal(sc.n_el).astype(np.float32) * sc.live
        scales, words, _r = sc.quantize(delta.copy())
        expected = sc.zeros()
        sc.apply(expected, scales, words)
        origin = 0xBEEF
        payload = wire.encode_fwd([(scales, words)], wlo, 0, origin, 1)
        # link seq 1: applied
        buf = bytearray(payload)
        wire.fwd_restamp(buf, 1)
        member.send(up, bytes(buf), timeout=1.0)
        # link seq 2, SAME (origin, fwd_seq): the re-route duplicate —
        # accepted at the link layer, discarded by the e2e window
        buf = bytearray(payload)
        wire.fwd_restamp(buf, 2)
        member.send(up, bytes(buf), timeout=1.0)
        # link seq 2 again: a LINK-level duplicate (our ACK was lost in
        # this story) — discarded unapplied, ACK re-announced
        member.send(up, bytes(buf), timeout=1.0)
        deadline = time.time() + 10.0
        while time.time() < deadline:
            c = h0.node._lane.counters()
            if int(c[3]) >= 1 and int(c[1]) >= 1:
                break
            time.sleep(0.05)
        c = h0.node._lane.counters()
        assert int(c[1]) == 1, "exactly one FWD applied"
        assert int(c[3]) == 1, "exactly one e2e dedup discard"
        acks = _drain_acks(member, up)
        assert acks and max(acks) == 2, acks
        got = h0.node.read_owned()[0][2]
        assert np.array_equal(got, expected)
    finally:
        if member is not None:
            member.close()
        h0.close()


def test_engine_relay_forwards_verbatim_toward_owner():
    """A FWD landing on an engine-lane node that does NOT own its shard
    relays toward the owner (per-link seq re-stamped, identity intact —
    the owner applies it) and counts st_shard_fwd_relayed_total."""
    port = free_port()
    h0 = create_or_fetch_sharded(  # master, owns shard 0
        "127.0.0.1", port, TMPL, _cfg(0), timeout=30.0
    )
    h1 = create_or_fetch_sharded(  # owns shard 1
        "127.0.0.1", port, TMPL, _cfg(1), timeout=30.0
    )
    member = None
    try:
        assert h1.node._lane is not None
        # join as a member UNDER h1 is not steerable on one rendezvous —
        # instead send the relay case through h1's own uplink position:
        # craft a member under the MASTER and address shard 1 (owned by
        # h1): the master does not own it and must relay down the route
        # its announce learned. h1 returns once granted, with its announce
        # still in flight, and the master's loop may admit the member
        # before it reads that announce: a FWD that lands first parks and
        # goes out later as an unpark, not a relay on arrival. So wait
        # until the master knows the route; the same loop thread sets the
        # plane's route before it handles the member's handshake
        deadline = time.time() + 10.0
        while time.time() < deadline and h0.node._route.get(1) is None:
            time.sleep(0.01)
        assert h0.node._route.get(1) is not None, "the master never learned h1's route"
        cfg = _cfg(1)
        member = TransportNode(
            "127.0.0.1", port, cfg.transport,
            frame_bytes=wire.frame_wire_bytes(SPEC),
        )
        _fake_member_join(member, cfg)
        up = member.uplink
        m = h0.node.map
        wlo, wcnt = m.word_range(1)
        sc = SliceCodec(SPEC, wlo, wcnt)
        rng = np.random.default_rng(11)
        delta = rng.standard_normal(sc.n_el).astype(np.float32) * sc.live
        scales, words, _r = sc.quantize(delta.copy())
        expected = h1.node.read_owned()[1][2].copy()
        sc.apply(expected, scales, words)
        payload = wire.encode_fwd([(scales, words)], wlo, 0, 0xCAFE, 1)
        buf = bytearray(payload)
        wire.fwd_restamp(buf, 1)
        member.send(up, bytes(buf), timeout=1.0)
        deadline = time.time() + 10.0
        relayer = h0.node._lane
        while time.time() < deadline:
            if int(h1.node._lane.counters()[1]) >= 1:
                break
            time.sleep(0.05)
        assert int(relayer.counters()[2]) == 1, "one verbatim relay"
        got = h1.node.read_owned()[1][2]
        assert np.array_equal(got, expected)
    finally:
        if member is not None:
            member.close()
        h1.close()
        h0.close()


# ---- mixed-tree interop ----------------------------------------------------


@pytest.mark.parametrize("orient", ["engine_owner", "python_owner"])
def test_mixed_lane_pair_converges_exactly(orient):
    """Engine-lane and python-lane nodes interop in both orientations —
    the FWD wire is lane-blind (the parity tests above make it
    byte-identical), so each side cannot tell what the other runs."""
    port = free_port()
    owner_engine = orient == "engine_owner"
    h0 = create_or_fetch_sharded(
        "127.0.0.1", port, TMPL, _cfg(0, engine=owner_engine), timeout=30.0
    )
    h1 = create_or_fetch_sharded(
        "127.0.0.1", port, TMPL, _cfg(1, engine=not owner_engine),
        timeout=30.0,
    )
    try:
        assert (h0.node._lane is not None) == owner_engine
        assert (h1.node._lane is not None) == (not owner_engine)
        rng = np.random.default_rng(3)
        ref = np.zeros(SPEC.total, np.float64)
        from shared_tensor_tpu_torch.ops.codec_np import flatten_np

        for _ in range(4):
            for h in (h0, h1):
                d = {
                    "w": rng.standard_normal(4096).astype(np.float32),
                    "b": rng.standard_normal(512).astype(np.float32),
                }
                h.add(d)
                ref += flatten_np(d, SPEC)
        assert h0.node.drain(timeout=60.0)
        assert h1.node.drain(timeout=60.0)
        with ShardGather(h0.node, TMPL) as g:
            got = flatten_np(g.read_tree(max_staleness=60.0), SPEC)
        assert float(np.max(np.abs(got - ref))) < 1e-3
    finally:
        h1.close()
        h0.close()


# ---- admission control ----------------------------------------------------


@pytest.mark.parametrize("engine", [False, True])
def test_outbox_admission_bounds_writer(engine):
    """A writer outrunning a ROUTELESS target (nobody owns the shard =
    the chaotic-link limit case: zero drain) stays inside
    outbox_limit_bytes — blocking add() times out into
    ShardBackpressure, and "raise" refuses immediately. The resident
    outbox bytes never exceed the bound."""
    if engine:
        _lib()
        assert shard_engine_eligible(_cfg(0))
    port = free_port()
    wlo, wcnt = None, None
    slice_bytes = None
    h0 = None
    try:
        # 2 shards; nobody claims shard 1 -> its outbox can never drain
        h0 = create_or_fetch_sharded(
            "127.0.0.1", port, TMPL,
            _cfg(
                0, engine=engine,
                outbox_limit_bytes=1,  # below one slice: second add gated
                outbox_overflow="block",
                outbox_block_timeout_sec=0.5,
            ),
            timeout=30.0,
        )
        m = h0.node.map
        elo, ehi = m.element_range(1)
        slice_bytes = (ehi - elo) * 4
        d = np.zeros(SPEC.total, np.float32)
        d[elo:ehi] = 1.0
        # the projection counts one slice per target shard: with
        # limit=1 < slice_bytes the very first add is refused after the
        # block timeout
        t0 = time.monotonic()
        with pytest.raises(ShardBackpressure):
            h0.add({"w": d[:4096], "b": d[4096:4608]})
        assert time.monotonic() - t0 >= 0.4  # it genuinely blocked first
        outbox = (
            h0.node._lane.outbox_bytes()
            if engine
            else h0.node.state.outbox_bytes()
        )
        assert outbox <= 1  # nothing was admitted past the bound
    finally:
        if h0 is not None:
            h0.close()


def test_outbox_admission_raise_policy():
    port = free_port()
    h0 = create_or_fetch_sharded(
        "127.0.0.1", port, TMPL,
        _cfg(
            0, engine=False, outbox_limit_bytes=1, outbox_overflow="raise",
        ),
        timeout=30.0,
    )
    try:
        m = h0.node.map
        elo, ehi = m.element_range(1)
        d = np.zeros(SPEC.total, np.float32)
        d[elo:ehi] = 1.0
        with pytest.raises(ShardBackpressure):
            h0.add({"w": d[:4096], "b": d[4096:4608]})
    finally:
        h0.close()
