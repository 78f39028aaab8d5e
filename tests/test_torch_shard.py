"""The port's cluster-sharded tensor (shared_tensor_tpu_torch/shard) against
the JAX package's (shared_tensor_tpu/shard).

- The cases of tests/test_shard.py, each on port nodes: the map's geometry
  and epoch merge, the slice codec's apply rule, the FWD wire, claims and
  owner-routed convergence under the memory contract, partial gathers,
  both fallback orientations, a subscriber under an owner, the
  drain-handoff, the sharded snapshot and restore, ST_SHARD=0 and the
  writer-side deposit counters.
- Bit parity with JAX on the same seeded numpy state: SliceCodec's
  measure, quantize_at, cascade_rows and apply at a range that starts and
  ends inside a leaf; ShardMap's ranges and merge_doc; the SYNC claim
  tail, WELCOME, FWD, SHARD and fwd_frames_cap over several specs.
- Mixed clusters: a JAX master with a port owner on the lane and one on
  the Python plane, a port master with JAX owners, a handoff from a port
  owner to a JAX parent; gathers of either package read the total.
- Shard-state files cross both ways and pass the coverage audit mixed.
- The successor of a handoff discards a resend of a frame the leaver
  applied (the dedup windows ride the handoff), on both planes; and its
  restart re-claims every shard its file holds.
- Zipf writes into one shard make the port root's HealthAnalyzer name it.

Tolerance: test_shard.py's (atol 2e-3 for sums of gaussian adds; 1e-3
for the mixed pair). Every wait has its own deadline. Port classic peers
run on the device tier on the CPU (``device="cpu"``).
"""

import dataclasses
import json
import threading
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu import compat as jcompat
from shared_tensor_tpu.comm import wire as JW
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import LifecycleConfig as JLifecycleConfig
from shared_tensor_tpu.config import ScalePolicy as JScalePolicy
from shared_tensor_tpu.config import ShardConfig as JShardConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu.ops.table import make_spec as jax_make_spec
from shared_tensor_tpu.shard import ShardGather as JShardGather
from shared_tensor_tpu.shard import create_or_fetch_sharded as jax_sharded
from shared_tensor_tpu.shard.map import ShardMap as JShardMap
from shared_tensor_tpu.shard.state import SliceCodec as JSliceCodec
from shared_tensor_tpu.utils import checkpoint as jckpt
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.comm.transport import TransportNode
from shared_tensor_tpu_torch.config import (
    Config,
    LifecycleConfig,
    ObsConfig,
    ScalePolicy,
    ShardConfig,
    TransportConfig,
)
from shared_tensor_tpu_torch.ops.codec_np import flatten_np, unflatten_np
from shared_tensor_tpu_torch.ops.table import make_spec
from shared_tensor_tpu_torch.shard import ShardGather, ShardMap, create_or_fetch_sharded
from shared_tensor_tpu_torch.shard.map import OwnerEntry
from shared_tensor_tpu_torch.shard.state import SliceCodec
from shared_tensor_tpu_torch.utils import checkpoint as ckpt
from tests._ports import free_port

TMPL = {"w": np.zeros(4096, np.float32), "b": np.zeros(512, np.float32)}
SPEC = make_spec(TMPL)
JSPEC = jax_make_spec(TMPL)
TOTAL = SPEC.total  # padded element count
WORDS = TOTAL // 32
POLICIES = [(ScalePolicy.POW2_RMS, JScalePolicy.POW2_RMS), (ScalePolicy.RMS, JScalePolicy.RMS),
            (ScalePolicy.ABS_MEAN, JScalePolicy.ABS_MEAN)]


def _cfg(idx: int, n: int = 3, name: str = "", restore: str = "", engine: bool = True, **obs) -> Config:
    return Config(
        shard=ShardConfig(n_shards=n, shard_index=idx, restore_dir=restore, engine_lane=engine),
        lifecycle=LifecycleConfig(node_name=name),
        transport=TransportConfig(peer_timeout_sec=20.0),
        obs=ObsConfig(**obs),
    )


def _jcfg(idx: int, n: int = 3, name: str = "", engine: bool = True) -> JConfig:
    return JConfig(
        shard=JShardConfig(n_shards=n, shard_index=idx, engine_lane=engine),
        lifecycle=JLifecycleConfig(node_name=name),
        transport=JTransportConfig(peer_timeout_sec=20.0),
    )


def _zeros() -> dict:
    return {"w": np.zeros(4096, np.float32), "b": np.zeros(512, np.float32)}


def _flat_ref(tree: dict) -> np.ndarray:
    return np.asarray(flatten_np(tree, SPEC), np.float32)


def _add_rounds(handles, rng, ref, rounds=3):
    for _ in range(rounds):
        for h in handles:
            d = {"w": rng.standard_normal(4096).astype(np.float32), "b": rng.standard_normal(512).astype(np.float32)}
            ref["w"] += d["w"]
            ref["b"] += d["b"]
            h.add(d)


def _drain_all(handles, timeout=60.0):
    for h in handles:
        assert h.drain(timeout=timeout), "drain timed out"


def _gather_matches(source, ref, atol=2e-3, gather=ShardGather):
    with gather(source, TMPL) as g:
        tree = g.read_tree(max_staleness=60.0)
    np.testing.assert_allclose(tree["w"], ref["w"], atol=atol)
    np.testing.assert_allclose(tree["b"], ref["b"], atol=atol)


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _close_all(handles):
    for h in reversed(handles):
        if h is not None:
            try:
                h.close()
            except Exception:
                pass


# ---- the cases of test_shard.py, on the port ----------------------------------


def test_shard_map_geometry_and_epoch_merge():
    m = ShardMap(WORDS, 3)
    assert m.validate() == []
    lo = 0
    for k, (wlo, wcnt) in enumerate(m.ranges):
        assert wlo == lo
        assert m.shard_of_word(wlo) == k
        assert m.shard_of_word(wlo + wcnt - 1) == k
        lo = wlo + wcnt
    assert lo == WORDS
    assert m.merge_entry(1, OwnerEntry(2, 7, "h", 1))
    assert not m.merge_entry(1, OwnerEntry(2, 9, "x", 2))
    assert not m.merge_entry(1, OwnerEntry(1, 9, "x", 2))
    assert m.owners[1].owner == 7
    m2 = ShardMap.from_doc(m.as_doc())
    assert m2.owners[1].epoch == 2
    with pytest.raises(ValueError, match="geometry"):
        m2.merge_doc(ShardMap(WORDS, 4).as_doc())


def test_slice_codec_quantize_apply_bit_compat():
    """One quantize step's frame applies back exactly like the main codec
    rule, and error feedback makes the ladder lossless."""
    rng = np.random.default_rng(7)
    c = SliceCodec(SPEC, WORDS // 3, WORDS // 3)
    resid = (rng.standard_normal(c.n_el) * c.live).astype(np.float32)
    want = resid.copy()
    target = np.zeros(c.n_el, np.float32)
    for _ in range(6000):
        scales, words, resid = c.quantize(resid, ScalePolicy.POW2_RMS)
        if not scales.any():
            break
        bits = np.unpackbits(words.view(np.uint8), bitorder="little").astype(np.float32)
        manual = target + scales[c.leaf_of] * c.live * (1.0 - 2.0 * bits)
        c.apply(target, scales, words)
        np.testing.assert_array_equal(target, manual.astype(np.float32))
    assert float(np.max(np.abs(resid))) < 2.0**-126 * np.sqrt(c.n_el)
    np.testing.assert_allclose(target, want, atol=5e-5)


def test_fwd_wire_roundtrip_restamp_and_caps():
    rng = np.random.default_rng(3)
    wcnt = WORDS // 3
    n_leaves = SPEC.num_leaves
    frames = [(rng.standard_normal(n_leaves).astype(np.float32) ** 2, rng.integers(0, 2**32, wcnt, dtype=np.uint32))
              for _ in range(5)]
    payload = wire.encode_fwd(frames, 4, seq=9, origin=42, fwd_seq=1234)
    assert payload[0] == wire.FWD
    got, word_lo, seq, origin, fwd_seq = wire.decode_fwd(payload, SPEC)
    assert (word_lo, seq, origin, fwd_seq) == (4, 9, 42, 1234)
    assert len(got) == 5
    for (s0, w0), (s1, w1) in zip(frames, got):
        np.testing.assert_array_equal(s0, s1)
        np.testing.assert_array_equal(w0, w1)
    buf = bytearray(payload)
    wire.fwd_restamp(buf, 77)
    got2, _wlo, seq2, origin2, fwd2 = wire.decode_fwd(bytes(buf), SPEC)
    assert (seq2, origin2, fwd2) == (77, 42, 1234)
    np.testing.assert_array_equal(got2[0][0], got[0][0])
    bad = bytearray(payload)
    bad[wire.FWD_HDR: wire.FWD_HDR + 4] = np.float32("nan").tobytes()
    gotb, *_ = wire.decode_fwd(bytes(bad), SPEC)
    assert gotb[0][0][0] == 0.0
    cap = wire.fwd_frames_cap(SPEC, wcnt)
    assert 1 <= cap <= wire.FWD_BURST_FRAMES
    assert wire.FWD_HDR + cap * (4 * n_leaves + 4 * wcnt) <= wire.frame_wire_bytes(SPEC)
    with pytest.raises(ValueError):
        wire.decode_fwd(payload[:-3], SPEC)


def test_map_negotiation_and_owner_routed_convergence():
    """3 port nodes claim 3 shards through the hello; out-of-shard writes
    ride owner-routed FWD frames (relayed, never re-quantized) and the
    cluster converges on the union while no node holds the full table."""
    port = free_port()
    handles = [create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(i)) for i in range(3)]
    try:
        assert all(h.sharded for h in handles)
        assert ShardMap.from_doc(handles[0].node.map_doc()).fully_owned()
        rng = np.random.default_rng(0)
        ref = _zeros()
        _add_rounds(handles, rng, ref, rounds=3)
        _drain_all(handles)
        for h in handles:
            assert h.node.alloc_bytes() < TOTAL * 4 // 2
            assert h.node.owned_words() < WORDS
        assert sum(h.node.owned_words() for h in handles) == WORDS
        _gather_matches(handles[0].node, ref)
        relayed = sum(int(h.node.metrics().get("st_shard_fwd_relayed_total", 0)) for h in handles)
        assert relayed > 0
    finally:
        _close_all(handles)


def test_partial_gather_reads_covering_shards_only():
    port = free_port()
    handles = [create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(i, n=2)) for i in range(2)]
    try:
        ref = _zeros()
        _add_rounds(handles, np.random.default_rng(5), ref, rounds=2)
        _drain_all(handles)
        flat_ref = _flat_ref(ref)
        lo, hi = 100, 1500  # inside shard 0 only
        with ShardGather(handles[0].node, TMPL, elements=(lo, hi)) as g:
            assert len(g.legs) == 1
            flat, worst = g.read(max_staleness=60.0)
        assert np.isfinite(worst)
        np.testing.assert_allclose(flat, flat_ref[lo:hi], atol=2e-3)
    finally:
        _close_all(handles)


def test_sharded_joiner_falls_back_under_classic_tree():
    from shared_tensor_tpu_torch.comm.peer import create_or_fetch

    port = free_port()
    classic = create_or_fetch("127.0.0.1", port, TMPL, Config(), device="cpu")
    try:
        h = create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1), device="cpu")
        try:
            assert not h.sharded
            d = np.ones(4096, np.float32)
            h.add({"w": d, "b": np.zeros(512, np.float32)})
            _wait(lambda: np.allclose(np.asarray(classic.read()["w"]), d, atol=1e-3), 30.0, "the classic master")
            np.testing.assert_allclose(np.asarray(classic.read()["w"]), d, atol=1e-3)
        finally:
            h.close()
    finally:
        classic.close()


def test_classic_writer_rejected_by_sharded_tree_loudly():
    from shared_tensor_tpu_torch.comm.peer import SpecMismatch, create_or_fetch

    port = free_port()
    h0 = create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(0, n=2))
    try:
        assert h0.sharded
        with pytest.raises(ConnectionError, match="sharded") as ei:
            p = create_or_fetch("127.0.0.1", port, TMPL, Config(), timeout=15, device="cpu")
            p.close()
        assert isinstance(ei.value, SpecMismatch)
    finally:
        h0.close()


def test_read_only_subscriber_interops_with_sharded_owner():
    from shared_tensor_tpu_torch.serve.subscriber import Subscriber

    port = free_port()
    handles = [create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(i, n=2)) for i in range(2)]
    try:
        ref = _zeros()
        _add_rounds(handles, np.random.default_rng(11), ref, rounds=2)
        _drain_all(handles)
        s_lo, s_hi = handles[0].node.map.element_range(0)
        lo, hi = s_lo + 32, min(s_hi, s_lo + 1056)
        cfg = Config()
        cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, range=(lo, hi)))
        flat_ref = _flat_ref(ref)
        with Subscriber("127.0.0.1", port, TMPL, cfg) as sub:
            sub.wait_ready(30.0)
            got = None
            deadline = time.time() + 30
            while time.time() < deadline:
                flat, _st, _ver = sub.read_flat(60.0)
                p_lo, _p_hi = sub.range_elements
                got = flat[lo - p_lo: hi - p_lo]
                if np.allclose(got, flat_ref[lo:hi], atol=2e-3):
                    break
                time.sleep(0.05)
            np.testing.assert_allclose(got, flat_ref[lo:hi], atol=2e-3)
    finally:
        _close_all(handles)


def test_owner_drain_handoff_preserves_mass_and_routes():
    """A leaving owner hands its slice to its parent; the successor owns it
    at a higher epoch, the full view is preserved, and later writes toward
    the moved shard land at the successor."""
    port = free_port()
    handles = [create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(i)) for i in range(3)]
    try:
        rng = np.random.default_rng(2)
        ref = _zeros()
        _add_rounds(handles, rng, ref, rounds=2)
        _drain_all(handles)
        leaver = handles[2]
        moved = leaver.node.owned_shards()
        assert moved
        epoch_before = leaver.node.map.owners[moved[0]].epoch
        assert leaver.leave(timeout=60.0)
        live = handles[:2]
        _wait(lambda: set(moved) <= {s for h in live for s in h.node.owned_shards()}, 30.0, "the successor")
        assert sorted(s for h in live for s in h.node.owned_shards()) == list(range(3))
        succ = next(h for h in live if set(moved) <= set(h.node.owned_shards()))
        assert succ.node.map.owners[moved[0]].epoch > epoch_before
        assert int(succ.node.metrics().get("st_shard_handoffs_total", 0)) > 0
        _gather_matches(succ.node, ref)
        _add_rounds(live, rng, ref, rounds=1)
        _drain_all(live)
        _gather_matches(live[0].node, ref)
    finally:
        _close_all(handles)


def test_sharded_snapshot_restore_roundtrip(tmp_path):
    """Quiesced capture, MANIFEST.json with per-shard rows, a clean coverage
    audit, a killed owner restored from disk under takeover semantics with
    its values intact, and the cluster converging again."""
    snap = str(tmp_path / "snap")
    port = free_port()
    h0 = create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(0, n=2, name="m"))
    h1 = create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1, n=2, name="n1"))
    try:
        rng = np.random.default_rng(4)
        ref = _zeros()
        _add_rounds([h0, h1], rng, ref, rounds=2)
        _drain_all([h0, h1])
        entries = [e for e in (h.node.save_shards(snap) for h in (h0, h1)) if e is not None]
        assert len(entries) == 2 and all(e["shards"] for e in entries)
        ckpt.write_manifest(snap, "shard-test", entries)
        assert ckpt.verify_shard_coverage(snap, 2) == []
        assert ckpt.verify_shard_coverage(snap, 3) != []
        before = h1.node.owned_shards()
        h1.close()  # hard kill: no handoff, no drain
        h1 = None
        h1 = create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1, n=2, name="n1", restore=snap))
        assert h1.sharded
        _wait(lambda: h1.node.owned_shards() == before, 30.0, "the restored claim")
        _gather_matches(h0.node, ref)
        _add_rounds([h0, h1], rng, ref, rounds=1)
        _drain_all([h0, h1])
        _gather_matches(h1.node, ref)
    finally:
        _close_all([h0, h1])


@pytest.mark.parametrize("successor", ["master", "joiner"])
def test_restart_after_a_handoff_reclaims_every_restored_shard(tmp_path, successor):
    """n2 hands shard 2 to its parent (the master n0, or n1 when n2 joined
    at n1's address); the successor's file then holds two shards, and its
    restart re-claims both (the master adopts them, a joiner claims each),
    so the restarted cluster owns every shard and gathers the cut's total."""
    snap = str(tmp_path / "snap")
    port = free_port()
    names = ("n0", "n1", "n2")
    hs = [create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(0, name="n0"))]
    hs.append(create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1, name="n1")))
    at = port if successor == "master" else hs[1].node.node.listen_port
    hs.append(create_or_fetch_sharded("127.0.0.1", at, TMPL, _cfg(2, name="n2")))
    succ = 0 if successor == "master" else 1
    try:
        ref = _zeros()
        _add_rounds(hs, np.random.default_rng(17), ref, rounds=1)
        _drain_all(hs)
        assert hs[2].leave(timeout=30.0)
        _wait(lambda: hs[succ].node.owned_shards() == sorted({succ, 2}), 30.0, "the successor")
        live = hs[:2]
        entries = [h.node.save_shards(snap) for h in live]
        ckpt.write_manifest(snap, "handoff-restart", entries)
        assert ckpt.verify_shard_coverage(snap, 3) == []
        _close_all(live)
        hs = []
        port = free_port()
        for i in range(2):
            hs.append(create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(i, name=names[i], restore=snap)))
        _wait(lambda: hs[succ].node.owned_shards() == sorted({succ, 2}), 30.0, "the re-claims")
        assert sorted(s for h in hs for s in h.node.owned_shards()) == [0, 1, 2]
        _gather_matches(hs[0].node, ref)
    finally:
        _close_all(hs)


def test_st_shard_0_pins_classic_protocol(monkeypatch):
    from shared_tensor_tpu_torch.comm.peer import SharedTensorPeer

    monkeypatch.setenv("ST_SHARD", "0")
    h = create_or_fetch_sharded("127.0.0.1", free_port(), TMPL, _cfg(0), device="cpu")
    try:
        assert not h.sharded
        assert isinstance(h.peer, SharedTensorPeer)
    finally:
        h.close()


def test_deposit_twins_expose_saturated_writer():
    """A lone master owning shard 0 of 2 has no owner to drain shard 1's
    outbox toward: the pre-coalesce deposit counters keep counting while
    the post-coalesce FWD count stays at 0."""
    from shared_tensor_tpu_torch.obs import schema as sch

    h = create_or_fetch_sharded("127.0.0.1", free_port(), TMPL, _cfg(0, n=2))
    try:
        node = h.node
        elo, ehi = node.map.element_range(1)
        d = _zeros()
        d["w"][-1] = 1.0  # leaves flatten b then w: w's tail is in shard 1
        for _ in range(8):
            h.add(d)
        out = node._collect()
        assert out[sch.shard_key("st_shard_heat_deposit_msgs", 1)] == 8
        assert out[sch.shard_key("st_shard_heat_deposit_bytes", 1)] == 8 * (ehi - elo) * 4
        assert out.get("st_shard_fwd_msgs_out_total", 0) == 0
        h.add({"w": np.zeros(4096, np.float32), "b": np.ones(512, np.float32)})
        out = node._collect()
        assert sch.shard_key("st_shard_heat_deposit_msgs", 0) not in out
    finally:
        h.close()


# ---- bit parity with the JAX package -------------------------------------------


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p[0].name)
def test_slice_codec_bit_equal_jax(policy):
    """measure, cascade_rows, quantize_at, quantize and apply of both
    packages agree to the bit at a range that starts and ends inside a
    leaf, through whole cascades on the same seeded state."""
    pol, jpol = policy
    tmpl = {"a": np.zeros(1000, np.float32), "b": np.zeros(3000, np.float32), "c": np.zeros(77, np.float32)}
    spec, jspec = make_spec(tmpl), jax_make_spec(tmpl)
    words = spec.total // 32
    rng = np.random.default_rng(21)
    for wlo, wcnt in ((5, 60), (20, words - 25), (0, words)):
        c, jc = SliceCodec(spec, wlo, wcnt), JSliceCodec(jspec, wlo, wcnt)
        np.testing.assert_array_equal(c.leaf_of, jc.leaf_of)
        np.testing.assert_array_equal(c.live, jc.live)
        assert c.segments == jc.segments
        r = (rng.standard_normal(c.n_el) * rng.uniform(0.5, 50)).astype(np.float32) * c.live
        jr = r.copy()
        for _ in range(5):
            s, a = c.measure(r, pol)
            js, ja = jc.measure(jr, jpol)
            np.testing.assert_array_equal(s, js)
            np.testing.assert_array_equal(a, ja)
            rows, jrows = c.cascade_rows(s, a, 16), jc.cascade_rows(js, ja, 16)
            assert len(rows) == len(jrows)
            for row, jrow in zip(rows, jrows):
                np.testing.assert_array_equal(row, jrow)
                w, r = c.quantize_at(r, row)
                jw, jr = jc.quantize_at(jr, jrow)
                np.testing.assert_array_equal(w, jw)
                np.testing.assert_array_equal(r, jr)
        s, w, r2 = c.quantize(r, pol)
        js, jw, jr2 = jc.quantize(jr, jpol)
        for x, y in ((s, js), (w, jw), (r2, jr2)):
            np.testing.assert_array_equal(x, y)
        t = rng.standard_normal(c.n_el).astype(np.float32)
        jt = t.copy()
        sc = np.abs(rng.standard_normal(spec.num_leaves)).astype(np.float32)
        ww = rng.integers(0, 2**32, wcnt, dtype=np.uint32)
        assert c.apply(t, sc, ww) == jc.apply(jt, sc, ww)
        np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("words,n", [(160, 3), (161, 4), (7, 7), (1000, 13)])
def test_shard_map_equals_jax(words, n):
    m, jm = ShardMap(words, n), JShardMap(words, n)
    assert m.ranges == jm.ranges
    for w in range(words):
        assert m.shard_of_word(w) == jm.shard_of_word(w)
    assert [m.element_range(k) for k in range(n)] == [jm.element_range(k) for k in range(n)]
    doc = {"words": words, "n": n, "owners": [[k % 3, 100 + k, "h", 2000 + k] for k in range(n)]}
    assert m.merge_doc(doc) == jm.merge_doc(doc)
    assert m.as_doc() == jm.as_doc()
    newer = {"words": words, "n": n, "owners": [[(k % 3) + (k % 2), 200 + k, "g", 3000 + k] for k in range(n)]}
    assert m.merge_doc(newer) == jm.merge_doc(newer)
    assert m.as_doc() == jm.as_doc() and m.validate() == jm.validate() == []
    assert m.owned_shards(201) == jm.owned_shards(201) and m.fully_owned() == jm.fully_owned()


@pytest.mark.parametrize("shapes", [(4096, 512), (1000, 3000, 77), (5,), (3, 1 << 16)])
def test_shard_wire_bytes_equal_jax(shapes):
    tmpl = {f"l{i}": np.zeros(n, np.float32) for i, n in enumerate(shapes)}
    spec, jspec = make_spec(tmpl), jax_make_spec(tmpl)
    words = spec.total // 32
    rng = np.random.default_rng(len(shapes))
    for flags in (wire.SYNC_FLAG_SHARD, wire.SYNC_FLAG_SHARD | wire.SYNC_FLAG_SHM):
        for claim in (-1, 0, 2):
            got = wire.encode_sync(spec, 2, flags, shm_host=b"x" * 16, shard=claim)
            assert got == JW.encode_sync(jspec, 2, flags, shm_host=b"x" * 16, shard=claim)
            assert wire.sync_shard(got) == JW.sync_shard(got) == claim
    assert wire.encode_welcome(wire.SYNC_FLAG_SHARD) == JW.encode_welcome(jcompat.SYNC_FLAG_SHARD)
    assert wire.welcome_flags(JW.encode_welcome(jcompat.SYNC_FLAG_SHARD)) & wire.SYNC_FLAG_SHARD
    for wlo, wcnt in ((0, words), (words // 3, max(1, words // 3)), (words - 1, 1)):
        assert wire.fwd_frames_cap(spec, wcnt) == JW.fwd_frames_cap(jspec, wcnt)
        k = min(3, wire.fwd_frames_cap(spec, wcnt))
        frames = [(np.abs(rng.standard_normal(spec.num_leaves)).astype(np.float32),
                   rng.integers(0, 2**32, wcnt, dtype=np.uint32)) for _ in range(k)]
        got = wire.encode_fwd(frames, wlo, 7, 0xBEEF, 99)
        assert got == JW.encode_fwd(frames, wlo, 7, 0xBEEF, 99)
        a, b = bytearray(got), bytearray(got)
        wire.fwd_restamp(a, 1234)
        JW.fwd_restamp(b, 1234)
        assert a == b
        mine, theirs = wire.decode_fwd(bytes(a), spec), JW.decode_fwd(bytes(a), jspec)
        assert mine[1:] == theirs[1:]
        for (s0, w0), (s1, w1) in zip(mine[0], theirs[0]):
            np.testing.assert_array_equal(s0, s1)
            np.testing.assert_array_equal(w0, w1)
    for doc in ({"t": "claim", "shard": 1, "owner": 5, "host": "127.0.0.1", "port": 9, "nonce": "n", "takeover": False},
                {"t": "map", "map": ShardMap(words, 1).as_doc(), "from": 3}):
        got = wire.encode_shard(doc)
        assert got == JW.encode_shard(doc) and wire.decode_shard(got) == JW.decode_shard(got) == doc
    with pytest.raises(ValueError):
        wire.encode_shard({"t": "ho_state", "data": "x" * wire.DIGEST_MAX_BYTES})


# ---- mixed clusters -------------------------------------------------------------


def _mixed_converges(handles, jax_node, port_node, rounds=2, seed=9):
    ref = _zeros()
    _add_rounds(handles, np.random.default_rng(seed), ref, rounds=rounds)
    _drain_all(handles)
    _gather_matches(port_node, ref, atol=1e-3)
    _gather_matches(jax_node, ref, atol=1e-3, gather=JShardGather)
    return ref


def test_jax_master_with_port_owners_on_both_planes():
    port = free_port()
    handles = [jax_sharded("127.0.0.1", port, TMPL, _jcfg(0), timeout=30.0)]
    try:
        handles.append(create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1, engine=True), timeout=30.0))
        handles.append(create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(2, engine=False), timeout=30.0))
        assert all(h.sharded for h in handles)
        assert handles[1].node._lane is not None and handles[2].node._lane is None
        _mixed_converges(handles, handles[0].node, handles[1].node)
        for h in handles[1:]:
            assert h.node.alloc_bytes() < TOTAL * 4 // 2
    finally:
        _close_all(handles)


def test_port_master_with_jax_owners():
    port = free_port()
    handles = [create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(0), timeout=30.0)]
    try:
        handles.append(jax_sharded("127.0.0.1", port, TMPL, _jcfg(1, engine=False), timeout=30.0))
        handles.append(jax_sharded("127.0.0.1", port, TMPL, _jcfg(2, engine=True), timeout=30.0))
        assert all(h.sharded for h in handles)
        _mixed_converges(handles, handles[1].node, handles[0].node, seed=10)
    finally:
        _close_all(handles)


@pytest.mark.parametrize("engine", [True, False], ids=["lane", "python"])
def test_handoff_from_port_owner_to_jax_parent(engine):
    port = free_port()
    handles = [jax_sharded("127.0.0.1", port, TMPL, _jcfg(0, n=2), timeout=30.0)]
    try:
        handles.append(create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1, n=2, engine=engine), timeout=30.0))
        ref = _mixed_converges(handles, handles[0].node, handles[1].node, seed=12)
        epoch = handles[0].node.map.owners[1].epoch
        assert handles[1].leave(timeout=30.0)
        jm = handles[0].node
        _wait(lambda: jm.owned_shards() == [0, 1], 30.0, "the JAX parent's adoption")
        assert jm.map.owners[1].epoch > epoch
        _gather_matches(jm, ref, atol=1e-3, gather=JShardGather)
        _add_rounds(handles[:1], np.random.default_rng(13), ref, rounds=1)
        _drain_all(handles[:1])
        _gather_matches(jm, ref, atol=1e-3, gather=JShardGather)
    finally:
        _close_all(handles)


def test_shard_state_files_cross_and_audit_mixed(tmp_path):
    """Each package's load_shard_state reads the other's file (same keys,
    same meta), and a snapshot with one node of each package passes
    verify_shard_coverage in both."""
    snap = str(tmp_path / "mixed")
    port = free_port()
    handles = [jax_sharded("127.0.0.1", port, TMPL, _jcfg(0, n=2, name="jm"), timeout=30.0)]
    try:
        handles.append(create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1, n=2, name="tn"), timeout=30.0))
        _mixed_converges(handles, handles[0].node, handles[1].node, rounds=1, seed=14)
        entries = [h.node.save_shards(snap) for h in handles]
        jckpt.write_manifest(snap, "mixed", entries)
        assert ckpt.verify_shard_coverage(snap, 2) == jckpt.verify_shard_coverage(snap, 2) == []
        for name in ("jm", "tn"):
            path = f"{snap}/{ckpt.shard_filename(name)}"
            mine, theirs = ckpt.load_shard_state(path), jckpt.load_shard_state(path)
            assert mine["layout"] == theirs["layout"] == SPEC.layout_digest()
            assert mine["dedup"] == theirs["dedup"] and mine["fwd_seq"] == theirs["fwd_seq"]
            assert mine["owned"].keys() == theirs["owned"].keys() and mine["owned"]
            for k in mine["owned"]:
                assert mine["owned"][k][:2] == theirs["owned"][k][:2]
                np.testing.assert_array_equal(mine["owned"][k][2], theirs["owned"][k][2])
        # a file the port writes from a JAX node's state loads in JAX, and back
        st = jckpt.load_shard_state(f"{snap}/{ckpt.shard_filename('jm')}")
        ckpt.save_shard_state(str(tmp_path / "re"), "x", st["layout"], st["owned"], st["outboxes"], st["dedup"],
                              st["fwd_seq"])
        back = jckpt.load_shard_state(str(tmp_path / "re" / ckpt.shard_filename("x")))
        assert back["dedup"] == st["dedup"] and back["owned"].keys() == st["owned"].keys()
    finally:
        _close_all(handles)


# ---- the dedup windows ride the handoff ------------------------------------------


def _join_member(port: int) -> TransportNode:
    """A bare member link under the rendezvous's master, through the real
    hello (SYNC with the shard flag and no claim, DONE, WELCOME)."""
    node = TransportNode("127.0.0.1", port, TransportConfig(peer_timeout_sec=20.0),
                         frame_bytes=wire.frame_wire_bytes(SPEC))
    node.send(node.uplink, wire.encode_sync(SPEC, 2, wire.SYNC_FLAG_SHARD, shard=-1), timeout=1.0)
    node.send(node.uplink, bytes([wire.DONE]), timeout=1.0)
    deadline = time.time() + 10.0
    while time.time() < deadline:
        payload = node.recv(node.uplink, timeout=0.2)
        if payload and payload[0] == wire.WELCOME:
            assert wire.welcome_flags(payload) & wire.SYNC_FLAG_SHARD
            return node
    node.close()
    raise AssertionError("no WELCOME")


@pytest.mark.parametrize("engine", [True, False], ids=["lane", "python"])
def test_handoff_successor_discards_a_resend_the_leaver_applied(engine):
    """A frame that n1 applied arrives again (a re-routed resend) after n1
    handed shard 1 to its parent m: m imported n1's dedup windows before
    adopting, so it discards the resend and the shard holds the frame's
    mass once."""
    port = free_port()
    m = create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(0, n=2, engine=engine))
    n1 = create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(1, n=2, engine=engine))
    member = None
    try:
        member = _join_member(port)
        up = member.uplink
        wlo, wcnt = m.node.map.word_range(1)
        sc = SliceCodec(SPEC, wlo, wcnt)
        delta = np.random.default_rng(15).standard_normal(sc.n_el).astype(np.float32) * sc.live
        scales, words, _r = sc.quantize(delta.copy())
        expected = sc.zeros()
        sc.apply(expected, scales, words)
        payload = bytearray(wire.encode_fwd([(scales, words)], wlo, 0, 0xD00D, 1))
        # m learns n1's route from its announce, then relays the frame to n1
        _wait(lambda: 1 in m.node._route, 10.0, "the route to shard 1")
        wire.fwd_restamp(payload, 1)
        member.send(up, bytes(payload), timeout=1.0)
        _wait(lambda: np.array_equal(n1.node.read_owned().get(1, (0, 0, None))[2], expected), 10.0, "n1's apply")
        assert n1.leave(timeout=30.0)
        _wait(lambda: m.node.owned_shards() == [0, 1], 10.0, "m's adoption")
        np.testing.assert_array_equal(m.node.read_owned()[1][2], expected)
        wire.fwd_restamp(payload, 2)  # the same (origin, fwd_seq) again
        member.send(up, bytes(payload), timeout=1.0)
        _wait(lambda: int(m.node.metrics().get("st_shard_fwd_dedup_total", 0)) >= 1, 10.0, "the dedup discard")
        np.testing.assert_array_equal(m.node.read_owned()[1][2], expected)
    finally:
        if member is not None:
            member.close()
        _close_all([m, n1])


# ---- heat --------------------------------------------------------------------------


def test_zipf_writes_name_the_hot_shard(tmp_path):
    """Zipf writes into a 4-shard port cluster (Python plane: exact
    per-shard apply counts), most of them into shard 2, make the port
    root's HealthAnalyzer name shard 2 from the nodes' st_shard_heat_*
    rows."""
    health = str(tmp_path / "health.json")
    port = free_port()
    hot = 2
    obs = {"digest_interval_sec": 0.2}
    handles = [create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(0, n=4, engine=False, health_json_path=health,
                                                                      **obs))]
    stop = threading.Event()
    try:
        for i in (1, 2, 3, -1):
            handles.append(create_or_fetch_sharded("127.0.0.1", port, TMPL, _cfg(i, n=4, engine=False, **obs)))
        mp = handles[0].node.map
        deltas = {}
        for k in range(4):
            d = np.zeros(TOTAL, np.float32)
            lo, hi = mp.element_range(k)
            d[lo:hi] = 0.01
            deltas[k] = unflatten_np(d, SPEC)
        order = [hot] + [k for k in range(4) if k != hot]
        weights = np.array([1.0 / (r + 1) ** 2.5 for r in range(4)])
        weights /= weights.sum()

        def writer():
            rng = np.random.default_rng(16)
            while not stop.is_set():
                handles[4].add(deltas[order[int(rng.choice(4, p=weights))]])
                stop.wait(0.03)

        t = threading.Thread(target=writer, daemon=True)
        t.start()

        def named():
            try:
                with open(health) as f:
                    return json.load(f)["heat"]["hot_shard"] == hot
            except (OSError, ValueError, KeyError):
                return False

        _wait(named, 30.0, f"the analyzer to name shard {hot}")
    finally:
        stop.set()
        _close_all(handles)
