"""The serving tier in the port (shared_tensor_tpu_torch.serve and the
writer side of comm/peer.py), on the CPU: the cases of tests/test_serve.py
on port writers and port subscribers, a JAX subscriber under a port writer
and a port subscriber under a JAX writer, and the bit-level checks against
the JAX package.

Writer tiers: the device tier (device="cpu"), the Python host tier
(host_tier=True, native_engine=False) and the native engine
(host_tier=True). The join and range cases run on each; the drop-chaos case
on the tiers whose sends cross the Python boundary the fault plan sits at,
as JAX's runs on its Python tier.

Tolerances are test_serve.py's: atol 1e-4 for whole tables, 1e-3 for
ranges and under drop chaos. The wire bytes, the page apply and the
handle's tensors are held bit for bit.
"""

import struct
import threading
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest
import torch

from shared_tensor_tpu import serve as jserve
from shared_tensor_tpu.comm import wire as jwire
from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import ServeConfig as JServeConfig
from shared_tensor_tpu.ops.table import TableFrame as JTableFrame
from shared_tensor_tpu.ops.table import make_spec as jax_make_spec
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, serve
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.config import FaultConfig, ServeConfig
from shared_tensor_tpu_torch.ops.codec import SAT
from shared_tensor_tpu_torch.ops.table import TableFrame, make_spec, tree_flatten
from shared_tensor_tpu_torch.serve.subscriber import _Pages
from tests._ports import free_port

TIERS = ("device", "host", "engine")
PY_TIERS = ("device", "host")
CFG = TransportConfig(peer_timeout_sec=10.0)


@pytest.fixture(scope="module", autouse=True)
def _built():
    build_native()


def _writer(port, template, tier, config=None, **kw):
    """A port writer on ``tier``."""
    cfg = config or Config(transport=CFG)
    if tier == "device":
        return create_or_fetch("127.0.0.1", port, template, cfg, device="cpu", **kw)
    cfg = Config(transport=cfg.transport, faults=cfg.faults, serve=cfg.serve, native_engine=tier == "engine",
                 send_pipeline_depth=cfg.send_pipeline_depth)
    return create_or_fetch("127.0.0.1", port, template, cfg, host_tier=True, **kw)


def _check_tier(p, tier):
    if tier == "engine":
        assert p._engine is not None
    else:
        assert p._engine is None and p.st.host_tier == (tier == "host")


def _poll(fn, deadline=45.0, every=0.02, errors=(serve.StalenessError,)):
    """Retry fn() (a StalenessError is tolerated: the subscriber may be
    seeding or resyncing) until truthy or the deadline."""
    t0 = time.monotonic()
    last = None
    while time.monotonic() - t0 < deadline:
        try:
            last = fn()
            if last:
                return last
        except errors:
            pass
        time.sleep(every)
    return last


def _sub(port, n, rng=None, **kw):
    cfg = Config(transport=CFG, serve=ServeConfig(range=rng))
    return serve.subscribe("127.0.0.1", port, np.zeros(n, np.float32), cfg, timeout=30.0, **kw)


# -- test_serve.py's cases on port writers and port subscribers -------------------------------


@pytest.mark.parametrize("tier", TIERS)
def test_subscriber_joins_reads_and_tracks_writes(tier):
    """A read-only leaf joins a live tree, gets the seed, tracks a write
    with verified freshness, and the writer keeps no ledger for it."""
    port = free_port()
    n = 512
    with _writer(port, np.arange(n, dtype=np.float32), tier) as m:
        _check_tier(m, tier)
        with _sub(port, n) as sub:
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), np.arange(n), atol=1e-4))
            m.add(np.ones(n, np.float32))
            sub.wait_fresh(serve.epoch(), timeout=20.0)
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), np.arange(n) + 1, atol=1e-4))
            assert _poll(lambda: m.st.inflight_total() == 0, deadline=10.0)
            wm = m.metrics()
            assert wm["st_sub_links"] == 1
            assert wm["st_sub_msgs_out_total"] >= 1 and wm["st_sub_fresh_out_total"] >= 1
            if tier != "engine":
                assert not any(m._unacked.values())  # nothing ledgered toward it
            sm = sub.metrics()
            assert sm["st_read_total"] >= 2 and sm["st_read_stale_total"] == 0
            assert 0 <= sm["st_sub_freshness_seconds"] < 30.0
            assert m.threads_alive() and m._error is None


def test_read_raises_not_stale_silently_when_writers_vanish():
    """An idle writer keeps reads verifiable (FRESH marks); once the only
    writer is gone, reads past their bound raise StalenessError."""
    port = free_port()
    n = 128
    m = _writer(port, np.arange(n, dtype=np.float32), "device")
    sub = _sub(port, n)
    try:
        assert _poll(lambda: sub.read(max_staleness=10.0) is not None, deadline=20.0)
        time.sleep(0.8)
        assert sub.read(max_staleness=0.6) is not None
        m.close()
        time.sleep(1.0)
        with pytest.raises(serve.StalenessError):
            sub.read(max_staleness=0.5)
        assert sub.metrics()["st_read_stale_total"] >= 1
    finally:
        sub.close()
        m.close()


@pytest.mark.parametrize("tier", TIERS)
def test_range_subscription_buffers_only_its_pages(tier):
    """A ranged subscriber buffers only its word-aligned range, converges
    on it, and the writer sends it RDATA."""
    port = free_port()
    n = 4096
    lo, hi = 1024, 2048
    with _writer(port, np.arange(n, dtype=np.float32), tier) as m:
        with _sub(port, n, (lo, hi)) as sub:
            assert sub.range_elements == (lo, hi)
            assert sub._vals.size == hi - lo and sub.buffered_bytes == 4 * (hi - lo)
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), np.arange(lo, hi), atol=1e-4))
            m.add(np.full((n,), 3.0, np.float32))
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), np.arange(lo, hi) + 3, atol=1e-4))
            assert sub.metrics()["st_sub_range_words"] == (hi - lo) // 32
            assert m.metrics()["st_sub_msgs_out_total"] >= 1


@pytest.mark.parametrize("tier", PY_TIERS)
def test_gap_triggers_resync_and_reads_stay_honest_under_drop_chaos(tier):
    """25% of the subscriber link's data messages dropped: each loss is a
    seq gap, the subscriber re-seeds, reads verify or raise, and the value
    converges once the writes stop."""
    port = free_port()
    n = 256
    cfg = Config(transport=CFG, faults=FaultConfig(enabled=True, seed=7, drop_pct=0.25))
    m = _writer(port, np.zeros(n, np.float32), tier, cfg)
    assert m._engine is None and m._faults is not None
    sub = _sub(port, n)
    try:
        total = np.zeros(n)
        rng = np.random.default_rng(1)
        for _ in range(25):
            d = rng.uniform(-1, 1, n).astype(np.float32)
            m.add(d)
            total += d
            time.sleep(0.02)
        assert _poll(lambda: np.allclose(sub.read(max_staleness=1.0), total, atol=1e-3), deadline=60.0)
        sm = sub.metrics()
        assert sm["st_sub_resyncs_total"] >= 1, "drops never forced a resync?"
        assert sm["st_sub_gap_discards_total"] >= 1
        assert m._faults.counts["dropped"] >= 1
        assert _poll(lambda: m.st.inflight_total() == 0, deadline=10.0)
        assert m.threads_alive() and m._error is None
    finally:
        sub.close()
        m.close()


def test_reads_outlive_the_data_plane():
    """A read touches only the published snapshot: it still serves after
    close() stopped the receive thread and the transport."""
    port = free_port()
    n = 128
    with _writer(port, np.arange(n, dtype=np.float32), "device") as m:
        sub = _sub(port, n)
        assert _poll(lambda: sub.read(max_staleness=10.0) is not None)
        sub.close()
        np.testing.assert_allclose(sub.read(max_staleness=30.0), np.arange(n), atol=1e-4)
        assert _poll(lambda: m.st.inflight_total() == 0, deadline=10.0)


def test_concurrent_reads_never_block_add():
    """Reader threads hammering a serving handle never hold up a writer's
    add()."""
    port = free_port()
    n = 1024
    with _writer(port, np.zeros(n, np.float32), "device") as m:
        with _sub(port, n) as sub:
            handle = sub.serving_handle(max_staleness=30.0, device="cpu")
            assert _poll(lambda: handle.refresh() or True)
            stop = threading.Event()
            reads = [0]

            def reader():
                while not stop.is_set():
                    handle.params()
                    try:
                        handle.refresh()
                    except serve.StalenessError:
                        pass
                    reads[0] += 1

            threads = [threading.Thread(target=reader) for _ in range(4)]
            for t in threads:
                t.start()
            worst = 0.0
            try:
                for _ in range(20):
                    t0 = time.monotonic()
                    m.add(np.full((n,), 0.01, np.float32))
                    worst = max(worst, time.monotonic() - t0)
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=10.0)
            assert not any(t.is_alive() for t in threads)
            assert reads[0] > 0
            assert worst < 1.0, f"add() blocked {worst:.3f}s under read load"


def test_writer_join_under_subscriber_is_refused():
    """A subscriber is a leaf: a writer pointed at its listen port fails
    its join loudly."""
    port = free_port()
    n = 64
    with _writer(port, np.zeros(n, np.float32), "device"):
        with _sub(port, n) as sub:
            cfg = Config(transport=TransportConfig(join_timeout_sec=3.0))
            with pytest.raises(ConnectionError):
                create_or_fetch("127.0.0.1", sub.node.listen_port, np.zeros(n, np.float32), cfg, timeout=8.0,
                                device="cpu")


def test_subscriber_cannot_become_master():
    with pytest.raises(ConnectionError):
        serve.Subscriber("127.0.0.1", free_port(), np.zeros(64, np.float32))


def test_mixed_tree_legacy_v1_peer_and_ranged_subscriber(monkeypatch):
    """A port master, a JAX peer pinned to the v1 framing (no trace stamps:
    the legacy peer) and a ranged port subscriber: the legacy peer gets the
    whole table, the subscriber its range, and a legacy write reaches the
    subscriber too."""
    port = free_port()
    n = 2048
    lo, hi = 512, 1024
    with _writer(port, np.zeros(n, np.float32), "device") as master:
        monkeypatch.setenv("ST_WIRE_TRACE", "0")
        legacy = jax_create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32))
        monkeypatch.delenv("ST_WIRE_TRACE")
        sub = _sub(port, n, (lo, hi))
        try:
            master.add(np.arange(n, dtype=np.float32))
            assert _poll(lambda: np.allclose(np.asarray(legacy.read()), np.arange(n), atol=1e-3))
            np.testing.assert_allclose(np.asarray(legacy.read()), np.arange(n), atol=1e-3)
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), np.arange(lo, hi), atol=1e-3))
            legacy.add(np.ones(n, np.float32))
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), np.arange(lo, hi) + 1, atol=1e-3),
                         deadline=60.0)
        finally:
            sub.close()
            legacy.close()


def test_serving_handle_hot_swap_identity():
    """params() is the same object between refreshes; a refresh after a
    write swaps new tensors in, equal to read(), and leaves the old ones
    as they were."""
    port = free_port()
    n = 256
    with _writer(port, np.zeros(n, np.float32), "device") as m:
        with _sub(port, n) as sub:
            handle = sub.serving_handle(max_staleness=30.0, device="cpu")
            assert _poll(lambda: handle.refresh() or handle.params() is not None)
            p1 = handle.params()
            assert isinstance(p1, torch.Tensor) and p1.device.type == "cpu"
            assert p1 is handle.params()
            before = p1.clone()
            m.add(np.ones(n, np.float32))
            sub.wait_fresh(serve.epoch(), timeout=20.0)
            assert _poll(lambda: handle.refresh(), deadline=20.0)
            p2 = handle.params()
            assert p2 is not p1 and torch.equal(p1, before)
            assert np.allclose(p2.numpy(), 1.0, atol=1e-4)
            np.testing.assert_array_equal(p2.numpy(), sub.read(max_staleness=30.0))


def test_idle_fresh_marks_leave_the_version_and_the_handle_alone():
    """A FRESH mark advances the verified instant and nothing else: on an
    idle tree the snapshot's version stays, and a refresh swaps nothing
    (params() the same object) however many marks arrive between two
    refreshes."""
    port = free_port()
    n = 256
    with _writer(port, np.ones(n, np.float32), "device"):
        with _sub(port, n) as sub:
            handle = sub.serving_handle(max_staleness=30.0, device="cpu")
            assert _poll(lambda: handle.refresh() or handle.params() is not None)
            p1, v1 = handle.params(), sub.version
            for _ in range(3):  # three more marks, each a newer verified instant
                f0 = sub._pub.acquire()[1]
                assert _poll(lambda: sub._pub.acquire()[1] > f0, deadline=20.0)
            assert sub.version == v1
            assert not handle.refresh() and handle.params() is p1


def test_serving_handle_tree_equals_read():
    """On a table of several leaves the handle's tensors are the template's
    tree, each leaf bit for bit read()'s."""
    port = free_port()
    seed = {"w": np.arange(1200, dtype=np.float32).reshape(30, 40), "b": np.full(7, -2.5, np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in seed.items()}
    with _writer(port, seed, "device"):
        with serve.subscribe("127.0.0.1", port, zeros, Config(transport=CFG), timeout=30.0) as sub:
            handle = sub.serving_handle(device="cpu")
            assert _poll(lambda: handle.refresh(10.0))
            got = sub.read(max_staleness=10.0)
            params = handle.params()
            for k in seed:
                assert params[k].shape == seed[k].shape and params[k].dtype == torch.float32
                np.testing.assert_array_equal(params[k].numpy(), got[k])


def test_serving_handle_needs_a_gpu_unless_cpu():
    """device=None is the GPU, as everywhere in the port: without one the
    handle raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    port = free_port()
    with _writer(port, np.zeros(64, np.float32), "device"):
        with _sub(port, 64) as sub:
            with pytest.raises(RuntimeError, match="CUDA"):
                sub.serving_handle()
            assert sub.serving_handle(device="cpu").device.type == "cpu"


# -- freshness: what a FRESH mark and a trace stamp may claim ---------------------------------


def test_fresh_never_covers_a_frame_left_in_the_pipeline():
    """A device-tier writer keeps up to send_pipeline_depth quantized frames
    per ledgered link in flight; a subscriber link is never pipelined. At
    every FRESH the writer sends, nothing of that link is quantized and
    unsent (its in-flight ledger is empty) and the mark's last seq is the
    last data message sent on it."""
    port = free_port()
    n = 4096
    cfg = Config(transport=CFG, send_pipeline_depth=8, serve=ServeConfig(fresh_interval_sec=0.0))
    m = _writer(port, np.zeros(n, np.float32), "device", cfg)
    j = _writer(port, np.zeros(n, np.float32), "device")  # a ledgered, pipelined link beside it
    sub = _sub(port, n)
    bad, marks, data_seqs = [], [0], {}
    try:
        link = next(iter(m._sub_links))
        real_send = m.node.send

        def send(lk, payload, timeout=0.1):
            kind = payload[0]
            if lk == link and kind == wire.FRESH:
                inflight = m.st._inflight.get(link)
                _, last_seq = wire.decode_fresh(payload)
                if inflight or last_seq != data_seqs.get(lk, 0):
                    bad.append((dict(inflight or {}), last_seq, data_seqs.get(lk, 0)))
                marks[0] += 1
            ok = real_send(lk, payload, timeout=timeout)
            if ok and lk == link and kind in (wire.DATA, wire.BURST, wire.RDATA):
                data_seqs[lk] = wire.data_seq(payload)
            return ok

        m.node.send = send
        rng = np.random.default_rng(3)
        total = np.zeros(n)
        for _ in range(30):
            # constant updates drain exactly, so the link idles (and marks)
            # between them
            d = np.full(n, rng.choice([-1.0, 1.0]) * 2.0 ** -rng.integers(0, 4), np.float32)
            (m if rng.random() < 0.5 else j).add(d)
            total += d
            time.sleep(0.01)
        assert _poll(lambda: np.allclose(sub.read(max_staleness=5.0), total, atol=1e-3), deadline=60.0)
        time.sleep(0.3)
        assert marks[0] > 0 and data_seqs
        assert bad == []
        assert link not in m._unacked or not m._unacked[link]
    finally:
        m.node.send = real_send
        sub.close()
        j.close()
        m.close()


#: Seconds a subscriber link may take to reach a FRESH mark past one real
#: update: the cascade drains it in tens of frames (a few passes); the
#: per-frame schedule takes thousands.
FRESH_AFTER_UPDATE_S = 5.0


def _fresh_after(m, subs, delta):
    """Add ``delta`` at the writer, then wait for a FRESH mark past the add
    at every subscriber, each within FRESH_AFTER_UPDATE_S; returns the
    writer's replica."""
    m.add(delta)
    ep = serve.epoch()
    for sub in subs:
        sub.wait_fresh(ep, timeout=FRESH_AFTER_UPDATE_S)
    return np.asarray(m.read())


@pytest.mark.parametrize("tier", PY_TIERS)
def test_subscriber_fresh_after_a_real_update(tier):
    """One add of a seeded gaussian scaled by 1e-2 (its bound no power of
    two), the way an SGD step lands: a full subscriber and a whole-range
    one (RDATA) both get a FRESH mark past it within a few seconds, and
    each reads the writer's replica. The writer's subscriber links burst
    by the cascade on both Python tiers."""
    port = free_port()
    n = 4096
    rng = np.random.default_rng(20)
    seed = rng.normal(size=n).astype(np.float32)
    m = _writer(port, seed, tier)
    full, whole = _sub(port, n), _sub(port, n, (0, n))
    try:
        assert m.st.cascade > 1
        for sub in (full, whole):
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), seed, atol=1e-6), deadline=20.0)
        rep = _fresh_after(m, (full, whole), (rng.normal(size=n) * 1e-2).astype(np.float32))
        np.testing.assert_allclose(full.read(max_staleness=10.0), rep, rtol=0, atol=1e-6)
        np.testing.assert_allclose(whole.read(max_staleness=10.0), rep, rtol=0, atol=1e-6)
        assert m._error is None and m.metrics()["st_sub_links"] == 2
    finally:
        full.close()
        whole.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_ranged_subscriber_fresh_after_a_real_update(tier):
    """A subscriber of a page range gets a FRESH mark past a gaussian add
    within a few seconds: the writer masks the link's residual to the range
    before the cascade measures it, and reads equal the writer's replica on
    the range."""
    port = free_port()
    n = 4096
    lo, hi = 1024, 2560
    rng = np.random.default_rng(21)
    m = _writer(port, np.zeros(n, np.float32), tier)
    sub = _sub(port, n, (lo, hi))
    try:
        assert _poll(lambda: sub.read(max_staleness=10.0) is not None, deadline=20.0)
        for _ in range(3):
            rep = _fresh_after(m, (sub,), (rng.normal(size=n) * 1e-2).astype(np.float32))
            np.testing.assert_allclose(sub.read(max_staleness=10.0), rep[lo:hi], rtol=0, atol=1e-6)
    finally:
        sub.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_subscriber_fresh_after_uniform_adds(tier):
    """Sums of uniform adds with unrelated bounds left a device-tier link
    with subnormal dust that never reached a FRESH mark; the cascade
    drains it: a FRESH past each of ten adds within a few seconds."""
    port = free_port()
    n = 4096
    rng = np.random.default_rng(22)
    m = _writer(port, np.zeros(n, np.float32), tier)
    sub = _sub(port, n)
    try:
        assert _poll(lambda: sub.read(max_staleness=10.0) is not None, deadline=20.0)
        for _ in range(10):
            d = (rng.uniform(-1, 1, n) * rng.uniform(0.1, 3.0)).astype(np.float32)
            rep = _fresh_after(m, (sub,), d)
            np.testing.assert_allclose(sub.read(max_staleness=10.0), rep, rtol=0, atol=1e-5)
    finally:
        sub.close()
        m.close()


def test_a_held_device_burst_goes_out_while_paused(monkeypatch):
    """A device-tier writer holds the frames of a subscriber burst that the
    link's send queue cannot take (here: none, SUB_QUEUED_MSGS at 0): no
    FRESH mark goes while any is held, paused or not, and once the queue
    may take them the sub-push thread sends them while the writer stays
    paused; resumed, the link reaches a FRESH mark past the add."""
    from shared_tensor_tpu_torch.comm import peer as peer_mod

    port = free_port()
    n = 4096
    rng = np.random.default_rng(23)
    m = _writer(port, np.zeros(n, np.float32), "device")
    sub = _sub(port, n)
    try:
        assert _poll(lambda: sub.read(max_staleness=10.0) is not None, deadline=20.0)
        monkeypatch.setattr(peer_mod, "SUB_QUEUED_MSGS", 0)
        applied = sub.frames_applied
        m.add((rng.normal(size=n) * 1e-2).astype(np.float32))
        ep = serve.epoch()
        assert _poll(lambda: len(m._sub_held) == 1, deadline=10.0)
        (link,) = m._sub_held
        m.pause()
        with pytest.raises(TimeoutError):
            sub.wait_fresh(ep, timeout=0.5)
        assert link in m._sub_held and sub.frames_applied == applied
        monkeypatch.setattr(peer_mod, "SUB_QUEUED_MSGS", 2)
        assert _poll(lambda: not m._sub_held, deadline=10.0)
        assert _poll(lambda: sub.frames_applied - applied == m._link_frames_out[link], deadline=10.0)
        m.pause(False)
        rep = np.asarray(m.read())
        sub.wait_fresh(ep, timeout=FRESH_AFTER_UPDATE_S)
        np.testing.assert_allclose(sub.read(max_staleness=10.0), rep, rtol=0, atol=1e-6)
    finally:
        sub.close()
        m.close()


#: Seconds to a FRESH mark past a writer's last add once its adds stop,
#: at a subscriber that applies a frame every 20 ms: what is in flight
#: (at most the bound below) and the cascade's drain of what is left.
FRESH_AFTER_STOP_S = 5.0


def _inflight_bound() -> int:
    """A subscriber link's most data messages (one a frame) sent and not
    yet applied: SUB_QUEUED_MSGS in the writer's send queue and as many in
    its transport sender's hand, SUB_SOCKET_FRAMES in each socket's buffer
    at twice the size asked for (the kernel doubles it for its own
    bookkeeping), the subscriber's receive queue, and one message each in
    its receiver's hand and in its apply."""
    from shared_tensor_tpu_torch.comm import peer as peer_mod
    from shared_tensor_tpu_torch.serve import subscriber as sub_mod

    return 2 * peer_mod.SUB_QUEUED_MSGS + 2 * 2 * peer_mod.SUB_SOCKET_FRAMES + sub_mod.RECV_QUEUE_MSGS + 2


@pytest.mark.parametrize("tier", PY_TIERS)
def test_a_slow_subscriber_link_holds_a_few_frames_in_flight(tier, monkeypatch):
    """The writer adds every 2 ms (ten times faster than its subscriber
    applies: each apply sleeps 20 ms more) for 3 s. Throughout, the data
    messages it has sent on the link minus the subscriber's applied seq stay
    within :func:`_inflight_bound`, where the kernel's autotuned socket
    buffers held hundreds of these 8 KiB frames. Once the adds stop, a FRESH
    mark past the last one arrives within FRESH_AFTER_STOP_S."""
    port = free_port()
    n = 1 << 16  # 8 KiB frames: two of them exceed the kernel's least socket buffer
    rng = np.random.default_rng(24)
    m = _writer(port, np.zeros(n, np.float32), tier)
    sub = _sub(port, n)
    stop, worst = threading.Event(), [0]
    real_apply = sub._apply

    def slow_apply(scales, words, word_lo):
        time.sleep(0.02)
        return real_apply(scales, words, word_lo)

    def sample():
        while not stop.is_set():
            applied = sub._expected_seq - 1  # read first: the difference never under-counts
            worst[0] = max(worst[0], m._sub_msgs_out - applied)
            time.sleep(0.002)

    deltas = [(rng.normal(size=n) * 1e-2).astype(np.float32) for _ in range(8)]
    sampler = threading.Thread(target=sample, daemon=True)
    try:
        assert _poll(lambda: sub.read(max_staleness=10.0) is not None, deadline=20.0)
        assert m._sub_msgs_out == 0
        monkeypatch.setattr(sub, "_apply", slow_apply)
        sampler.start()
        t0 = time.monotonic()
        i = 0
        while time.monotonic() - t0 < 3.0:
            m.add(deltas[i % len(deltas)])
            i += 1
            time.sleep(0.002)
        ep = serve.epoch()
        sub.wait_fresh(ep, timeout=FRESH_AFTER_STOP_S)
        stop.set()
        sampler.join()
        assert sub.metrics()["st_sub_resyncs_total"] == 0  # one seq stream: sent and applied compare
        assert m._sub_msgs_out >= 50, m._sub_msgs_out  # the link was busy throughout
        assert worst[0] <= _inflight_bound(), (worst[0], _inflight_bound())
        # the subscriber sums the frames in another order than the writer
        # its adds: each applied frame rounds once, at 2^-24 of the value
        rep = np.asarray(m.read())
        tol = sub.frames_applied * 2.0**-24 * float(np.abs(rep).max())
        np.testing.assert_allclose(sub.read(max_staleness=10.0), rep, rtol=0, atol=tol)
    finally:
        stop.set()
        sub.close()
        m.close()


@pytest.mark.parametrize("tier", PY_TIERS)
def test_a_full_subscriber_queue_holds_up_no_other_link(tier):
    """The send thread waits on S1's full queue (its sends refused, the
    quarantine off) in the middle of S1's send pass. Meanwhile S2's link
    drops: the receive thread handles that LINK_DOWN at once, and goes on
    applying and acknowledging a ledgered child's frames."""
    port = free_port()
    n = 256
    tcfg = TransportConfig(peer_timeout_sec=10.0, max_children=3, quarantine_send_failures=0)
    m = _writer(port, np.zeros(n, np.float32), tier, Config(transport=tcfg))
    j = _writer(port, np.zeros(n, np.float32), tier)
    s1, s2 = _sub(port, n), _sub(port, n)
    release, entered = threading.Event(), threading.Event()
    real_send = m.node.send
    try:
        assert _poll(lambda: len(m._sub_links) == 2, deadline=20.0)
        l1 = min(m._sub_links)  # S1 attached first: link ids only grow

        def send(lk, payload, timeout=0.1):
            if lk == l1 and payload[0] in (wire.DATA, wire.BURST) and not release.is_set():
                entered.set()
                time.sleep(timeout)
                return False  # the queue is full
            return real_send(lk, payload, timeout=timeout)

        m.node.send = send
        m.add(np.ones(n, np.float32))
        assert entered.wait(20.0)
        l2 = next(lk for lk in m._sub_links if lk != l1)
        s2.close()
        assert _poll(lambda: l2 not in m._sub_links, deadline=5.0)
        d = np.random.default_rng(8).normal(size=n).astype(np.float32)
        j.add(d)
        assert _poll(lambda: np.allclose(np.asarray(m.read()), 1.0 + d, atol=1e-4), deadline=10.0)
        assert _poll(lambda: not any(j._unacked.values()), deadline=10.0)
        assert not release.is_set() and l1 in m._sub_links  # S1's pass is still waiting
    finally:
        release.set()
        m.node.send = real_send
        s1.close()
        s2.close()
        j.close()
        m.close()


@pytest.mark.parametrize("tier", TIERS)
def test_relayed_stamp_is_the_origins(tier):
    """A writer that relays another writer's add stamps the subscriber's
    data with the ORIGIN's time: the subscriber's verified instant lands
    between the two clocks read around the add, never at the relay's later
    send time. FRESH marks are kept out of the way (one a day), and the
    update (a power-of-two uniform, table wider than the host tier's burst
    threshold) drains over many messages."""
    port = free_port()
    n = 1 << 16
    cfg = Config(transport=CFG, serve=ServeConfig(fresh_interval_sec=86400.0))
    m = _writer(port, np.zeros(n, np.float32), tier, cfg)
    w = create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32), Config(transport=CFG), host_tier=True)
    sub = _sub(port, n)
    try:
        time.sleep(0.2)
        marks = sub.metrics()["st_sub_fresh_marks_total"]
        delta = np.random.default_rng(4).uniform(-1, 1, n).astype(np.float32)
        t_before = time.monotonic_ns()
        w.add(delta)
        t_after = time.monotonic_ns()
        assert _poll(lambda: np.allclose(sub._pub.acquire()[0][:n], delta, rtol=0, atol=1e-6), deadline=60.0)
        assert _poll(lambda: sub._pub.acquire()[1] >= t_before, deadline=10.0)
        stamp = sub._pub.acquire()[1]
        assert sub.metrics()["st_sub_fresh_marks_total"] == marks  # data stamps only
        assert t_before <= stamp <= t_after, (t_before, stamp, t_after)
    finally:
        sub.close()
        w.close()
        m.close()


# -- across packages ------------------------------------------------------------------------


@pytest.mark.parametrize("ranged", [False, True], ids=["full", "range"])
@pytest.mark.parametrize("tier", TIERS)
def test_jax_subscriber_under_a_port_writer(tier, ranged):
    port = free_port()
    n = 2048
    lo, hi = (512, 1536) if ranged else (0, n)
    with _writer(port, np.arange(n, dtype=np.float32), tier) as m:
        jcfg = JConfig(serve=JServeConfig(range=(lo, hi) if ranged else None))
        with jserve.subscribe("127.0.0.1", port, np.zeros(n, np.float32), jcfg, timeout=30.0) as sub:
            m.add(np.full(n, 0.5, np.float32))
            sub.wait_fresh(jserve.epoch(), timeout=20.0)
            tol = 1e-3 if ranged else 1e-4
            assert _poll(lambda: np.allclose(np.asarray(sub.read(max_staleness=10.0)), np.arange(lo, hi) + 0.5,
                                             atol=tol), errors=(jserve.StalenessError,))
            assert m.metrics()["st_sub_links"] == 1
            assert m.metrics()["st_unknown_msgs_total"] == 0 and m._error is None


@pytest.mark.parametrize("ranged", [False, True], ids=["full", "range"])
@pytest.mark.parametrize("tier", ["python", "engine"])
def test_port_subscriber_under_a_jax_writer(tier, ranged):
    port = free_port()
    n = 2048
    lo, hi = (512, 1536) if ranged else (0, n)
    m = jax_create_or_fetch("127.0.0.1", port, np.arange(n, dtype=np.float32),
                            JConfig(native_engine=tier == "engine"))
    try:
        assert (m._engine is not None) == (tier == "engine")
        with _sub(port, n, (lo, hi) if ranged else None) as sub:
            m.add(np.full(n, 0.5, np.float32))
            sub.wait_fresh(serve.epoch(), timeout=20.0)
            tol = 1e-3 if ranged else 1e-4
            assert _poll(lambda: np.allclose(sub.read(max_staleness=10.0), np.arange(lo, hi) + 0.5, atol=tol))
    finally:
        m.close()


def test_port_parent_still_refuses_a_sharded_joiner():
    """A sharded joiner's SYNC (SYNC_FLAG_SHARD and its claim tail) is not
    refused any more: the port parent attaches it as a plain writer child,
    as JAX's classic peer does, with a WELCOME that carries no shard flag
    (the joiner's cue to fall back), and never as a subscriber."""
    from shared_tensor_tpu_torch.comm.transport import TransportNode

    port = free_port()
    with _writer(port, np.zeros(64, np.float32), "device") as parent:
        with TransportNode("127.0.0.1", port, CFG) as node:
            deadline = time.time() + 30
            while node.uplink is None and time.time() < deadline:
                time.sleep(0.01)
            spec = make_spec(np.zeros(64, np.float32))
            sync = wire.encode_sync(spec, wire.WIRE_VERSION_V2, wire.SYNC_FLAG_SHARD, shard=1)
            for msg in (sync, bytes([wire.DONE])):
                assert node.send(node.uplink, msg)
            reply = None
            while (reply is None or reply[0] not in (wire.WELCOME, wire.REJECT)) and time.time() < deadline:
                try:
                    reply = node.recv(node.uplink, timeout=0.1)
                except BrokenPipeError:
                    break
            assert reply is not None and reply[0] == wire.WELCOME
            assert not wire.welcome_flags(reply) & wire.SYNC_FLAG_SHARD
            while len(parent.st.link_ids) < 1 and time.time() < deadline:
                time.sleep(0.01)
            assert len(parent.st.link_ids) == 1
        assert parent.threads_alive() and parent._error is None and not parent._sub_links


def test_range_outside_the_table_is_rejected():
    """A RANGE past the table's words is refused with a REJECT."""
    from shared_tensor_tpu_torch.comm.transport import TransportNode

    port = free_port()
    with _writer(port, np.zeros(64, np.float32), "device") as parent:
        with TransportNode("127.0.0.1", port, CFG) as node:
            deadline = time.time() + 30
            while node.uplink is None and time.time() < deadline:
                time.sleep(0.01)
            spec = make_spec(np.zeros(64, np.float32))
            flags = wire.SYNC_FLAG_READ_ONLY | wire.SYNC_FLAG_RANGE
            for msg in (wire.encode_sync(spec, wire.WIRE_VERSION_V2, flags), wire.encode_range(0, 1000)):
                assert node.send(node.uplink, msg)
            reply = None
            while reply is None and time.time() < deadline:
                try:
                    reply = node.recv(node.uplink, timeout=0.1)
                except BrokenPipeError:
                    break
            assert reply is not None and reply[0] == wire.REJECT and "outside" in wire.decode_reject(reply)
        assert parent.threads_alive() and not parent._sub_links and not parent._pending_sub


# -- bit level against the JAX package ------------------------------------------------------


def _spec_pair(shapes):
    tpl = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    return tpl, make_spec(tpl), jax_make_spec(tpl)


SHAPES = {"a": (300,), "b": (17, 9), "c": (64, 64)}


def _frame(spec, rng):
    scales = (2.0 ** rng.integers(-6, 3, spec.num_leaves)).astype(np.float32)
    scales[rng.random(spec.num_leaves) < 0.3] = 0.0
    words = rng.integers(0, 2**32, spec.total // 32, dtype=np.uint64).astype(np.uint32)
    return scales, words


def test_range_fresh_rdata_bytes_equal_jax():
    _, spec, jspec = _spec_pair(SHAPES)
    rng = np.random.default_rng(5)
    for wlo, wcnt in ((0, 1), (3, 40), (0, spec.total // 32)):
        assert wire.encode_range(wlo, wcnt) == jwire.encode_range(wlo, wcnt)
        assert wire.decode_range(jwire.encode_range(wlo, wcnt)) == (wlo, wcnt)
    for t, seq in ((0, 0), (123456789012345, 7), (2**64 - 1, 2**32 - 1)):
        assert wire.encode_fresh(t, seq) == jwire.encode_fresh(t, seq)
        assert wire.decode_fresh(jwire.encode_fresh(t, seq)) == (t, seq)
    for i in range(6):
        scales, words = _frame(spec, rng)
        wlo = int(rng.integers(0, spec.total // 32 - 8))
        wcnt = int(rng.integers(1, spec.total // 32 - wlo))
        trace = None if i % 2 else (int(rng.integers(1, 2**32)), int(rng.integers(0, 2**63)), int(rng.integers(0, 9)))
        ours = wire.encode_rdata(TableFrame(scales, words), wlo, wcnt, 100 + i, trace=trace)
        theirs = jwire.encode_rdata(JTableFrame(scales, words), wlo, wcnt, 100 + i, trace=trace)
        assert ours == theirs
        assert wire.data_seq(ours) == 100 + i
        s, w, lo2, cnt2, tr = wire.decode_rdata(theirs, spec)
        js, jw, jlo, jcnt, jtr = jwire.decode_rdata(ours, jspec)
        assert (lo2, cnt2, tr) == (jlo, jcnt, jtr) == (wlo, wcnt, trace)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(w, words[wlo : wlo + wcnt])
    with pytest.raises(ValueError):
        wire.decode_rdata(ours[:-1], spec)


def test_rdata_with_a_non_finite_scale_zeroes_it():
    _, spec, _ = _spec_pair(SHAPES)
    scales, words = _frame(spec, np.random.default_rng(1))
    scales[1] = np.nan
    s, _, _, _, _ = wire.decode_rdata(wire.encode_rdata(TableFrame(scales, words), 0, 4, 1), spec)
    assert s[1] == 0.0 and np.isfinite(s).all()


@pytest.mark.parametrize("rng_el", [None, (320, 4416), (0, 96)], ids=["full", "range", "first-words"])
def test_page_apply_matches_jax_bit_for_bit(rng_el):
    """The port subscriber's apply against the JAX subscriber's _apply_frame
    on the same frames: every bit of the pages, with zero-scale leaves,
    the padding (nonzero at the start, and -0.0 values), values clamped at
    +-SAT, and both whole-table frames and range slices."""
    tpl, spec, _ = _spec_pair(SHAPES)
    port = free_port()
    m = jax_create_or_fetch("127.0.0.1", port, tpl)
    jsub = jserve.subscribe("127.0.0.1", port, tpl, JConfig(serve=JServeConfig(range=rng_el)), timeout=30.0)
    try:
        wlo, wcnt = jsub._wlo, jsub._wcnt
        pages = _Pages(spec, wlo, wcnt)
        assert (pages.wlo, pages.wcnt) == (wlo, wcnt)
        np.testing.assert_array_equal(pages.live, jsub._live)
        rng = np.random.default_rng(11)
        start = rng.normal(size=wcnt * 32).astype(np.float32)
        start[:5] = [-0.0, 0.0, SAT, -SAT, 2.9e38]
        pages.vals[:] = start
        jvals = start.copy()
        jsub._vals = jvals  # the JAX apply works on the instance's pages
        for i in range(12):
            scales, words = _frame(spec, rng)
            if i == 3:
                scales[:] = np.float32(2.0e38)  # pushes past SAT: the clamp
            if i % 2:
                args = (scales, words[wlo : wlo + wcnt], wlo)  # an RDATA's slice
            else:
                args = (scales, words, 0)  # a whole-table frame
            with np.errstate(over="ignore"):  # frame 3 overflows to inf, which both clamp to SAT
                assert pages.apply(*args) == jsub._apply_frame(*args)
            np.testing.assert_array_equal(pages.vals.view(np.uint32), jvals.view(np.uint32))
        assert pages.apply(np.zeros(spec.num_leaves, np.float32), words, 0) is False
        if rng_el is not None and wlo > 0:
            with pytest.raises(ValueError):
                pages.apply(scales, words[:wcnt], 0 if wlo else 1)
    finally:
        jsub.close()
        m.close()


def test_subscriber_tree_and_handle_leaves_keep_the_layout():
    """read() of a whole-table subscription is the template's tree of numpy
    arrays (JAX's shape of result), leaf for leaf the writer's."""
    seed = {"x": np.arange(40, dtype=np.float32).reshape(5, 8), "y": [np.ones(3, np.float32), np.zeros(2, np.float32)]}
    zeros = {"x": np.zeros((5, 8), np.float32), "y": [np.zeros(3, np.float32), np.zeros(2, np.float32)]}
    port = free_port()
    with _writer(port, seed, "device"):
        with serve.subscribe("127.0.0.1", port, zeros, Config(transport=CFG), timeout=30.0) as sub:
            got = _poll(lambda: sub.read(max_staleness=10.0))
            for g, e in zip(tree_flatten(got)[0], tree_flatten(seed)[0]):
                assert isinstance(g, np.ndarray)
                np.testing.assert_array_equal(g, e)


def test_wire_kinds_are_jax_s():
    assert (wire.RANGE, wire.FRESH, wire.RDATA) == (jwire.RANGE, jwire.FRESH, jwire.RDATA)
    assert (wire.RDATA_HDR, wire.RDATA_HDR_T) == (jwire.RDATA_HDR, jwire.RDATA_HDR_T)
    assert struct.calcsize(wire._FRESH_FMT) == 12
