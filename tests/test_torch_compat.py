"""The reference-named shim and the reference (compat) wire format on port
peers (shared_tensor_tpu_torch.compat, TransportConfig(wire_compat=True)),
against the JAX package and the compiled C reference peer
(native/stc_harness.c, built by the port's _build into csrc/build/).

- The constants, sign2_mode and wire_protocol_version equal the JAX
  package's under every ST_SIGN2 / ST_WIRE_TRACE value.
- Compat frames are byte-identical both ways, a non-finite scale dropped.
- test_compat.py's three cases on port peers (device="cpu").
- A port compat tree with a JAX compat peer on each of its tiers.
- test_c_interop.py's three cases (the C peer as a leaf, as an interior
  node, receiving the seed) with port peers; they skip only without gcc.
- The compat leaf re-graft after its parent dies.

Tolerances: test_compat.py's 1e-6 where every add is a power-of-two
constant (exact in a few frames), test_c_interop.py's 0.02 / 0.05 against
the C peer (its codec runs on its own clock, bounded by its run time), and
1e-6 for the re-graft (uniform adds, exact)."""

import shutil
import subprocess
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest
import torch

from shared_tensor_tpu import compat as jcompat
from shared_tensor_tpu.comm import wire as jwire
from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import CodecConfig as JCodecConfig
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu.ops.table import TableFrame as JTableFrame
from shared_tensor_tpu.ops.table import make_spec as jax_make_spec
from shared_tensor_tpu_torch import CodecConfig, Config, TransportConfig, _build, compat, create_or_fetch, serve
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.ops.table import TableFrame, make_spec
from tests._ports import free_port
from tests.test_torch_peer import wait_converged

CPU = "cpu"
COMPAT = Config(transport=TransportConfig(peer_timeout_sec=10.0, wire_compat=True))


def _compat_cfg(tier="device", **tkw):
    tkw.setdefault("peer_timeout_sec", 10.0)
    return Config(transport=TransportConfig(wire_compat=True, **tkw), native_engine=tier != "host")


def _peer(port, template, tier="device", **tkw):
    """A port compat peer on ``tier``: device (device="cpu"), engine or host."""
    cfg = _compat_cfg(tier, **tkw)
    if tier == "device":
        return create_or_fetch("127.0.0.1", port, template, cfg, device=CPU)
    return create_or_fetch("127.0.0.1", port, template, cfg, host_tier=True)


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# -- constants and policy ---------------------------------------------------------


@pytest.mark.parametrize(
    "name",
    ["WIRE_VERSION_V1", "WIRE_VERSION_V2", "WIRE_VERSION", "SYNC_FLAG_READ_ONLY", "SYNC_FLAG_RANGE",
     "SYNC_FLAG_SIGN2", "SYNC_FLAG_SHM", "SYNC_FLAG_SHARD"],
)
def test_constants_equal_jax(name):
    assert getattr(compat, name) == getattr(jcompat, name)


@pytest.mark.parametrize("env", [None, "0", "1", "2"])
@pytest.mark.parametrize("adaptive", [None, True, False])
def test_sign2_mode_equals_jax(env, adaptive, monkeypatch):
    if env is None:
        monkeypatch.delenv("ST_SIGN2", raising=False)
    else:
        monkeypatch.setenv("ST_SIGN2", env)
    cfg = None if adaptive is None else Config(codec=CodecConfig(adaptive_precision=adaptive))
    jcfg = None if adaptive is None else JConfig(codec=JCodecConfig(adaptive_precision=adaptive))
    assert compat.sign2_mode(cfg) == jcompat.sign2_mode(jcfg)


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_wire_protocol_version_equals_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("ST_WIRE_TRACE", raising=False)
    else:
        monkeypatch.setenv("ST_WIRE_TRACE", env)
    assert compat.wire_protocol_version() == jcompat.wire_protocol_version()
    assert compat.wire_protocol_version(Config()) == jcompat.wire_protocol_version(JConfig())


def test_st_wire_trace_pins_v1_emission(monkeypatch):
    """ST_WIRE_TRACE=0: a port peer emits v1 (untraced) DATA/BURST, and its
    SYNC says so; the tree still converges."""
    monkeypatch.setenv("ST_WIRE_TRACE", "0")
    port = free_port()
    seed = np.arange(64, dtype=np.float32)
    with create_or_fetch("127.0.0.1", port, seed, device=CPU) as m:
        with create_or_fetch("127.0.0.1", port, np.zeros_like(seed), device=CPU) as j:
            assert m._wire_version == j._wire_version == 1 and not j._trace_wire
            j.add(np.full(64, 0.5, np.float32))
            wait_converged([m, j], seed + 0.5)


# -- frames -------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 32, 240, 1000, 4099])
def test_compat_frames_byte_identical_both_ways(n):
    rng = np.random.default_rng(n)
    spec, jspec = make_spec(np.zeros(n, np.float32)), jax_make_spec(np.zeros(n, np.float32))
    assert wire.compat_frame_bytes(n) == jwire.compat_frame_bytes(n)
    assert wire.compat_burst_frames_cap(n) == jwire.compat_burst_frames_cap(n)
    words = rng.integers(0, 2**32, spec.total // 32, dtype=np.uint64).astype(np.uint32)
    scale = np.asarray([0.375], np.float32)
    ours = wire.encode_compat_frame(TableFrame(scale, words), spec)
    theirs = jwire.encode_compat_frame(JTableFrame(scale, words), jspec)
    assert ours == theirs and len(ours) == wire.compat_frame_bytes(n)
    a, b = wire.decode_compat_frame(theirs, spec), jwire.decode_compat_frame(ours, jspec)
    np.testing.assert_array_equal(a.scales, np.asarray(b.scales))
    np.testing.assert_array_equal(a.words, np.asarray(b.words))
    # a keepalive (scale 0) and a non-finite scale apply nothing
    for bad in (0.0, float("nan"), float("inf")):
        raw = np.float32(bad).tobytes() + ours[4:]
        assert wire.decode_compat_frame(raw, spec) is None and jwire.decode_compat_frame(raw, jspec) is None
    with pytest.raises(ValueError):
        wire.decode_compat_frame(ours[:-1], spec)


def test_compat_needs_one_flat_tensor():
    with pytest.raises(ValueError, match="one flat tensor"):
        create_or_fetch("127.0.0.1", free_port(), {"a": np.zeros(4, np.float32), "b": np.zeros(4, np.float32)},
                        COMPAT, device=CPU)


def test_subscriber_refuses_compat():
    with pytest.raises(ValueError, match="native protocol"):
        serve.Subscriber("127.0.0.1", free_port(), np.zeros(4, np.float32), COMPAT)


# -- test_compat.py's cases on port peers ----------------------------------------------


def test_example_lua_program_shape():
    x = torch.arange(1.0, 5.0)
    with compat.createOrFetch("127.0.0.1", free_port(), x, device=CPU) as a:
        np.testing.assert_allclose(a.copyToTensor().numpy(), [1, 2, 3, 4])
        a.addFromTensor(torch.ones_like(x))
        np.testing.assert_allclose(a.copyToTensor().numpy(), [2, 3, 4, 5])


def test_reference_shim_tree_serves_a_read_only_subscriber():
    x = np.arange(1.0, 65.0, dtype=np.float32)
    port = free_port()
    with compat.createOrFetch("127.0.0.1", port, x, device=CPU) as a:
        with serve.subscribe("127.0.0.1", port, np.zeros_like(x), timeout=30.0) as sub:

            def has(v):
                try:
                    return np.allclose(sub.read(max_staleness=10.0), v, atol=1e-4)
                except serve.StalenessError:
                    return False

            assert _wait(lambda: has(x))
            a.addFromTensor(torch.ones(64))
            sub.wait_fresh(serve.epoch(), timeout=20.0)
            assert _wait(lambda: has(x + 1))
            np.testing.assert_allclose(a.copyToTensor().numpy(), x + 1, atol=1e-6)


def test_two_process_semantics_in_one_process():
    x = torch.arange(1.0, 5.0)
    port = free_port()
    with compat.createOrFetch("127.0.0.1", port, x, device=CPU) as master:
        with compat.createOrFetch("127.0.0.1", port, torch.zeros_like(x), device=CPU) as joiner:
            assert _wait(lambda: np.allclose(joiner.copyToTensor().numpy(), [1, 2, 3, 4], atol=1e-6), 5.0)
            joiner.addFromTensor(torch.ones_like(x))
            assert _wait(lambda: np.allclose(master.copyToTensor().numpy(), [2, 3, 4, 5], atol=1e-6), 5.0)


# -- the reference wire on every port tier, and with JAX compat peers -----------------


@pytest.mark.parametrize("tier", ["device", "engine", "host"])
def test_compat_pair_on_each_port_tier(tier):
    """BASELINE config 1 on the reference wire: a port compat master on
    ``tier`` and a device-tier joiner, both adding; readiness at the first
    frame, no ledger, frames equal messages."""
    port = free_port()
    seed = np.arange(1, 241, dtype=np.float32)
    with _peer(port, seed, tier) as m, _peer(port, np.zeros_like(seed)) as j:
        assert (m._engine is not None) == (tier == "engine") and m._compat and j._compat
        wait_converged([j], seed)
        m.add(np.full(240, 2.0, np.float32))
        j.add(np.full(240, 0.5, np.float32))
        wait_converged([m, j], seed + 2.5)
        jm = j.metrics()
        assert jm["st_msgs_out_total"] == jm["st_frames_out_total"] and jm["st_inflight_msgs"] == 0
        assert jm["st_unknown_msgs_total"] == 0 and not [k for k in jm if k.startswith("st_shm_active")]


@pytest.mark.parametrize("jtier", ["engine", "host", "device"])
@pytest.mark.parametrize("orientation", ["torch_master", "jax_master"])
def test_compat_tree_with_a_jax_peer(orientation, jtier, monkeypatch):
    """A port compat tree with a JAX compat peer (on its engine, its Python
    host tier or its device tier): master, joiner and a third peer of the
    other implementation (a port engine peer), every replica converging
    to the seed plus every add."""
    build_native()
    if jtier == "device":
        monkeypatch.setenv("ST_HOST_CODEC", "xla")
    jcfg = JConfig(native_engine=jtier != "host",
                   transport=JTransportConfig(peer_timeout_sec=10.0, wire_compat=True))
    port = free_port()
    seed = np.linspace(0.5, 1.5, 256).astype(np.float32)
    peers = []
    try:
        if orientation == "torch_master":
            peers.append(_peer(port, seed))
            peers.append(jax_create_or_fetch("127.0.0.1", port, np.zeros_like(seed), jcfg))
        else:
            peers.append(jax_create_or_fetch("127.0.0.1", port, seed, jcfg))
            peers.append(_peer(port, np.zeros_like(seed)))
        peers.append(_peer(port, np.zeros_like(seed), "engine"))
        jp = peers[1] if orientation == "torch_master" else peers[0]
        assert (jp._engine is not None) == (jtier == "engine") and jp.st.host_tier == (jtier != "device")
        wait_converged(peers, seed, timeout=30.0)
        total = seed.copy()
        for p, v in zip(peers, (2.0, 0.5, 0.25)):
            p.add(np.full(256, v, np.float32))
            total += v
        wait_converged(peers, total, timeout=30.0)
        for p in peers:
            if not hasattr(p, "_compat"):
                continue
            m = p.metrics()
            assert m["st_unknown_msgs_total"] == 0 and p.threads_alive() and p._error is None
    finally:
        for p in reversed(peers):
            p.close()


@pytest.mark.parametrize("tier", ["device", "engine", "host"])
def test_compat_leaf_regraft_after_parent_death(tier):
    """A compat chain master - interior - leaf (max_children 1), the leaf
    on ``tier``. The leaf adds while the interior is alive, the interior
    dies, the leaf adds again while orphaned (into its carry) and
    re-grafts to the master: as a leaf it resets to exactly its carry
    (core.regraft_reset_to_carry, the engine's compat_regraft) and the
    master re-seeds it with its whole replica, so every replica ends at
    seed + every add, with nothing doubled or lost."""
    port = free_port()
    seed = np.full(256, 1.0, np.float32)
    m = _peer(port, seed, max_children=1, peer_timeout_sec=3.0)
    mid = _peer(port, np.zeros_like(seed), max_children=1, peer_timeout_sec=3.0)
    leaf = _peer(port, np.zeros_like(seed), tier, max_children=1, peer_timeout_sec=3.0)
    try:
        assert (leaf._engine is not None) == (tier == "engine") and leaf.st.host_tier == (tier != "device")
        assert _wait(lambda: len(mid.node.links) == 2)
        wait_converged([m, mid, leaf], seed)
        leaf.add(np.full(256, 0.5, np.float32))
        wait_converged([m, mid, leaf], seed + 0.5)
        up0 = leaf.node.uplink
        mid.close()
        assert _wait(lambda: leaf._uplink != up0, 10.0)
        # orphaned (or just re-grafted): the add rides the carry or the new uplink
        leaf.add(np.full(256, 0.25, np.float32))
        assert _wait(lambda: leaf.node.uplink not in (None, up0) and leaf.ready, 30.0)
        m.add(np.full(256, 2.0, np.float32))
        wait_converged([m, leaf], seed + 2.75, timeout=30.0)
        assert not leaf._compat_reset_on_regraft
    finally:
        leaf.close()
        mid.close()
        m.close()


# -- the compiled C reference peer ---------------------------------------------------


@pytest.fixture(scope="module")
def harness_bin():
    if shutil.which("gcc") is None:
        pytest.skip("no gcc: the C reference peer cannot be built")
    return str(_build.build_harness())


def _run_harness(harness_bin, port, n, seconds, add, children=None):
    args = [harness_bin, "127.0.0.1", str(port), str(n), str(seconds), str(add)]
    if children is not None:
        args.append(str(children))
    return subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _harness_values(proc, timeout=40):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-500:]
    return np.array([float(x) for x in out.split()], np.float32)


def test_c_peer_as_leaf(harness_bin):
    """The C peer joins a port compat master; both add; both reach seed +
    both adds (test_c_interop.py's mutual convergence)."""
    n = 256
    port = free_port()
    seed = np.linspace(0.5, 1.5, n).astype(np.float32)
    with _peer(port, seed) as peer:
        c = _run_harness(harness_bin, port, n, 6.0, 1.0)
        time.sleep(1.0)
        peer.add(np.full(n, 2.0, np.float32))
        got = _harness_values(c)
        np.testing.assert_allclose(got, seed + 3.0, atol=0.02)
        assert _wait(lambda: np.allclose(peer.read().numpy(), seed + 3.0, atol=0.02), 10.0)


def test_c_peer_receives_seed_state(harness_bin):
    n = 128
    port = free_port()
    seed = (np.arange(n) % 7 + 1).astype(np.float32) * 0.25
    with _peer(port, seed, "engine"):
        got = _harness_values(_run_harness(harness_bin, port, n, 3.0, 0.0), timeout=30)
        np.testing.assert_allclose(got, seed, atol=0.02)


def test_c_peer_as_interior_node(harness_bin):
    """master (port, max_children 1) <- C peer (one child slot) <- port
    joiner: the joiner is redirected to the C node, and the masses cross
    it both ways (its flood re-quantizes per hop)."""
    n = 192
    port = free_port()
    seed = np.linspace(0.25, 1.25, n).astype(np.float32)
    expected = seed + 2.0 + 1.0 + 0.5
    with _peer(port, seed, max_children=1) as master:
        c = _run_harness(harness_bin, port, n, 6.0, 1.0, children=1)
        time.sleep(1.0)
        with _peer(port, np.zeros_like(seed), "engine", max_children=1) as leaf:
            assert not leaf.is_master and len(master.node.links) == 1
            master.add(np.full(n, 2.0, np.float32))
            leaf.add(np.full(n, 0.5, np.float32))
            np.testing.assert_allclose(_harness_values(c), expected, atol=0.05)
            assert _wait(lambda: all(np.allclose(p.read().numpy(), expected, atol=0.05) for p in (master, leaf)),
                         15.0)


def test_compat_child_frame_before_link_up_is_not_echoed():
    """A reference child streams at once, so its first frame can reach the
    parent's transport before the parent has handled the link's LINK_UP
    (the transport lists a link before it queues the event). Here the
    parent's LINK_UP is held back 0.5 s behind the child's frame (+1 on
    every element): the parent leaves the frame queued until the link is
    open, so the child link's seed (the parent's whole replica) does not
    contain the child's own +1, and the child receives exactly the seed."""
    from shared_tensor_tpu_torch.comm.transport import EventKind, TransportNode
    from shared_tensor_tpu_torch.ops import codec_np

    n = 256
    seed = np.linspace(0.5, 1.5, n).astype(np.float32)
    spec = make_spec(seed)
    port = free_port()
    with _peer(port, seed) as m:
        orig, held = m.node.poll_events, []

        def delayed(timeout=0.0, cap=16):
            now = time.time()
            out = []
            for ev in orig(timeout, cap):
                if ev.kind == EventKind.LINK_UP and not ev.is_uplink:
                    held.append((now + 0.5, ev))
                else:
                    out.append(ev)
            due = [e for t, e in held if t <= now]
            held[:] = [(t, e) for t, e in held if t > now]
            return due + out

        m.node.poll_events = delayed
        fb = wire.compat_frame_bytes(n)
        with TransportNode("127.0.0.1", port, TransportConfig(peer_timeout_sec=10.0, wire_compat=True),
                           frame_bytes=fb) as child:
            assert _wait(lambda: child.uplink is not None, 10.0)
            plus_one = TableFrame(np.ones(1, np.float32), np.zeros(spec.total // 32, np.uint32))
            assert child.send(child.uplink, wire.encode_compat_frame(plus_one, spec))
            got = np.zeros(spec.total, np.float32)
            deadline = time.time() + 20
            while time.time() < deadline:
                payload = child.recv(child.uplink, timeout=0.05)
                if payload is None:
                    if m.st.link_ids and all(m.st.residual_rms(l) == 0 for l in m.st.link_ids) and \
                            np.allclose(got[:n], seed, atol=1e-6):
                        break
                    continue
                f = wire.decode_compat_frame(payload, spec)
                if f is not None:
                    (got,) = codec_np.apply_table_many_plain((got,), f.scales, f.words, spec)
            np.testing.assert_allclose(m.read().numpy(), seed + 1.0, atol=1e-6)
            np.testing.assert_allclose(got[:n], seed, atol=1e-6)
