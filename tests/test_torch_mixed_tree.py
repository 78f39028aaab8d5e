"""JAX and PyTorch peers in one loopback tree: the wire is shared, so a tree
may mix them. Every replica, JAX's and the port's, converges to the seed
plus every peer's update.

Topologies: a JAX master with a port joiner, a port master with a JAX
joiner, and a chain JAX - port - JAX (the JAX master takes one child, so
the third peer is redirected below the port peer). Each runs with the JAX
peers on each of their tiers: the native engine (the default on a CPU
host), the Python host tier (``native_engine=False``) and the device tier
(``ST_HOST_CODEC=xla``). Port peers run on their device tier
(device="cpu"), and in a second set on their host tier: the native engine
(the default there) and the Python host tier (``native_engine=False``). A
last tree mixes the port's three tiers with a JAX engine peer.

Tolerance: test_peer.py's, rtol 1e-4 and atol 1e-6. Every wait has its
own deadline. JAX subscribers under port writers are in
test_torch_serve.py."""

import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.config import Config as JConfig
from shared_tensor_tpu.config import TransportConfig as JTransportConfig
from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
from shared_tensor_tpu_torch.comm import wire
from tests._ports import free_port
from tests.test_torch_peer import _leaves, wait_converged

TIERS = ("engine", "host", "device")
PORT_HOST_TIERS = ("engine", "host")
TOPOLOGIES = ("jax_master", "torch_master", "jax_torch_jax")
TORCH_CFG = Config(transport=TransportConfig(peer_timeout_sec=10.0))


@pytest.fixture(scope="module", autouse=True)
def _built():
    build_native()


def _jax_cfg(tier, max_children=2):
    return JConfig(
        native_engine=tier != "host",
        transport=JTransportConfig(peer_timeout_sec=10.0, max_children=max_children),
    )


def _check_tier(p, tier):
    if tier == "engine":
        assert p._engine is not None
    else:
        assert p._engine is None and p.st.host_tier == (tier == "host")


def _torch_peer(port, template, tier):
    """A port peer on ``tier``: device (device="cpu"), engine or host."""
    if tier == "device":
        return create_or_fetch("127.0.0.1", port, template, TORCH_CFG, device="cpu")
    cfg = Config(transport=TORCH_CFG.transport, native_engine=tier == "engine")
    return create_or_fetch("127.0.0.1", port, template, cfg, host_tier=True)


def _seed():
    return {"w": np.ones((16, 8), np.float32), "b": np.arange(8, dtype=np.float32)}


def _zeros(tree):
    return {k: np.zeros_like(v) for k, v in tree.items()}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_mixed_tree_converges(topology, tier, monkeypatch):
    _converge(topology, tier, "device", monkeypatch)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("port_tier", PORT_HOST_TIERS)
def test_mixed_tree_converges_port_host_tier(port_tier, topology, tier, monkeypatch):
    _converge(topology, tier, port_tier, monkeypatch)


def _converge(topology, tier, port_tier, monkeypatch):
    if tier == "device":
        monkeypatch.setenv("ST_HOST_CODEC", "xla")
    port = free_port()
    seed = _seed()
    peers = []
    try:
        if topology == "torch_master":
            peers.append(_torch_peer(port, seed, port_tier))
            peers.append(jax_create_or_fetch("127.0.0.1", port, _zeros(seed), _jax_cfg(tier)))
            jax_peers, torch_peer = peers[1:], peers[0]
        else:
            chain = topology == "jax_torch_jax"
            peers.append(jax_create_or_fetch("127.0.0.1", port, seed, _jax_cfg(tier, 1 if chain else 2)))
            peers.append(_torch_peer(port, _zeros(seed), port_tier))
            if chain:
                peers.append(jax_create_or_fetch("127.0.0.1", port, _zeros(seed), _jax_cfg(tier)))
            jax_peers, torch_peer = [peers[0], *peers[2:]], peers[1]
        for p in jax_peers:
            _check_tier(p, tier)
        _check_tier(torch_peer, port_tier)
        if topology == "jax_torch_jax":
            # the third peer hangs below the port peer: its traffic crosses it
            deadline = time.time() + 30
            while len(torch_peer.node.links) < 2 and time.time() < deadline:
                time.sleep(0.02)
            assert len(torch_peer.node.links) == 2 and len(peers[0].node.links) == 1
        wait_converged(peers, seed, timeout=60.0)
        rng = np.random.default_rng(len(peers))
        total = seed
        for p in peers:
            delta = {k: rng.uniform(-1, 1, v.shape).astype(np.float32) for k, v in seed.items()}
            p.add(delta)
            total = {k: total[k] + delta[k] for k in total}
        wait_converged(peers, total, timeout=60.0)
        m = torch_peer.metrics()
        assert m["st_frames_in_total"] > 0 and m["st_frames_out_total"] > 0
        assert m["st_unknown_msgs_total"] == 0
        assert torch_peer.threads_alive() and torch_peer._error is None
    finally:
        for p in reversed(peers):
            p.close()


def test_port_tiers_and_a_jax_engine_in_one_tree():
    """A port device-tier master, a port engine peer, a port Python
    host-tier peer and a JAX engine peer (the fourth below the master's two
    children): every replica converges."""
    port = free_port()
    seed = _seed()
    peers = []
    try:
        peers.append(_torch_peer(port, seed, "device"))
        peers.append(_torch_peer(port, _zeros(seed), "engine"))
        peers.append(_torch_peer(port, _zeros(seed), "host"))
        peers.append(jax_create_or_fetch("127.0.0.1", port, _zeros(seed), _jax_cfg("engine")))
        for p, tier in zip(peers, ("device", "engine", "host", "engine")):
            _check_tier(p, tier)
        wait_converged(peers, seed, timeout=60.0)
        rng = np.random.default_rng(7)
        total = seed
        for p in peers:
            delta = {k: rng.uniform(-1, 1, v.shape).astype(np.float32) for k, v in seed.items()}
            p.add(delta)
            total = {k: total[k] + delta[k] for k in total}
        wait_converged(peers, total, timeout=60.0)
        for p in peers[:3]:
            m = p.metrics()
            assert m["st_unknown_msgs_total"] == 0 and p.threads_alive() and p._error is None
    finally:
        for p in reversed(peers):
            p.close()


def test_port_parent_ignores_digest_and_clock_traffic():
    """A JAX child sends a metrics digest every 0.5 s and a clock probe every
    1 s up its uplink. The port parent no longer drops them: it merges the
    digests into its cluster view and answers the probes, so the child
    learns its clock offset; none of it is an unknown message, the link
    stays up (no re-graft) and the tree still syncs."""
    port = free_port()
    seed = _seed()
    with create_or_fetch("127.0.0.1", port, seed, TORCH_CFG, device="cpu") as parent:
        child = jax_create_or_fetch("127.0.0.1", port, _zeros(seed), _jax_cfg("engine"))
        try:
            wait_converged([child], seed)
            link, uplink = parent.node.links, child._uplink
            time.sleep(2.6)
            m = parent.metrics()
            assert m["st_digest_msgs_in_total"] >= 4, m  # >= 4 digests in 2.6 s
            assert m["st_unknown_msgs_total"] == 0
            assert str(child.node.obs_id) in parent.metrics(cluster=True)["nodes"]
            assert child._clock.known and child._clock.probes >= 2
            assert parent.node.links == link and child._uplink == uplink
            assert parent.threads_alive() and parent._error is None
            delta = {k: np.full(v.shape, 0.5, np.float32) for k, v in seed.items()}
            child.add(delta)
            wait_converged([parent, child], {k: seed[k] + 0.5 for k in seed})
        finally:
            child.close()


def test_port_joiner_refuses_what_it_lacks():
    """A JAX sharded joiner (``create_or_fetch_sharded``: a SYNC with
    SYNC_FLAG_SHARD and its shard claim) under a port classic parent is
    attached as a plain writer child, as JAX's classic peer attaches it:
    the WELCOME carries no shard flag, so the joiner falls back to a
    classic handle, and the two converge."""
    from shared_tensor_tpu.config import ShardConfig as JShardConfig
    from shared_tensor_tpu.shard import create_or_fetch_sharded as jax_sharded

    port = free_port()
    seed = _seed()
    with create_or_fetch("127.0.0.1", port, seed, TORCH_CFG, device="cpu") as parent:
        cfg = JConfig(transport=JTransportConfig(peer_timeout_sec=10.0), shard=JShardConfig(n_shards=4, shard_index=1))
        h = jax_sharded("127.0.0.1", port, _zeros(seed), cfg, timeout=30.0)
        try:
            assert not h.sharded
            delta = {k: np.full(v.shape, 0.5, np.float32) for k, v in seed.items()}
            h.add(delta)
            parent.add(delta)
            wait_converged([parent, h.peer], {k: seed[k] + 1.0 for k in seed})
        finally:
            h.close()
        assert parent.threads_alive() and parent._error is None


@pytest.mark.parametrize("tier", ("device", "engine"))
def test_port_sharded_joiner_falls_back_under_jax_parent(tier):
    """The mirror: a port ``create_or_fetch_sharded`` under a JAX classic
    parent falls back to a port classic peer on the tier asked for (the
    device tier by default, the engine with host_tier=True) and
    converges."""
    from shared_tensor_tpu_torch.config import ShardConfig
    from shared_tensor_tpu_torch.shard import create_or_fetch_sharded

    port = free_port()
    seed = _seed()
    parent = jax_create_or_fetch("127.0.0.1", port, seed, _jax_cfg("engine"))
    try:
        cfg = Config(transport=TORCH_CFG.transport, shard=ShardConfig(n_shards=4, shard_index=1))
        kw = {"device": "cpu"} if tier == "device" else {"host_tier": True}
        h = create_or_fetch_sharded("127.0.0.1", port, _zeros(seed), cfg, timeout=30.0, **kw)
        try:
            assert not h.sharded
            _check_tier(h.peer, tier)
            delta = {k: np.full(v.shape, 0.5, np.float32) for k, v in seed.items()}
            h.add(delta)
            parent.add(delta)
            wait_converged([parent, h.peer], {k: seed[k] + 1.0 for k in seed})
            view = h.torch_view(device="cpu")
            np.testing.assert_allclose(view[:8].numpy(), seed["b"] + 1.0, rtol=1e-4, atol=1e-6)
        finally:
            h.close()
    finally:
        parent.close()


@pytest.mark.parametrize("jax_tier", ("engine", "host"))
@pytest.mark.parametrize("port_tier", ("device", "host", "engine"))
def test_port_child_under_a_jax_parent_keeps_its_whole_carry(port_tier, jax_tier, monkeypatch):
    """A port child under the sever fault plan (test_torch_faults.py's)
    below a JAX parent. Its SYNCs carry the port's SYNC_FLAG_PREV_LINK and
    link tokens, which the JAX parent ignores; every WELCOME it gets back is
    the JAX package's own bytes, with no applied count, so the child keeps
    its whole carry at the re-join, as before the port had the flag, and
    the tree converges. The child's sends after its first wait until it has
    read the first one's ACK, so no applied frame is left in the carry and
    that path is exact here. An engine child's plan is its transport's
    (ST_FAULT_PLAN, around its creation): every data message on its first
    uplink is swallowed until the sever, so the parent applies none of
    them."""
    from shared_tensor_tpu.comm import wire as JW
    from shared_tensor_tpu_torch.comm import faults
    from shared_tensor_tpu_torch.comm.peer import SharedTensorPeer
    from shared_tensor_tpu_torch.config import FaultConfig

    syncs, welcomes = [], []
    encode_sync, on_message = wire.encode_sync, SharedTensorPeer._on_message
    monkeypatch.setattr(wire, "encode_sync", lambda *a, **k: syncs.append(encode_sync(*a, **k)) or syncs[-1])

    def on_msg(self, link, payload):
        if payload[0] == wire.WELCOME:
            welcomes.append(bytes(payload))
        return on_message(self, link, payload)

    monkeypatch.setattr(SharedTensorPeer, "_on_message", on_msg)
    port = free_port()
    seed = _seed()
    m = jax_create_or_fetch("127.0.0.1", port, seed, _jax_cfg(jax_tier))
    fault = FaultConfig(enabled=True, seed=11, stall_after_frames=1, sever_after_frames=4, only_link=1)
    if port_tier == "engine":
        env = faults.to_env(FaultConfig(enabled=True, seed=11, stall_after_frames=0, sever_after_frames=4,
                                        only_link=1))
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0, ack_timeout_sec=1.0))
    else:
        cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0, ack_timeout_sec=1.0), faults=fault,
                     native_engine=False)
    j = SharedTensorPeer("127.0.0.1", port, _zeros(seed), cfg,
                         **({"device": "cpu"} if port_tier == "device" else {"host_tier": True}))
    if port_tier == "engine":
        for k in env:
            monkeypatch.delenv(k)
    try:
        j.wait_ready(60.0)
        _check_tier(m, jax_tier)
        _check_tier(j, port_tier)
        wait_converged([j], seed)
        first = j._uplink
        sent, send = [], j._send_blocking

        def gated(link, payload, data=False):
            if data and link == first and len(sent) < 2:  # the second send waits, once
                deadline = time.time() + 30
                while sent and j._acked.get(first, 0) < 1 and time.time() < deadline:
                    time.sleep(0.005)
                sent.append(link)
            return send(link, payload, data)

        j._send_blocking = gated
        rng = np.random.default_rng(7)
        delta = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in seed.items()}
        j.add(delta)
        deadline = time.time() + 90
        while len(welcomes) < 2 and time.time() < deadline:
            time.sleep(0.02)  # the re-join (one burst may carry the whole delta at this tolerance)
        wait_converged([m, j], {k: seed[k] + delta[k] for k in seed}, tol=1e-5, timeout=90.0)
        if port_tier != "engine":
            assert j._faults.counts["severed"] >= 1 and j._faults.counts["stalled"] >= 1
        # the child named each uplink, and the severed one in the re-join
        tokens = [wire.sync_prev_link(s) for s in syncs]
        assert len(tokens) >= 2 and all(t is not None for t in tokens)
        assert tokens[1][1] == tokens[0][0] != 0
        # the JAX parent's WELCOMEs: its own encoder's bytes, no count
        assert len(welcomes) >= 2
        for w in welcomes:
            assert not wire.welcome_flags(w) & wire.SYNC_FLAG_PREV_LINK and wire.welcome_applied(w) is None
            assert w == JW.encode_welcome(JW.welcome_flags(w), JW.welcome_shm(w))
        got = j.metrics()
        assert got["st_carry_frames_rolled_total"] >= 1 and got["st_carry_frames_retracted_total"] == 0
    finally:
        j.close()
        m.close()
