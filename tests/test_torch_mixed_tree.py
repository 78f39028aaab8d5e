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
own deadline."""

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
    1 s up its uplink. A port parent counts and drops them for several
    intervals: the link stays up (no re-graft) and the tree still syncs."""
    port = free_port()
    seed = _seed()
    with create_or_fetch("127.0.0.1", port, seed, TORCH_CFG, device="cpu") as parent:
        child = jax_create_or_fetch("127.0.0.1", port, _zeros(seed), _jax_cfg("engine"))
        try:
            wait_converged([child], seed)
            link, uplink = parent.node.links, child._uplink
            time.sleep(2.6)
            m = parent.metrics()
            assert m["st_ctrl_ignored_total"] >= 4, m  # >= 4 digests + 2 probes in 2.6 s
            assert m["st_unknown_msgs_total"] == 0
            assert parent.node.links == link and child._uplink == uplink
            assert parent.threads_alive() and parent._error is None
            delta = {k: np.full(v.shape, 0.5, np.float32) for k, v in seed.items()}
            child.add(delta)
            wait_converged([parent, child], {k: seed[k] + 0.5 for k in seed})
        finally:
            child.close()


def test_port_joiner_refuses_what_it_lacks():
    """A JAX joiner that asks for a feature the port does not serve (here a
    read-only subscriber's SYNC) gets a REJECT that names it; the port
    parent carries on."""
    from shared_tensor_tpu.comm.transport import TransportNode as JaxNode
    from shared_tensor_tpu.comm import wire as JW
    from shared_tensor_tpu.ops.table import make_spec as jax_make_spec

    port = free_port()
    seed = _seed()
    with create_or_fetch("127.0.0.1", port, seed, TORCH_CFG, device="cpu") as parent:
        with JaxNode("127.0.0.1", port, JTransportConfig(peer_timeout_sec=10.0)) as node:
            deadline = time.time() + 30
            while node.uplink is None and time.time() < deadline:
                time.sleep(0.01)
            sync = JW.encode_sync(jax_make_spec(seed), 2, flags=wire.SYNC_FLAG_READ_ONLY)
            assert node.send(node.uplink, sync)
            reply = None
            while reply is None and time.time() < deadline:
                try:
                    reply = node.recv(node.uplink, timeout=0.1)
                except BrokenPipeError:
                    break
            assert reply is not None and reply[0] == JW.REJECT
            assert "read-only subscribers" in JW.decode_reject(reply)
        assert parent.threads_alive() and parent._error is None
        np.testing.assert_array_equal(_leaves(parent.read())[0], seed["b"])
