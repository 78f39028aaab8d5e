"""The port's binding of the native transport (shared_tensor_tpu_torch.comm.
transport), held to the JAX package's transport tests: tree formation,
framed streaming, a redirected joiner, link death and survival. Loopback
nodes in one process; messages are opaque bytes at this layer.

The port's library is its own build of native/sttransport.cpp
(shared_tensor_tpu_torch/_build.py), so a mixed JAX/torch tree also
interoperates at this layer: the last test joins a JAX node under a
port master and moves bytes both ways."""

import time

import pytest

from shared_tensor_tpu_torch import _build
from shared_tensor_tpu_torch.comm.transport import EventKind, TransportNode
from shared_tensor_tpu_torch.config import TransportConfig
from tests._ports import free_port


def _wait(cond, timeout=30.0, step=0.01):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        time.sleep(step)
    return False


def _recv(node, link, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = node.recv(link, timeout=0.1)
        if got:
            return got
    return None


CFG = TransportConfig(peer_timeout_sec=10.0)


def test_build_goes_to_the_port_and_is_cached():
    path = _build.build_transport()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert _build.NATIVE_DIR not in path.parents
    assert _build.build_transport() == path  # no second compile


def test_master_election_and_join():
    port = free_port()
    with TransportNode("127.0.0.1", port, CFG) as master:
        assert master.is_master
        assert master.listen_port == port
        with TransportNode("127.0.0.1", port, CFG) as joiner:
            assert not joiner.is_master
            assert _wait(lambda: joiner.uplink is not None)
            assert _wait(lambda: len(master.links) == 1)
            ev = master.poll_events(timeout=1.0)
            assert any(e.kind == EventKind.LINK_UP for e in ev)


def test_frame_roundtrip():
    port = free_port()
    with TransportNode("127.0.0.1", port, CFG) as a, TransportNode("127.0.0.1", port, CFG) as b:
        assert _wait(lambda: b.uplink is not None and len(a.links) == 1)
        la, lb = a.links[0], b.uplink
        payload = b"\x01\x02\x03" * 100
        assert a.send(la, payload)
        assert _recv(b, lb) == payload
        # a writable buffer goes through without a copy to bytes
        assert b.send(lb, bytearray(b"pong"))
        assert _recv(a, la) == b"pong"
        st = a.stats(la)
        assert st.frames_out >= 1 and st.frames_in >= 1


def test_tree_redirect_third_joiner():
    """max_children=2: the third joiner is redirected below a child."""
    port = free_port()
    nodes = [TransportNode("127.0.0.1", port, CFG) for _ in range(4)]
    try:
        assert _wait(lambda: all(n.uplink is not None for n in nodes[1:]), timeout=30)
        assert _wait(
            lambda: len(nodes[0].links) == 2
            and sum(len(n.links) - (0 if n.is_master else 1) for n in nodes) == 3,
            timeout=30,
        )
    finally:
        for n in nodes:
            n.close()


def test_link_down_event_and_survival():
    """A dying joiner does not take the master with it, and the master
    still accepts joiners afterwards."""
    port = free_port()
    cfg = TransportConfig(peer_timeout_sec=10.0, max_rejoin_attempts=1)
    master = TransportNode("127.0.0.1", port, cfg)
    joiner = TransportNode("127.0.0.1", port, cfg)
    try:
        assert _wait(lambda: len(master.links) == 1)
        master.poll_events(timeout=0.5)
        joiner.close()
        assert _wait(
            lambda: any(e.kind == EventKind.LINK_DOWN for e in master.poll_events(timeout=0.2)),
            timeout=30,
        )
        assert master.links == []
        j2 = TransportNode("127.0.0.1", port, cfg)
        try:
            assert _wait(lambda: len(master.links) == 1)
        finally:
            j2.close()
    finally:
        master.close()


def test_closed_node_introspection_is_empty():
    port = free_port()
    node = TransportNode("127.0.0.1", port, CFG)
    node.close()
    assert node.links == [] and node.uplink is None and node.stats(1) is None
    node.drop_link(1)  # a no-op, never a native call on a null handle


def test_close_waits_for_a_call_in_progress_on_another_thread():
    """A close on one thread while another thread is inside a native call
    on the node (the TSan arm's report: st_node_close freed the node under
    st_node_links) frees the node only after that call has returned; the
    calls that follow see a closed node."""
    import threading

    port = free_port()
    node = TransportNode("127.0.0.1", port, CFG)
    lib, order, inside = node._lib, [], threading.Event()

    class SlowLinks:
        def __getattr__(self, name):
            return getattr(lib, name)

        def st_node_links(self, h, arr, cap):
            inside.set()
            time.sleep(0.3)
            order.append("links returned")
            return lib.st_node_links(h, arr, cap)

        def st_node_close(self, h):
            order.append("close")
            return lib.st_node_close(h)

    node._lib = SlowLinks()
    t = threading.Thread(target=lambda: node.links)
    t.start()
    assert inside.wait(5.0)
    node.close()
    t.join()
    assert order == ["links returned", "close"]
    assert node.links == [] and node.poll_events() == []
    with pytest.raises(BrokenPipeError):
        node.recv(1)
    with pytest.raises(BrokenPipeError):
        node.send(1, b"x")


def test_unported_transport_knobs_are_type_errors():
    with pytest.raises(ValueError):
        TransportConfig(stripe_count=9)
    with pytest.raises(ValueError):
        TransportConfig(max_children=0)


def test_port_and_jax_nodes_share_a_tree():
    """A JAX transport node joins under a port master: both libraries speak
    the same join walk and framing, and bytes cross both ways."""
    from shared_tensor_tpu.comm.transport import TransportNode as JaxNode
    from shared_tensor_tpu.comm.transport import build_native
    from shared_tensor_tpu.config import TransportConfig as JaxTransportConfig

    build_native()
    port = free_port()
    with TransportNode("127.0.0.1", port, CFG) as master, JaxNode(
        "127.0.0.1", port, JaxTransportConfig(peer_timeout_sec=10.0)
    ) as j:
        assert master.is_master and not j.is_master
        assert _wait(lambda: j.uplink is not None and len(master.links) == 1)
        assert master.send(master.links[0], b"down")
        assert _recv(j, j.uplink) == b"down"
        assert j.send(j.uplink, b"up")
        assert _recv(master, master.links[0]) == b"up"
