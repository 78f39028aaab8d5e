"""Node ids are unique within one process across the two packages.

Every transport node takes an id of 12 pid bits and 12 local bits at
creation. The JAX package and the port each load their own transport
build, so each has its own local counter: the port's copy counts down from
0xFFF while ``native/`` counts up from 1, and the first node of each in one
process no longer takes the same id. The shard plane keys ownership by that
id, so with one shared id a JAX shard master took its port owner's shard
for its own and forwarded nothing to it.

An in-process test cannot show this once an earlier test has made a node,
so each body here runs first in a fresh interpreter, with a timeout of its
own. Tolerance of the mixed pair's gathers: 1e-3, as
``test_torch_shard.py``'s mixed cases.
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PRELUDE = """
import numpy as np
from shared_tensor_tpu.comm.transport import TransportNode as JNode
from shared_tensor_tpu_torch.comm.transport import TransportNode as PNode
from tests._ports import free_port
"""


def _fresh(body: str, timeout: float) -> None:
    code = _PRELUDE + textwrap.dedent(body)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_first_nodes_of_both_packages_take_distinct_ids(first):
    body = f"""
    makers = [("jax", JNode), ("port", PNode)]
    if {first!r} == "port":
        makers.reverse()
    nodes = {{name: make("127.0.0.1", free_port()) for name, make in makers}}
    ids = {{name: n.obs_id for name, n in nodes.items()}}
    for n in nodes.values():
        n.close()
    assert ids["jax"] != ids["port"], ids
    """
    _fresh(body, timeout=120)


def test_interleaved_nodes_keep_distinct_ids_within_24_bits():
    """Five nodes of each package, made in turns in one process: ten ids,
    each within the 24 bits a trace record's origin field holds, and the
    port's in its process's pid block as the reference's are."""
    body = """
    import os
    ids = {"jax": [], "port": []}
    for _ in range(5):
        for name, make in (("jax", JNode), ("port", PNode)):
            n = make("127.0.0.1", free_port())
            ids[name].append(n.obs_id)
            n.close()
    every = ids["jax"] + ids["port"]
    assert len(set(every)) == len(every), ids
    assert all(0 <= i < 1 << 24 for i in every), ids
    block = (os.getpid() & 0xFFF) << 12
    assert all(i & ~0xFFF == block for i in every), ids
    """
    _fresh(body, timeout=120)


@pytest.mark.parametrize("engine", [True, False], ids=["lane", "python"])
def test_jax_master_with_a_port_owner_first_in_its_process(engine):
    """A JAX lane master and one port owner (on the lane or on the Python
    plane) of a two-shard map, made first in their process: three rounds of
    adds on each, both drain, and both packages' gathers read the sum."""
    body = f"""
    import jax  # noqa: F401  (the JAX package needs its backend first)
    from shared_tensor_tpu.config import Config as JConfig
    from shared_tensor_tpu.config import ShardConfig as JShardConfig
    from shared_tensor_tpu.config import TransportConfig as JTransportConfig
    from shared_tensor_tpu.shard import ShardGather as JShardGather
    from shared_tensor_tpu.shard import create_or_fetch_sharded as jax_sharded
    from shared_tensor_tpu_torch.config import Config, ShardConfig, TransportConfig
    from shared_tensor_tpu_torch.shard import ShardGather, create_or_fetch_sharded

    tmpl = {{"w": np.zeros(4096, np.float32), "b": np.zeros(512, np.float32)}}
    port = free_port()
    jcfg = JConfig(shard=JShardConfig(n_shards=2, shard_index=0, engine_lane=True),
                   transport=JTransportConfig(peer_timeout_sec=20.0))
    pcfg = Config(shard=ShardConfig(n_shards=2, shard_index=1, engine_lane={engine!r}),
                  transport=TransportConfig(peer_timeout_sec=20.0))
    handles = [jax_sharded("127.0.0.1", port, tmpl, jcfg, timeout=30.0)]
    try:
        handles.append(create_or_fetch_sharded("127.0.0.1", port, tmpl, pcfg, timeout=30.0))
        assert all(h.sharded for h in handles)
        assert (handles[1].node._lane is not None) == {engine!r}
        jm, po = handles[0].node, handles[1].node
        rng = np.random.default_rng(24)
        ref = {{k: np.zeros_like(v) for k, v in tmpl.items()}}
        for _ in range(3):
            for h in handles:
                d = {{k: rng.standard_normal(v.size).astype(np.float32) for k, v in tmpl.items()}}
                for k in ref:
                    ref[k] += d[k]
                h.add(d)
        drained = [h.drain(timeout=30.0) for h in handles]
        assert drained == [True, True], (drained, jm.map.owners, po.map.owners)
        for source, gather in ((po, ShardGather), (jm, JShardGather)):
            with gather(source, tmpl) as g:
                tree = g.read_tree(max_staleness=60.0)
            for k in ref:
                np.testing.assert_allclose(tree[k], ref[k], atol=1e-3)
        assert jm.obs_id != po.obs_id, (jm.obs_id, po.obs_id)
    finally:
        for h in reversed(handles):
            h.close()
    """
    _fresh(body, timeout=240)
