"""The cluster-sharded tensor: shard ownership, owner-routed updates, and a
cluster-wide ``createOrFetch``.

The counterpart of ``shared_tensor_tpu/shard/``: the same shard map and
ranges, the same slice-codec frames and residuals bit for bit, the same
FWD, SHARD, SYNC-tail and WELCOME bytes and the same shard-state files, so
port and JAX nodes form one sharded cluster in any role.

The classic protocol converges EVERY node on the WHOLE table, so cluster
memory and per-link bytes scale with model size. This package changes the
core invariant: the table's word space is partitioned into
``ShardConfig.n_shards`` contiguous ranges, every word has exactly one
owner node, and the cluster converges on the union of the owned slices,
so per-node memory is O(total / n_shards) (shard-local apply and
owner-routed forwarding: reduce-scatter and all-gather decomposed over the
asynchronous tree).

Layers:

- :mod:`.map`: the partition and the epoch-merged owner directory;
- :mod:`.state`: shard-local arrays (owned slices, per-subscriber
  residuals, per-target-shard outboxes) and the word-range slice codec;
- :mod:`.engine_lane`: the native FWD plane (``st_shard_*`` in the port's
  ``libstengine``);
- :mod:`.node`: the cluster member: capability hello, claim and grant,
  the ledgered FWD plane with end-to-end dedup, relay routing, subscriber
  serving, drain-handoff, restart-restore;
- :mod:`.gather`: the reader's asynchronous all-gather over ranged
  subscriptions.

The shard plane is host code on every tier, as JAX's is (numpy and the
native lane). The card comes in at two places: :meth:`ShardHandle.
torch_view` copies a verified gather to it, and the classic fallback of
:func:`create_or_fetch_sharded` runs a peer on it (``device``), whose
frames go through kernels A and B.

Entry point: :func:`create_or_fetch_sharded`, the sharded twin of
``create_or_fetch``. Joining an unsharded tree (a port or JAX classic
peer) returns a CLASSIC full-replica peer, so a sharded binary
interoperates with any existing deployment. ``ST_SHARD=0`` pins the
classic protocol end to end.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..config import Config
from .gather import ShardGather
from .map import OwnerEntry, ShardMap
from .node import (
    ShardBackpressure,
    ShardFallback,
    ShardNode,
    ShardRejected,
    shard_enabled,
)
from .state import ShardState, SliceCodec

__all__ = [
    "OwnerEntry",
    "ShardMap",
    "ShardState",
    "SliceCodec",
    "ShardNode",
    "ShardGather",
    "ShardBackpressure",
    "ShardFallback",
    "ShardRejected",
    "ShardHandle",
    "create_or_fetch_sharded",
    "shard_enabled",
]


class ShardHandle:
    """The user-facing handle ``create_or_fetch_sharded`` returns.

    ``sharded`` is True when the node joined (or created) a sharded
    cluster; False when the tolerant fallback attached a classic
    full-replica peer instead (an unsharded tree, n_shards=0, or
    ST_SHARD=0). Same API either way, so callers do not branch."""

    def __init__(self, node=None, peer=None, template=None, config=None):
        if (node is None) == (peer is None):
            raise ValueError("exactly one of node/peer")
        self._node: Optional[ShardNode] = node
        self._peer = peer
        self._template = template
        self._config = config or Config()

    @property
    def sharded(self) -> bool:
        return self._node is not None

    @property
    def node(self) -> ShardNode:
        if self._node is None:
            raise RuntimeError("classic-fallback handle has no ShardNode")
        return self._node

    @property
    def peer(self):
        if self._peer is None:
            raise RuntimeError("sharded handle has no classic peer")
        return self._peer

    def add(self, delta: Any) -> None:
        (self._node or self._peer).add(delta)

    def drain(self, timeout: float = 60.0, tol: float = 0.0) -> bool:
        return (self._node or self._peer).drain(timeout=timeout, tol=tol)

    def gather(self, elements: Optional[tuple[int, int]] = None, timeout: float = 30.0) -> ShardGather:
        """An asynchronous all-gather view over the cluster (sharded
        handles only: a classic peer already holds the full replica; read
        it)."""
        return ShardGather(self.node, self._template, self._config, elements=elements, timeout=timeout)

    def read(self, max_staleness: Optional[float] = None) -> Any:
        """The full table as the caller's tree. Classic fallback: the local
        replica (exactly ``peer.read()``, tensors on the peer's device).
        Sharded: a verified gather across the owners (numpy leaves, the
        staleness bound checked per shard).

        Each call builds and tears down one subscription per owner: a loop
        that reads repeatedly should hold ONE :meth:`gather` open and pay
        the N-leg join once."""
        if self._peer is not None:
            return self._peer.read()
        with self.gather() as g:
            return g.read_tree(max_staleness)

    def torch_view(self, max_staleness: Optional[float] = None, device=None) -> torch.Tensor:
        """The table as ONE flat f32 tensor (the padded layout) on
        ``device``: the GPU when None (raising without one), the CPU when
        asked. Sharded: a verified gather taken at one instant and copied
        to the device, not a live view of the owners' state. Fallback: the
        local replica, flattened on the device. This takes the place of
        JAX's ``jax_view``, whose ``NamedSharding`` over the local devices
        has no single-tensor counterpart without a process group; on one
        card the view is one tensor."""
        from ..core import resolve_device
        from ..ops.table import flatten, make_spec

        dev = resolve_device(device)
        if self._peer is not None:
            return flatten(self._peer.read(), make_spec(self._template), device=dev)
        with self.gather() as g:
            flat, _worst = g.read(max_staleness)
        return torch.from_numpy(np.ascontiguousarray(flat, np.float32)).to(dev)

    def close(self) -> None:
        (self._node or self._peer).close()

    def leave(self, timeout: float = 60.0) -> bool:
        if self._node is not None:
            return self._node.leave(timeout=timeout)
        return self._peer.leave(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def create_or_fetch_sharded(
    host: str,
    port: int,
    template: Any,
    config: Config | None = None,
    timeout: float = 30.0,
    device=None,
    host_tier: bool = False,
) -> ShardHandle:
    """The sharded ``createOrFetch``: create the cluster-sharded tensor at
    ``host:port`` (becoming master and minting the shard map) or join it
    (claiming ``ShardConfig.shard_index``). Falls back to the CLASSIC
    full-replica protocol, returning a working handle either way, when
    sharding is off (``n_shards=0`` / ``ST_SHARD=0``) or the existing tree
    is not sharded. The fallback peer is the port's ``create_or_fetch``
    with ``device`` and ``host_tier``: by default a peer on the GPU."""
    from ..comm.peer import create_or_fetch

    cfg = config or Config()
    if cfg.shard.n_shards <= 0 or not shard_enabled():
        peer = create_or_fetch(host, port, template, cfg, timeout, device=device, host_tier=host_tier)
        return ShardHandle(peer=peer, template=template, config=cfg)
    deadline = time.monotonic() + timeout
    node = ShardNode(host, port, template, cfg)
    try:
        node.wait_ready(timeout)
    except ShardFallback:
        node.close()
        peer = create_or_fetch(
            host, port, template, cfg, max(1.0, deadline - time.monotonic()), device=device, host_tier=host_tier,
        )
        return ShardHandle(peer=peer, template=template, config=cfg)
    except BaseException:
        node.close()
        raise
    return ShardHandle(node=node, template=template, config=cfg)
