"""Hierarchical tier: pods synced over their mesh's collectives inside,
bridged over the TCP peer tree outside.

The counterpart of ``shared_tensor_tpu/train/hierarchical.py``: each pod (a
mesh running ``PodTrainer``'s compressed sync) is ONE peer of the
self-organising TCP tree (comm/peer.py), the reference's multi-machine
scenario at pod granularity. Updates flow

  mesh peer --all-gather of 1-bit frames--> pod replica mean
  pod --TCP tree codec frames (1-bit, error feedback)--> other pods

with error feedback at both levels and no synchronisation between them: a
pod never waits for the tree, and other pods' deltas arrive whenever the
tree delivers them.

Bridge semantics (additive, order-free), as in the JAX package:

- push: the pod's training progress since the last push, the change of the
  pod-mean replica, is ``add()``ed into the tree like a worker's update;
- pull: what the tree delivered since the last pull (other pods' deltas,
  net of our own pushes) is applied to every mesh peer's values, residuals
  untouched: split horizon at the pod boundary.

The rank layout is the port's own. In JAX one process holds the whole pod
and its peer; here each mesh cell is a process, and cell (0, 0), the
**bridge rank**, holds the ``SharedTensorPeer`` and the bridge's
bookkeeping (full flat tables); the other ranks hold none. An exchange, on
every rank of the pod: the pod mean's block (an all-reduce over the peer
group, divided by ``n_peer``), joined over peer 0's shard group at the
bridge rank; there, the peer's snapshot, the pull delta and the ``add`` of
the push delta; the pull delta broadcast from the bridge rank to every
rank, each applying its block with ``apply_external``. So an exchange moves
two tables through the mesh's collectives (through pinned host buffers on
gloo with CUDA tensors), and the bridge rank's peer threads share its
interpreter with its training loop.

The mean's sum is the backend's all-reduce: with 2 peers it equals JAX's
``jnp.mean(axis=0)`` bit for bit; with more its order may differ, by at
most about ``n_peer * eps * max|value|``.

``create``, ``exchange`` (so every ``step`` that exchanges), ``read`` and
``close`` are collective over the pod's ranks.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from ..comm.peer import SharedTensorPeer, create_or_fetch
from ..ops.table import make_spec, unflatten
from ..parallel.ici import apply_external, gather_replica
from ..parallel.mesh import Mesh, all_reduce_, all_true, broadcast_from_root_
from ..utils.timing import Spans
from .async_sgd import PodTrainer


def _is_bridge(mesh: Mesh) -> bool:
    return mesh.peer == 0 and mesh.shard == 0


class HierarchicalTrainer:
    """Wraps a PodTrainer and, on the bridge rank, a SharedTensorPeer into
    one training-loop peer. ``sync_every`` pod steps between tree exchanges.

    Contract: at construction the pod replicas equal the peer-tier replica
    (the bridge tracks deltas on both sides from that common point). Use
    :meth:`create`, which seeds the pod from the one snapshot it records as
    seen, rather than wiring the pieces by hand.

    ``spans`` (utils/timing.Spans, None by default) receives marks in each
    exchange: ``mean`` (the pod mean's collectives), ``snapshot``, ``push``
    (both on the bridge rank only), ``broadcast``, ``apply_external``."""

    @classmethod
    def create(
        cls,
        mesh: Mesh,
        host: str,
        port: int,
        template: Any,
        loss_fn,
        sync_every: int = 1,
        peer_config=None,
        timeout: float = 30.0,
        pod_sync_every: int = 1,
        host_tier: bool = False,
        **pod_kwargs,
    ) -> "HierarchicalTrainer":
        """``create_or_fetch`` at pod granularity, on every rank of the pod:
        the bridge rank becomes the tree's master (seeded from ``template``)
        or joins it (the state streams in); either way it takes ONE snapshot
        of its replica, which seeds every rank's PodTrainer and is the
        bridge's record of what the pod has seen. Codec frames keep arriving
        after ``create_or_fetch`` returns (a joiner returns mid state
        transfer), so a second snapshot would count as seen frames the pod
        never got. The peer lives on the mesh's device, or with
        ``host_tier`` on the host tier (the CPU; the native engine unless
        ``peer_config.native_engine`` is False), whatever the mesh's device.

        ``sync_every`` is pod steps between TREE exchanges;
        ``pod_sync_every`` is pod steps between the pod's own sync steps
        (``PodTrainer.sync_every``)."""
        pod_kwargs.setdefault("sync_every", pod_sync_every)
        spec = make_spec(template)
        peer = snap = err = None
        if _is_bridge(mesh):
            try:
                peer = create_or_fetch(host, port, template, peer_config, timeout,
                                       device=None if host_tier else mesh.device, host_tier=host_tier)
                snap = peer.st.snapshot_flat().to(mesh.device)
            except Exception as e:  # raised below, after every rank has heard
                err = e
        if not all_true(mesh, err is None):
            if peer is not None:
                peer.close()
            raise err if err is not None else RuntimeError("the pod's bridge rank could not join the tree")
        if snap is None:
            snap = torch.empty(spec.total, dtype=torch.float32, device=mesh.device)
        broadcast_from_root_(mesh, snap)
        try:
            pod = PodTrainer(mesh, unflatten(snap, spec), loss_fn, **pod_kwargs)
            return cls(pod, peer, sync_every, _peer_seen=snap if peer is not None else None)
        except BaseException:
            if peer is not None:
                peer.close()
            raise

    def __init__(
        self,
        pod: PodTrainer,
        peer: Optional[SharedTensorPeer],
        sync_every: int = 1,
        _peer_seen: Optional[torch.Tensor] = None,
    ):
        """``peer`` on the bridge rank, None on the others. Collective."""
        self.is_bridge = _is_bridge(pod.mesh)
        if not all_true(pod.mesh, self.is_bridge == (peer is not None)):
            raise ValueError("the bridge rank, cell (0, 0), and only it, holds the peer")
        same = peer is None or peer.st.spec.layout_digest() == pod.spec.layout_digest()
        if not all_true(pod.mesh, same):
            raise ValueError("pod table layout != peer table layout")
        self.pod = pod
        self.peer = peer
        self.sync_every = max(1, int(sync_every))
        self.spans: Optional[Spans] = None
        # What the pod has already incorporated of the peer-tier replica,
        # and what the peer tier already has of the pod's progress (bridge
        # rank only). ``_peer_seen`` must be the exact snapshot the pod was
        # seeded from (create() passes it); the pod mean keeps the
        # invariant for manual wiring, where a fresh snapshot here would
        # silently absorb frames applied since the pod was seeded.
        mean = self._pod_mean()
        self._peer_seen = None if mean is None else (_peer_seen if _peer_seen is not None else mean.clone())
        self._pod_pushed = mean
        self.exchanges = 0

    def _mark(self, name: str) -> None:
        if self.spans is not None:
            self.spans.mark(name)

    def _pod_mean(self) -> Optional[torch.Tensor]:
        """The mean of the pod's replicas, flat, on the bridge rank (None on
        the others). Collective."""
        mesh = self.pod.mesh
        block = all_reduce_(mesh, self.pod.state.values.clone(), dist.ReduceOp.SUM, mesh.peer_group) / mesh.n_peer
        if mesh.peer != 0:
            return None
        full = gather_replica(mesh, block)
        return full if self.is_bridge else None

    def step(self, batch: Any, lr: float = 1e-2):
        losses, scales = self.pod.step(batch, lr)
        if self.pod.steps % self.sync_every == 0:
            self.exchange()
        return losses, scales

    def exchange(self) -> None:
        """One pull and push against the tree. Non-blocking beyond the
        pod's collectives: ``add`` enqueues into the link residuals and the
        peer's threads stream the frames."""
        if self.spans is not None:
            self.spans.start()
        mean = self._pod_mean()
        self._mark("mean")
        if self.is_bridge:
            # pull: tree progress since last seen (our own pushes are in
            # _peer_seen already, through the bookkeeping below)
            snap = self.peer.st.snapshot_flat().to(mean.device)
            incoming = snap - self._peer_seen
            self._mark("snapshot")
            # push: pod progress since the last push. Through the peer's
            # add, not st.add: it wakes the send loop, where st.add would
            # leave the frames waiting for the next keepalive tick.
            outgoing = mean - self._pod_pushed
            self.peer.add(unflatten(outgoing, self.pod.spec))
            self._mark("push")
            # the peer replica now holds our push; the pod is about to
            # hold the pull
            self._peer_seen = snap + outgoing
            self._pod_pushed = mean + incoming
        else:
            incoming = torch.empty(self.pod.spec.total, dtype=torch.float32, device=self.pod.mesh.device)
        broadcast_from_root_(self.pod.mesh, incoming)
        self._mark("broadcast")
        apply_external(self.pod.state, incoming, self.pod.mesh, self.pod.spec)
        self._mark("apply_external")
        self.exchanges += 1

    def read(self, peer: int = 0) -> Any:
        """Mesh peer ``peer``'s replica, on every rank (collective)."""
        return self.pod.read(peer)

    def close(self) -> None:
        """Leave the tree (the bridge rank closes its peer); every rank
        returns once the peer is closed. Collective."""
        if self.peer is not None:
            self.peer.close()
        all_true(self.pod.mesh, True)
