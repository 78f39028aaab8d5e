"""Async data-parallel SGD over the pod tier, in PyTorch.

The counterpart of ``shared_tensor_tpu/train/async_sgd.py``. The
reference's workload is N workers each looping {read the table; compute a
local update; add it} while peer updates stream in asynchronously; on a
pod, each peer of the mesh is one such worker, and a training step, on
every rank of the mesh, is

  1. the grads of this peer's replica on this peer's batch
     (``torch.autograd``; JAX vmaps over the peer axis, here each rank is
     one peer's replica). The flat replica is one leaf that requires grad
     and the model sees views of it, so the grad comes back as one flat
     buffer, 0 in the padding, exactly ``ops/table.flatten`` of the grads;
  2. ``add_updates``: the scaled update lands in the replica (visible at
     once) and in the outgoing residual;
  3. the compressed sync step (parallel/ici.py): kernel A, one all-gather
     over the peer group, kernel B.

With ``n_shard > 1`` a rank holds one block of its peer's replica, and the
grads need the whole replica: it is assembled with one all-gather over the
shard group before the forward pass, every shard of a peer computes the
same grads from the same batch, and each keeps its own block of them.

``overlap=True`` starts the all-gather of the CURRENT residual before the
grads and applies the gathered frames after them, so the collective runs
under the backward pass (with gloo, on the backend's threads); the local
update then rides the next step's frame. ``sync_every = k > 1`` runs k - 1
steps without exchange (updates pile up in the residual) and syncs their
sum as one frame on every k-th step.

``optimizer`` has optax's shape, applied per rank to the flat block:
``init(flat) -> state`` and ``update(grads, state, flat) -> (updates,
state)``; it must be elementwise, since it sees the padded flat buffer. The
package ships none, as the JAX package ships none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..config import CodecConfig, ScalePolicy
from ..ops.table import TableSpec, make_spec, tree_flatten, tree_unflatten, unflatten
from ..parallel.ici import (
    PeerSyncState,
    add_updates,
    block_range,
    build_sync_phases,
    build_sync_step,
    gather_replica,
    init_state,
    read_peer,
)
from ..parallel.mesh import Mesh, all_gather, all_reduce_
from ..utils.timing import Spans


def build_train_step(
    mesh: Mesh,
    spec: TableSpec,
    loss_fn: Callable[[Any, Any], torch.Tensor],
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
    compressed: bool = True,
    sync: bool = True,
    optimizer=None,
    overlap: bool = False,
    spans: Optional[Spans] = None,
):
    """``(state, opt_state, batch, lr) -> (state, opt_state, losses f32[n_peer],
    scales f32[n_peer, k])`` on every rank, the state updated in place.

    ``loss_fn(params, batch) -> scalar`` sees the table's pytree (views of
    the flat replica) and this peer's batch. ``sync=False`` is the
    no-communication arm (pure local SGD; scales are 0). With an
    ``optimizer``, ``lr`` is ignored. ``spans`` receives marks after the
    grads (``grads``), the optimizer and local add (``update``) and the loss
    gather (``losses``), and the sync step's own."""
    if overlap and (not sync or not compressed):
        raise ValueError("overlap=True requires sync=True and compressed=True")
    sync_step = build_sync_step(mesh, spec, policy, per_leaf, compressed, spans=spans) if sync and not overlap else None
    phases = build_sync_phases(mesh, spec, policy, per_leaf, spans=spans) if sync and overlap else None
    k = spec.num_leaves if per_leaf else 1
    lo, hi = block_range(mesh, spec)

    def mark(name: str) -> None:
        if spans is not None:
            spans.mark(name)

    def grads(values: torch.Tensor, batch) -> tuple[torch.Tensor, torch.Tensor]:
        flat = gather_replica(mesh, values).detach().requires_grad_(True)
        loss = loss_fn(unflatten(flat, spec), batch)
        (g,) = torch.autograd.grad(loss, flat)
        mark("grads")
        return loss.detach(), g[lo:hi]

    def updates(g, opt_state, values, lr):
        if optimizer is None:
            return g * -lr, opt_state
        return optimizer.update(g, opt_state, values)

    def step(state: PeerSyncState, opt_state, batch, lr: float):
        if spans is not None:
            spans.start()
        if phases is not None:
            send, apply_gathered = phases
            frames = send(state.residual)
            loss, g = grads(state.values, batch)
            u, opt_state = updates(g, opt_state, state.values, lr)
            apply_gathered(state.values, frames)
            add_updates(state, u)
            scales = frames.wait()[1]
            mark("update")
        else:
            loss, g = grads(state.values, batch)
            u, opt_state = updates(g, opt_state, state.values, lr)
            add_updates(state, u)
            mark("update")
            if sync_step is not None:
                state, scales = sync_step(state)
            else:
                scales = torch.zeros(mesh.n_peer, k, dtype=torch.float32, device=mesh.device)
        losses = all_gather(mesh, loss.reshape(1), mesh.peer_group).wait().reshape(-1)
        mark("losses")
        return state, opt_state, losses, scales

    return step


@dataclasses.dataclass
class PodTrainer:
    """This rank's share of a pod trainer: its block of its peer's replica
    and residual, and the step. Every rank of the mesh constructs one with
    the same arguments and calls each method the same number of times
    (the steps and :meth:`read`, :meth:`replica_spread` are collective).
    Every peer starts from ``template``."""

    mesh: Mesh
    template: Any
    loss_fn: Callable[[Any, Any], torch.Tensor]
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    compressed: bool = True
    sync: bool = True
    optimizer: Any = None  # optax-shaped, elementwise (see build_train_step)
    overlap: bool = False  # the collective under the backward pass
    #: Pod steps per sync exchange: with k > 1, k - 1 steps run without
    #: exchange (updates accumulate in the residual) and every k-th step
    #: syncs their sum as ONE frame.
    sync_every: int = 1

    def __post_init__(self):
        self.spec: TableSpec = make_spec(self.template)
        self.state: PeerSyncState = init_state(self.mesh, self.spec, self.template)
        self.n_peer: int = self.mesh.n_peer
        self.opt_state = None if self.optimizer is None else self.optimizer.init(self.state.values)
        self.sync_every = max(1, int(self.sync_every))
        kw = dict(
            policy=self.codec.scale_policy, per_leaf=self.codec.per_leaf_scale,
            compressed=self.compressed, optimizer=self.optimizer,
        )
        self._step = build_train_step(self.mesh, self.spec, self.loss_fn, sync=self.sync, overlap=self.overlap, **kw)
        # the off-beat step for sync_every > 1: no exchange
        self._step_local = (
            build_train_step(self.mesh, self.spec, self.loss_fn, sync=False, **kw)
            if self.sync and self.sync_every > 1
            else None
        )
        self.steps = 0

    def shard_batch(self, batch: Any) -> Any:
        """This peer's slice of a batch pytree whose leaves carry a leading
        [n_peer] axis, on the mesh's device."""
        leaves, treedef = tree_flatten(batch)
        return tree_unflatten(treedef, [torch.as_tensor(x[self.mesh.peer]).to(self.mesh.device) for x in leaves])

    def step(self, batch: Any, lr: float = 1e-2) -> tuple[torch.Tensor, torch.Tensor]:
        """One train step on this peer's ``batch`` (+ sync on every
        ``sync_every``-th call). Returns (per-peer losses f32[n_peer],
        per-peer-leaf scales f32[n_peer, k]), on every rank."""
        fn = self._step
        if self._step_local is not None and (self.steps + 1) % self.sync_every:
            fn = self._step_local
        self.state, self.opt_state, losses, scales = fn(self.state, self.opt_state, batch, lr)
        self.steps += 1
        return losses, scales

    def read(self, peer: int = 0) -> Any:
        """Peer ``peer``'s replica as the template's pytree, on every rank
        (collective)."""
        return read_peer(self.state, self.spec, self.mesh, peer)

    def add(self, updates: torch.Tensor) -> None:
        """Out-of-band additive update of this peer, flat f32[spec.total]
        (this rank adds its block)."""
        lo, hi = block_range(self.mesh, self.spec)
        add_updates(self.state, torch.as_tensor(updates).to(self.mesh.device)[lo:hi])

    def replica_spread(self) -> float:
        """Max abs deviation of any replica from the peer mean (0 when the
        replicas agree), on every rank (collective): an all-reduce of the
        replica block over the peer group for the mean, then the max over
        the mesh."""
        mesh = self.mesh
        v = self.state.values
        mean = all_reduce_(mesh, v.clone(), dist.ReduceOp.SUM, mesh.peer_group) / mesh.n_peer
        dev = (v - mean).abs().max().reshape(1)
        all_reduce_(mesh, dev, dist.ReduceOp.MAX, mesh.peer_group)
        all_reduce_(mesh, dev, dist.ReduceOp.MAX, mesh.shard_group)
        return float(dev)
