"""State carry-over into the port: numpy pytrees, SharedTensor snapshots
and pod states.

A JAX ``SharedTensor.snapshot_all()`` gives (replica, {link: residual}) as
flat padded arrays; after ``np.asarray`` they carry straight into a port
``SharedTensor``, because both packages lay a table out identically (leaf
order, per-leaf padding to 1024, zero padding lanes). The checks here make
a layout disagreement an error instead of a silent misplacement of mass.
A JAX ``PeerSyncState`` holds [n_peer, total] arrays; a port rank holds one
block of one row of each (parallel/ici.py), and :func:`pod_state_from_numpy`
/ :func:`pod_state_to_numpy` carry a state across.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import CodecConfig
from .core import SharedTensor
from .ops.table import TableSpec, make_spec, tree_flatten, tree_unflatten
from .parallel.ici import PeerSyncState, gather_replica
from .parallel.mesh import Mesh, all_gather, rows_per_shard


def table_from_numpy(tree: Any) -> Any:
    """A numpy pytree -> the same tree of float32 CPU tensors (copies), in
    the structure and leaf order the port's ``make_spec`` uses."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(
        treedef, [torch.from_numpy(np.array(l, dtype=np.float32, copy=True)) for l in leaves]
    )


def _check_flat(name: str, arr: np.ndarray, spec: TableSpec) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.shape != (spec.total,):
        raise ValueError(f"{name} has shape {arr.shape}, layout needs ({spec.total},)")
    if arr.dtype != np.float32:
        raise ValueError(f"{name} has dtype {arr.dtype}, expected float32")
    # padding lanes are 0 by invariant; a buffer that violates it was laid
    # out differently (other leaf order or padding)
    live = (np.arange(128)[None, :] < spec.live_rowcount()[:, None]).reshape(-1)
    if np.any(arr[~live] != 0):
        raise ValueError(f"{name} has non-zero padding lanes: the layouts disagree")
    return arr


def shared_tensor_from_numpy(
    template: Any,
    values: np.ndarray,
    residuals: Mapping[int, np.ndarray],
    codec: CodecConfig | None = None,
    device=None,
) -> SharedTensor:
    """Build a port SharedTensor holding ``values`` as its replica and one
    link per entry of ``residuals`` — the arrays of a JAX
    ``SharedTensor.snapshot_all()`` after ``np.asarray``. ``template`` is
    the table's pytree (its shapes define the layout). Raises if a buffer's
    length or padding disagrees with the layout."""
    spec = make_spec(template)
    st = SharedTensor(template, codec=codec, seed_values=False, device=device)
    st.values = st._own(_check_flat("values", values, spec))
    for link_id, r in residuals.items():
        st.new_link(int(link_id), residual=_check_flat(f"residual {link_id}", r, spec))
    return st


def pod_state_from_numpy(values: np.ndarray, residual: np.ndarray, mesh: Mesh) -> PeerSyncState:
    """This rank's block of a JAX ``PeerSyncState``'s [n_peer, total]
    arrays (after ``np.asarray``): row ``mesh.peer``, block ``mesh.shard``,
    copied onto the mesh's device."""
    out = []
    for name, arr in (("values", values), ("residual", residual)):
        arr = np.asarray(arr)
        if arr.ndim != 2 or arr.shape[0] != mesh.n_peer or arr.dtype != np.float32:
            raise ValueError(f"{name} is {arr.dtype}{list(arr.shape)}, expected float32[{mesh.n_peer}, total]")
        n = rows_per_shard(arr.shape[1], mesh.n_shard) * 128
        block = arr[mesh.peer, mesh.shard * n : (mesh.shard + 1) * n]
        out.append(torch.from_numpy(block.copy()).to(mesh.device))
    return PeerSyncState(*out)


def pod_state_to_numpy(state: PeerSyncState, mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    """The inverse, on every rank (collective): the whole pod's (values,
    residual) as float32 [n_peer, total] arrays."""
    return tuple(
        all_gather(mesh, gather_replica(mesh, t), mesh.peer_group).wait().cpu().numpy()
        for t in state
    )
