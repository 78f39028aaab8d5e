"""State carry-over into the port: numpy pytrees and SharedTensor snapshots.

A JAX ``SharedTensor.snapshot_all()`` gives (replica, {link: residual}) as
flat padded arrays; after ``np.asarray`` they carry straight into a port
``SharedTensor``, because both packages lay a table out identically (leaf
order, per-leaf padding to 1024, zero padding lanes). The checks here make
a layout disagreement an error instead of a silent misplacement of mass.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import CodecConfig
from .core import SharedTensor
from .ops.table import TableSpec, make_spec, tree_flatten, tree_unflatten


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
