"""Checkpoint / resume of peers, pods and trainers, in the file formats of
``shared_tensor_tpu/utils/checkpoint.py``: a JAX checkpoint restores into
the port and a port checkpoint into the JAX package.

- :func:`save_shared` / :func:`load_shared`: a peer-tier ``SharedTensor``
  (either tier) or a peer's native ``EngineTensor``, the replica and every
  link residual in one ``.npz`` (keys ``values``, ``link_<id>``,
  ``layout``, ``meta``).
- :func:`save_pod` / :func:`load_pod` and :func:`save_trainer` /
  :func:`load_trainer`: a pod's state (and a ``PodTrainer``'s step count and
  optimizer state) as ``[n_peer, total]`` arrays in one ``.npz``, the shape
  the JAX package writes. A port rank holds only its block of one peer's
  row (parallel/ici.py), so a save gathers the blocks to cell (0, 0), which
  writes the file, and a load reads the file on every rank and keeps the
  rank's block. Optimizer leaves are stacked on a leading peer axis, as
  JAX's ``vmap(optimizer.init)`` gives them: a leaf shaped like the rank's
  block becomes ``[n_peer, total]``, any other leaf (Adam's step count)
  ``[n_peer, *shape]``.
- :func:`save_pod_sharded` / :func:`load_pod_sharded`: one file per rank,
  named as JAX names its device shards (``shard_p{r}_{p}-{p+1}_{lo}-{hi}.npz``,
  ``manifest_p{r}.npz``, and ``meta.npz`` from rank 0 with ``n_processes``
  the mesh's rank count), so no rank holds the whole table. A load builds
  each rank's block from the saved shards that cover it, so a directory
  restores onto a mesh with another shard count: JAX's loader slices one
  covering shard (a finer mesh); this one also joins several (a coarser
  mesh, such as JAX's 8 device shards onto a port mesh of 2 x 2).

The pod functions are collective over the mesh: every rank calls them with
the same arguments. Writes are atomic (a temporary file, then a rename).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..convert import pod_state_from_numpy
from ..core import SharedTensor
from ..ops.table import TableSpec, tree_flatten
from ..parallel.ici import PeerSyncState, block_range
from ..parallel.mesh import Mesh, all_true, gather_to

_FORMAT = 1


def _atomic_savez(path: str, **arrays) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


def _meta(z) -> dict:
    return json.loads(z["meta"].tobytes().decode())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# -- the peer tier -------------------------------------------------------------


def save_shared(st: SharedTensor, path: str) -> None:
    """Snapshot a peer-tier SharedTensor: the replica and every link
    residual, taken under one lock (``snapshot_all``) so that no frame
    tears the error-feedback invariant between them. On an EngineTensor
    the capture is one ``snapshot_ex`` under the engine's lock (the carry
    included, as link -1)."""
    values, links = st.snapshot_all()
    arrays = {"values": _host(values), "layout": _u8(st.spec.layout_digest())}
    for lid, r in links.items():
        arrays[f"link_{lid}"] = _host(r)
    arrays["meta"] = _u8(json.dumps({"format": _FORMAT, "links": list(links)}).encode())
    _atomic_savez(path, **arrays)


def load_shared(st: SharedTensor, path: str) -> None:
    """Restore into an existing SharedTensor (or EngineTensor) of the same
    layout. Residuals are restored for the links of the file that exist
    here; links opened since keep theirs. The carry pseudo-slot (a negative
    id, the peer's ``CARRY_LINK``) is recreated unconditionally: dropping it
    would present the restored mass as known to the tree at the next
    handshake."""
    with np.load(path) as z:
        if z["layout"].tobytes() != st.spec.layout_digest():
            raise ValueError(
                "checkpoint layout does not match this SharedTensor's table "
                "layout (different tree structure/shapes)"
            )
        values = z["values"]
        links = {lid: z[f"link_{lid}"] for lid in _meta(z).get("links", []) if f"link_{lid}" in z}
    st.restore_state(values, links)


# -- the pod tier: one file ------------------------------------------------------


def _gather_rows(mesh: Mesh, t: torch.Tensor, blocked: bool):
    """Every peer's ``t`` at cell (0, 0), as a numpy array with a leading
    peer axis, None elsewhere: each rank's block joined into the flat row
    (``blocked``), or shard 0's tensor of each peer. Collective."""
    rows = gather_to(mesh, t, mesh.rank_of(0, mesh.shard), mesh.peer_group)
    if mesh.peer != 0 or not blocked:
        return None if rows is None or mesh.shard != 0 else _host(rows)
    full = gather_to(mesh, rows, mesh.rank_of(0, 0), mesh.shard_group)  # [n_shard, n_peer, block]
    return None if full is None else _host(full.transpose(0, 1).reshape(mesh.n_peer, -1))


def _write_at_root(mesh: Mesh, path: str, arrays: dict) -> None:
    """Cell (0, 0) writes ``arrays``; every rank returns once the file is
    there, or raises if the write failed."""
    err = None
    if mesh.peer == 0 and mesh.shard == 0:
        try:
            _atomic_savez(path, **arrays)
        except Exception as e:  # raised below, after every rank has heard
            err = e
    if not all_true(mesh, err is None):
        raise err if err is not None else RuntimeError(f"writing {path} failed on cell (0, 0)")


def _pod_arrays(state: PeerSyncState, spec: TableSpec, mesh: Mesh) -> dict:
    return {
        "values": _gather_rows(mesh, state.values, True),
        "residual": _gather_rows(mesh, state.residual, True),
        "layout": _u8(spec.layout_digest()),
    }


def save_pod(state: PeerSyncState, spec: TableSpec, path: str, mesh: Mesh) -> None:
    """Snapshot the pod's state (every peer's replica and residual) as
    ``[n_peer, total]`` arrays, written by cell (0, 0). Collective."""
    arrays = _pod_arrays(state, spec, mesh)
    arrays["meta"] = _u8(json.dumps({"format": _FORMAT}).encode())
    _write_at_root(mesh, path, arrays)


def _read_pod(path: str, mesh: Mesh, spec: TableSpec, what: str):
    with np.load(path) as z:
        if z["layout"].tobytes() != spec.layout_digest():
            raise ValueError(f"checkpoint layout does not match the {what}")
        values, residual = z["values"], z["residual"]
        meta = _meta(z)
        opt = [z[f"opt_{i}"] for i in range(meta.get("opt_leaves", 0))]
    if values.shape[0] != mesh.n_peer:
        raise ValueError(f"checkpoint has {values.shape[0]} peers, the mesh has {mesh.n_peer}")
    return values, residual, meta, opt


def load_pod(path: str, mesh: Mesh, spec: TableSpec) -> PeerSyncState:
    """This rank's block of a :func:`save_pod` checkpoint's state. The peer
    count must be the mesh's (a different peer count is a join or a leave,
    not a restore)."""
    values, residual, _, _ = _read_pod(path, mesh, spec, "table spec")
    return pod_state_from_numpy(values, residual, mesh)


def save_trainer(trainer, path: str) -> None:
    """Snapshot a PodTrainer completely: the pod's state, the step count
    and, with an optimizer, its state, each leaf stacked over the peers (see
    the module docstring). Collective."""
    mesh = trainer.mesh
    arrays = _pod_arrays(trainer.state, trainer.spec, mesh)
    lo, hi = block_range(mesh, trainer.spec)
    leaves = [] if trainer.opt_state is None else tree_flatten(trainer.opt_state)[0]
    for i, leaf in enumerate(leaves):
        leaf = torch.as_tensor(leaf)
        arrays[f"opt_{i}"] = _gather_rows(mesh, leaf, tuple(leaf.shape) == (hi - lo,))
    meta = {"format": _FORMAT, "steps": trainer.steps, "opt_leaves": len(leaves)}
    arrays["meta"] = _u8(json.dumps(meta).encode())
    _write_at_root(mesh, path, arrays)


def load_trainer(trainer, path: str) -> None:
    """Restore a :func:`save_trainer` checkpoint into a PodTrainer of the
    same template, peer count and optimizer: the live optimizer state is
    the schema, and each of its leaves (tensors) receives this rank's part
    of the saved leaf in place. Every check runs before anything changes.
    Training continues bit for bit from the saved step."""
    mesh, spec = trainer.mesh, trainer.spec
    values, residual, meta, opt = _read_pod(path, mesh, spec, "trainer's table")
    live = [] if trainer.opt_state is None else tree_flatten(trainer.opt_state)[0]
    if trainer.opt_state is None and opt:
        raise ValueError("checkpoint carries optimizer state; the trainer has no optimizer")
    if len(live) != len(opt):
        raise ValueError(
            f"checkpoint has {len(opt)} optimizer leaves, the trainer's optimizer has "
            f"{len(live)}: a different optimizer?"
        )
    lo, hi = block_range(mesh, spec)
    parts = []
    for cur, new in zip(live, opt):
        if not isinstance(cur, torch.Tensor):
            raise ValueError(f"optimizer leaf {type(cur).__name__} is not a tensor; cannot restore in place")
        blocked = tuple(cur.shape) == (hi - lo,)
        want = (mesh.n_peer, spec.total) if blocked else (mesh.n_peer, *cur.shape)
        if tuple(new.shape) != want:
            raise ValueError(f"optimizer leaf shape {new.shape} != live {want}")
        parts.append(new[mesh.peer, lo:hi] if blocked else new[mesh.peer])
    trainer.state = pod_state_from_numpy(values, residual, mesh)
    for cur, part in zip(live, parts):
        cur.copy_(torch.from_numpy(np.array(part)))
    trainer.steps = int(meta.get("steps", 0))


# -- the pod tier: one file per rank ---------------------------------------------


def _shard_key(mesh: Mesh, spec: TableSpec) -> str:
    """The JAX package's name of this rank's shard of the [n_peer, total]
    state: its global index, ``{p}-{p+1}_{lo}-{hi}``."""
    lo, hi = block_range(mesh, spec)
    return f"{mesh.peer}-{mesh.peer + 1}_{lo}-{hi}"


def save_pod_sharded(state: PeerSyncState, spec: TableSpec, path: str, mesh: Mesh) -> None:
    """Per-rank snapshot of the pod state into directory ``path``: each
    rank writes its block of ``values`` and ``residual`` and its manifest,
    rank 0 the layout and shape. Collective; returns once every rank's
    files are written."""
    r = mesh.peer * mesh.n_shard + mesh.shard
    key = _shard_key(mesh, spec)
    err = None
    try:
        os.makedirs(path, exist_ok=True)
        # [1, hi - lo]: the shard of the [n_peer, total] arrays, as JAX writes it
        _atomic_savez(os.path.join(path, f"shard_p{r}_{key}.npz"), values=_host(state.values)[None],
                      residual=_host(state.residual)[None])
        _atomic_savez(os.path.join(path, f"manifest_p{r}.npz"), meta=_u8(json.dumps({"shards": [key]}).encode()))
        if r == 0:
            meta = {"format": _FORMAT, "n_processes": mesh.n_peer * mesh.n_shard}
            _atomic_savez(
                os.path.join(path, "meta.npz"), layout=_u8(spec.layout_digest()),
                shape=np.asarray((mesh.n_peer, spec.total), np.int64), meta=_u8(json.dumps(meta).encode()),
            )
    except Exception as e:  # raised below, after every rank has heard
        err = e
    if not all_true(mesh, err is None):
        raise err if err is not None else RuntimeError(f"save_pod_sharded into {path} failed on another rank")


def load_pod_sharded(path: str, mesh: Mesh, spec: TableSpec) -> PeerSyncState:
    """This rank's block of a :func:`save_pod_sharded` directory (the
    port's or the JAX package's), built from the saved shards that cover
    it, one file at a time. Only the files that the saving processes'
    manifests list are read: stale shards of an earlier save with another
    sharding are never served."""
    with np.load(os.path.join(path, "meta.npz")) as z:
        if z["layout"].tobytes() != spec.layout_digest():
            raise ValueError("checkpoint layout does not match the table spec")
        shape = tuple(int(x) for x in z["shape"])
        meta = _meta(z)
    if shape[0] != mesh.n_peer:
        raise ValueError(f"checkpoint has {shape[0]} peers, the mesh has {mesh.n_peer}")
    lo, hi = block_range(mesh, spec)
    out = {f: np.empty(hi - lo, np.float32) for f in ("values", "residual")}
    covered = np.zeros(hi - lo, bool)
    for pi in range(int(meta.get("n_processes", 1))):
        with np.load(os.path.join(path, f"manifest_p{pi}.npz")) as z:
            keys = _meta(z)["shards"]
        for key in keys:
            (p0, p1), (c0, c1) = (tuple(int(v) for v in part.split("-")) for part in key.split("_"))
            a, b = max(lo, c0), min(hi, c1)
            if not p0 <= mesh.peer < p1 or a >= b:
                continue
            with np.load(os.path.join(path, f"shard_p{pi}_{key}.npz")) as z:
                for f, arr in out.items():
                    arr[a - lo : b - lo] = z[f][mesh.peer - p0, a - c0 : b - c0]
            covered[a - lo : b - lo] = True
    if not covered.all():
        raise ValueError(
            f"no saved shards cover peer {mesh.peer} [{lo}, {hi}): checkpoint written with an incompatible sharding"
        )
    return PeerSyncState(*(torch.from_numpy(out[f]).to(mesh.device) for f in ("values", "residual")))
