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
- The cluster lifecycle's consistent-cut snapshot: :func:`save_cluster_shard`
  / :func:`load_cluster_shard`, one ``shard_<name>.npz`` per node (keys
  ``values``, ``layout``, ``resid_<id>``, ``meta``), and
  :func:`write_manifest` / :func:`verify_manifest`, the root's
  ``MANIFEST.json`` with each shard's sha256. These take numpy arrays: the
  caller brings tensors to the host. A shard or a manifest either package
  writes loads and verifies in the other.
- The cluster-sharded tensor's node state: :func:`save_shard_state` /
  :func:`load_shard_state`, one ``shard_<name>.npz`` per node (keys
  ``owned_<k>``, ``outbox_<k>``, ``layout``, and ``meta`` with ``"kind":
  "shard_state"``) holding the node's owned slices, its outbox residuals,
  its end-to-end dedup windows and its fwd_seq, and
  :func:`verify_shard_coverage`, the manifest audit that every shard was
  owned by exactly one node at the capture.

The pod functions are collective over the mesh: every rank calls them with
the same arguments. Writes are atomic (a temporary file, then a rename).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Optional

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


# -- the cluster lifecycle: one shard per node, the root's manifest ----------------
#
# One consistent-cut snapshot of a tree is one shard file per node and
# MANIFEST.json at the root. A shard holds what the quiesce barrier froze:
# the replica, every writer link's error-feedback residual, the re-graft
# carry, and each link's role, wire seqs at the cut and precision.
# Subscriber links keep their meta only: a read-only leaf re-seeds from
# scratch on restore. The per-link seqs are for post-mortem reading; link
# ids are node-local, so the audit does not pair them.

MANIFEST_NAME = "MANIFEST.json"


def shard_filename(node_name: str) -> str:
    """The shard file of a node name (sanitized: names land in filenames)."""
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in str(node_name))
    return f"shard_{safe}.npz"


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_cluster_shard(
    dirpath: str,
    node_name: str,
    snap_id: str,
    layout_digest: bytes,
    values: np.ndarray,
    links: list[dict],
    wire_version: int = 0,
) -> dict:
    """Write one node's shard. ``links`` entries: ``{"id", "role" ("up",
    "child", "sub" or "carry"), "tx_seq", "rx_count", "prec", "resid" (an
    f32 array or None)}``. Returns the manifest entry ``{"node", "file",
    "sha256", "bytes", "links"}``."""
    os.makedirs(dirpath, exist_ok=True)
    fname = shard_filename(node_name)
    path = os.path.join(dirpath, fname)
    arrays = {"values": np.ascontiguousarray(values, np.float32), "layout": _u8(layout_digest)}
    meta_links = []
    for entry in links:
        lid = int(entry["id"])
        resid = entry.get("resid")
        if resid is not None:
            arrays[f"resid_{lid}"] = np.ascontiguousarray(resid, np.float32)
        meta_links.append({
            "id": lid,
            "role": entry.get("role", "child"),
            "tx_seq": int(entry.get("tx_seq", 0)),
            "rx_count": int(entry.get("rx_count", 0)),
            "prec": int(entry.get("prec", 1)),
            "has_resid": resid is not None,
        })
    arrays["meta"] = _u8(json.dumps({
        "format": _FORMAT,
        "kind": "cluster_shard",
        "snap_id": str(snap_id),
        "node": str(node_name),
        "wire_version": int(wire_version),
        "time": time.time(),
        "links": meta_links,
    }).encode())
    _atomic_savez(path, **arrays)
    return {
        "node": str(node_name),
        "file": fname,
        "sha256": file_sha256(path),
        "bytes": os.path.getsize(path),
        "links": meta_links,
    }


def load_cluster_shard(path: str) -> dict:
    """Read a shard back: ``{"values", "layout", "meta", "links": {id:
    {"role", "tx_seq", "rx_count", "prec", "resid" (or None)}}}``."""
    with np.load(path) as z:
        meta = _meta(z)
        if meta.get("kind") != "cluster_shard":
            raise ValueError(f"{path} is not a cluster shard")
        values = np.asarray(z["values"], np.float32)
        layout = z["layout"].tobytes()
        links: dict[int, dict] = {}
        for entry in meta.get("links", []):
            lid = int(entry["id"])
            links[lid] = dict(entry)
            key = f"resid_{lid}"
            links[lid]["resid"] = np.asarray(z[key], np.float32) if entry.get("has_resid") and key in z else None
    return {"values": values, "layout": layout, "meta": meta, "links": links}


def restore_carry_from_shard(shard: dict) -> Optional[np.ndarray]:
    """The re-graft carry a restarted node re-joins with: its checkpointed
    uplink residual plus any checkpointed carry. Only up-flow mass rides
    the carry; child-link residuals are dropped, because the children's own
    re-join diff handshakes re-derive the down-flow they are missing
    (summing both directions into one carry would deliver an add twice)."""
    out = None
    for entry in shard["links"].values():
        if entry.get("role") in ("up", "carry") and entry.get("resid") is not None:
            r = np.asarray(entry["resid"], np.float32)
            out = r if out is None else out + r
    return out


def atomic_write_json(path: str, doc: dict) -> str:
    """A JSON write through a temporary file and a rename: the manifest,
    the peer's ctl result and the CLI's command file all go through it."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def write_manifest(dirpath: str, snap_id: str, entries: list[dict], extra: Optional[dict] = None) -> str:
    doc = {
        "format": _FORMAT,
        "kind": "cluster_manifest",
        "snap_id": str(snap_id),
        "time": time.time(),
        "nodes": sorted(entries, key=lambda e: e["node"]),
    }
    if extra:
        doc.update(extra)
    return atomic_write_json(os.path.join(dirpath, MANIFEST_NAME), doc)


def load_manifest(dirpath: str) -> dict:
    with open(os.path.join(dirpath, MANIFEST_NAME)) as f:
        doc = json.load(f)
    if doc.get("kind") != "cluster_manifest":
        raise ValueError(f"{dirpath} holds no cluster manifest")
    return doc


def verify_manifest(dirpath: str) -> list[str]:
    """Audit a snapshot directory against its manifest: the manifest
    parses, every shard is there and every sha256 matches. Returns the
    problems ([] = clean)."""
    problems: list[str] = []
    try:
        doc = load_manifest(dirpath)
    except (OSError, ValueError) as e:
        return [f"manifest unreadable: {e}"]
    for entry in doc.get("nodes", []):
        path = os.path.join(dirpath, entry["file"])
        if not os.path.exists(path):
            problems.append(f"{entry['node']}: shard {entry['file']} missing")
            continue
        digest = file_sha256(path)
        if digest != entry.get("sha256"):
            problems.append(f"{entry['node']}: shard digest mismatch ({digest[:12]} != {entry.get('sha256', '')[:12]})")
    return problems


# -- the cluster-sharded tensor: one node's shard state ------------------------
#
# The payload is the sharded memory model, not a full replica: the node's
# OWNED slices (word ranges of the global table), its per-target-shard
# OUTBOX residuals (out-of-shard mass not yet delivered, owed to other
# owners: dropping it at a restart would lose cluster mass), its
# per-origin END-TO-END dedup windows (without them a restart re-applies
# any frame that was delivered but not acknowledged at the kill), and its
# fwd_seq high-water mark. MANIFEST.json rows record, under ``shards``,
# which word ranges each node owned at the capture, so the audit can check
# that every shard was owned exactly once before a snapshot is trusted.


def save_shard_state(
    dirpath: str,
    node_name: str,
    layout_digest: bytes,
    owned: dict,
    outboxes: dict,
    dedup: dict,
    fwd_seq: int,
) -> dict:
    """Write one sharded node's checkpoint. ``owned`` maps shard index ->
    (word_lo, word_cnt, values f32); ``outboxes`` maps shard index ->
    (word_lo, residual f32); ``dedup`` maps origin (str) -> sorted seq
    list. Returns the MANIFEST.json entry (``{"node", "file", "sha256",
    "bytes", "shards"}``)."""
    os.makedirs(dirpath, exist_ok=True)
    fname = shard_filename(node_name)
    path = os.path.join(dirpath, fname)
    arrays = {"layout": _u8(layout_digest)}
    shard_meta = []
    for k, (wlo, wcnt, vals) in sorted(owned.items()):
        arrays[f"owned_{int(k)}"] = np.ascontiguousarray(vals, np.float32)
        shard_meta.append({"shard": int(k), "word_lo": int(wlo), "word_cnt": int(wcnt)})
    outbox_meta = []
    for k, (wlo, resid) in sorted(outboxes.items()):
        arrays[f"outbox_{int(k)}"] = np.ascontiguousarray(resid, np.float32)
        outbox_meta.append({"shard": int(k), "word_lo": int(wlo)})
    arrays["meta"] = _u8(json.dumps({
        "format": _FORMAT,
        "kind": "shard_state",
        "node": str(node_name),
        "time": time.time(),
        "shards": shard_meta,
        "outboxes": outbox_meta,
        "dedup": {str(o): list(map(int, seqs)) for o, seqs in dedup.items()},
        "fwd_seq": int(fwd_seq),
    }).encode())
    _atomic_savez(path, **arrays)
    return {
        "node": str(node_name),
        "file": fname,
        "sha256": file_sha256(path),
        "bytes": os.path.getsize(path),
        "shards": shard_meta,
    }


def load_shard_state(path: str) -> dict:
    """Read a :func:`save_shard_state` file back: ``{"layout", "owned":
    {shard: (word_lo, word_cnt, values)}, "outboxes": {shard: (word_lo,
    residual)}, "dedup": {origin: [seqs]}, "fwd_seq"}``."""
    with np.load(path) as z:
        meta = _meta(z)
        if meta.get("kind") != "shard_state":
            raise ValueError(f"{path} is not a shard-state checkpoint")
        layout = z["layout"].tobytes()
        owned = {
            int(e["shard"]): (int(e["word_lo"]), int(e["word_cnt"]), np.asarray(z[f"owned_{int(e['shard'])}"], np.float32))
            for e in meta.get("shards", [])
        }
        outboxes = {
            int(e["shard"]): (int(e["word_lo"]), np.asarray(z[f"outbox_{int(e['shard'])}"], np.float32))
            for e in meta.get("outboxes", [])
        }
    return {
        "layout": layout,
        "owned": owned,
        "outboxes": outboxes,
        "dedup": meta.get("dedup", {}),
        "fwd_seq": int(meta.get("fwd_seq", 0)),
    }


def verify_shard_coverage(dirpath: str, n_shards: int) -> list[str]:
    """The sharded manifest's audit on top of :func:`verify_manifest`:
    every shard index in [0, n_shards) owned by EXACTLY one node at the
    capture. Returns the problems ([] = clean)."""
    problems = verify_manifest(dirpath)
    try:
        doc = load_manifest(dirpath)
    except (OSError, ValueError):
        return problems  # verify_manifest already reported it
    owners: dict[int, list[str]] = {}
    for entry in doc.get("nodes", []):
        for s in entry.get("shards", []):
            owners.setdefault(int(s["shard"]), []).append(entry["node"])
    for k in range(n_shards):
        who = owners.get(k, [])
        if len(who) != 1:
            problems.append(f"shard {k}: owned by {who or 'nobody'} at the capture (exactly-one-owner audit)")
    return problems
