"""The pod tier's mesh on ``torch.distributed``: one process (rank) per
(peer, shard) cell.

The counterpart of ``shared_tensor_tpu/parallel/mesh.py``. There, the peers
of a pod are devices on one ``jax.sharding.Mesh`` in one process; here each
cell of the (peer, shard) grid is a process with its own device, and the
mesh's two axes become two families of process groups:

- the **peer group** of a rank: the ranks with the same shard index (one per
  peer). Compressed frames are all-gathered over it every sync step;
- the **shard group** of a rank: the ranks with the same peer index (one per
  shard of that peer's replica). The per-leaf scale reductions run over it.

Global rank ``r`` of the mesh's rank list sits at peer ``r // n_shard``,
shard ``r % n_shard``: the shard axis is innermost, as the JAX mesh lays
its devices out.

:func:`run_mesh` spawns the ranks of one host and returns what each
returned: the counterpart of the test suite's 8 virtual devices and of a
v5e-8. :func:`init_multihost` joins ranks that ``torchrun`` started.

Collectives on CUDA tensors go through the backend the mesh names. NCCL
refuses two ranks on one device, so ranks that share a card use ``gloo``,
which moves tensors through the host: the helpers here stage a CUDA tensor
through a pinned host buffer for it (:attr:`Mesh.host_staged`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops.packing import LANES


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (peer, shard) mesh and its two process groups."""

    n_peer: int
    n_shard: int
    peer: int
    shard: int
    device: torch.device
    backend: str
    #: Global ranks of the mesh, peer-major (shard innermost).
    ranks: tuple[int, ...]
    #: The ranks with this rank's shard index, in peer order.
    peer_group: Any
    #: The ranks with this rank's peer index, in shard order.
    shard_group: Any

    @property
    def shape(self) -> dict[str, int]:
        return {"peer": self.n_peer, "shard": self.n_shard}

    def rank_of(self, peer: int, shard: int) -> int:
        """Global rank of cell (peer, shard)."""
        return self.ranks[peer * self.n_shard + shard]

    @property
    def host_staged(self) -> bool:
        """Collectives copy CUDA tensors through pinned host buffers: the
        backend is gloo and the tensors live on a GPU."""
        return self.backend == "gloo" and self.device.type == "cuda"


def rows_per_shard(total: int, n_shard: int, lanes: int = LANES) -> int:
    """Rows of the (rows, 128) view each shard owns; validates divisibility.

    ``total`` is always a multiple of 1024 (= 8 rows), so any power-of-two
    ``n_shard`` <= 8 divides evenly; larger shard counts may need the caller
    to grow the table padding."""
    rows = total // lanes
    if rows % n_shard:
        raise ValueError(
            f"{rows} rows not divisible by {n_shard} shards; "
            f"pad the table to a multiple of {n_shard * lanes * 8} elements"
        )
    return rows // n_shard


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def resolve_mesh_device(device=None) -> torch.device:
    """``None`` (or ``"cuda"``) is this rank's GPU, ``cuda:{local rank %
    device count}``; raises without a GPU. ``"cpu"`` is the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' explicitly for the CPU")
        if dev.index is None:
            dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return dev


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(
    n_peer: Optional[int] = None,
    n_shard: int = 1,
    device=None,
    backend: Optional[str] = None,
    ranks: Optional[Sequence[int]] = None,
) -> Optional[Mesh]:
    """A (peer, shard) mesh over ``ranks`` (default: every rank of the
    process group), after ``init_process_group``.

    EVERY rank of the process group must call this with the same
    arguments, since each group is created by all ranks in the same order;
    a rank outside ``ranks`` gets ``None``. ``n_peer=None`` uses all the
    ranks. ``device=None`` is this rank's GPU (raises without one);
    ``backend=None`` is ``"nccl"`` on CUDA and ``"gloo"`` on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: use run_mesh or init_multihost first")
    ranks = list(range(dist.get_world_size())) if ranks is None else [int(r) for r in ranks]
    if n_peer is None:
        n_peer = len(ranks) // n_shard
    need = n_peer * n_shard
    if need < 1 or need > len(ranks):
        raise ValueError(f"mesh ({n_peer} peers x {n_shard} shards) needs {need} ranks, have {len(ranks)}")
    ranks = ranks[:need]
    me = dist.get_rank()
    dev = resolve_mesh_device(device)
    backend = backend or default_backend(dev)
    grid = [ranks[p * n_shard : (p + 1) * n_shard] for p in range(n_peer)]
    peer_group = shard_group = None
    for s in range(n_shard):
        members = [grid[p][s] for p in range(n_peer)]
        g = dist.new_group(members, backend=backend)
        if me in members:
            peer_group = g
    for p in range(n_peer):
        g = dist.new_group(grid[p], backend=backend)
        if me in grid[p]:
            shard_group = g
    if me not in ranks:
        return None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pos = ranks.index(me)
    return Mesh(
        n_peer=n_peer, n_shard=n_shard, peer=pos // n_shard, shard=pos % n_shard,
        device=dev, backend=backend, ranks=tuple(ranks),
        peer_group=peer_group, shard_group=shard_group,
    )


def init_multihost(backend: Optional[str] = None, timeout_s: float = 600.0) -> int:
    """Join the process group that ``torchrun`` (or any launcher setting
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``) started;
    then every rank builds the same mesh with :func:`make_mesh`. Returns
    this rank. Idempotent. ``backend=None`` is NCCL when a GPU is present,
    gloo otherwise."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


# -- collectives ---------------------------------------------------------------


def _group_size(group) -> int:
    return dist.get_world_size(group)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t``, complete on return (gloo reads it at once)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(mesh: Mesh, t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (a no-op for one rank)."""
    if _group_size(group) == 1:
        return t
    if mesh.host_staged:
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


class Gathered:
    """An all-gather in flight: :meth:`wait` returns ``[group size, *shape]``
    on the mesh's device, the rows in group order."""

    def __init__(self, mesh: Mesh, t: torch.Tensor, group, async_op: bool):
        self._n = _group_size(group)
        self._device = t.device
        self._result = None
        self._work = None
        if self._n == 1:
            self._result = t[None]
            return
        src = (_to_host(t) if mesh.host_staged else t.contiguous()).reshape(-1)
        self._shape = (self._n, *t.shape)
        # the flat concatenation: the one output form every backend takes
        self._out = torch.empty(self._n * src.numel(), dtype=t.dtype, device=src.device,
                                pin_memory=mesh.host_staged)
        self._work = dist.all_gather_into_tensor(self._out, src, group=group, async_op=async_op)
        self._src = src  # alive until the collective has read it

    def wait(self) -> torch.Tensor:
        if self._result is None:
            if self._work is not None:
                self._work.wait()
            out = self._out.view(self._shape)
            self._result = out.to(self._device, non_blocking=True) if out.device != self._device else out
            self._out = self._src = self._work = None
        return self._result


def all_gather(mesh: Mesh, t: torch.Tensor, group, async_op: bool = False) -> Gathered:
    """Start an all-gather of ``t`` over ``group``; ``.wait()`` for the
    stacked result."""
    return Gathered(mesh, t, group, async_op)


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast of ``t`` from global rank ``src`` over ``group``."""
    if _group_size(group) == 1:
        return t
    if mesh.host_staged:
        h = _to_host(t)
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def broadcast_from_root_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """In-place broadcast of ``t`` from cell (0, 0) to every rank of the
    mesh: over peer 0's shard group, then over each shard's peer group.
    Collective over the mesh."""
    if mesh.peer == 0:
        broadcast_(mesh, t, mesh.rank_of(0, 0), mesh.shard_group)
    return broadcast_(mesh, t, mesh.rank_of(0, mesh.shard), mesh.peer_group)


def all_true(mesh: Mesh, flag: bool) -> bool:
    """True iff ``flag`` is true on every rank of the mesh (an all-reduce
    MIN over the shard group, then over the peer group). Collective; it
    also orders every rank after every other rank's call."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=mesh.device)
    all_reduce_(mesh, t, dist.ReduceOp.MIN, mesh.shard_group)
    all_reduce_(mesh, t, dist.ReduceOp.MIN, mesh.peer_group)
    return bool(t.item())


def gather_to(mesh: Mesh, t: torch.Tensor, dst: int, group) -> Optional[torch.Tensor]:
    """Gather ``t`` from every rank of ``group`` to global rank ``dst``:
    ``[group size, *t.shape]`` in group order there (on ``t``'s device),
    None on the other ranks."""
    if _group_size(group) == 1:
        return t[None]
    src = _to_host(t) if mesh.host_staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(_group_size(group))] if dist.get_rank() == dst else None
    dist.gather(src, out, dst=dst, group=group)
    return None if out is None else torch.stack(out).to(t.device)


# -- spawning a mesh on one host -----------------------------------------------


def _rank_main(rank, world, n_peer, n_shard, device, backend, tmp, timeout_s):
    torch.set_num_threads(1)  # many ranks share one host's cores
    try:
        fn, args = pickle.loads((Path(tmp) / "call.pkl").read_bytes())
        dev = torch.device("cuda" if device is None else device)
        dist.init_process_group(
            backend=backend or default_backend(dev),
            init_method=f"file://{tmp}/rendezvous",
            world_size=world,
            rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        mesh = make_mesh(n_peer, n_shard, device=device, backend=backend)
        out = fn(mesh, *args)
        part = Path(tmp) / f"result_{rank}.part"
        part.write_bytes(pickle.dumps(out))
        os.replace(part, Path(tmp) / f"result_{rank}.pkl")
        dist.destroy_process_group()
    except BaseException:
        (Path(tmp) / f"error_{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)


def run_mesh(
    fn: Callable[..., Any],
    n_peer: int,
    n_shard: int = 1,
    *args,
    device=None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> list:
    """Run ``fn(mesh, *args)`` on ``n_peer * n_shard`` new processes of this
    host, one per mesh cell, and return each rank's result in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and the
    results come back pickled. The ranks meet through a ``file://`` store in
    a new temporary directory, so parallel meshes cannot collide on a port.
    ``device`` and ``backend`` are :func:`make_mesh`'s: ``device=None`` is
    the GPU (``cuda:{rank % device count}``). Each rank runs with one
    intra-op thread. If a rank fails, or the whole run outlasts
    ``timeout_s``, every rank is killed and this raises, with the failed
    rank's traceback."""
    world = n_peer * n_shard
    if torch.device("cuda" if device is None else device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' explicitly for the CPU")
    dev = None if device is None else str(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="st_mesh_") as tmp:
        # the call goes through a file: a start's pipe write would wait for
        # the child to boot once the arguments outgrow the pipe's buffer,
        # and the ranks would then start one after another
        (Path(tmp) / "call.pkl").write_bytes(pickle.dumps((fn, args)))
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, world, n_peer, n_shard, dev, backend, tmp, timeout_s),
                daemon=True,
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    # every failed rank's traceback: the first to fail is not
                    # always the first found (its peers see a closed link)
                    why = []
                    for r in failed:
                        err = Path(tmp) / f"error_{r}.txt"
                        why.append(f"rank {r}: " + (err.read_text() if err.exists() else f"exit code {procs[r].exitcode}"))
                    raise RuntimeError(f"mesh of {world} ranks: ranks {failed} failed:\n" + "\n".join(why))
                if all(p.exitcode == 0 for p in procs):
                    break
                if time.monotonic() > deadline:
                    alive = [r for r, p in enumerate(procs) if p.exitcode is None]
                    raise TimeoutError(f"mesh of {world} ranks: ranks {alive} still running after {timeout_s} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join(timeout=30)
        return [pickle.loads((Path(tmp) / f"result_{r}.pkl").read_bytes()) for r in range(world)]

