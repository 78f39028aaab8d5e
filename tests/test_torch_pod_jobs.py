"""Rank-side jobs of the port's pod-tier tests (tests/test_torch_ici.py,
test_torch_ici_lab.py, test_torch_trainer.py, test_torch_resnet.py,
test_torch_mesh.py). It holds
no tests itself.

These run inside ``shared_tensor_tpu_torch.parallel.run_mesh`` ranks, so
this module imports torch and the port only: a rank never loads jax. Each
test file makes ONE mesh of ranks and hands it a list of jobs
(:func:`run_jobs`); each job builds the sub-mesh it needs over the first
ranks, so many mesh shapes share one spawn. Inputs and results are numpy.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import tempfile

import numpy as np
import torch

from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.convert import pod_state_from_numpy, pod_state_to_numpy, table_from_numpy
from shared_tensor_tpu_torch.ops.table import make_spec, tree_flatten
from shared_tensor_tpu_torch.parallel import (
    add_updates,
    apply_external,
    build_sync_phases,
    build_sync_step,
    init_state,
    make_mesh,
    read_peer,
)
from shared_tensor_tpu_torch.parallel.ici import block_range
from shared_tensor_tpu_torch.parallel.ici_lab import build_sign2_sync_step
from shared_tensor_tpu_torch.parallel.mesh import all_true

CHAR_TEXT = b"the quick brown fox jumps over the lazy dog. " * 60


@contextlib.contextmanager
def mesh_lock():
    """Held while a test file's mesh of ranks runs: the meshes take a lock
    file in turn, so that under pytest-xdist they start one at a time and
    do not crowd the host's cores (and the timing-bound tests beside them)."""
    with open(os.path.join(tempfile.gettempdir(), "st_torch_pod_tests.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def run_on_mesh(jobs, world=8):
    """Run ``jobs`` (see :func:`run_jobs`) on one mesh of ``world`` CPU
    ranks and return each rank's results, under :func:`mesh_lock`."""
    from shared_tensor_tpu_torch.parallel import run_mesh

    with mesh_lock():
        return run_mesh(run_jobs, world, 1, jobs, device="cpu", timeout_s=120)


def run_jobs(world, jobs):
    """Run ``jobs`` in order: (name, function name, n_peer, n_shard, kwargs)
    each. Every rank builds each job's sub-mesh (over ranks 0..n-1); the
    ranks inside it run the job. Returns {name: result or None}."""
    meshes = {}
    out = {}
    for name, fn, n_peer, n_shard, kw in jobs:
        key = (n_peer, n_shard)
        if key not in meshes:
            meshes[key] = make_mesh(n_peer, n_shard, device="cpu", ranks=range(n_peer * n_shard))
        mesh = meshes[key]
        out[name] = None if mesh is None else globals()[fn](mesh, **kw)
    return out


def result(results, name):
    """The job's result from rank 0 (every rank of a mesh returns the
    same gathered value)."""
    return results[0][name]


# -- the sync step ------------------------------------------------------------------


def _spec_state(mesh, tpl, ups):
    spec = make_spec(tpl)
    state = init_state(mesh, spec, table_from_numpy(tpl))
    if ups is not None:
        lo, hi = block_range(mesh, spec)
        add_updates(state, torch.from_numpy(np.asarray(ups[mesh.peer], np.float32)[lo:hi].copy()))
    return spec, state


def sync(mesh, tpl, ups, policy="POW2_RMS", per_leaf=True, compressed=True, impl="auto", steps=1, phases=False,
         sign2=False):
    """Seed ``tpl`` on every peer, add ``ups[p]`` on peer p, run ``steps``
    sync steps (``phases``: composed from build_sync_phases; ``sign2``: the
    codec lab's 2-bit step). Returns the pod's values and residual before
    and after, and each step's scales."""
    spec, state = _spec_state(mesh, tpl, ups)
    before = pod_state_to_numpy(state, mesh)
    pol = ScalePolicy[policy]
    scales = []
    if sign2:
        step = build_sign2_sync_step(mesh, spec, pol, per_leaf)
        for _ in range(steps):
            state, s = step(state)
            scales.append(s.numpy().copy())
    elif phases:
        send, apply_gathered = build_sync_phases(mesh, spec, pol, per_leaf, impl)
        for _ in range(steps):
            frames = send(state.residual)
            apply_gathered(state.values, frames)
            scales.append(frames.wait()[1].numpy().copy())
    else:
        step = build_sync_step(mesh, spec, pol, per_leaf, compressed, impl)
        for _ in range(steps):
            state, s = step(state)
            scales.append(s.numpy().copy())
    values, residual = pod_state_to_numpy(state, mesh)
    return {"before": before, "values": values, "residual": residual, "scales": np.stack(scales)}


def leaf_scales_block(mesh, shapes, residual, policy="POW2_RMS", per_leaf=True):
    """The pod tier's per-leaf scales (``ici._leaf_scales``: the per-leaf
    scale pass on this rank's block of ``residual``, a whole padded table of
    leaves of ``shapes``, then its sums summed over the shard group and the
    rule) and the block's own leaf sums, with the block's tile phase and
    leaf slots. Every rank of a shard group returns the same scales."""
    from shared_tensor_tpu_torch.ops import codec_cuda
    from shared_tensor_tpu_torch.parallel.ici import _leaf_scales, _make_ctx

    spec = make_spec({f"l{i:02d}": np.zeros(s, np.float32) for i, s in enumerate(shapes)})
    ctx = _make_ctx(mesh, spec, per_leaf)
    lo, hi = block_range(mesh, spec)
    block = torch.from_numpy(np.asarray(residual, np.float32)[lo:hi].copy())
    pol = ScalePolicy[policy]
    scales = _leaf_scales(ctx, block.view(-1, 128), pol)
    _, sums = codec_cuda.leaf_scales(block, ctx.rowcount, ctx.leaf_slots, ctx.ns, pol, per_leaf, ctx.phase)
    return {"scales": scales.numpy().copy(), "sums": sums.numpy().copy(), "phase": ctx.phase,
            "leaf_slots": ctx.leaf_slots.numpy().copy(), "shard": mesh.shard}


def _same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def sign2_ab(mesh, tpl, ups, steps):
    """The production step and the 2-bit step from the same state, in
    turns, for ``steps`` steps or until the production arm's residuals are
    all exactly zero. Returns whether each step left the two arms' scales,
    values and residuals bit-equal on every rank, the steps run, whether
    both drained, and the pod's state before and after each arm."""
    spec, s1 = _spec_state(mesh, tpl, ups)
    _, s2 = _spec_state(mesh, tpl, ups)
    before = pod_state_to_numpy(s1, mesh)
    step1, step2 = build_sync_step(mesh, spec), build_sign2_sync_step(mesh, spec)
    equal = []
    for _ in range(steps):
        s1, sc1 = step1(s1)
        s2, sc2 = step2(s2)
        same = _same_bits(sc1, sc2) and _same_bits(s1.values, s2.values) and _same_bits(s1.residual, s2.residual)
        equal.append(all_true(mesh, same))
        if all_true(mesh, not bool(s1.residual.any())):
            break
    return {"equal": equal, "before": before, "prod": pod_state_to_numpy(s1, mesh),
            "sign2": pod_state_to_numpy(s2, mesh),
            "drained": all_true(mesh, not bool(s1.residual.any()) and not bool(s2.residual.any()))}


def sign2_planes(mesh, tpl, ups):
    """One 2-bit step, as :func:`sync` with ``sign2``, plus the planes every
    peer sent: the step's all-gather is watched, and each peer's sign and
    magnitude words are joined over its shards, u32[n_peer, 2 * W] with
    the sign plane first."""
    from shared_tensor_tpu_torch.parallel import ici_lab
    from shared_tensor_tpu_torch.parallel.mesh import all_gather

    sent, real = [], ici_lab.all_gather
    ici_lab.all_gather = lambda m, t, group, async_op=False: (sent.append(t.clone()), real(m, t, group, async_op))[1]
    try:
        out = sync(mesh, tpl, ups, sign2=True)
    finally:
        ici_lab.all_gather = real
    k = out["scales"].shape[-1]
    words = sent[0][k:].reshape(2, -1)  # this rank's [sign | magnitude] words
    joined = all_gather(mesh, words, mesh.shard_group).wait()  # [n_shard, 2, W_local]
    peer = joined.permute(1, 0, 2).reshape(-1)
    out["words"] = all_gather(mesh, peer, mesh.peer_group).wait().numpy().view(np.uint32).copy()
    return out


def sign2_char_ab(mesh, cfg_kw, steps, lr=0.3, batch=4, seq=16):
    """The char-RNN trained through the production step and through the
    2-bit step on ONE list of batches (tests/test_ici_lab.py's training
    A/B): each step takes the grads and adds the update locally, then runs
    the arm's sync step. Returns each arm's mean loss per step."""
    from shared_tensor_tpu_torch.train import PodTrainer

    m, cfg, loss = _char_model(cfg_kw)
    params = m.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    data = m.encode_corpus(bytes(range(32, 127)) * 40, device="cpu")
    batches = [m.make_batches(data, batch, seq, torch.Generator().manual_seed(i), n_peer=mesh.n_peer, vocab=cfg.vocab)
               for i in range(steps)]
    out = {}
    for name in ("sign1", "sign2"):
        tr = PodTrainer(mesh, params, loss, sync=False)
        step = build_sync_step(mesh, tr.spec) if name == "sign1" else build_sign2_sync_step(mesh, tr.spec)
        losses = []
        for b in batches:
            l, _ = tr.step(tr.shard_batch(b), lr=lr)
            tr.state, _ = step(tr.state)
            losses.append(float(l.mean()))
        out[name] = losses
        out[f"{name}_finite"] = all_true(mesh, bool(torch.isfinite(tr.state.values).all()))
    return out


def read(mesh, tpl, peer):
    spec = make_spec(tpl)
    state = init_state(mesh, spec, table_from_numpy(tpl))
    state.values.add_(float(mesh.peer))  # peers differ, so the broadcast matters
    return [x.numpy().copy() for x in tree_flatten(read_peer(state, spec, mesh, peer))[0]]


def external(mesh, tpl, ups, delta):
    spec, state = _spec_state(mesh, tpl, ups)
    apply_external(state, torch.from_numpy(delta), mesh, spec)
    return pod_state_to_numpy(state, mesh)


def convert_roundtrip(mesh, values, residual):
    return pod_state_to_numpy(pod_state_from_numpy(values, residual, mesh), mesh)


def mesh_facts(mesh):
    """The mesh's shape and groups as this rank sees them, and what an
    oversized mesh raises."""
    import torch.distributed as dist

    try:
        make_mesh(64, 1, device="cpu")
        oversized = None
    except ValueError as e:
        oversized = str(e)
    return {
        "shape": mesh.shape, "peer": mesh.peer, "shard": mesh.shard, "rank": dist.get_rank(),
        "peer_group": dist.get_process_group_ranks(mesh.peer_group),
        "shard_group": dist.get_process_group_ranks(mesh.shard_group),
        "backend": mesh.backend, "device": str(mesh.device), "oversized": oversized,
    }


# -- training -----------------------------------------------------------------------


class Momentum:
    """optax.sgd(lr, momentum) in optax's shape, elementwise on a flat
    buffer: m = g + momentum * m; updates = -lr * m."""

    def __init__(self, lr, momentum):
        self.lr, self.momentum = lr, momentum

    def init(self, flat):
        return torch.zeros_like(flat)

    def update(self, g, m, flat):
        m = g + self.momentum * m
        return -self.lr * m, m


def _char_model(cfg_kw):
    from shared_tensor_tpu_torch.models import char_rnn as m

    cfg = m.CharRNNConfig(**cfg_kw)
    return m, cfg, (lambda p, b: m.loss_fn(p, b, cfg))


def _trainer(mesh, params, loss, momentum=None, **kw):
    from shared_tensor_tpu_torch.train import PodTrainer

    opt = None if momentum is None else Momentum(*momentum)
    return PodTrainer(mesh, table_from_numpy(params), loss, optimizer=opt, **kw)


def char_train(mesh, params=None, cfg_kw=None, steps=10, lr=0.3, batch=4, seq=16, batches=None,
               quiesce=0, drain=0, trainer_kw=None, values=False):
    """Train the char-RNN: ``params`` (numpy tree; default the port's init
    from seed 0), batches from ``batches`` (numpy (x, y) [n_peer, B, T]
    per step) or the port's make_batches seeded by the step. ``quiesce``
    zero-lr steps on one fixed batch follow; then ``drain`` sync-only
    steps. Returns the per-step losses and scales, spreads and checks."""
    m, cfg, loss = _char_model(cfg_kw or dict(vocab=64, embed=16, hidden=32, layers=1))
    if params is None:
        params = _np_tree(m.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    try:
        tr = _trainer(mesh, params, loss, **(trainer_kw or {}))
    except ValueError as e:
        return {"raised": str(e)}
    data = m.encode_corpus(CHAR_TEXT, device="cpu")

    def batch_of(i):
        if batches is not None:
            return tuple(torch.from_numpy(np.asarray(x)) for x in batches[i])
        return m.make_batches(data, batch, seq, torch.Generator().manual_seed(i), n_peer=mesh.n_peer, vocab=cfg.vocab)

    losses, scales = [], []
    for i in range(steps):
        l, s = tr.step(tr.shard_batch(batch_of(i)), lr=lr)
        losses.append(l.numpy().copy())
        scales.append(s.numpy().copy())
    out = {"losses": np.stack(losses) if steps else None, "scales": np.stack(scales) if steps else None}
    if quiesce:
        fixed = tr.shard_batch(batch_of(99) if batches is None else batch_of(0))
        for _ in range(quiesce):
            _, s = tr.step(fixed, lr=0.0)
        out["quiesce_scales"] = s.numpy().copy()
    out["spread"] = tr.replica_spread()
    if drain:
        step = build_sync_step(mesh, tr.spec)
        for _ in range(drain):
            tr.state, _ = step(tr.state)
        out["spread_drained"] = tr.replica_spread()
    v, r = pod_state_to_numpy(tr.state, mesh)
    out.update(finite=bool(np.isfinite(v).all()), residual_max=float(np.abs(r).max()),
               opt_state=tr.opt_state is not None, steps=tr.steps)
    if values:
        out["values"] = v
    out["read_keys"] = sorted(tr.read(0).keys())
    out["read_embed_shape"] = tuple(tr.read(0)["embed"].shape)
    return out


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


def resnet_train(mesh, cfg_kw, steps, lr, compressed, n=8, hw=8):
    """ResNet async-DP (BASELINE config 4's shape): a class-dependent mean
    shift plus noise from numpy seeded by the step; returns mean losses."""
    from shared_tensor_tpu_torch.models import resnet as r

    cfg = r.ResNetConfig(**cfg_kw)
    params = _np_tree(r.init_params(torch.Generator().manual_seed(0), cfg, device="cpu"))
    tr = _trainer(mesh, params, lambda p, b: r.loss_fn(p, b, cfg), compressed=compressed)
    losses = []
    for i in range(steps):
        x, y = resnet_data(i, n, hw, cfg.classes, mesh.n_peer)
        l, _ = tr.step(tr.shard_batch((x, y)), lr=lr)
        losses.append(float(l.mean()))
    return {"losses": losses}


def resnet_data(seed, n, hw, classes, n_peer):
    """A learnable synthetic task: labels, and images shifted by their
    class, [n_peer, n, hw, hw, 3] float32 and [n_peer, n] int64."""
    rng = np.random.default_rng(seed)
    count = n_peer * n
    labels = rng.integers(0, classes, count)
    x = rng.normal(size=(count, hw, hw, 3)) * 0.3 + ((labels - (classes - 1) / 2) * 0.5)[:, None, None, None]
    return x.astype(np.float32).reshape(n_peer, n, hw, hw, 3), labels.reshape(n_peer, n)


# -- run_mesh itself ----------------------------------------------------------------


def sub_mesh_facts(world):
    """The world mesh's facts, and those of a 2-peer mesh over ranks 2 and 3
    (None on the ranks outside it)."""
    import torch.distributed as dist

    sub = make_mesh(2, 1, device="cpu", ranks=[2, 3])
    return {"world": mesh_facts(world), "sub": None if sub is None else (sub.peer, sub.shard, sub.ranks),
            "threads": torch.get_num_threads(), "rank": dist.get_rank()}


def fail_on_rank(mesh, rank):
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()  # the others wait for it until they are killed
    return "unreachable"


def hang(mesh):
    import time

    time.sleep(3600)
