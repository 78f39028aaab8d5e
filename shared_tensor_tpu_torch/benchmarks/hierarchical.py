"""Two pods bridged over the TCP peer tree: the char-RNN (BASELINE config 2's
model) trained by two pods on different data streams.

    python -m shared_tensor_tpu_torch.benchmarks.hierarchical [--device cpu] [--small] [--steps N] [--host-tier]

The counterpart of the root ``benchmarks/hierarchical_bench.py``. Each pod
is a (PEERS, 1) mesh of ranks, and the two bridge peers meet over loopback TCP.
Four arms, one after the other: the first two on ``PodTrainer``s, the
bridged ones on a ``HierarchicalTrainer`` per pod (cell (0, 0) holds the
pod's peer; pod 1's joins the tree that pod 0's founds):

- ``solo``: pod 0 trains alone (pod 1 waits);
- ``unbridged``: both pods train at once, with no peer (what they pay for
  sharing the host and the card);
- ``bridged``: exchanging every pod step;
- ``bridged8``: exchanging every 8 pod steps.

Reported (one JSON line): ms per step and steps/s of each arm (the slower
rank's), the contention (unbridged against solo) and the bridge overhead
(bridged against unbridged), each rank's own step; the join (pod 1 is
seeded from its peer's replica at the handshake, before the tree's state
has streamed in, so the bridged arms start once the pods agree) and the
settle after the last training step: exchanges until every leaf of the two
pods' mean replicas agrees within AGREE_REL of the leaf's max |value|, with
their seconds and final gaps; then each rank's bridged step by stage (its pod
step's, and the exchange's: ``mean``, ``snapshot``, ``push``,
``broadcast``, ``apply_external``, from ``utils/timing.Spans``) over a few
steps; and the frames the bridge peers sent.

:func:`make_pods`, :func:`create`, :func:`run_arms` and :func:`settle` run
on ranks that already exist (``chip_smoke.py`` phase 11 calls them inside
its own spawn); :func:`main` spawns the ranks itself with
``parallel.run_mesh``. On one GPU every rank shares the card, over gloo.
``--host-tier`` puts the two bridge peers on the host tier (the native
engine on the CPU), whatever the pods' device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..examples.train_char_rnn import PANGRAM
from ..models import char_rnn as m
from ..parallel.mesh import Mesh, all_reduce_, all_true, broadcast_, make_mesh
from ..train import HierarchicalTrainer, PodTrainer, build_train_step
from ..utils.timing import Spans

ARMS = ("solo", "unbridged", "bridged", "bridged8")
PEERS = 2  # ranks per pod: BASELINE config 2's 4 peers as two pods
WARMUP = 1  # untimed steps at the start of each arm
SPLIT_STEPS = 2  # bridged steps timed by stage
AGREE_REL = 1e-5  # the settle's goal: every leaf within this * its max |value|
SETTLE_S = 60.0  # the settle's deadline


@dataclasses.dataclass(frozen=True)
class Setup:
    """The run: model (``CharRNNConfig`` keywords; empty is config 2's full
    width), per-peer batch (config 2's), learning rate, timed steps per arm
    (after WARMUP), and the seed of the parameters and batches. The rate is
    config 2's 0.5 over 5, since at 0.5 two bridged pods of the full model
    diverge within a few steps: each takes the other's deltas compressed
    twice and a step or more late."""

    cfg: dict = dataclasses.field(default_factory=dict)
    batch: int = 32
    seq: int = 128
    lr: float = 0.1
    steps: int = 8
    seed: int = 0
    #: bridge peers on the host tier (the native engine) instead of the
    #: mesh's device
    host_tier: bool = False


#: A width for the CPU: the root bench's model, batch and rate.
SMALL = Setup(cfg=dict(vocab=96, embed=64, hidden=192, layers=2), batch=4, seq=24, lr=0.1)


def make_pods(device, backend: Optional[str], ranks=None):
    """Two (PEERS, 1) meshes over the first 2 * PEERS of ``ranks`` (default
    every rank) and the joint (2 * PEERS, 1) mesh over both. Every rank of
    the process group calls it. Returns (this rank's pod mesh, its pod
    index, the joint mesh), or (None, None, None) outside them."""
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    mine, index = None, None
    for i in range(2):
        mesh = make_mesh(PEERS, 1, device=device, backend=backend, ranks=ranks[i * PEERS : (i + 1) * PEERS])
        if mesh is not None:
            mine, index = mesh, i
    both = make_mesh(2 * PEERS, 1, device=device, backend=backend, ranks=ranks[: 2 * PEERS])
    return mine, index, both


def _model(setup: Setup, device):
    cfg = m.CharRNNConfig(**setup.cfg)
    params = m.init_params(torch.Generator().manual_seed(setup.seed), cfg, device=device)
    return params, (lambda p, b: m.loss_fn(p, b, cfg))


def batches(pod: PodTrainer, index: int, setup: Setup):
    """This peer's batch of step ``i``: pod ``index``'s own data stream."""
    data = m.encode_corpus(PANGRAM, device=pod.mesh.device)
    n_peer, vocab = pod.mesh.n_peer, m.CharRNNConfig(**setup.cfg).vocab

    def batch(i: int):
        gen = torch.Generator().manual_seed(setup.seed * 100_003 + index * 7_919 + i)
        return pod.shard_batch(m.make_batches(data, setup.batch, setup.seq, gen, n_peer=n_peer, vocab=vocab))

    return batch


def pod_trainer(pod: Mesh, setup: Setup) -> PodTrainer:
    """A pod of its own, with no peer: the solo and unbridged arms'."""
    params, loss = _model(setup, pod.device)
    return PodTrainer(pod, params, loss)


def create(pod: Mesh, index: int, both: Mesh, port: int, setup: Setup) -> HierarchicalTrainer:
    """Pod 0 founds the tree at ``port`` (its bridge is the master), then
    pod 1 joins. Collective over the joint mesh."""
    params, loss = _model(setup, pod.device)
    tr = None
    for i in range(2):
        if index == i:
            tr = HierarchicalTrainer.create(pod, "127.0.0.1", port, params, loss, timeout=120.0,
                                            host_tier=setup.host_tier)
        all_true(both, True)
    return tr


def run_arms(tr, index: int, both: Mesh, setup: Setup, arms) -> dict:
    """The timed arms in order (collective over the joint mesh): ``solo``
    and ``unbridged`` on a PodTrainer (:func:`pod_trainer`), the bridged
    arms on a HierarchicalTrainer (:func:`create`). Returns this rank's ms
    per timed step and mean loss per step of each arm."""
    pod = tr.pod if isinstance(tr, HierarchicalTrainer) else tr
    batch = batches(pod, index, setup)
    out = {"arms": {}, "losses": {}}
    for arm in arms:
        if arm.startswith("bridged"):
            tr.sync_every = 8 if arm == "bridged8" else 1
        step = tr.step if arm.startswith("bridged") else pod.step
        ms, losses = [], []
        if arm != "solo" or index == 0:
            for i in range(WARMUP + setup.steps):
                t0 = time.perf_counter()
                l, _ = step(batch(i), setup.lr)
                losses.append(float(l.mean()))  # the host waits for the step here
                if i >= WARMUP:
                    ms.append(1e3 * (time.perf_counter() - t0))
        all_true(both, True)  # the arms do not overlap
        out["arms"][arm], out["losses"][arm] = ms, losses
    return out


def step_split(tr: HierarchicalTrainer, index: int, setup: Setup) -> dict:
    """Mean ms per stage of SPLIT_STEPS bridged steps, each stage ended by a
    device sync (``utils/timing.Spans``): the pod step's (``grads``,
    ``update``, ``scales``, ``quantize``, ``gather``, ``apply``,
    ``losses``) and the exchange's (``mean``, ``snapshot``, ``push``,
    ``broadcast``, ``apply_external``). On every rank of the pod
    (collective)."""
    pod = tr.pod
    spans = tr.spans = Spans(pod.mesh.device)
    step = build_train_step(pod.mesh, pod.spec, pod.loss_fn, spans=spans)
    batch = batches(pod, index, setup)
    try:
        for i in range(SPLIT_STEPS):
            pod.state, _, _, _ = step(pod.state, None, batch(i), setup.lr)
            tr.exchange()
    finally:
        tr.spans = None
    return spans.ms()


def leaf_gap(a: torch.Tensor, b: torch.Tensor, spec) -> tuple[float, float]:
    """(worst per-leaf max |a - b| / the leaf's max |a|, max |a - b|) of two
    flat tables."""
    row_leaf = torch.from_numpy(spec.row_leaf().astype(np.int64)).to(a.device)
    zero = torch.zeros(spec.num_leaves, dtype=torch.float32, device=a.device)
    d = (a - b).abs().view(-1, 128).amax(dim=1)
    mag = a.abs().view(-1, 128).amax(dim=1)
    leaf_d = zero.scatter_reduce(0, row_leaf, d, reduce="amax")
    leaf_m = zero.scatter_reduce(0, row_leaf, mag, reduce="amax")
    rel = torch.where(leaf_d > 0, leaf_d.double() / leaf_m.double().clamp_min(1e-30), 0.0)
    return float(rel.max()), float(d.max())


def settle(tr: HierarchicalTrainer, both: Mesh) -> dict:
    """Exchanges, and no pod steps, until the two pods' mean replicas agree
    within AGREE_REL per leaf or rank 0 of the joint mesh passes SETTLE_S:
    the time the tree takes to carry the pods' last progress. (A pod step,
    even at ``lr = 0``, runs the pod's own sync, whose frames keep
    realising the residual's slow tail in the pod mean: a target that moves
    with every step.) Collective over the joint mesh."""
    t0 = time.perf_counter()
    exchanges, curve = 0, []
    while True:
        tr.exchange()
        exchanges += 1
        rel, gap, late = pod_gap(tr, both, time.perf_counter() - t0 > SETTLE_S)
        curve.append((time.perf_counter() - t0, rel))
        if rel <= AGREE_REL or late:
            break
    return {"seconds": time.perf_counter() - t0, "exchanges": exchanges, "gap_rel": rel, "gap_abs": gap,
            "agreed": rel <= AGREE_REL, "curve": curve}


def pod_gap(tr: HierarchicalTrainer, both: Mesh, late: bool = False) -> tuple[float, float, bool]:
    """(:func:`leaf_gap` of pod 0's mean replica against pod 1's, rank 0's
    ``late``) on every rank of the joint mesh. Collective: each pod's mean
    (an all-reduce over its peer group), pod 1's sent from its first rank
    to rank 0, which compares and broadcasts the verdict."""
    mesh = tr.pod.mesh
    mean = all_reduce_(mesh, tr.pod.state.values.clone(), dist.ReduceOp.SUM, mesh.peer_group) / mesh.n_peer
    src, dst = both.rank_of(mesh.n_peer, 0), both.rank_of(0, 0)
    verdict = torch.zeros(3, dtype=torch.float64, device=both.device)
    staged = mean.cpu() if both.host_staged else mean
    if dist.get_rank() == src:
        dist.send(staged, dst)
    elif dist.get_rank() == dst:
        other = torch.empty_like(staged)
        dist.recv(other, src)
        rel, gap = leaf_gap(mean, other.to(mean.device), tr.pod.spec)
        verdict = torch.tensor([rel, gap, float(late)], dtype=torch.float64, device=both.device)
    broadcast_(both, verdict, dst, both.peer_group)
    rel, gap, late = verdict.tolist()
    return rel, gap, bool(late)


def bridge_frames(tr: HierarchicalTrainer) -> Optional[dict]:
    """The bridge peer's non-idle frames out, in all and per link (None off
    the bridge rank)."""
    if tr.peer is None:
        return None
    mt = tr.peer.metrics()
    links = {k.split('"')[1]: v for k, v in mt.items() if k.startswith("st_link_frames_out_total")}
    return {"frames_out": mt["st_frames_out_total"], "frames_in": mt["st_frames_in_total"], "links": links}


def _rank(world: Mesh, port: int, setup: Setup) -> dict:
    pod, index, both = make_pods(world.device, world.backend)
    first = run_arms(pod_trainer(pod, setup), index, both, setup, ("solo", "unbridged"))
    tr = create(pod, index, both, port, setup)
    try:
        join = settle(tr, both)  # pod 1 trains once it holds the model
        second = run_arms(tr, index, both, setup, ("bridged", "bridged8"))
        return {
            "pod": index, "peer": pod.peer, "bridge": tr.is_bridge,
            "arms": first["arms"] | second["arms"], "losses": first["losses"] | second["losses"],
            "join": join, "settle": settle(tr, both), "split_ms": step_split(tr, index, setup),
            "frames": bridge_frames(tr),
        }
    finally:
        tr.close()


def summarize(ranks: list[dict], arms=ARMS) -> dict:
    """One line from every rank's :func:`run_arms` (+ settle) results."""
    ms = {a: max(float(np.mean(r["arms"][a])) for r in ranks if r["arms"].get(a)) for a in arms}
    sps = {a: 1e3 / v for a, v in ms.items()}
    pct = lambda a, b: 100.0 * (1.0 - sps[a] / sps[b]) if a in sps and b in sps else None
    bridges = [r for r in ranks if r["bridge"]]
    return {
        "ms_per_step": ms, "steps_per_s": sps,
        "contention_pct": pct("unbridged", "solo"),
        "bridge_overhead_pct_every_step": pct("bridged", "unbridged"),
        "bridge_overhead_pct_every_8": pct("bridged8", "unbridged"),
        "rank_step_ms": {a: [float(np.mean(r["arms"][a])) if r["arms"].get(a) else None for r in ranks] for a in arms},
        "split_ms": [r.get("split_ms") for r in ranks],
        "bridge_ranks": [i for i, r in enumerate(ranks) if r["bridge"]],
        "join": ranks[0].get("join"),
        "settle": ranks[0].get("settle"),
        "frames": [r.get("frames") for r in bridges],
    }


def main(argv=None) -> None:
    from ..parallel import run_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the GPU (default)")
    ap.add_argument("--steps", type=int, default=None, help="timed steps per arm (a multiple of 8)")
    ap.add_argument("--small", action="store_true", help="a narrow char-RNN for the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-tier", action="store_true", help="bridge peers on the host tier (native engine)")
    args = ap.parse_args(argv)
    setup = SMALL if args.small else Setup()
    setup = dataclasses.replace(setup, seed=args.seed, host_tier=args.host_tier,
                                **({} if args.steps is None else {"steps": args.steps}))
    backend = "gloo" if args.device == "cpu" or torch.cuda.device_count() < 2 * PEERS else None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ranks = run_mesh(_rank, 2 * PEERS, 1, port, setup, device=args.device, backend=backend,
                     timeout_s=1800)
    device = "cpu" if args.device == "cpu" else torch.cuda.get_device_name(0)
    line = {"bench": "hierarchical_two_pods", "device": device, "backend": backend or "nccl",
            "pods": 2, "peers_per_pod": PEERS, "steps": setup.steps, "setup": dataclasses.asdict(setup)}
    print(json.dumps(line | summarize(ranks)))


if __name__ == "__main__":
    main()
