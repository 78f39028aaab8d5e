#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shared_tensor_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

1. Build: compile the CUDA kernels from shared_tensor_tpu_torch/csrc/ (one
   nvcc per source, started together) and print the build seconds.
2. Kernel vs plain on the card, at the ResNet-18 table shape (87,504 rows,
   partial rows, zero-scale leaves): kernel A (quantize_rows) words and
   residual bit-equal, kernel B (apply_rows_batch) bit-equal for
   K in {1, 2, 8} and N in {1, 3, 9} (9 targets take two launches).
3. Tree drive at full width: three SharedTensors on the GPU in a chain
   master - interior - leaf over the ResNet-18 parameter table (56 leaves,
   11,172,170 elements). The master is seeded; the seed spreads, then each
   node in turn adds its own update and it spreads. Frames cross as host
   wire bytes in batches (receive_frames) until every link is quiet
   (every leaf's scale <= 1e-7 of its max |value|); every replica must
   equal seed + all updates to
   1e-5 of each leaf's max |value|, and each link's first frame must equal
   the CPU plain path's on the same state (scales equal or one octave apart).
   The kernel launch counts of this phase are reported.
4. Times at the phase-3 shapes: A, and B at every (K, N) of the drive's
   flood (K in {1, 4}, N in {1, 2, 3}), from a CUDA graph of many launches
   (device time without the host's; A also eagerly, by CUDA events) that
   takes the next of enough buffer sets at each launch to hold four times
   the L2, so that the bytes come from device memory (the time on one set
   beside it), each beside its bytes bound, the plain version's time and
   copy_ms: a device-to-device copy_ that moves the same bytes over as many
   sets, the card's practical streaming ceiling (not a library call for the
   same function).
5. Kernel vs plain on the card for the scalar codec: kernel C (quantize)
   and kernel D (apply_frame_many) at n in {17, 1000, 2^20 + 3, 2^24 + 5},
   all three scale policies, garbage in the padding, scale 0 given
   explicitly, D with K in {1, 3, 9}; then all four kernels at 2^30 + 1024
   elements (byte offsets past 2^31), against their plain versions chunk by
   chunk. Any mismatch fails.
6. The headline codec bench (shared_tensor_tpu_torch.bench) at N = 1 Mi
   with the kernel and the plain codec: its JSON lines, frames/s and us
   per frame; the launches of C and D in the kernel run; the device time
   per launch of compute_scale, C and D and of one whole frame, each from
   a CUDA graph of many launches, so the eager frame splits into scale,
   C, D and launch/host overhead; a torch.profiler window of the eager
   chain (busy share of the device; trace in profiles/).
7. The config-5 sweep (shared_tensor_tpu_torch.benchmarks.pareto) at 2^20,
   2^24, 2^27 and 2^30 elements with a short target: one JSON line per
   size, RMS decay per frame within 0.45-0.55, peak device memory, and the
   times of C and D per launch at 2^30 by CUDA events: D with K = 1 and
   K = 3 targets, each beside its bound and copy_ms.
8. The peer tier over loopback TCP in this process, every SharedTensor on
   the card, through create_or_fetch / add / read: (8a) BASELINE config 1,
   a master seeding arange(1, 241) as 4x5x6x2 and a joiner, both adding,
   both reading seed + both deltas within 1e-6; (8b) four peers on the
   ResNet-18 table (the third joiner below the master's two children), the
   master seeded from --seed, each peer adding one update; every replica
   must reach seed + every update within AGREE_REL of each leaf's max
   |value| within 120 s of the last add. A peer whose thread died or that
   got a message kind it does not speak fails the phase. Reports the time
   from the last add to agreement, frames, messages, bytes and
   retransmissions per peer, frames/s per link, host ms per frame by stage
   (fetch wait, encode, socket, decode, H2D, apply), the launches of A and
   B in 8a+8b (both must be > 0) and the peak device memory; (8c) the host
   wait per K-frame fetch at the ResNet-18 table with 8 bursts in flight,
   asynchronous against the blocking copy, in turns, with the pinned
   allocations each arm made, and the host time of receive_frames for one
   K-frame burst alone in one thread.
9. The pod tier, BASELINE config 2 at full width (CharRNNConfig(): 2 layers,
   hidden 512, 3,870,976 parameters; batch 32 x seq 128 per peer, lr 0.5,
   the built-in pangram corpus, batches from --seed): the first 4 of phase
   10's 8 ranks (one parallel.run_mesh for both phases; the other 4 wait at
   a barrier), all on the one card with backend gloo (NCCL refuses two
   ranks on one device; printed), 20 compressed steps then 5 with
   overlap=True;
   tokens/s, ms per step and its stages (grads, scales, A, collective, B,
   the rest) over the last 10 compressed steps, the loss at the first and
   the last step, the replica spread after 10 sync-only steps, peak device
   memory and each rank's launches of A and B (one each per sync step);
   each rank then holds A and B against their plain versions on its
   trained state (B with K = 4 frames, its own column zeroed, N = 1).
   Then 2 peers x 2 shards on the same ranks for 10 steps (the shard-group
   reductions on the card). Fails if a rank dies, a launch count is off, a
   kernel disagrees with its plain version or the loss does not fall.
10. BASELINE config 4: ResNet-18 at ResNetConfig() (width 64, CIFAR stem, 10
   classes), 8 ranks on the card (gloo), 12 steps of the compressed arm and
   12 of the exact arm from the same parameters, on synthetic 32x32 images
   and labels from --seed (the repo holds no CIFAR); both arms' losses,
   ms per step and frame_ici_bytes. Then A and B alone at phase 9's shapes
   (one rank's block of the char-RNN table), timed as in phase 4.
11. BASELINE config 2 as two pods of two: ranks 0-1 and 2-3 of the same
   spawn as two (2, 1) meshes, each a HierarchicalTrainer at full width
   (benchmarks/hierarchical.py) whose bridge rank (0 and 2) holds a CUDA
   SharedTensorPeer on one loopback rendezvous port, the pods on different
   batch streams from --seed: 1 + BRIDGE_STEPS steps unbridged (the two
   pods as PodTrainers with no peer); the bridged pods created, exchanges
   until pod B holds the model (its pod starts from its peer's replica at
   the handshake, before the state has streamed in); then 1 + BRIDGE_STEPS
   steps bridged (an exchange every step); ms per step of each arm, the
   seconds of each stage and the bridge overhead, every rank's step, the
   bridge peers' frames, then the settle from the last training step
   (exchanges only) until every leaf of the two pods' mean replicas agrees
   within AGREE_REL, under a deadline (the join waits the same way), and
   each rank's bridged step by stage over a few steps (its pod step's, and
   the exchange's: the pod mean's collectives, the snapshot, the push, the
   broadcast, apply_external); then, the bridges closed, pod A's
   checkpoint: save_trainer and save_pod_sharded (MB, seconds),
   load_trainer into a fresh PodTrainer and load_pod_sharded bit for bit,
   and RESUME_STEPS steps from the saved point by the live and the
   restored trainer with losses and states bit for bit
   (torch.use_deterministic_algorithms on: PyTorch documents the
   embedding's and the loss's index backward as nondeterministic on
   CUDA); each rank's launches of A and B on the phase (A and B on every
   pod step; on the bridge ranks also the peer's) and A and B against
   their plain versions on its state. Fails if the pods do not agree, the checkpoint is not exact, a
   rank's launches are short, a kernel disagrees or the bridged arm's loss
   does not fall.
12. The host tier on BASELINE config 2's table (the default CharRNNConfig:
   9 leaves, 3,870,976 elements): (12a) the port's libstcodec
   (ops/codec_np, native/stcodec.c) against its plain numpy versions on
   this machine's CPU, on seeded data: K = 4 successive quantize_table
   frames (scales equal or one octave apart, words and residuals bit for
   bit at the C loop's scales), apply_table_batch of the K frames into
   N = 2 targets and accumulate_table, 0 mismatches required; host ms of
   each beside its plain version, and the CPU's model (lscpu); (12b) a
   mixed-tier tree over loopback: a CUDA device-tier master and two
   host-tier peers on the native engine below it, the master seeded, each
   peer adding a seeded update; every replica must reach seed + all
   updates within AGREE_REL of each leaf's max |value| within 30 s of the
   last add; a peer on another tier than asked fails the phase. Reports
   frames/s per peer and per link by tier, the engines' counters, and the
   launches of A and B (the master's) in 12b; then A and B against their
   plain versions on the master's state, A as a burst of as many frames as
   one BURST carries on this table and B with those frames into N = 2
   targets (its replica and a link's residual), 0 mismatches required.
13. The serving path on BASELINE config 2's table (the default CharRNNConfig,
   9 leaves, 3,870,976 parameters, its init from --seed redrawn with
   power-of-two bounds, benchmarks/serve.tables): a CUDA device-tier
   master (max_children 3), an engine writer (host_tier=True) below it,
   subscriber S1 on the whole table and S2 on the embedding leaf's element
   range, both below the master (each node's parent, each subscriber's
   seed time and buffered bytes reported; S2 must buffer only its pages).
   The engine writer adds a seeded power-of-two update and drains it, the
   subscribers catch up, then the master adds its own; each subscriber
   waits until it is fresh past an epoch taken after that last add (the
   time reported), then reads within 1 s of staleness and must agree with
   the master's read() per leaf within AGREE_REL. S1's ServingHandle on the card: refresh ms,
   params() the same object between refreshes, and a char-RNN forward on
   a pangram batch with the handle's params and the master's (largest
   logit difference; a non-finite logit fails; the handle's logits must
   equal those of S1's read() on the card bit for bit). Then 2 x
   fresh_interval_sec idle (S1's staleness must stay within the interval
   plus SERVE_IDLE_SLACK), and a 1 s read arm of
   benchmarks/serve.read_arm while the engine writer adds at SERVE_ADD_HZ
   (reads/s, p50/p99 staleness, refused fraction). Last, sgd_arm: the
   master adds one SGD step of the char-RNN (bounds no powers of two) and
   S1 is read at the 1 s bound for SERVE_SGD_ARM_S s with no more writes
   (refused fraction, staleness, time to a FRESH past the step or None,
   frames applied, S1's distance from the master; S1 must have taken in
   most of the step). The launches of A and B
   in the phase (both > 0), then A and B against their plain versions on
   the master's state (tree_kernel_check), 0 mismatches required; the
   subscriber's host ms per applied frame. One {"serve": ...} line.
14. The peer's wire capabilities (`/dev/shm`'s size printed first): (14a)
   BASELINE config 1 on the reference wire: compat.createOrFetch on the card
   (wire_compat) seeds arange(1, 241) as 4x5x6x2, the C reference peer
   (native/stc_harness.c) joins as a leaf and a compat engine peer joins;
   all three add; every reader (copyToTensor, the C peer's printout) must
   hold seed + every add within 1e-6. (14b) one flat tensor of config 2's
   width (3,870,976 elements) on the reference wire: a CUDA master, a
   compat engine peer and a CUDA peer, each adding a seeded update in
   turn; agreement within AGREE_REL within 30 s of each; seconds, frames/s
   per link, bytes a frame; the master must send and apply frames (A and
   B); then three more updates at once, their worst error read AT_ONCE_S
   later (reported; the codec drains summed updates in thousands of
   frames, tools/compat_tail.py). (14c)
   config 2's table as a chain CUDA master (max_children 1) - engine E1 -
   engine E2, ST_SIGN2=2 around E1's and E2's creation: every link on the
   shared-memory lane at both ends (st_shm_active 2), E1-E2 at 2 bits with
   sign2 frames sent, the master's link at 1 bit, agreement within
   AGREE_REL (beside 12b's time in the same run); each link's ring bytes,
   lane traffic and frames2; then the same chain with stripe_count 4 and
   the lane off, E1's node made under to_env(FaultConfig(sever_after_frames
   =3, only_link=1, only_stripe=2)): 4 stripes on every link, one death and
   a re-route on E1's uplink, which stays up, and agreement. A and B against
   their plain versions on each arm's CUDA master (tree_kernel_check: 14a's
   and 14b's one-leaf tables, 14c's), 0 mismatches, reported by arm.
   The launches of A and B by arm.
The transport, the host codec and the engine (native/sttransport.cpp,
stcodec.c, stengine.cpp) and the C reference peer (stc_harness.c) are
compiled with g++ and gcc in phase 1, beside the kernels. Every rank's full results of phases 9, 10 and 11 go to
profiles/pod.json.

Prints the card's name and power limit (nvidia-smi), a {"kernels": [...]}
line, and last {"ok": true, "device": {...}}. Exits non-zero with no result
when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

#: HBM bandwidth by card (NVIDIA data sheets), bytes/s; the SXM part's is
#: the default.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
HBM_DEFAULT = 3.35e12

QUIET_REL = 1e-7  # a frame is quiet when every leaf's scale <= this * its max |value|
AGREE_REL = 1e-5  # replicas agree when every leaf is within this * its max |value|
BATCH = 4  # frames per link per round, delivered together (K of kernel B)
B_SHAPES = ((1, 1), (BATCH, 2), (BATCH, 3), (BATCH, 1), (1, 3))  # phase 4: (K, N) of the flood
D_TARGETS = (1, 3)  # phase 7: target arrays of D at 2^30
MAX_ROUNDS = 400
WORDS_BYTES = 4 * 4  # packed words per row x bytes per word
SCALAR_SIZES = (17, 1000, 2**20 + 3, 2**24 + 5)  # phase 5: live counts, padded to 1024
BIG_PAD = 2**30 + 1024  # phase 5: padded elements of the 64-bit indexing check
BENCH_SECONDS = 0.5  # phase 6: target length of one timed chain
SWEEP_LOG2 = (20, 24, 27, 30)  # phase 7: config 5's sizes, up to its "1B"
SWEEP_SECONDS = 0.5  # phase 7: target length of one timed chain
OUT_DIR = "profiles"  # phase 6 writes its profiler trace here


def resnet18_template(width: int = 64) -> dict:
    """ResNet-18 parameter shapes (the repo's default ResNetConfig: 3x3 CIFAR
    stem, two basic blocks per stage, 10 classes), as zero float32 arrays.
    A smaller ``width`` gives the same structure for a rehearsal on the CPU."""
    classes, stages = 10, (2, 2, 2, 2)
    z = lambda *s: np.zeros(s, np.float32)
    params = {"stem": {"conv": z(3, 3, 3, width), "scale": z(width), "bias": z(width)}}
    blocks = []
    cin = width
    for si, depth in enumerate(stages):
        cout = width * 2**si
        for bi in range(depth):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {
                "conv1": z(3, 3, cin, cout), "scale1": z(cout), "bias1": z(cout),
                "conv2": z(3, 3, cout, cout), "scale2": z(cout), "bias2": z(cout),
            }
            if stride != 1 or cin != cout:
                blk["proj"] = z(1, 1, cin, cout)
            blocks.append(blk)
            cin = cout
    params["blocks"] = blocks
    params["head"] = {"w": z(cin, classes), "b": z(classes)}
    return params


def random_like(template, rng: np.random.Generator, scale: float = 1.0):
    """Per leaf uniform(-1, 1) times 10^U(-3, 3), the magnitude rounded to
    a power of two, so the per-leaf scales matter. The rounding keeps the
    drive short: the sign codec drains a uniform residual in about 25
    frames when its bound is a power of two, and otherwise leaves sparse
    outliers that drain at about sqrt(n)/2 frames per octave."""
    from shared_tensor_tpu_torch.ops.table import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(template)
    out = []
    for leaf in leaves:
        mag = scale * 2.0 ** np.round(np.log2(10.0 ** rng.uniform(-3, 3)))
        out.append((rng.uniform(-1, 1, np.shape(leaf)) * mag).astype(np.float32))
    return tree_unflatten(treedef, out)


def tree_updates(template, seed: int, n_peers: int):
    """Phase 8b's data: the master's seed and each peer's update, drawn
    from ``seed`` (tools/agreement_tail.py drives the same data)."""
    rng = np.random.default_rng(seed + 8)
    seed_tree = random_like(template, rng)
    return seed_tree, [random_like(template, rng, 0.5) for _ in range(n_peers)]


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in name:
            return rate
    return HBM_DEFAULT


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _bitdiff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose 32 bits differ."""
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def _maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; NaN in both counts as equal, NaN in one as inf."""
    d = (a.double() - b.double()).abs()
    d = torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)
    d = torch.nan_to_num(d, nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


# -- phase 2 --------------------------------------------------------------------


def kernel_vs_plain(spec, device, rng) -> dict:
    """Both kernels against their plain versions at this table's shapes.
    Returns {kernel: {"mismatches": n, "max_abs_err": x}}."""
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops import table as TT

    row_leaf, rowcount, live, *_ = TT._consts(spec, str(torch.device(device)))
    n = spec.total
    mags = 10.0 ** rng.uniform(-3, 3, spec.num_leaves)
    resid = torch.from_numpy(
        (rng.uniform(-1, 1, n) * mags[spec.row_leaf()].repeat(128)).astype(np.float32)
    ).to(device)
    resid = torch.where(live.view(-1), resid, torch.zeros_like(resid))
    resid[::97] = 0.0  # zeros count as negative
    scales = TT.compute_scales(resid, spec)
    scales[:: 5] = 0.0  # zero-scale (idle) leaves
    s_row = scales[row_leaf].contiguous()
    r_k, r_p = resid.clone(), resid.clone()
    w_k = CC.quantize_rows_kernel(s_row, rowcount, r_k)
    w_p = CC.quantize_rows_plain(s_row, rowcount, r_p)
    _sync(device)
    out = {"quantize_rows": {"mismatches": _bitdiff(w_k, w_p) + _bitdiff(r_k, r_p),
                             "max_abs_err": _maxerr(r_k, r_p)}}
    print(f"[2] A quantize_rows rows={spec.rows}: word mismatches {_bitdiff(w_k, w_p)}, "
          f"residual mismatches {_bitdiff(r_k, r_p)}")

    # real frames, RMS scales (not powers of two: the k order matters)
    frames, _ = TT.quantize_table_burst(resid.clone(), spec, 8, ScalePolicy.RMS, impl="plain")
    frames.scales[:, ::7] = 0.0
    mism, err = 0, 0.0
    for k in (1, 2, 8):
        s_rows = frames.scales[:k, row_leaf].contiguous()
        words = frames.words[:k].contiguous()
        for n_arr in (1, 3, 9):
            base = [resid * (i + 1) for i in range(n_arr)]
            a_k = [b.clone() for b in base]
            a_p = [b.clone() for b in base]
            CC.apply_rows_batch_kernel(s_rows, rowcount, words, a_k)
            CC.apply_rows_batch_plain(s_rows, rowcount, words, a_p)
            _sync(device)
            m = sum(_bitdiff(x, y) for x, y in zip(a_k, a_p))
            e = max(_maxerr(x, y) for x, y in zip(a_k, a_p))
            mism += m
            err = max(err, e)
            print(f"[2] B apply_rows_batch K={k} N={n_arr}: mismatches {m}")
    out["apply_rows_batch"] = {"mismatches": mism, "max_abs_err": err}
    return out


# -- phase 3 --------------------------------------------------------------------


def _to_wire(frame, spec) -> tuple[bytes, bytes]:
    from shared_tensor_tpu_torch.ops.packing import words_to_wire

    return np.asarray(frame.scales, "<f4").tobytes(), words_to_wire(frame.words, spec.total)


def _from_wire(payload: tuple[bytes, bytes], spec):
    from shared_tensor_tpu_torch.ops.packing import wire_to_words
    from shared_tensor_tpu_torch.ops.table import TableFrame

    scales = np.frombuffer(payload[0], "<f4").astype(np.float32)
    return TableFrame(scales, wire_to_words(payload[1], spec.total))


def _first_frame_check(resid_cpu, host, resid_after, spec, codec) -> int:
    """The link's first frame vs the CPU plain path on the same residual:
    words bit-equal, scales equal or one octave apart, residual bit-equal on
    leaves whose scales are equal. Returns the mismatch count."""
    from shared_tensor_tpu_torch.ops import table as TT

    f_cpu, r_cpu = TT.quantize_table(resid_cpu, spec, codec.scale_policy, codec.per_leaf_scale, impl="plain")
    s_dev, s_cpu = np.asarray(host.scales), f_cpu.scales.numpy()
    octave = (s_dev == s_cpu) | (s_dev == 2 * s_cpu) | (2 * s_dev == s_cpu)
    bad = int((~octave).sum())
    bad += int((np.asarray(host.words).view(np.int32) != f_cpu.words.numpy()).sum())
    same = torch.from_numpy(s_dev == s_cpu)[torch.from_numpy(spec.row_leaf().astype(np.int64))]
    r_dev = resid_after.view(-1, 128)[same]
    bad += _bitdiff(r_dev, r_cpu.view(-1, 128)[same])
    return bad


def tree_drive(template, device, seed: int, verbose: bool = True) -> dict:
    """master - interior - leaf over ``template`` on ``device``; see the
    module docstring (phase 3). Returns counts, timings and the check
    results; raises on disagreement."""
    from shared_tensor_tpu_torch.core import SharedTensor
    from shared_tensor_tpu_torch.ops.table import make_spec, tree_flatten

    rng = np.random.default_rng(seed)
    seed_tree = random_like(template, rng)
    updates = [random_like(template, rng, 0.5) for _ in range(3)]
    t0 = time.perf_counter()
    m = SharedTensor(seed_tree, seed_values=True, device=device)
    i = SharedTensor(template, device=device)
    l = SharedTensor(template, device=device)
    spec = m.spec
    m.new_link(1, seed=True)
    i.new_link(1, seed=False)
    i.new_link(2, seed=True)
    l.new_link(2, seed=False)
    target = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
    for u in updates:
        for j, x in enumerate(tree_flatten(u)[0]):
            target[j] += x
    mag = np.array([np.abs(x).max() for x in target])
    _sync(device)

    links = ((m, i, 1), (i, m, 1), (i, l, 2), (l, i, 2))
    stats = {"frames": 0, "rounds": 0, "max_k": 0, "first_mismatch": 0}
    checked = set()

    def pump() -> None:
        """Exchange frames over every link, up to BATCH per link per round,
        delivered together, until a round in which every frame is quiet."""
        for _ in range(MAX_ROUNDS):
            stats["rounds"] += 1
            quiet = True
            for src, dst, link in links:
                batch = []
                for _ in range(BATCH):
                    first = (id(src), link) not in checked
                    pre = src._links[link].to("cpu", copy=True) if first else None
                    seq, dframe = src.begin_frame(link)
                    host = src.finish_frame(dframe)
                    src.ack_frame(link, seq)
                    if host is None:
                        break
                    if first:
                        checked.add((id(src), link))
                        stats["first_mismatch"] += _first_frame_check(
                            pre, host, src._links[link].to("cpu", copy=True), spec, src.codec
                        )
                    batch.append(_from_wire(_to_wire(host, spec), spec))
                    if np.any(host.scales > QUIET_REL * mag):
                        quiet = False
                if batch:
                    dst.receive_frames(link, batch)
                    stats["frames"] += len(batch)
                    stats["max_k"] = max(stats["max_k"], len(batch))
            if quiet:
                return
        raise AssertionError(f"links did not quiesce in {MAX_ROUNDS} rounds")

    # the seed spreads, then each node adds its own update and it spreads
    t_pump = time.perf_counter()
    pump()
    for st, u in zip((m, i, l), updates):
        st.add(u)
        pump()
    _sync(device)
    pump_s = time.perf_counter() - t_pump
    frames, rounds, first_mismatch = stats["frames"], stats["rounds"], stats["first_mismatch"]
    max_k = stats["max_k"]
    if len(checked) != len(links):
        raise AssertionError(f"only {len(checked)} of {len(links)} links sent a frame")

    worst = 0.0
    for st in (m, i, l):
        got = tree_flatten(st.read())[0]
        for j, g in enumerate(got):
            rel = float(np.abs(g.cpu().numpy().astype(np.float64) - target[j]).max()) / mag[j]
            worst = max(worst, rel)
    res = {
        "rounds": rounds, "frames": frames, "pump_s": pump_s,
        "frames_per_s": frames / pump_s, "max_k": max_k,
        "worst_rel_err": worst, "first_frame_mismatches": first_mismatch,
        "setup_s": t_pump - t0,
        "frames_out": [st.frames_out for st in (m, i, l)],
        "frames_in": [st.frames_in for st in (m, i, l)],
    }
    if verbose:
        print(f"[3] tree drive: {frames} frames in {rounds} rounds, {pump_s:.3f} s "
              f"({res['frames_per_s']:.1f} frames/s), worst leaf error {worst:.3e} of max|value|, "
              f"first-frame mismatches {first_mismatch}")
    if worst > AGREE_REL:
        raise AssertionError(f"replicas disagree: worst leaf error {worst:.3e} > {AGREE_REL}")
    if first_mismatch:
        raise AssertionError(f"{first_mismatch} first-frame mismatches against the CPU plain path")
    if sum(res["frames_out"]) != sum(res["frames_in"]):
        raise AssertionError(f"frames out {res['frames_out']} != frames in {res['frames_in']}")
    return res


# -- phase 4 --------------------------------------------------------------------


def times(spec, device, rate: float, shapes=B_SHAPES) -> dict:
    """ms per launch of A and of B at each (K, N) of ``shapes``, from a CUDA
    graph of many launches that takes the next of enough buffer sets at
    every launch that they hold four times the L2 (``ms``, read against the
    bytes bound; ``copy_ms`` likewise), and from the same graph on one set
    (``ms_hot``: where a set fits in the L2 it stays there); A's eager time
    by CUDA events; each with its plain version's time. Returns
    {"quantize_rows": row, "apply_rows_batch": [row per shape]}."""
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops import table as TT
    from shared_tensor_tpu_torch.utils.timing import copy_ms, event_ms, graph_ms, l2_sets

    row_leaf, rowcount, live, *_ = TT._consts(spec, str(torch.device(device)))
    gen = torch.Generator(device=device).manual_seed(0)
    rows, n = spec.rows, spec.total
    resid = torch.rand(n, generator=gen, device=device) * 2 - 1
    resid = torch.where(live.view(-1), resid, torch.zeros_like(resid))
    s_row = TT.compute_scales(resid, spec)[row_leaf].contiguous()

    def timed(launch, make_set, nbytes) -> dict:
        """Graph, eager and copy times of ``launch(*set)`` over fresh sets
        from ``make_set()``, and the graph's time on one set."""
        sets = [make_set() for _ in range(l2_sets(nbytes, device))]
        turn = itertools.cycle(sets)
        cold = lambda: launch(*next(turn))
        hot = lambda: launch(*sets[0])
        r = {"ms": graph_ms(cold, 50), "ms_hot": graph_ms(hot, 50), "eager_ms": event_ms(cold, 50),
             "copy_ms": copy_ms(nbytes, device, lambda fn: graph_ms(fn, 50), sets=len(sets)),
             "sets": len(sets), "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
        del sets, turn
        return r

    a_bytes = n * 8 + rows * WORDS_BYTES + rows * 8
    r = timed(CC.quantize_rows_kernel, lambda: (s_row.clone(), rowcount.clone(), resid.clone()), a_bytes)
    r.update(plain_ms=event_ms(lambda: CC.quantize_rows_plain(s_row, rowcount, resid), 5, 1),
             shape=f"rows={rows}")
    out = {"quantize_rows": r}
    print(f"[4] quantize_rows {r['shape']}: {r['ms']:.4f} ms/launch from a graph over {r['sets']} buffer sets "
          f"({r['ms_hot']:.4f} on one set, {r['eager_ms']:.4f} eager), bound {r['bound_ms']:.4f} ms "
          f"({r['bytes'] / 1e6:.1f} MB at {rate / 1e12:.2f} TB/s, {100 * r['bound_ms'] / r['ms']:.1f}% of it), "
          f"copy_ms {r['copy_ms']:.4f}, plain {r['plain_ms']:.4f} ms")
    frames, _ = TT.quantize_table_burst(resid.clone(), spec, max(k for k, _ in shapes), impl="kernel")
    out["apply_rows_batch"] = []
    for k, n_arr in shapes:
        s_rows = frames.scales[:k, row_leaf].contiguous()
        words = frames.words[:k].contiguous()
        b_bytes = n * k / 8 + k * rows * 4 + rows * 4 + 8 * n_arr * n
        r = timed(CC.apply_rows_batch_kernel,
                  lambda: (s_rows.clone(), rowcount.clone(), words.clone(), [resid.clone() for _ in range(n_arr)]),
                  b_bytes)
        arrays = [resid.clone() for _ in range(n_arr)]
        r.update(plain_ms=event_ms(lambda: CC.apply_rows_batch_plain(s_rows, rowcount, words, arrays), 5, 1),
                 shape=f"rows={rows} K={k} N={n_arr}")
        out["apply_rows_batch"].append(r)
        print(f"[4] apply_rows_batch {r['shape']}: {r['ms']:.4f} ms/launch from a graph over {r['sets']} buffer "
              f"sets ({r['ms_hot']:.4f} on one set, {r['eager_ms']:.4f} eager), bound {r['bound_ms']:.4f} ms "
              f"({r['bytes'] / 1e6:.1f} MB, {100 * r['bound_ms'] / r['ms']:.1f}% of it), "
              f"copy_ms {r['copy_ms']:.4f}, plain {r['plain_ms']:.4f} ms")
        del arrays
    return out


# -- phase 5 --------------------------------------------------------------------


def scalar_kernel_vs_plain(device, sizes=SCALAR_SIZES, seed: int = 0) -> dict:
    """Kernels C and D against their plain versions; see the module
    docstring (phase 5). Returns {kernel: {"mismatches": n, "max_abs_err": x}}."""
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.packing import padded_len

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"quantize": {"mismatches": 0, "max_abs_err": 0.0},
           "apply_frame_many": {"mismatches": 0, "max_abs_err": 0.0}}

    def note(name, m, e):
        out[name]["mismatches"] += m
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)

    for n in sizes:
        n_pad = padded_len(n)
        base = torch.randn(n_pad, generator=gen, device=device)  # the padding holds garbage
        base[::97] = 0.0  # zeros count as negative
        base[:3] = torch.tensor([1e-40, -1e-45, 0.0])  # subnormals survive
        cases = [(p.name, p, None) for p in ScalePolicy] + [("scale=0", ScalePolicy.POW2_RMS, 0.0)]
        for label, policy, fixed in cases:
            r_k, r_p = base.clone(), base.clone()
            s_k = None if fixed is None else torch.full((), fixed, device=device)
            s_p = None if fixed is None else s_k.clone()
            f_k, _ = CC.quantize_kernel(r_k, n, policy, scale=s_k)
            f_p, _ = CC.quantize_plain(r_p, n, policy, scale=s_p)
            _sync(device)
            m = _bitdiff(f_k.words, f_p.words) + _bitdiff(r_k, r_p) + _bitdiff(f_k.scale, f_p.scale)
            m += int(r_k[n:].count_nonzero())  # padding lanes are 0
            note("quantize", m, _maxerr(r_k, r_p))
            print(f"[5] C quantize n={n} {label}: scale {float(f_k.scale):.6g}, mismatches {m}")
            if label == "RMS":
                frame = f_k  # a scale that is not a power of two
        for k in (1, 3, 9):
            a_k = [base * (i + 1) for i in range(k)]
            a_k[0][3:6] = torch.tensor([3e38, -3e38, float("nan")])
            a_p = [a.clone() for a in a_k]
            CC.apply_frame_many_kernel(a_k, frame, n)
            CC.apply_frame_many_plain(a_p, frame, n)
            _sync(device)
            m = sum(_bitdiff(x, y) + int(x[n:].count_nonzero()) for x, y in zip(a_k, a_p))
            note("apply_frame_many", m, max(_maxerr(x, y) for x, y in zip(a_k, a_p)))
            print(f"[5] D apply_frame_many n={n} K={k}: mismatches {m}")
    return out


def big_index_check(device, n_pad: int = BIG_PAD, chunk: int = 2**26, seed: int = 0) -> dict:
    """All four kernels on one buffer of ``n_pad`` elements (byte offsets
    past 2^31), each against its plain version chunk by chunk: the plain
    versions are elementwise given the scales, so a chunk with its own live
    count is the same function. Returns {kernel: mismatches}."""
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.codec import Frame

    gen = torch.Generator(device=device).manual_seed(seed)
    n = n_pad - 5
    out = {}
    # C then D (K = 1)
    r0 = torch.randn(n_pad, generator=gen, device=device)
    r = r0.clone()
    frame, _ = CC.quantize_kernel(r, n)
    v0 = torch.randn(n_pad, generator=gen, device=device)
    v = v0.clone()
    CC.apply_frame(v, frame, n)
    _sync(device)
    mc = md = 0
    for lo in range(0, n_pad, chunk):
        hi = min(n_pad, lo + chunk)
        live = max(0, min(n, hi) - lo)
        words = frame.words[lo // 32 : hi // 32]
        f_p, r_p = CC.quantize_plain(r0[lo:hi].clone(), live, scale=frame.scale.clone())
        mc += _bitdiff(f_p.words, words) + _bitdiff(r_p, r[lo:hi])
        (v_p,) = CC.apply_frame_many_plain([v0[lo:hi].clone()], Frame(frame.scale.clone(), words.clone()), live)
        md += _bitdiff(v_p, v[lo:hi])
    out["quantize"], out["apply_frame_many"] = mc, md
    del r, v
    # A then B (K = 1, N = 1), per-row scales and live counts
    rows = n_pad // 128
    s_row = 2.0 ** torch.randint(-6, 2, (rows,), generator=gen, device=device).float()
    s_row[::5] = 0.0
    rowcount = torch.randint(0, 129, (rows,), generator=gen, device=device, dtype=torch.int32)
    r = r0.clone()
    words = CC.quantize_rows_kernel(s_row, rowcount, r)
    v = v0.clone()
    CC.apply_rows_batch_kernel(s_row[None].contiguous(), rowcount, words[None].contiguous(), [v])
    _sync(device)
    ma = mb = 0
    rc = chunk // 128
    for lo in range(0, rows, rc):
        hi = min(rows, lo + rc)
        r_p = r0[lo * 128 : hi * 128].clone()
        w_p = CC.quantize_rows_plain(s_row[lo:hi].contiguous(), rowcount[lo:hi].contiguous(), r_p)
        ma += _bitdiff(w_p, words[lo * 4 : hi * 4]) + _bitdiff(r_p, r[lo * 128 : hi * 128])
        (v_p,) = CC.apply_rows_batch_plain(
            s_row[None, lo:hi].contiguous(), rowcount[lo:hi].contiguous(),
            words[None, lo * 4 : hi * 4].contiguous(), [v0[lo * 128 : hi * 128].clone()])
        mb += _bitdiff(v_p, v[lo * 128 : hi * 128])
    out["quantize_rows"], out["apply_rows_batch"] = ma, mb
    print(f"[5] 64-bit indexing at {n_pad} elements ({n_pad * 4 / 2**30:.2f} GiB per buffer): "
          f"mismatches {out}")
    return out


# -- phase 6 --------------------------------------------------------------------


def scalar_bytes(n: int, k: int = 1) -> dict:
    """Bytes each kernel must move at ``n`` padded elements: C reads and
    writes the residual and writes the words; D reads the words and reads
    and writes K arrays; each reads the 4-byte scale."""
    return {"quantize": 8 * n + n / 8 + 4, "apply_frame_many": 8 * k * n + n / 8 + 4}


def codec_bench(device, rate: float, n: int, seconds: float) -> dict:
    """Phase 6: the bench for both codecs, the launches of C and D in the
    kernel run, and the device time split of one frame."""
    from shared_tensor_tpu_torch import bench
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.codec import compute_scale
    from shared_tensor_tpu_torch.utils.profiling import trace
    from shared_tensor_tpu_torch.utils.timing import copy_ms, graph_ms

    CC.reset_launches()
    kern = bench.run("kernel", device, n, target_seconds=seconds)
    launches = {k: CC.LAUNCHES[k] for k in ("quantize", "apply_frame_many")}
    plain = bench.run("plain", device, n, target_seconds=seconds)
    for res in (kern, plain):
        print(json.dumps(res))
        d = res["detail"]
        print(f"[6] bench {d['codec']}: {d['frames_per_s']:.1f} frames/s, "
              f"{d['frame_s'] * 1e6:.3f} us/frame, {res['value']} GB/s equiv")
    print(f"[6] launches in the kernel bench: {launches}")

    pol = ScalePolicy.POW2_RMS
    gen = torch.Generator(device=device).manual_seed(1)
    r = torch.randn(n, generator=gen, device=device)
    v = torch.zeros(n, device=device)
    frame, _ = CC.quantize_kernel(r.clone(), n, pol)
    scale = frame.scale
    iters = 200

    def whole_frame():
        f, _ = CC.quantize_kernel(r, n, pol)
        CC.apply_frame(v, f, n)

    split = {
        "scale_ms": graph_ms(lambda: compute_scale(r, n, pol), iters),
        "quantize_ms": graph_ms(lambda: CC.quantize_kernel(r, n, pol, scale=scale), iters),
        "apply_frame_many_ms": graph_ms(lambda: CC.apply_frame_many_kernel((v,), frame, n), iters),
        "frame_graph_ms": graph_ms(whole_frame, iters),
        "quantize_plain_ms": graph_ms(lambda: CC.quantize_plain(r, n, pol, scale=scale), 50),
        "apply_frame_many_plain_ms": graph_ms(lambda: CC.apply_frame_many_plain((v,), frame, n), 50),
    }
    for k in ("quantize", "apply_frame_many"):
        split[f"{k}_copy_ms"] = copy_ms(scalar_bytes(n)[k], device, lambda fn: graph_ms(fn, iters))
    eager_ms = kern["detail"]["frame_s"] * 1e3
    split["frame_eager_ms"] = eager_ms
    split["overhead_ms"] = eager_ms - split["scale_ms"] - split["quantize_ms"] - split["apply_frame_many_ms"]
    for k, b in scalar_bytes(n).items():
        split[f"{k}_bound_ms"] = b / rate * 1e3

    # a profiler window over the eager chain: device busy share, time by kernel
    os.makedirs(OUT_DIR, exist_ok=True)
    r.copy_(torch.randn(n, generator=gen, device=device))
    whole_frame()
    torch.cuda.synchronize()
    frames = 100
    t0 = time.perf_counter()
    with trace(os.path.join(OUT_DIR, "codec_chain_trace")) as prof:
        for _ in range(frames):
            whole_frame()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a CPU operator's device time repeats its kernels'
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    # the profiler slows the host many times over, so the busy share is the
    # profiled kernel time per frame over the unprofiled eager frame time
    split["kernel_ms_per_frame_profiled"] = dev_us / 1e3 / frames if dev_us else None
    split["busy_share"] = dev_us / 1e3 / frames / eager_ms if dev_us else None
    print(f"[6] profiler window: {frames} eager frames in {wall_ms:.3f} ms under the profiler, "
          f"{len(kern)} kernel names, {dev_us / 1e3:.3f} ms of kernel time")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[6] profile: {e.key[:70]}: {e.self_device_time_total / frames:.3f} us/frame, "
              f"{e.count / frames:.2f} launches/frame")
    print(f"[6] frame split at n={n} (ms): " + ", ".join(f"{k} {v:.6f}" if v is not None else f"{k} not measured"
                                                       for k, v in split.items()))
    return {"bench": {"kernel": kern, "plain": plain}, "launches": launches, "split": split}


# -- phase 7 --------------------------------------------------------------------


def sweep(device, rate: float, log2s=SWEEP_LOG2, seconds: float = SWEEP_SECONDS) -> dict:
    """Phase 7: config 5's sweep through the port's pareto.measure_size;
    the RMS decay must be within 0.45-0.55 at every size."""
    from shared_tensor_tpu_torch.benchmarks import pareto
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.utils.timing import copy_ms, event_ms

    rows = []
    CC.reset_launches()
    for log2n in log2s:
        n = 1 << log2n
        row = pareto.measure_size(CC, n, ScalePolicy.POW2_RMS, device, target_seconds=seconds, budget_s=60.0)
        print(json.dumps(row))
        print(f"[7] n=2^{log2n}: {row['frame_us']:.3f} us/frame, {row['equiv_gbps']} GB/s equiv, "
              f"RMS decay {row['rms_decay_per_frame']}, peak {row['peak_bytes'] / 2**30:.2f} GiB")
        if not 0.45 <= row["rms_decay_per_frame"] <= 0.55:
            raise AssertionError(f"RMS decay {row['rms_decay_per_frame']} at 2^{log2n} is outside 0.45-0.55")
        rows.append(row)
        torch.cuda.empty_cache()
    launches = {k: CC.LAUNCHES[k] for k in ("quantize", "apply_frame_many")}
    print(f"[7] launches in the sweep: {launches}")

    n = 1 << log2s[-1]
    gen = torch.Generator(device=device).manual_seed(2)
    r = torch.randn(n, generator=gen, device=device)
    frame, _ = CC.quantize_kernel(r.clone(), n)
    events = lambda fn: event_ms(fn, 10)
    big = {"n": n, "quantize_ms": events(lambda: CC.quantize_kernel(r, n, scale=frame.scale)),
           "quantize_bound_ms": scalar_bytes(n)["quantize"] / rate * 1e3}
    del r
    for k in D_TARGETS:
        vs = [torch.zeros(n, device=device) for _ in range(k)]
        nbytes = scalar_bytes(n, k)["apply_frame_many"]
        d = {"ms": events(lambda: CC.apply_frame_many_kernel(vs, frame, n)),
             "bound_ms": nbytes / rate * 1e3}
        del vs
        d["copy_ms"] = copy_ms(nbytes, device, events)
        big[f"apply_frame_many_k{k}"] = d
        print(f"[7] D at n=2^{log2s[-1]} K={k}: {d['ms']:.4f} ms, bound {d['bound_ms']:.4f} ms "
              f"({100 * d['bound_ms'] / d['ms']:.1f}% of it), copy_ms {d['copy_ms']:.4f}")
    print(f"[7] C at n=2^{log2s[-1]}: {big['quantize_ms']:.4f} ms (bound {big['quantize_bound_ms']:.4f})")
    del frame
    torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches, "big": big}


# -- phase 8 --------------------------------------------------------------------


def _free_port() -> int:
    """A loopback port the OS hands out."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: A peer's receive faults: frames dropped because their apply raised,
#: messages whose handler raised, recv-loop restarts, unspoken kinds.
FAULTS = ("st_apply_dropped_total", "st_msg_errors_total", "st_recv_restarts_total", "st_unknown_msgs_total")


def _healthy(peers) -> None:
    """Raise if a peer's thread died, it holds an error, or its receive
    path survived a fault (each would hide a loss that agreement within
    the tolerance need not show)."""
    for i, p in enumerate(peers):
        if p._error is not None or not p.threads_alive():
            raise AssertionError(f"peer {i}: error {p._error!r}, threads alive {p.threads_alive()}")
        m = p.metrics()
        faults = {k: m[k] for k in FAULTS if m[k]}
        if faults:
            raise AssertionError(f"peer {i}: receive faults {faults}")


def _leaf_rel_errs(peers, target, mag, spec) -> list[float]:
    """Each peer's worst per-leaf max |replica - target| / the leaf's max
    |target|, computed on the device (target: flat f32 on the device)."""
    from shared_tensor_tpu_torch.ops import table as TT

    row_leaf = TT._consts(spec, str(target.device))[0]
    out = []
    for p in peers:
        d = (p.st.snapshot_flat().to(target.device) - target).abs().view(-1, 128).amax(dim=1)
        leaf = torch.zeros(spec.num_leaves, device=target.device).scatter_reduce(0, row_leaf, d, reduce="amax")
        out.append(float((leaf.double() / mag).max()))
    return out


def _leaf_rel_err(peers, target, mag, spec) -> float:
    """The worst of :func:`_leaf_rel_errs` over ``peers``."""
    return max(_leaf_rel_errs(peers, target, mag, spec))


def _wait_agree(peers, target, mag, spec, tol: float, deadline_s: float, poll_s: float = 0.05,
                per_peer: dict | None = None) -> tuple[float, float]:
    """Poll every ``poll_s`` until every replica is within ``tol``; returns
    (seconds, worst error), and in ``per_peer`` (when given) the seconds at
    which each peer's replica was first seen within ``tol``. Raises at the
    deadline or when a peer's thread died."""
    t0 = time.perf_counter()
    while True:
        _healthy(peers)
        errs = _leaf_rel_errs(peers, target, mag, spec)
        if per_peer is not None:
            for i, e in enumerate(errs):
                if e <= tol:
                    per_peer.setdefault(i, time.perf_counter() - t0)
        err = max(errs)
        if err <= tol:
            return time.perf_counter() - t0, err
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"replicas did not agree within {deadline_s} s: worst leaf error {err:.3e}")
        time.sleep(poll_s)


def peer_example(device) -> dict:
    """8a, BASELINE config 1 over the TCP tree: a master seeds
    arange(1, 241) as 4x5x6x2, a joiner fetches it, both add (1.0 and 0.5),
    both must read seed + both deltas within 1e-6."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch

    seed = np.arange(1.0, 241.0, dtype=np.float32).reshape(4, 5, 6, 2)
    want = torch.from_numpy(seed + 1.5).to(device)
    cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0))
    port = _free_port()
    t0 = time.perf_counter()
    with create_or_fetch("127.0.0.1", port, seed, cfg, device=device) as m, create_or_fetch(
        "127.0.0.1", port, np.zeros_like(seed), cfg, device=device
    ) as j:
        m.add(np.full_like(seed, 1.0))
        j.add(torch.full(seed.shape, 0.5, device=device))
        while True:
            _healthy((m, j))
            err = max(float((p.read() - want).abs().max()) for p in (m, j))
            if err <= 1e-6 or time.perf_counter() - t0 > 60:
                break
            time.sleep(0.02)
        _healthy((m, j))
        res = {"seconds": time.perf_counter() - t0, "max_abs_err": err,
               "frames_out": [m.st.frames_out, j.st.frames_out]}
    print(f"[8a] config 1 over TCP: read-back error {err:.3e} (limit 1e-6) after {res['seconds']:.3f} s, "
          f"frames out {res['frames_out']}")
    if err > 1e-6:
        raise AssertionError(f"config 1 read-back error {err:.3e} > 1e-6")
    return res


def peer_tree(template, device, seed: int, n_peers: int = 4, deadline_s: float = 120.0) -> dict:
    """8b: ``n_peers`` peers over loopback TCP on one card, every
    SharedTensor on ``device``: the master seeded from ``seed``, the
    joiners fetch it (the third below the master's two children), then
    each adds its own update; every replica must reach seed + every update
    within AGREE_REL of each leaf's max |value| before the deadline."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec, tree_flatten, tree_unflatten

    spec = make_spec(template)
    seed_tree, deltas = tree_updates(template, seed, n_peers)
    leaves = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
    seed_flat = flatten(seed_tree, spec, device)
    seed_mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    for d in deltas:
        for j, x in enumerate(tree_flatten(d)[0]):
            leaves[j] += x
    target = flatten(tree_unflatten(spec.treedef, [x.astype(np.float32) for x in leaves]), spec, device)
    mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0))
    port = _free_port()
    peers = []
    try:
        t0 = time.perf_counter()
        peers.append(create_or_fetch("127.0.0.1", port, seed_tree, cfg, timeout=60.0, device=device))
        for _ in range(n_peers - 1):
            peers.append(create_or_fetch("127.0.0.1", port, template, cfg, timeout=60.0, device=device))
        t_join = time.perf_counter() - t0
        children = [len(p.node.links) - (0 if p.is_master else 1) for p in peers]
        if sum(children) != n_peers - 1 or children[0] != 2:
            raise AssertionError(f"unexpected tree: child links per peer {children}")
        t_seed, err_seed = _wait_agree(peers, seed_flat, seed_mag, spec, AGREE_REL, deadline_s)
        before = [p.metrics() for p in peers]
        t1 = time.perf_counter()
        for p, d in zip(peers, deltas):
            p.add(d)
        t_last_add = time.perf_counter()
        t_conv, err = _wait_agree(peers, target, mag, spec, AGREE_REL, deadline_s)
        _sync(device)
        _healthy(peers)
        after = [p.metrics() for p in peers]
        phase_s = time.perf_counter() - t1
    finally:
        for p in peers:
            p.close()
    per_peer = []
    for i, (b, a) in enumerate(zip(before, after)):
        d = {k: a[k] - b.get(k, 0) for k in a if not k.startswith("st_link_")}
        links = {}
        for k, v in a.items():
            if k.startswith("st_link_"):
                name, link = k.split("{link=")
                links.setdefault(int(link.strip('"}')), {})[name] = v - b.get(k, 0)
        per_peer.append({"peer": i, "master": i == 0, "delta": d, "links": links})
    res = {
        "peers": n_peers, "join_s": t_join, "seed_converge_s": t_seed, "seed_err": err_seed,
        "last_add_to_converged_s": t_conv, "adds_s": t_last_add - t1, "worst_rel_err": err,
        "window_s": phase_s, "per_peer": per_peer,
    }
    for pp in per_peer:
        d = pp["delta"]
        print(f"[8b] peer {pp['peer']}{' (master)' if pp['master'] else ''}: frames out {d['st_frames_out_total']} "
              f"in {d['st_frames_in_total']}, msgs out {d['st_msgs_out_total']} in {d['st_msgs_in_total']}, "
              f"data MB out {d['st_data_bytes_out_total'] / 1e6:.1f} in {d['st_data_bytes_in_total'] / 1e6:.1f}, "
              f"retransmits {d['st_retransmit_msgs_total']}, dedup {d['st_dedup_discards_total']}, "
              f"ignored ctrl {d['st_ctrl_ignored_total']}, faults "
              + ", ".join(f"{k[3:-6]} {d[k]}" for k in FAULTS))
        for link, v in sorted(pp["links"].items()):
            fo = v.get("st_link_frames_out_total", 0)
            print(f"[8b]   link {link}: {v.get('st_link_bytes_out_total', 0) / 1e6:.1f} MB out on the wire, "
                  f"{fo} frames out = {fo / phase_s:.1f} frames/s over the {phase_s:.3f} s window")
        secs = {k[3:-14]: d[k] for k in d if k.endswith("_seconds_total")}
        n = max(1, d["st_frames_out_total"])
        m_in = max(1, d["st_frames_in_total"])
        print(f"[8b]   host ms per frame: fetch wait {1e3 * secs['fetch_wait'] / n:.4f}, encode "
              f"{1e3 * secs['encode'] / n:.4f}, socket {1e3 * secs['send'] / n:.4f} (out); decode "
              f"{1e3 * secs['decode'] / m_in:.4f}, H2D {1e3 * secs['h2d'] / m_in:.4f}, apply incl. H2D "
              f"{1e3 * secs['apply'] / m_in:.4f} of which the state lock {1e3 * secs['apply_lock_wait'] / m_in:.4f} "
              f"(in); send loop busy {secs['send_loop_busy']:.3f} s, "
              f"fetch wait share {secs['fetch_wait'] / max(1e-9, secs['send_loop_busy']):.4f}")
    tot = lambda k: sum(pp["delta"][k] for pp in per_peer)
    res["fetch_wait_share"] = tot("st_fetch_wait_seconds_total") / max(1e-9, tot("st_send_loop_busy_seconds_total"))
    res["frames_out"] = tot("st_frames_out_total")
    res["retransmits"] = tot("st_retransmit_msgs_total")
    print(f"[8b] {n_peers} peers, ResNet-18 table ({spec.num_leaves} leaves, {spec.total_n} elements): joined in "
          f"{t_join:.3f} s, seed agreed in {t_seed:.3f} s; last add to agreement {t_conv:.3f} s "
          f"(worst leaf error {err:.3e} of max|value|, limit {AGREE_REL}); {res['frames_out']} frames out, "
          f"{res['retransmits']} retransmissions; fetch wait share of the send loops {res['fetch_wait_share']:.4f}")
    return res


def fetch_ab(template, device, k: int, depth: int = 8, bursts: int = 40) -> dict:
    """8c: host ms per K-frame burst that the sender waits for its fetch, at
    the ResNet-18 table, with ``depth`` bursts in flight as the send loop
    keeps them: the asynchronous fetch against the parent commit's
    blocking one (the same SharedTensor with its side stream taken away,
    so finish_frame_burst runs the plain .cpu() copies; the burst graph,
    captured in the warm-up, replays in both); in turns (blocking, async,
    async, blocking)."""
    from shared_tensor_tpu_torch.core import SharedTensor

    st = SharedTensor(random_like(template, np.random.default_rng(3)), seed_values=True, device=device)
    st.new_link(1)
    stream = st._fetch_stream

    def run(asynchronous: bool):
        st._fetch_stream = stream if asynchronous else None
        q = []
        w0 = st.fetch_wait_s
        t0 = time.perf_counter()
        for i in range(bursts + depth):
            if i < bursts:
                q.append(st.begin_frame_burst_device(1, k))
            if len(q) > depth or i >= bursts:
                seq, df = q.pop(0)
                st.finish_frame_burst(df)
                st.ack_frame(1, seq)
        _sync(device)
        st._fetch_stream = stream
        return st.fetch_wait_s - w0, time.perf_counter() - t0

    cuda = torch.device(device).type == "cuda"
    pinned_allocs = lambda: torch.cuda.host_memory_stats().get("num_host_alloc") if cuda else None
    run(True)  # warm-up: the pinned pool and the kernels
    runs = {"blocking": [], "async": []}
    for name in ("blocking", "async", "async", "blocking"):
        a0 = pinned_allocs()
        wait, wall = run(name == "async")
        a1 = pinned_allocs()
        runs[name].append({"wait_ms_per_burst": 1e3 * wait / bursts, "wall_ms_per_burst": 1e3 * wall / bursts,
                           "pinned_allocs": None if a0 is None or a1 is None else a1 - a0})
    for name, rs in runs.items():
        print(f"[8c] {name} fetch, K={k}, {bursts} bursts: wait ms per burst "
              + ", ".join(f"{r['wait_ms_per_burst']:.4f}" for r in rs) + "; wall ms per burst "
              + ", ".join(f"{r['wall_ms_per_burst']:.4f}" for r in rs) + "; pinned allocations "
              + ", ".join(str(r["pinned_allocs"]) for r in rs))

    # the receive side alone: one K-frame burst staged, copied and applied
    # to a replica and one other link's residual, in this one thread
    st.add(random_like(template, np.random.default_rng(4)))  # the bursts above drained the residual
    seq, df = st.begin_frame_burst_device(1, k)
    frames = st.finish_frame_burst(df)
    rx = SharedTensor(template, device=device)
    rx.new_link(1, seed=False)
    rx.new_link(2, seed=False)
    recv = []
    for _ in range(6):
        _sync(device)
        h0, t0 = rx.h2d_s, time.perf_counter()
        rx.receive_frames(1, frames)
        recv.append({"host_ms": 1e3 * (time.perf_counter() - t0), "staging_h2d_ms": 1e3 * (rx.h2d_s - h0)})
    recv = recv[1:]  # the first staged into a new pinned block
    print(f"[8c] receive_frames of {len(frames)} frames alone: host ms "
          + ", ".join(f"{r['host_ms']:.4f}" for r in recv) + "; of which staging + H2D "
          + ", ".join(f"{r['staging_h2d_ms']:.4f}" for r in recv))
    return {"k": k, "depth": depth, **runs, "receive": {"frames": len(frames), "runs": recv}}


# -- phases 9, 10 and 11 ---------------------------------------------------------

#: The chip phases' ranks share the one card, and NCCL refuses two ranks on
#: one device: they talk over gloo, which moves the tensors through pinned
#: host buffers (parallel/mesh.py).
POD_BACKEND = "gloo"
CHAR_PEERS, CHAR_BATCH, CHAR_SEQ, CHAR_LR = 4, 32, 128, 0.5  # BASELINE config 2, the example's defaults
CHAR_STEPS = 20  # compressed steps, the last CHAR_TIMED of them with stage times
CHAR_TIMED = 10
OVERLAP_STEPS = 5
DRAIN_STEPS = 10  # sync-only steps before replica_spread
SHARDED_STEPS = 10  # 2 peers x 2 shards
SHARDED_LR = 0.1  # at 0.5 the first 10 steps of SGD are too noisy to show the loss falling
RESNET_PEERS, RESNET_BATCH, RESNET_HW, RESNET_LR = 8, 32, 32, 0.05  # BASELINE config 4
RESNET_STEPS = 12  # per arm
BRIDGE_STEPS = 4  # timed steps per arm, after one warm-up step
RESUME_STEPS = 2  # steps from the checkpoint, live and restored


def pod_kernel_check(state, spec, mesh) -> dict:
    """Kernels A and B against their plain versions on this rank's block of
    the trained state, at the pod shapes: A with the per-leaf scales of the
    block, B with K = n_peer frames gathered from every peer (this peer's
    column zeroed) into N = 1 target. Collective (the scales and the
    frames). Returns {kernel: {"mismatches", "max_abs_err"}}."""
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.parallel import ici

    ctx = ici._make_ctx(mesh, spec, True)
    r0 = state.residual.clone()
    s_row = ici._leaf_scales(ctx, r0.view(-1, 128), ScalePolicy.POW2_RMS)[ctx.row_leaf].contiguous()
    r_k, r_p = r0.clone(), r0.clone()
    w_k = CC.quantize_rows_kernel(s_row, ctx.rowcount, r_k)
    w_p = CC.quantize_rows_plain(s_row, ctx.rowcount, r_p)
    words_all, scales_all = ici._codec_send(ctx, ScalePolicy.POW2_RMS, CC.quantize_rows_plain, r0.clone()).wait()
    v_k, v_p = state.values.clone(), state.values.clone()
    ici._codec_apply(ctx, CC.apply_rows_batch_kernel, v_k, words_all, scales_all)
    ici._codec_apply(ctx, CC.apply_rows_batch_plain, v_p, words_all, scales_all)
    torch.cuda.synchronize()
    return {
        "quantize_rows": {"mismatches": _bitdiff(w_k, w_p) + _bitdiff(r_k, r_p), "max_abs_err": _maxerr(r_k, r_p)},
        "apply_rows_batch": {"mismatches": _bitdiff(v_k, v_p), "max_abs_err": _maxerr(v_k, v_p),
                             "k": int(words_all.shape[0]), "zero_column": int(mesh.peer)},
    }


def _char_batches(data, seed: int, n_peer: int):
    from shared_tensor_tpu_torch.models import char_rnn as m

    return lambda i: m.make_batches(data, CHAR_BATCH, CHAR_SEQ, torch.Generator().manual_seed(seed * 100_003 + i),
                                    n_peer=n_peer)


def pod_char_rnn(mesh, mesh22, seed: int) -> dict:
    """Phase 9, on each of the 4 ranks: BASELINE config 2 at full width.
    CHAR_STEPS compressed steps (tokens/s over all but the first; stage
    times over the last CHAR_TIMED), then OVERLAP_STEPS with the collective
    under the backward pass; the launches of A and B over those steps; A
    and B against their plain versions on the trained state; DRAIN_STEPS
    sync-only steps and the replica spread; then 2 peers x 2 shards on the
    same ranks (``mesh22``) for SHARDED_STEPS."""
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.parallel import build_sync_step
    from shared_tensor_tpu_torch.train import PodTrainer, build_train_step
    from shared_tensor_tpu_torch.utils.timing import Spans
    from shared_tensor_tpu_torch.examples.train_char_rnn import PANGRAM

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = m.CharRNNConfig()
    params = m.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    loss = lambda p, b: m.loss_fn(p, b, cfg)
    data = m.encode_corpus(PANGRAM, device=dev)
    batch = _char_batches(data, seed, mesh.n_peer)
    tr = PodTrainer(mesh, params, loss)
    losses = []
    spans = Spans(dev)
    timed = build_train_step(mesh, tr.spec, loss, spans=spans)
    CC.reset_launches()
    t0 = time.perf_counter()
    for i in range(CHAR_STEPS):
        if i < CHAR_STEPS - CHAR_TIMED:
            l, _ = tr.step(tr.shard_batch(batch(i)), lr=CHAR_LR)
        else:
            tr.state, _, l, _ = timed(tr.state, None, tr.shard_batch(batch(i)), CHAR_LR)
        losses.append(l.cpu().numpy())  # the host waits for the step here
        if i == 0:
            t1 = time.perf_counter()
        if i == CHAR_STEPS - CHAR_TIMED - 1:
            t2 = time.perf_counter()
    untimed = CHAR_STEPS - CHAR_TIMED - 1
    over = PodTrainer(mesh, params, loss, overlap=True)
    over.state = tr.state
    t3 = time.perf_counter()
    for i in range(CHAR_STEPS, CHAR_STEPS + OVERLAP_STEPS):
        l, _ = over.step(over.shard_batch(batch(i)), lr=CHAR_LR)
        losses.append(l.cpu().numpy())
    t4 = time.perf_counter()
    launches = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    check = pod_kernel_check(over.state, over.spec, mesh)
    drain = build_sync_step(mesh, over.spec)
    for _ in range(DRAIN_STEPS):
        drain(over.state)
    spread = over.replica_spread()
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = mesh.n_peer * CHAR_BATCH * CHAR_SEQ

    # 2 peers x 2 shards over the same 4 ranks: the shard-group reductions
    sh = PodTrainer(mesh22, params, loss)
    batch22 = _char_batches(data, seed + 1, 2)
    CC.reset_launches()
    sh_losses = [sh.step(sh.shard_batch(batch22(i)), lr=SHARDED_LR)[0].cpu().numpy() for i in range(SHARDED_STEPS)]
    sh_launches = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    sh_check = pod_kernel_check(sh.state, sh.spec, mesh22)
    rows_local = tr.spec.rows // mesh.n_shard
    del tr, over, sh, timed, drain
    torch.cuda.empty_cache()  # phase 10 follows on the same ranks
    return {
        "peer": mesh.peer, "device": str(dev), "backend": mesh.backend,
        "losses": np.stack(losses).tolist(), "launches": launches, "check": check,
        "tokens_per_s": tokens * untimed / (t2 - t1), "step_ms": 1e3 * (t2 - t1) / untimed,
        "first_step_ms": 1e3 * (t1 - t0), "overlap_step_ms": 1e3 * (t4 - t3) / OVERLAP_STEPS,
        "overlap_tokens_per_s": tokens * OVERLAP_STEPS / (t4 - t3),
        "stage_ms": spans.ms(), "spread_after_drain": spread, "peak_bytes": peak,
        "rows_local": rows_local,
        "sharded": {"losses": np.stack(sh_losses).tolist(), "launches": sh_launches, "check": sh_check,
                    "peer": mesh22.peer, "shard": mesh22.shard},
    }


def resnet_batch(seed: int, step: int, n_peer: int, n: int = RESNET_BATCH, hw: int = RESNET_HW, classes: int = 10):
    """Synthetic 32x32 images (a class-dependent shift plus noise) and
    labels for every peer, [n_peer, n, hw, hw, 3] and [n_peer, n], from
    numpy seeded by (seed, step)."""
    rng = np.random.default_rng((seed, step))
    labels = rng.integers(0, classes, n_peer * n)
    x = rng.normal(size=(n_peer * n, hw, hw, 3)) * 0.3 + ((labels - (classes - 1) / 2) * 0.5)[:, None, None, None]
    return x.astype(np.float32).reshape(n_peer, n, hw, hw, 3), labels.reshape(n_peer, n)


def pod_resnet(mesh, seed: int) -> dict:
    """Phase 10, on each of the 8 ranks: BASELINE config 4, ResNet-18 at
    the default width, RESNET_STEPS of the compressed arm and of the exact
    arm from the same parameters and batches."""
    from shared_tensor_tpu_torch.models import resnet as r
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.parallel import frame_ici_bytes
    from shared_tensor_tpu_torch.train import PodTrainer

    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = r.ResNetConfig()
    out = {"peer": mesh.peer}
    for compressed in (True, False):
        params = r.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
        tr = PodTrainer(mesh, params, lambda p, b: r.loss_fn(p, b, cfg), compressed=compressed)
        CC.reset_launches()
        losses = []
        t0 = time.perf_counter()
        for i in range(RESNET_STEPS):
            l, _ = tr.step(tr.shard_batch(resnet_batch(seed, i, mesh.n_peer)), lr=RESNET_LR)
            losses.append(float(l.mean()))
            if i == 0:
                t1 = time.perf_counter()
        t2 = time.perf_counter()
        out["compressed" if compressed else "exact"] = {
            "losses": losses, "step_ms": 1e3 * (t2 - t1) / (RESNET_STEPS - 1), "first_step_ms": 1e3 * (t1 - t0),
            "launches": {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")},
            "frame_ici_bytes": frame_ici_bytes(tr.spec, mesh.n_peer, compressed),
            "spread": tr.replica_spread(),
        }
        del tr
        torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _loss_fell(losses) -> bool:
    """Finite, and the mean of the last 5 steps' losses (SGD at these rates
    is noisy step to step) below the first step's."""
    ls = np.asarray(losses, dtype=np.float64)
    return bool(np.isfinite(ls).all() and ls[-5:].mean() < ls[0])


def pod_ranks(world, seed: int, port: int) -> dict:
    """Phases 9, 10 and 11 in one spawn of RESNET_PEERS ranks (a spawn and
    a CUDA context per rank cost seconds): every rank builds every mesh;
    phase 9 runs on the first CHAR_PEERS ranks while the others wait at a
    barrier, then phase 10 on all, then phase 11 on the first
    2 * PEERS of benchmarks/hierarchical.py."""
    import torch.distributed as dist

    from shared_tensor_tpu_torch.benchmarks import hierarchical as H
    from shared_tensor_tpu_torch.parallel import make_mesh

    first = range(CHAR_PEERS)
    mesh4 = make_mesh(CHAR_PEERS, 1, device=world.device, backend=world.backend, ranks=first)
    mesh22 = make_mesh(2, 2, device=world.device, backend=world.backend, ranks=first)
    pod, index, both = H.make_pods(world.device, world.backend, ranks=range(2 * H.PEERS))
    t0 = time.perf_counter()
    char = None if mesh4 is None else pod_char_rnn(mesh4, mesh22, seed)
    dist.barrier()
    t1 = time.perf_counter()
    resnet = pod_resnet(world, seed)
    dist.barrier()
    t2 = time.perf_counter()
    bridge = None if pod is None else pod_bridge(pod, index, both, seed, port)
    dist.barrier()
    return {"char": char, "resnet": resnet, "bridge": bridge, "phase9_s": t1 - t0, "phase10_s": t2 - t1,
            "phase11_s": time.perf_counter() - t2}


def _stopwatch():
    """({name: seconds}, lap): ``lap(name)`` records the seconds since the
    previous lap (or the call)."""
    secs, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        secs[name] = now - last[0]
        last[0] = now

    return secs, lap


def checkpoint_roundtrip(live, index: int, setup) -> dict:
    """Phase 11's checkpoint of pod A's trainer (collective over its ranks),
    once its bridge is closed: save_trainer and save_pod_sharded with their
    bytes and seconds; load_trainer into a fresh PodTrainer and
    load_pod_sharded, both bit for bit; then RESUME_STEPS steps from the
    saved point, once by the live trainer and once by the restored one, on
    the same batches, losses and states bit for bit. Deterministic
    algorithms are on for those steps: the embedding's and the loss's
    backward accumulate by index, which PyTorch documents as
    nondeterministic on CUDA."""
    import shutil

    from shared_tensor_tpu_torch.benchmarks import hierarchical as H
    from shared_tensor_tpu_torch.parallel.mesh import all_true
    from shared_tensor_tpu_torch.train import PodTrainer
    from shared_tensor_tpu_torch.utils import checkpoint as ckpt

    mesh = live.mesh
    root = os.path.join(OUT_DIR, "checkpoint")
    path, sdir = os.path.join(root, "trainer.npz"), os.path.join(root, "sharded")
    os.makedirs(root, exist_ok=True)
    secs, lap = _stopwatch()
    ckpt.save_trainer(live, path)
    lap("save_trainer")
    ckpt.save_pod_sharded(live.state, live.spec, sdir, mesh)
    lap("save_sharded")
    out = {"seconds": secs, "trainer_bytes": os.path.getsize(path),
           "sharded_bytes": sum(os.path.getsize(os.path.join(sdir, f)) for f in os.listdir(sdir))}
    fresh = PodTrainer(mesh, live.template, live.loss_fn)
    lap("fresh_trainer")
    ckpt.load_trainer(fresh, path)
    lap("load_trainer")
    sharded = ckpt.load_pod_sharded(sdir, mesh, live.spec)
    lap("load_sharded")
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    out["restored_equal"] = all_true(mesh, same(fresh.state, live.state) and fresh.steps == live.steps)
    out["sharded_equal"] = all_true(mesh, same(sharded, live.state))
    batch = H.batches(live, index, setup)
    lap("compare")
    # an op with no deterministic version raises here; cuBLAS is pinned by
    # CUBLAS_WORKSPACE_CONFIG, set before the ranks were spawned. This is
    # torch.use_deterministic_algorithms(True) without its import of
    # torch._inductor (for inductor's own flag; nothing here compiles),
    # which took seconds in each rank at its first call
    torch._C._set_deterministic_algorithms(True)
    try:
        losses, out["resume_ms"] = [], []
        for i in range(RESUME_STEPS):
            b = batch(2_000_000 + i)
            row = []
            for trainer in (live, fresh):
                t0 = time.perf_counter()
                losses.append(trainer.step(b, setup.lr)[0])
                torch.cuda.synchronize(mesh.device)
                row.append(1e3 * (time.perf_counter() - t0))
            out["resume_ms"].append(row)
        pairs = list(zip(losses[::2], losses[1::2]))
        out["resume_losses"] = [[float(x.mean()), float(y.mean())] for x, y in pairs]
    finally:
        torch._C._set_deterministic_algorithms(False)
    lap("resume")
    out["resume_equal"] = all_true(mesh, all(torch.equal(x, y) for x, y in pairs) and same(fresh.state, live.state))
    if mesh.peer == 0:
        shutil.rmtree(root, ignore_errors=True)
    lap("cleanup")
    return out


def pod_bridge(pod, index: int, both, seed: int, port: int) -> dict:
    """Phase 11, on each of the 2 * PEERS ranks: BASELINE config 2 as two
    pods of PEERS bridged over loopback TCP (benchmarks/hierarchical.py):
    the unbridged arm on PodTrainers with no peer, the
    join, the bridged arm, the settle, the bridged step by stage, the bridge
    peers' frames and this rank's launches of A and B over them; then, the
    bridges closed, pod A's checkpoint round trip and each rank's A and B
    against their plain versions on its state. ``stage_s`` holds the
    seconds of each stage."""
    from shared_tensor_tpu_torch.benchmarks import hierarchical as H
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.parallel.mesh import all_true

    setup = H.Setup(seed=seed, steps=BRIDGE_STEPS)  # config 2's batch, lr 0.1
    stage_s, lap = _stopwatch()
    CC.reset_launches()
    out = {"pod": index, "peer": pod.peer, "bridge": pod.peer == 0, "stage_s": stage_s}
    plain = H.run_arms(H.pod_trainer(pod, setup), index, both, setup, ("unbridged",))
    lap("unbridged")
    tr = H.create(pod, index, both, port, setup)
    lap("create")
    try:
        # pod B was seeded from its peer's replica at the handshake, before
        # the tree's state had arrived: it trains once it has the model
        out["join"] = H.settle(tr, both)
        lap("join")
        bridged = H.run_arms(tr, index, both, setup, ("bridged",))
        out["arms"] = plain["arms"] | bridged["arms"]
        out["losses"] = plain["losses"] | bridged["losses"]
        lap("bridged")
        out["settle"] = H.settle(tr, both)
        lap("settle")
        out["split_ms"] = H.step_split(tr, index, setup)
        out["frames"] = H.bridge_frames(tr)
        out["launches"] = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
        lap("split")
    finally:
        tr.close()
    lap("close")
    # the checkpoint and the kernel check on the pods' trainers, their
    # bridges closed (a bridge peer streams until every residual is zero)
    out["checkpoint"] = checkpoint_roundtrip(tr.pod, index, setup) if index == 0 else None
    all_true(both, True)
    lap("checkpoint")
    out["check"] = pod_kernel_check(tr.pod.state, tr.pod.spec, pod)
    lap("check")
    return out


def bridge_report(res: list, secs: float) -> dict:
    """Print phase 11's block from every rank's pod_bridge results; returns
    {"summary": ..., "bad": [failures]}."""
    from shared_tensor_tpu_torch.benchmarks import hierarchical as H

    arms = ("unbridged", "bridged")
    summ = H.summarize(res, arms=arms)
    ms, bad = summ["ms_per_step"], []
    ranks = lambda: range(len(res))
    tag = lambda i: f"{i}{' (bridge)' if res[i]['bridge'] else ''}"
    print(f"[11] BASELINE config 2 as two pods of {H.PEERS} ranks (ranks 0-{len(res) - 1}, backend "
          f"{POD_BACKEND}) bridged over loopback TCP, the pods on different batch streams; seconds by stage "
          + ", ".join(f"{k} {v:.3f}" for k, v in res[0]["stage_s"].items()) + f"; ms/step (the slower rank's, {BRIDGE_STEPS} steps an arm): unbridged "
          f"{ms['unbridged']:.3f} (no peer), bridged (an exchange every step) {ms['bridged']:.3f}: bridge overhead "
          f"{summ['bridge_overhead_pct_every_step']:.2f}%")
    for arm in arms:
        print(f"[11] {arm} ms/step by rank: "
              + ", ".join(f"{tag(i)} {summ['rank_step_ms'][arm][i]:.3f}" for i in ranks()))
    for i in ranks():
        print(f"[11] rank {tag(i)} bridged step by stage, ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in res[i]["split_ms"].items())
              + f"; launches {res[i]['launches']}; kernel vs plain {res[i]['check']}")
    for i in ranks():
        f = res[i]["frames"]
        if f is not None:
            print(f"[11] bridge of pod {res[i]['pod']} (rank {i}): frames out {f['frames_out']} in "
                  f"{f['frames_in']}, by link {f['links']}")
    def under(st, thr):
        return next((f"{t:.3f} s" for t, r in st["curve"] if r <= thr), "not reached")

    for name, st in (("join: pod B receives the model", res[0]["join"]),
                     ("settle from the last training step", res[0]["settle"])):
        print(f"[11] {name}: {st['exchanges']} exchanges, {st['seconds']:.3f} s to a gap of {st['gap_rel']:.3e} of "
              f"each leaf's max |value| (limit {H.AGREE_REL}; {st['gap_abs']:.3e} absolute); under 1e-3 after "
              f"{under(st, 1e-3)}, under 1e-4 after {under(st, 1e-4)}")
    for arm in arms:
        print(f"[11] {arm} mean loss by step, pod A: " + " ".join(f"{x:.4f}" for x in res[0]["losses"][arm])
              + "; pod B: " + " ".join(f"{x:.4f}" for x in res[H.PEERS]["losses"][arm]))
    st = res[0]["settle"]
    ck = res[0]["checkpoint"]
    mb, cs = lambda n: n / 1e6, ck["seconds"]
    print(f"[11] checkpoint of pod A: save_trainer {mb(ck['trainer_bytes']):.1f} MB in {cs['save_trainer']:.3f} s "
          f"({mb(ck['trainer_bytes']) / cs['save_trainer']:.1f} MB/s), save_pod_sharded "
          f"{mb(ck['sharded_bytes']):.1f} MB in {cs['save_sharded']:.3f} s "
          f"({mb(ck['sharded_bytes']) / cs['save_sharded']:.1f} MB/s); load_trainer {cs['load_trainer']:.3f} s, "
          f"load_pod_sharded {cs['load_sharded']:.3f} s; restored bit for bit {ck['restored_equal']}, sharded "
          f"{ck['sharded_equal']}; {RESUME_STEPS} steps live and restored (deterministic algorithms on): losses "
          f"{ck['resume_losses']}, bit for bit {ck['resume_equal']}, ms per step [live, restored] "
          f"{[[round(x, 3) for x in row] for row in ck['resume_ms']]}; seconds by stage "
          + ", ".join(f"{k} {v:.3f}" for k, v in cs.items()))
    print(f"[11] phase 11 {secs:.3f} s")
    for name in ("join", "settle"):
        if not res[0][name]["agreed"]:
            bad.append(f"{name}: the pods did not agree within {H.SETTLE_S} s: gap {res[0][name]['gap_rel']:.3e}")
    bad += [f"checkpoint: {k} false" for k in ("restored_equal", "sharded_equal", "resume_equal") if not ck[k]]
    want = 2 * (1 + BRIDGE_STEPS)  # one A and one B per pod step
    for i in ranks():
        if any(v < want for v in res[i]["launches"].values()):
            bad.append(f"rank {i} launches {res[i]['launches']} (want at least {want} each)")
        bad += [f"rank {i} {k}: {v['mismatches']} mismatches" for k, v in res[i]["check"].items() if v["mismatches"]]
        if not _loss_fell(res[i]["losses"]["bridged"]):
            bad.append(f"rank {i}: loss did not fall in the bridged arm ({res[i]['losses']['bridged']})")
    summ["checkpoint"] = ck
    for name in ("join", "settle"):
        st = res[0][name]
        summ[name] = {k: v for k, v in st.items() if k != "curve"} | {
            "under_1e-3": under(st, 1e-3), "under_1e-4": under(st, 1e-4)}
    summ["seconds"] = secs
    summ["stage_s"] = res[0]["stage_s"]
    return {"summary": summ, "bad": bad}


def pod_phases(device, rate: float, seed: int) -> dict:
    """Phases 9, 10 and 11 (see the module docstring); raises on any failed
    check. Returns their results and the pod-shape times of A and B."""
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.ops.table import make_spec
    from shared_tensor_tpu_torch.parallel import run_mesh

    print(f"[9] {CHAR_PEERS} of {RESNET_PEERS} ranks on one card (the rest wait for phase 10), "
          f"backend={POD_BACKEND} (NCCL refuses two ranks on one device)")
    # phase 11's resume runs with deterministic algorithms, which need
    # cuBLAS's workspace pinned in every rank before its first matmul
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    ranks = run_mesh(pod_ranks, RESNET_PEERS, 1, seed, _free_port(), device=device, backend=POD_BACKEND,
                     timeout_s=600)
    spawn_s = time.perf_counter() - t0
    char = [r["char"] for r in ranks[:CHAR_PEERS]]
    res10 = [r["resnet"] for r in ranks]
    secs9, secs10 = ranks[0]["phase9_s"], ranks[0]["phase10_s"]
    spec = make_spec(m.init_params(torch.Generator().manual_seed(seed), m.CharRNNConfig(), device=device))
    steps = CHAR_STEPS + OVERLAP_STEPS
    bad = []
    for rk, res in enumerate(char):
        st = res["stage_ms"]
        sync_ms = sum(st.get(k, 0.0) for k in ("scales", "quantize", "gather", "apply"))
        print(f"[9] rank {rk}: {res['tokens_per_s']:.1f} tokens/s, {res['step_ms']:.3f} ms/step "
              f"(first step {res['first_step_ms']:.1f} ms); overlap {res['overlap_step_ms']:.3f} ms/step "
              f"({res['overlap_tokens_per_s']:.1f} tokens/s); stage ms: grads {st.get('grads', 0):.3f}, sync "
              f"{sync_ms:.3f} (scales {st.get('scales', 0):.3f}, A {st.get('quantize', 0):.3f}, collective "
              f"{st.get('gather', 0):.3f}, B {st.get('apply', 0):.3f}), other (update, loss gather) "
              f"{st.get('update', 0) + st.get('losses', 0):.3f}; loss first {np.mean(res['losses'][0]):.4f} last "
              f"{np.mean(res['losses'][-1]):.4f}; replica spread after {DRAIN_STEPS} sync-only steps "
              f"{res['spread_after_drain']:.3e}; peak {res['peak_bytes'] / 2**30:.3f} GiB; launches "
              f"{res['launches']}; kernel vs plain {res['check']}")
        sh = res["sharded"]
        print(f"[9] 2x2 rank {rk} (peer {sh['peer']}, shard {sh['shard']}): loss first "
              f"{np.mean(sh['losses'][0]):.4f} last {np.mean(sh['losses'][-1]):.4f}; launches {sh['launches']}; "
              f"kernel vs plain {sh['check']}")
        for name, want in (("launches", steps), ("sharded", SHARDED_STEPS)):
            got = res["launches"] if name == "launches" else sh["launches"]
            if any(v != want for v in got.values()):
                bad.append(f"rank {rk} {name}: {got} (want {want} each)")
        for c in (res["check"], sh["check"]):
            bad += [f"rank {rk} {k}: {v['mismatches']} mismatches" for k, v in c.items() if v["mismatches"]]
        for name, ls in (("4x1", res["losses"]), ("2x2", sh["losses"])):
            if not _loss_fell(np.mean(ls, axis=1)):
                bad.append(f"rank {rk} {name}: loss did not fall ({np.mean(ls, axis=1).tolist()})")
    print(f"[9] phase 9 {secs9:.3f} s (phases 9, 10 and 11 with the ranks' start {spawn_s:.3f} s)")
    if bad:
        raise AssertionError("phase 9: " + "; ".join(bad))

    for arm in ("compressed", "exact"):
        a = res10[0][arm]
        print(f"[10] ResNet-18 {arm}: {RESNET_PEERS} ranks, backend={POD_BACKEND}, {a['step_ms']:.3f} ms/step "
              f"(first {a['first_step_ms']:.1f} ms), frame_ici_bytes {a['frame_ici_bytes']}, losses "
              + " ".join(f"{x:.4f}" for x in a["losses"]) + f"; spread {a['spread']:.3e}; launches {a['launches']}")
        for rk, res in enumerate(res10):
            if not _loss_fell(res[arm]["losses"]):
                bad.append(f"rank {rk} {arm}: loss did not fall ({res[arm]['losses']})")
            want = RESNET_STEPS if arm == "compressed" else 0
            if any(v != want for v in res[arm]["launches"].values()):
                bad.append(f"rank {rk} {arm}: launches {res[arm]['launches']} (want {want} each)")
    print(f"[10] phase 10 {secs10:.3f} s; peak per rank "
          + ", ".join(f"{r['peak_bytes'] / 2**30:.3f}" for r in res10) + " GiB")
    if bad:
        raise AssertionError("phase 10: " + "; ".join(bad))

    res11 = [r["bridge"] for r in ranks if r["bridge"] is not None]
    bridge = bridge_report(res11, ranks[0]["phase11_s"])
    if bridge["bad"]:
        raise AssertionError("phase 11: " + "; ".join(bridge["bad"]))

    # every rank's full results go to a file; the summary to the output
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "pod.json"), "w") as f:
        json.dump({"char_rnn": char, "resnet": res10, "bridge": res11}, f)
    mean = lambda rows: float(np.mean(rows))
    summary = {
        "seconds": {"phase9": secs9, "phase10": secs10, "phase11": ranks[0]["phase11_s"],
                    "phases_9_10_11_with_start": spawn_s}, "backend": POD_BACKEND,
        "bridge": bridge["summary"],
        "char_rnn": [{k: v for k, v in r.items() if k not in ("losses", "sharded")}
                     | {"loss_first": mean(r["losses"][0]), "loss_last": mean(r["losses"][-1]),
                        "sharded_loss_first": mean(r["sharded"]["losses"][0]),
                        "sharded_loss_last": mean(r["sharded"]["losses"][-1]),
                        "sharded_launches": r["sharded"]["launches"]} for r in char],
        "resnet": {arm: res10[0][arm] for arm in ("compressed", "exact")}
                  | {"peak_bytes": [r["peak_bytes"] for r in res10]},
    }
    # A and B alone at the pod shapes of phase 9 (one rank's block of the
    # char-RNN table; B with K = 4 frames and N = 1 target)
    t = times(spec, device, rate, shapes=((CHAR_PEERS, 1),))
    return {"char_rnn": char, "bridge": res11, "summary": summary,
            "times": {"quantize_rows": t["quantize_rows"], "apply_rows_batch": t["apply_rows_batch"][0]}}


# -- phase 12 -------------------------------------------------------------------


def char_rnn_template() -> dict:
    """BASELINE config 2's table: the default CharRNNConfig's parameter
    shapes as zero float32 arrays (9 leaves, 3,870,976 elements)."""
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.ops.table import tree_flatten, tree_unflatten

    params = m.init_params(torch.Generator().manual_seed(0), m.CharRNNConfig(), device="cpu")
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [np.zeros(tuple(x.shape), np.float32) for x in leaves])


def cpu_model() -> str:
    """The host CPU's model name as lscpu gives it, or, where that reads
    "unknown" (a virtual machine may hide it), its vendor, family and model
    numbers."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except OSError:
        out = ""
    info = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    info = {k.strip(): v.strip() for k, v in info.items()}
    name = info.get("Model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{info.get('Vendor ID', 'unknown')} family {info.get('CPU family', '?')} model "
                f"{info.get('Model', '?')}, {info.get('CPU(s)', '?')} CPUs")
    return name


def _host_ms(fn, reps: int = 5) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def host_codec_check(template, seed: int, k: int = BATCH, n_targets: int = 2) -> dict:
    """12a: the port's libstcodec (ops/codec_np) against its plain numpy
    versions on this machine's CPU, on the char-RNN table with seeded data:
    K successive quantize_table frames (scales within the one-octave
    allowance, words and residuals bit for bit at the C loop's scales), the
    K frames applied to N targets (apply_table_batch), and accumulate_table,
    each counted in mismatching words or elements; host ms of each C loop
    and of its plain version."""
    from shared_tensor_tpu_torch.ops import codec_np as NP
    from shared_tensor_tpu_torch.ops.table import make_spec

    spec = make_spec(template)
    rng = np.random.default_rng(seed + 12)
    resid = NP.flatten_np(random_like(template, rng), spec)
    targets = tuple(NP.flatten_np(random_like(template, rng), spec) for _ in range(n_targets))
    update = NP.flatten_np(random_like(template, rng, 0.5), spec)
    bad = {"quantize_table": 0, "apply_table_batch": 0, "accumulate_table": 0, "scales_off_octave": 0,
           "scales_one_octave": 0}
    r, frames = resid, []
    for _ in range(k):
        s, w, r_next = NP.quantize_table_np(r, spec)
        s_plain = NP.compute_scales_plain(r, spec)
        ratio = s_plain[s > 0] / s[s > 0]
        bad["scales_off_octave"] += int(np.count_nonzero(~np.isin(ratio, (0.5, 1.0, 2.0)))
                                        + np.count_nonzero((s == 0) != (s_plain == 0)))
        bad["scales_one_octave"] += int(np.count_nonzero(ratio != 1.0))
        _, w_plain, r_plain = NP.quantize_table_plain(r, spec, scales=s)
        bad["quantize_table"] += int(np.count_nonzero(w != w_plain)) + _bitdiff(
            torch.from_numpy(r_next), torch.from_numpy(r_plain))
        frames.append((s, w))
        r = r_next
    scales, words = np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    got = NP.apply_table_batch_np(targets, scales, words, spec)
    want = NP.apply_table_batch_plain(targets, scales, words, spec)
    bad["apply_table_batch"] = sum(_bitdiff(torch.from_numpy(a), torch.from_numpy(b)) for a, b in zip(got, want))
    got = NP.accumulate_table_np(targets, update, spec)
    want = NP.accumulate_table_plain(targets, update, spec)
    bad["accumulate_table"] = sum(_bitdiff(torch.from_numpy(a), torch.from_numpy(b)) for a, b in zip(got, want))
    ms = {
        "quantize_table": _host_ms(lambda: NP.quantize_table_np(resid, spec)),
        "quantize_table_plain": _host_ms(lambda: NP.quantize_table_plain(resid, spec), 2),
        "apply_table_batch": _host_ms(lambda: NP.apply_table_batch_np(targets, scales, words, spec)),
        "apply_table_batch_plain": _host_ms(lambda: NP.apply_table_batch_plain(targets, scales, words, spec), 2),
        "accumulate_table": _host_ms(lambda: NP.accumulate_table_np(targets, update, spec)),
        "accumulate_table_plain": _host_ms(lambda: NP.accumulate_table_plain(targets, update, spec), 2),
    }
    cpu = cpu_model()
    print(f"[12a] host codec (libstcodec) vs plain numpy on {spec.num_leaves} leaves, {spec.total_n} elements, "
          f"K={k} N={n_targets}: mismatches " + ", ".join(f"{x} {bad[x]}" for x in
                                                          ("quantize_table", "apply_table_batch", "accumulate_table"))
          + f"; scales off by more than an octave {bad['scales_off_octave']}, one octave apart "
          f"{bad['scales_one_octave']}")
    print(f"[12a] host ms on {cpu}: quantize_table {ms['quantize_table']:.3f} (plain {ms['quantize_table_plain']:.3f}), "
          f"apply_table_batch K={k} N={n_targets} {ms['apply_table_batch']:.3f} "
          f"(plain {ms['apply_table_batch_plain']:.3f}), accumulate_table N={n_targets} "
          f"{ms['accumulate_table']:.3f} (plain {ms['accumulate_table_plain']:.3f}); a link frame "
          f"(quantize + apply of one frame into 2 arrays) {ms['quantize_table'] + ms['apply_table_batch'] / k:.3f}")
    return {"mismatches": bad, "host_ms": ms, "cpu": cpu, "k": k, "n_targets": n_targets,
            "elements": spec.total_n, "leaves": spec.num_leaves}


def mixed_tier_tree(template, device, seed: int, deadline_s: float = 30.0, poll_s: float = 0.05) -> dict:
    """12b: a CUDA device-tier port master and two host-tier port peers on
    the native engine joined below it, over loopback, on the char-RNN
    table; the master seeded, every peer adds a seeded update; every replica
    must reach seed + all updates within AGREE_REL of each leaf's max
    |value| within ``deadline_s`` of the last add, polled every ``poll_s``
    (each peer's own time is reported too). Fails if a peer runs on
    another tier than asked."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec, tree_flatten, tree_unflatten

    spec = make_spec(template)
    seed_tree, deltas = tree_updates(template, seed + 12, 3)
    leaves = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
    seed_flat = flatten(seed_tree, spec, device)
    seed_mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    for d in deltas:
        for j, x in enumerate(tree_flatten(d)[0]):
            leaves[j] += x
    target = flatten(tree_unflatten(spec.treedef, [x.astype(np.float32) for x in leaves]), spec, device)
    mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0))
    port = _free_port()
    peers, tiers = [], ("device", "engine", "engine")
    try:
        t0 = time.perf_counter()
        peers.append(create_or_fetch("127.0.0.1", port, seed_tree, cfg, timeout=60.0, device=device))
        for _ in range(2):
            peers.append(create_or_fetch("127.0.0.1", port, template, cfg, timeout=60.0, host_tier=True))
        t_join = time.perf_counter() - t0
        got = ["engine" if p._engine is not None else ("host" if p.st.host_tier else p.st.device.type)
               for p in peers]
        want = [torch.device(device).type, "engine", "engine"]
        if got != want:
            raise AssertionError(f"phase 12b: peers came up on tiers {got}, asked for {want}")
        t_seed, err_seed = _wait_agree(peers, seed_flat, seed_mag, spec, AGREE_REL, deadline_s)
        before = [p.metrics() for p in peers]
        t1 = time.perf_counter()
        for p, d in zip(peers, deltas):
            p.add(d)
        agree_each = {}
        t_conv, err = _wait_agree(peers, target, mag, spec, AGREE_REL, deadline_s, poll_s, agree_each)
        window = time.perf_counter() - t1
        _sync(device)
        _healthy(peers)
        after = [p.metrics() for p in peers]
        engines = [p._engine.counters().tolist() if p._engine is not None else None for p in peers]
        master = peers[0].st.snapshot_all() + (flatten(deltas[0], spec, device), peers[0].st.codec)
    finally:
        for p in peers:
            p.close()
    per_peer = []
    for i, (tier, b, a) in enumerate(zip(tiers, before, after)):
        d = {k: a[k] - b.get(k, 0) for k in a if not k.startswith("st_link_")}
        links = {}
        for k, v in a.items():
            if k.startswith("st_link_"):
                name, link = k.split("{link=")
                links.setdefault(int(link.strip('"}')), {})[name] = v - b.get(k, 0)
        per_peer.append({"peer": i, "tier": tier, "delta": d, "links": links, "engine_counters": engines[i]})
        print(f"[12b] peer {i} ({tier}{', master' if i == 0 else ''}): frames out {d['st_frames_out_total']} "
              f"= {d['st_frames_out_total'] / window:.1f}/s, in {d['st_frames_in_total']} "
              f"= {d['st_frames_in_total'] / window:.1f}/s, msgs out {d['st_msgs_out_total']} "
              f"in {d['st_msgs_in_total']}, retransmits {d['st_retransmit_msgs_total']}, dedup "
              f"{d['st_dedup_discards_total']}")
        for link, v in sorted(links.items()):
            fo = v.get("st_link_frames_out_total")
            wo = v.get("st_link_wire_msgs_out_total", 0)
            print(f"[12b]   link {link}: " + (f"{fo} frames out = {fo / window:.1f} frames/s, " if fo is not None else "")
                  + f"{wo} wire messages out = {wo / window:.1f}/s, "
                  f"{v.get('st_link_bytes_out_total', 0) / 1e6:.1f} MB out")
        if engines[i] is not None:
            c = engines[i]
            print(f"[12b]   engine counters: frames out {c[0]} in {c[1]}, updates {c[2]}, msgs out {c[3]} "
                  f"in {c[4]}, tx slot acquires {c[5]} alloc events {c[6]}, retransmits {c[8]}, dedup {c[9]}, "
                  f"ACK rtt mean {c[10] / max(1, c[11]) / 1e6:.3f} ms over {c[11]}")
    print(f"[12b] mixed-tier tree on the char-RNN table ({spec.num_leaves} leaves, {spec.total_n} elements), "
          f"a CUDA master and two engine peers: joined in {t_join:.3f} s, seed agreed in {t_seed:.3f} s; "
          f"last add to agreement {t_conv:.3f} s (worst leaf error {err:.3e}, limit {AGREE_REL}, "
          f"deadline {deadline_s} s)")
    return {"join_s": t_join, "seed_converge_s": t_seed, "seed_err": err_seed, "last_add_to_converged_s": t_conv,
            "worst_rel_err": err, "window_s": window, "per_peer": per_peer,
            "per_peer_agree_s": [agree_each.get(i) for i in range(len(peers))],
            "lane_at_add": [{l: r.get("st_shm_active", 0) for l, r in _link_rows(b).items()} for b in before]}, master


def tree_kernel_check(master, spec, tag: str = "12b") -> dict:
    """Kernels A and B against their plain versions on a tree's CUDA master
    (12b's, 13's), at the shapes an engine child gives it: A as a burst of K = the most frames
    one BURST carries for this table (the engine's cascade burst), on the
    master's own update with its codec's scale policy; B with those K frames
    into N = 2 targets, the master's replica and one link's residual (a
    child's burst applies to the replica and the other child's link).
    Returns {kernel: {"mismatches", "max_abs_err", "k", "n"}}."""
    from shared_tensor_tpu_torch.comm import wire
    from shared_tensor_tpu_torch.ops import table as TT

    values, links, update, codec = master
    k = wire.burst_frames_cap(spec)
    f_k, r_k = TT.quantize_table_burst(update.clone(), spec, k, codec.scale_policy, codec.per_leaf_scale, "kernel")
    f_p, r_p = TT.quantize_table_burst(update.clone(), spec, k, codec.scale_policy, codec.per_leaf_scale, "plain")
    resid = next(iter(links.values()))
    a_k = TT.apply_table_batch((values.clone(), resid.clone()), f_p, spec, "kernel")
    a_p = TT.apply_table_batch((values.clone(), resid.clone()), f_p, spec, "plain")
    _sync(values.device)
    live = int((f_p.scales != 0).any(dim=1).sum())
    out = {
        "quantize_rows": {"mismatches": _bitdiff(f_k.words, f_p.words) + _bitdiff(f_k.scales, f_p.scales)
                          + _bitdiff(r_k, r_p), "max_abs_err": _maxerr(r_k, r_p), "k": k, "live_frames": live},
        "apply_rows_batch": {"mismatches": sum(_bitdiff(x, y) for x, y in zip(a_k, a_p)),
                             "max_abs_err": max(_maxerr(x, y) for x, y in zip(a_k, a_p)), "k": k, "n": 2},
    }
    print(f"[{tag}] A quantize_rows, a burst of K={k} ({live} frames with a nonzero scale): mismatches "
          f"{out['quantize_rows']['mismatches']}; B apply_rows_batch K={k} N=2: mismatches "
          f"{out['apply_rows_batch']['mismatches']}")
    return out


# -- phase 13 -------------------------------------------------------------------

#: Phase 13: seconds an idle subscriber's staleness may exceed the FRESH
#: interval (the writer's send loop sleeps up to 50 ms between passes, and
#: the mark waits behind whatever the subscriber is applying).
SERVE_IDLE_SLACK = 0.25
#: Phase 13's read arm: adds per second of the engine writer.
SERVE_ADD_HZ = 10.0
#: Phase 13's last arm: the SGD step's learning rate (the trainer's default)
#: and the seconds S1 is read at the 1 s bound after it.
SERVE_SGD_LR = 1e-2
SERVE_SGD_ARM_S = 2.5
SERVE_BATCH = 8  # phase 13's forward: sequences of CHAR_SEQ tokens


def _rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| / max |b| (0 when b is all zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mag = float(np.abs(b).max()) if b.size else 0.0
    return float(np.abs(a - b).max()) / mag if mag > 0 else float(np.abs(a - b).max())


def serve_tree(cfg_m, device, seed: int, deadline_s: float = 30.0) -> tuple[dict, tuple]:
    """Phase 13 (module docstring) on the table of the char-RNN ``cfg_m``
    (benchmarks/serve.tables' data): the tree, the writes, the reads, the handle and
    the read arm. Returns the report and the master's state for
    tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, serve
    from shared_tensor_tpu_torch.benchmarks import serve as serve_bench
    from shared_tensor_tpu_torch.config import ServeConfig
    from shared_tensor_tpu_torch.examples.train_char_rnn import PANGRAM
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.ops import codec_np
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec, tree_flatten, tree_unflatten

    template, seed_tree, deltas = serve_bench.tables(cfg_m, seed)
    spec = make_spec(template)
    leaves_t = tree_flatten(template)[0]
    embed = next(i for i, x in enumerate(leaves_t) if x is template["embed"])
    offs = codec_np._layout(spec)[0]
    rng_embed = (int(offs[embed]), int(offs[embed]) + spec.ns[embed])
    leaves = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
    for d in deltas:
        for j, x in enumerate(tree_flatten(d)[0]):
            leaves[j] += x
    target = flatten(tree_unflatten(spec.treedef, [x.astype(np.float32) for x in leaves]), spec, device)
    mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    scfg = ServeConfig()
    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0, max_children=3))
    port = _free_port()
    peers, subs, out = [], [], {}
    try:
        t0 = time.perf_counter()
        peers.append(create_or_fetch("127.0.0.1", port, seed_tree, cfg, timeout=60.0, device=device))
        peers.append(create_or_fetch("127.0.0.1", port, template, cfg, timeout=60.0, host_tier=True))
        out["writers_join_s"] = time.perf_counter() - t0
        master, writer = peers
        if writer._engine is None or master.st.device.type != torch.device(device).type:
            raise AssertionError(f"phase 13: the master must be a {device} peer and the writer an engine peer")
        seed_s = []
        for rng in (None, rng_embed):
            t1 = time.perf_counter()
            subs.append(serve.subscribe("127.0.0.1", port, template, Config(transport=cfg.transport,
                                        serve=ServeConfig(range=rng)), timeout=60.0))
            seed_s.append(time.perf_counter() - t1)
        s1, s2 = subs
        mm = master.metrics()
        if len(master.node.links) != 3 or mm["st_sub_links"] != 2 or writer._uplink is None:
            raise AssertionError(f"phase 13: the writer and both subscribers must hang off the master: "
                                 f"{len(master.node.links)} links, {mm['st_sub_links']} subscriber links")
        out["tree"] = {"master": f"root ({master.st.device} device tier)", "engine_writer": "master", "s1": "master",
                       "s2": "master"}
        out["seed_s"] = {"s1": seed_s[0], "s2": seed_s[1]}
        out["buffered_bytes"] = {"s1": s1.buffered_bytes, "s2": s2.buffered_bytes,
                                 "s2_range": list(s2.range_elements), "embed_range": list(rng_embed)}
        if s2.buffered_bytes != 4 * spec.ns[embed] or s1.buffered_bytes != 4 * spec.total:
            raise AssertionError(f"phase 13: buffered bytes {out['buffered_bytes']}")
        print(f"[13] writers joined in {out['writers_join_s']:.3f} s; S1 seeded in {seed_s[0]:.3f} s "
              f"({s1.buffered_bytes} bytes buffered), S2 on elements {rng_embed} in {seed_s[1]:.3f} s "
              f"({s2.buffered_bytes} bytes); all three below the master")
        steps = {"build": time.perf_counter() - t0}
        t_step = time.perf_counter()
        # writes and freshness
        _wait_agree(peers, flatten(seed_tree, spec, device), torch.tensor(
            [np.abs(x).max() for x in tree_flatten(seed_tree)[0]], dtype=torch.float64, device=device),
            spec, AGREE_REL, deadline_s)
        # The engine writer adds first and drains (its frames all acknowledged
        # by the master), the subscribers catch up, then the master adds. A
        # FRESH mark needs a drained residual, and a subscriber link drains
        # a sum of two updates of unrelated power-of-two bounds only after
        # thousands of frames (sparse outliers, PERF.md §4); each update
        # alone, relayed or not, drains in about 28.
        writer.add(deltas[1])
        if not writer.drain(timeout=deadline_s):
            raise AssertionError("phase 13: the engine writer did not drain its update")
        ep1 = serve.epoch()
        for sub in subs:
            sub.wait_fresh(ep1, timeout=deadline_s)
        master.add(deltas[0])
        t_add = time.perf_counter()
        ep = serve.epoch()
        fresh = {}
        for name, sub in zip(("s1", "s2"), subs):
            sub.wait_fresh(ep, timeout=deadline_s)
            fresh[name] = {"last_add_to_fresh_s": time.perf_counter() - t_add}
        out["writers_agree_s"], out["writers_err"] = _wait_agree(peers, target, mag, spec, AGREE_REL, deadline_s)
        want = master.st.snapshot_flat().cpu().numpy()
        got1 = s1.read_flat(1.0)[0]
        got2 = s2.read(max_staleness=1.0)
        errs = {"s1": max(_rel_err(got1[o:o + n], want[o:o + n]) for o, n in zip(offs, spec.ns)),
                "s2": _rel_err(got2[: spec.ns[embed]], want[rng_embed[0]:rng_embed[1]])}
        out["fresh"], out["agree_rel_err"] = fresh, errs
        print("[13] last add to fresh past the epoch: " + "; ".join(
            f"{k} {v['last_add_to_fresh_s']:.3f} s, worst leaf error vs the master {errs[k]:.3e}"
            for k, v in fresh.items()) + f" (limit {AGREE_REL}); writers agreed within {AGREE_REL} "
            f"{out['writers_agree_s']:.3f} s after that")
        if max(errs.values()) > AGREE_REL:
            raise AssertionError(f"phase 13: subscribers disagree with the master: {errs}")
        steps["writes"], t_step = time.perf_counter() - t_step, time.perf_counter()
        # serve: the handle on the card and a char-RNN forward
        handle = s1.serving_handle(device=device)
        t1 = time.perf_counter()
        handle.refresh(1.0)
        out["refresh_ms"] = 1e3 * (time.perf_counter() - t1)
        p1 = handle.params()
        if p1 is not handle.params() or handle.refresh(1.0) or handle.params() is not p1:
            raise AssertionError("phase 13: params() changed between refreshes of an unchanged state")
        on_card = all(x.device.type == torch.device(device).type for x in tree_flatten(p1)[0])
        data = m.encode_corpus(PANGRAM, cfg_m.vocab, device=device)
        x, y = m.make_batches(data, SERVE_BATCH, CHAR_SEQ, torch.Generator().manual_seed(seed + 13))
        with torch.no_grad():
            la = m.forward(p1, x, cfg_m)
            lb = m.forward(master.read(), x, cfg_m)
            ls = m.forward(tree_unflatten(spec.treedef, [torch.from_numpy(np.asarray(v)).to(device)
                                                         for v in tree_flatten(s1.read(1.0))[0]]), x, cfg_m)
        _sync(device)
        if _bitdiff(la, ls):
            raise AssertionError("phase 13: the handle's params are not S1's read() on the card")
        diff, top = float((la - lb).abs().max()), float(lb.abs().max())
        out["forward"] = {"batch": list(x.shape), "max_logit_diff": diff, "max_abs_logit": top,
                          "finite": bool(torch.isfinite(la).all()), "params_on_device": on_card}
        # the weights agree within AGREE_REL, but the matmuls round their
        # operands to bf16 (8 bits), so a weight near a rounding boundary
        # moves its product by 2^-8 of itself: the logits agree to about that
        print(f"[13] S1 handle refresh {out['refresh_ms']:.3f} ms, params on {device} {on_card}; char-RNN forward "
              f"{list(x.shape)}: largest logit difference handle vs master {diff:.3e} (largest |logit| {top:.3e})")
        if not (on_card and out["forward"]["finite"]):
            raise AssertionError(f"phase 13: handle forward {out['forward']}")
        steps["serve"], t_step = time.perf_counter() - t_step, time.perf_counter()
        # idle, then the read arm under paced adds
        t1, worst = time.perf_counter(), 0.0
        while time.perf_counter() - t1 < 2 * scfg.fresh_interval_sec:
            worst = max(worst, s1.staleness())
            time.sleep(0.01)
        out["idle"] = {"seconds": 2 * scfg.fresh_interval_sec, "max_staleness_s": worst,
                       "limit_s": scfg.fresh_interval_sec + SERVE_IDLE_SLACK}
        print(f"[13] idle {2 * scfg.fresh_interval_sec} s: S1's largest staleness {worst:.4f} s "
              f"(limit {scfg.fresh_interval_sec} + {SERVE_IDLE_SLACK})")
        if worst > scfg.fresh_interval_sec + SERVE_IDLE_SLACK:
            raise AssertionError(f"phase 13: idle staleness {worst} s")
        small = [tree_unflatten(spec.treedef, [np.asarray(x, np.float32) * np.float32(2.0**-10)
                                               for x in tree_flatten(d)[0]]) for d in deltas]
        stop, count = threading.Event(), [0]
        adder = serve_bench.paced_adds(writer, small, SERVE_ADD_HZ, stop, count)
        try:
            arm = serve_bench.read_arm(s1, 1.0, 1.0)
        finally:
            stop.set()
            adder.join(timeout=10.0)
        arm.update(adds=count[0], add_hz=SERVE_ADD_HZ)
        out["read_arm"] = arm
        print(f"[13] read arm (bound 1 s, engine writer adding at {SERVE_ADD_HZ} Hz): {arm['read_per_s']:.1f} "
              f"reads/s, staleness p50 {arm['staleness_p50_s']} p99 {arm['staleness_p99_s']} s, refused "
              f"{arm['refused_fraction']}")
        out["sgd_arm"] = sgd_arm(master, s1, m.loss_fn, (x, y), cfg_m, spec, offs)
        _healthy(peers)
        out["apply_ms_per_frame"] = {k: 1e3 * s.apply_s / max(1, s.frames_applied) for k, s in zip(("s1", "s2"), subs)}
        out["frames_applied"] = {k: s.frames_applied for k, s in zip(("s1", "s2"), subs)}
        out["subscriber_metrics"] = {k: s.metrics() for k, s in zip(("s1", "s2"), subs)}
        mm = master.metrics()
        out["master"] = {k: mm[k] for k in ("st_sub_links", "st_sub_msgs_out_total", "st_sub_fresh_out_total",
                                            "st_frames_in_total", "st_frames_out_total")}
        print(f"[13] subscriber host apply ms per frame {out['apply_ms_per_frame']} over {out['frames_applied']} "
              f"frames; master {out['master']}")
        steps["idle_and_read_arm"] = time.perf_counter() - t_step
        out["step_s"] = steps
        state = master.st.snapshot_all() + (flatten(deltas[0], spec, device), master.st.codec)
    finally:
        for s in subs:
            s.close()
        for p in reversed(peers):
            p.close()
    return out, state


def sgd_arm(master, s1, loss_fn, batch, cfg_m, spec, offs) -> dict:
    """Phase 13's last arm, on an update whose bounds are no powers of two:
    the master adds one SGD step of the char-RNN at its own weights (as a
    trainer adds it), then nobody writes. Such a residual drains its sparse
    outliers over thousands of frames, so no FRESH mark need come within
    the arm, and S1's newest verified instant is the step's own stamp: its
    reads at the 1 s bound are served until the step is 1 s old, then
    refused. Reports the refused fraction and staleness over
    SERVE_SGD_ARM_S s of reads, the time to a FRESH past the step (None:
    none came in the arm), S1's frames applied and its distance from the
    master at the arm's end; fails unless S1 is finite and has taken in
    most of the step (its RMS distance from the master under half the
    step's RMS)."""
    from shared_tensor_tpu_torch import serve
    from shared_tensor_tpu_torch.benchmarks import serve as serve_bench
    from shared_tensor_tpu_torch.ops.table import flatten, tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(master.read())
    leaves = [v.detach().clone().requires_grad_(True) for v in leaves]
    grads = torch.autograd.grad(loss_fn(tree_unflatten(treedef, leaves), batch, cfg_m), leaves)
    step = tree_unflatten(treedef, [(-SERVE_SGD_LR * g).detach().float() for g in grads])
    frames0 = s1.frames_applied
    master.add(step)
    t_add, ep = time.perf_counter(), serve.epoch()
    fresh_at = []

    def waiter():
        try:
            s1.wait_fresh(ep, timeout=SERVE_SGD_ARM_S)
            fresh_at.append(time.perf_counter() - t_add)
        except TimeoutError:
            pass

    th = threading.Thread(target=waiter)
    th.start()
    try:
        arm = serve_bench.read_arm(s1, 1.0, SERVE_SGD_ARM_S)
    finally:
        th.join()
    want = master.st.snapshot_flat().cpu().numpy().astype(np.float64)
    got = np.asarray(s1.read_flat(float("inf"))[0], np.float64)
    d = flatten(step, spec).numpy().astype(np.float64)
    rms_err, rms_step = float(np.sqrt(np.mean((got - want) ** 2))), float(np.sqrt(np.mean(d**2)))
    arm.update(
        update=f"one SGD step, lr {SERVE_SGD_LR}", time_to_fresh_s=fresh_at[0] if fresh_at else None,
        frames_applied=s1.frames_applied - frames0, rms_err=rms_err, rms_step=rms_step,
        worst_leaf_rel_err=max(_rel_err(got[o:o + n], want[o:o + n]) for o, n in zip(offs, spec.ns)),
        step_worst_leaf_rel=max(_rel_err(d[o:o + n], want[o:o + n]) for o, n in zip(offs, spec.ns)),
    )
    print(f"[13] SGD-step arm (bound 1 s, no writes after the step): {arm['read_per_s']:.1f} reads/s, refused "
          f"{arm['refused_fraction']}, staleness p50 {arm['staleness_p50_s']} p99 {arm['staleness_p99_s']} s; "
          f"FRESH past the step after {arm['time_to_fresh_s']} s; S1 applied {arm['frames_applied']} frames, "
          f"RMS distance from the master {rms_err:.3e} (the step's RMS {rms_step:.3e}), worst leaf "
          f"{arm['worst_leaf_rel_err']:.3e} (the step's {arm['step_worst_leaf_rel']:.3e})")
    if not (np.isfinite(got).all() and rms_err < 0.5 * rms_step):
        raise AssertionError(f"phase 13: S1 did not take in the SGD step: {arm}")
    return arm


# -- phase 14 -------------------------------------------------------------------

#: Phase 14a: seconds the C reference peer runs before it prints its replica.
HARNESS_S = 2.5
#: Phase 14b's last arm: seconds the three updates added at once get before
#: their residual is read.
AT_ONCE_S = 3.0
#: Phase 14c: E1's seeded updates, added one at a time WIRE_ADD_GAP_S apart,
#: so its uplink carries enough messages for the striped run's sever (3
#: data messages on stripe 2 of 4, round-robin) to fire.
E1_ADDS = 16
WIRE_ADD_GAP_S = 0.02


def _flat_target(seed_tree, deltas, spec, device):
    """(seed flat, seed per-leaf max |v|, seed + every delta flat, its
    per-leaf max |v|) on ``device``: the agreement targets."""
    from shared_tensor_tpu_torch.ops.table import flatten, tree_flatten, tree_unflatten

    leaves = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
    seed_mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    for d in deltas:
        for j, x in enumerate(tree_flatten(d)[0]):
            leaves[j] += x
    target = flatten(tree_unflatten(spec.treedef, [x.astype(np.float32) for x in leaves]), spec, device)
    mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    return flatten(seed_tree, spec, device), seed_mag, target, mag


def _link_rows(metrics: dict) -> dict:
    """{link: {metric: value}} of a peer's per-link metrics."""
    out = {}
    for k, v in metrics.items():
        if "{link=" in k:
            name, link = k.split("{link=")
            out.setdefault(int(link.strip('"}')), {})[name] = v
    return out


def compat_example(device) -> tuple[dict, tuple]:
    """14a, BASELINE config 1 on the reference wire: compat.createOrFetch on
    the card seeds arange(1, 241) as 4x5x6x2 (wire_compat), the C reference
    peer (native/stc_harness.c, the port's build) joins as a leaf and adds
    0.25 at once, a port engine peer in compat mode joins; once every port
    reader holds seed + 0.25 the master adds 1.0 and the engine peer 0.5.
    Every reader (copyToTensor, and the C peer's printed replica) must hold
    seed + 1.75 within 1e-6. (An add that lands while a link still streams
    the seed can leave a residual whose tail no float32 replica near 240
    represents, a property of the reference codec: the port's adds wait
    for the seed.) Returns the report and the master's state for
    tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, _build, compat
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec

    seed = np.arange(1.0, 241.0, dtype=np.float32).reshape(4, 5, 6, 2)
    cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0, wire_compat=True))
    harness = str(_build.build_harness())
    port = _free_port()
    t0 = time.perf_counter()

    def wait_for(handles, want, limit):
        while True:
            _healthy([h.peer for h in handles])
            errs = [float(np.abs(h.copyToTensor().cpu().numpy() - want).max()) for h in handles]
            if max(errs) <= 1e-6 or time.perf_counter() - t0 > limit:
                return errs
            time.sleep(0.01)

    with compat.createOrFetch("127.0.0.1", port, seed, cfg, device=device) as a:
        proc = subprocess.Popen([harness, "127.0.0.1", str(port), str(seed.size), str(HARNESS_S), "0.25"],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            while len(a.peer.node.links) < 1 and time.perf_counter() - t0 < 10:
                time.sleep(0.005)
            with compat.createOrFetch("127.0.0.1", port, np.zeros_like(seed), cfg, host_tier=True) as e:
                if e.peer._engine is None or not (a.peer._compat and e.peer._compat):
                    raise AssertionError("phase 14a: the joiner must be a compat engine peer")
                seed_errs = wait_for((a, e), seed + 0.25, 10)
                # and the master's link to the C peer has streamed it the seed
                while any(a.peer.st.residual_rms(l) > 0 for l in a.peer.st.link_ids) \
                        and time.perf_counter() - t0 < 10:
                    time.sleep(0.005)
                t_seed = time.perf_counter() - t0
                links = len(a.peer.node.links)
                a.addFromTensor(np.full_like(seed, 1.0))
                e.addFromTensor(np.full_like(seed, 0.5))
                errs = wait_for((a, e), seed + 1.75, 20)
                t_port = time.perf_counter() - t0
                frames = [a.peer.metrics()["st_frames_out_total"], e.peer.metrics()["st_frames_out_total"]]
                state = a.peer.st.snapshot_all() + (flatten(np.full_like(seed, 1.0), make_spec(seed), device),
                                                    a.peer.st.codec)
                out, err = proc.communicate(timeout=HARNESS_S + 30)
                if proc.returncode != 0:
                    raise AssertionError(f"phase 14a: the C peer failed: {err[-300:]}")
                c_vals = np.array([float(x) for x in out.split()], np.float32)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    c_err = float(np.abs(c_vals - (seed + 1.75).reshape(-1)).max()) if c_vals.size == seed.size else float("inf")
    res = {"seconds_seed": t_seed, "seconds_port_agree": t_port, "seconds": time.perf_counter() - t0,
           "seed_err": max(seed_errs), "max_abs_err_master": errs[0], "max_abs_err_engine": errs[1],
           "max_abs_err_c_peer": c_err, "master_links": links, "frames_out": frames,
           "compat_frame_bytes": 4 + (seed.size + 7) // 8}
    print(f"[14a] config 1 on the reference wire: CUDA master, C peer (stc_harness) and compat engine peer "
          f"({links} children); seed + the C peer's add everywhere after {t_seed:.3f} s; errors master "
          f"{errs[0]:.3e}, engine {errs[1]:.3e}, C peer {c_err:.3e} (limit 1e-6) after {t_port:.3f} s; frames out "
          f"{frames}; {res['compat_frame_bytes']} bytes a frame")
    if max(errs[0], errs[1], c_err, res["seed_err"]) > 1e-6 or links != 2:
        raise AssertionError(f"phase 14a: {res}")
    return res, state


def compat_wide(device, seed: int, n: int, deadline_s: float = 30.0) -> tuple[dict, tuple]:
    """14b: one flat f32 tensor of ``n`` elements (config 2's width) on the
    reference wire: a CUDA compat master seeded from ``seed``, a compat
    engine peer and a compat device-tier peer on the card, each adding a
    seeded update in turn; every replica within AGREE_REL of max |value|
    within ``deadline_s`` of each add. The adds take turns because two
    updates of unrelated power-of-two bounds summed on one link drain their
    sparse outliers in thousands of frames under the reference's per-frame
    scale (a property of the codec, JAX's peers alike: tools/compat_tail.py),
    while one alone, relayed or not, drains in about 28 frames. The last
    arm then adds three more seeded updates at once and reports the worst
    error AT_ONCE_S later (or the seconds to agreement); it fails only on a
    peer fault or a non-finite replica. The master must have sent and
    applied frames (kernels A and B on its path). Returns the report and
    the master's state for tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, compat
    from shared_tensor_tpu_torch.comm import wire
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec

    template = np.zeros(n, np.float32)
    spec = make_spec(template)
    seed_tree, deltas = tree_updates(template, seed + 14, 3)
    at_once = tree_updates(template, seed + 15, 3)[1]
    seed_flat, seed_mag, _, _ = _flat_target(seed_tree, [], spec, device)
    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0, wire_compat=True))
    port = _free_port()
    handles = []
    try:
        t0 = time.perf_counter()
        handles.append(compat.createOrFetch("127.0.0.1", port, seed_tree, cfg, device=device))
        handles.append(compat.createOrFetch("127.0.0.1", port, template, cfg, host_tier=True))
        handles.append(compat.createOrFetch("127.0.0.1", port, template, cfg, device=device))
        t_join = time.perf_counter() - t0
        peers = [h.peer for h in handles]
        want = torch.device(device).type
        if peers[1]._engine is None or {peers[0].st.device.type, peers[2].st.device.type} != {want} \
                or not all(p._compat for p in peers):
            raise AssertionError(f"phase 14b: want a {want} master, a compat engine peer and a {want} peer")
        t_seed, _ = _wait_agree(peers, seed_flat, seed_mag, spec, AGREE_REL, deadline_s)
        before = [p.metrics() for p in peers]
        t1 = time.perf_counter()
        per_add = []
        for i, (h, d) in enumerate(zip(handles, deltas)):
            h.addFromTensor(d)
            _, _, target_i, mag_i = _flat_target(seed_tree, deltas[: i + 1], spec, device)
            per_add.append(_wait_agree(peers, target_i, mag_i, spec, AGREE_REL, deadline_s))
        t_conv, err = per_add[-1]
        window = time.perf_counter() - t1
        _sync(device)
        after = [p.metrics() for p in peers]
        # the last arm: three updates at once, read AT_ONCE_S later
        _, _, target2, mag2 = _flat_target(seed_tree, deltas + at_once, spec, device)
        t2 = time.perf_counter()
        for h, d in zip(handles, at_once):
            h.addFromTensor(d)
        once_s = None
        while True:
            _healthy(peers)
            once_err = _leaf_rel_err(peers, target2, mag2, spec)
            if once_err <= AGREE_REL:
                once_s = time.perf_counter() - t2
                break
            if time.perf_counter() - t2 > AT_ONCE_S:
                break
            time.sleep(0.05)
        once_frames = peers[0].metrics()["st_frames_out_total"] - after[0]["st_frames_out_total"]
        state = peers[0].st.snapshot_all() + (flatten(deltas[0], spec, device), peers[0].st.codec)
    finally:
        for h in reversed(handles):
            h.close()
    m0 = {k: after[0][k] - before[0].get(k, 0) for k in ("st_frames_out_total", "st_frames_in_total")}
    per_link = []
    for i, (b, a) in enumerate(zip(before, after)):
        lb, la = _link_rows(b), _link_rows(a)
        for link, row in sorted(la.items()):
            fo = row.get("st_link_frames_out_total", 0) - lb.get(link, {}).get("st_link_frames_out_total", 0)
            mo = row.get("st_link_wire_msgs_out_total", 0) - lb.get(link, {}).get("st_link_wire_msgs_out_total", 0)
            per_link.append({"peer": i, "link": link, "frames_out_per_s": fo / window, "msgs_out_per_s": mo / window})
    res = {"n": n, "join_s": t_join, "seed_agree_s": t_seed, "add_to_agree_s": [x[0] for x in per_add],
           "last_add_to_agree_s": t_conv, "worst_rel_err": err,
           "compat_frame_bytes": wire.compat_frame_bytes(n), "master_frames": m0, "per_link": per_link,
           "at_once": {"window_s": AT_ONCE_S, "add_to_agree_s": once_s, "worst_rel_err": once_err,
                       "master_frames_out": once_frames}}
    print(f"[14b] the reference wire at {n} elements ({res['compat_frame_bytes']} bytes a frame): CUDA master, "
          f"compat engine and CUDA peers joined in {t_join:.3f} s, seed agreed in {t_seed:.3f} s; each add in turn "
          f"(master, engine, CUDA peer) to agreement " + ", ".join(f"{x[0]:.3f}" for x in per_add)
          + f" s (worst error {err:.3e}, limit {AGREE_REL}); master frames {m0}")
    for row in per_link:
        print(f"[14b]   peer {row['peer']} link {row['link']}: {row['frames_out_per_s']:.1f} frames/s out, "
              f"{row['msgs_out_per_s']:.1f} wire messages/s")
    print(f"[14b] three more updates added at once: " + (f"agreed in {once_s:.3f} s" if once_s is not None else
          f"worst error {once_err:.3e} after {AT_ONCE_S} s") + f" (limit {AGREE_REL}); master frames out "
          f"{once_frames}")
    if not (m0["st_frames_out_total"] > 0 and m0["st_frames_in_total"] > 0):
        raise AssertionError(f"phase 14b: the CUDA master sent or applied no frame: {m0}")
    if not math.isfinite(once_err):
        raise AssertionError(f"phase 14b: a replica is not finite after the adds at once: {once_err}")
    return res, state


def _with_env(env: dict, fn):
    """fn() with ``env`` set, the environment restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def lane_chain(template, device, seed: int, striped: bool, deadline_s: float = 30.0) -> tuple[dict, tuple]:
    """14c on config 2's table: a chain of a CUDA device-tier master
    (max_children 1), engine peer E1 below it and engine peer E2 below E1.
    Unstriped: the shared-memory lane on (the default) and ST_SIGN2=2
    around E1's and E2's creation; every link must be on the lane at both
    ends, E1-E2 at 2 bits with sign2 frames sent, the master's link at 1
    bit. Striped: stripe_count 4, the lane off, E1's node made under
    to_env(FaultConfig(sever_after_frames=3, only_link=1, only_stripe=2));
    every link must have 4 stripes and E1's uplink lose one, re-route and
    stay up. Each node adds a seeded update (E1 as E1_ADDS of them); every
    replica within AGREE_REL within ``deadline_s``. Returns the report and
    the master's state for tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.comm import faults
    from shared_tensor_tpu_torch.config import FaultConfig
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec

    tag = "14c striped" if striped else "14c"
    spec = make_spec(template)
    rng = np.random.default_rng(seed + (141 if striped else 140))
    seed_tree = random_like(template, rng)
    d_master, d_e2 = random_like(template, rng, 0.5), random_like(template, rng, 0.5)
    d_e1 = [random_like(template, rng, 0.5 / E1_ADDS) for _ in range(E1_ADDS)]
    seed_flat, seed_mag, target, mag = _flat_target(seed_tree, [d_master, d_e2, *d_e1], spec, device)
    tcfg = TransportConfig(peer_timeout_sec=30.0, max_children=1, stripe_count=4 if striped else 1,
                           shm_enabled=not striped)
    cfg = Config(transport=tcfg)
    env_e1 = (faults.to_env(FaultConfig(enabled=True, sever_after_frames=3, only_link=1, only_stripe=2))
              if striped else {"ST_SIGN2": "2"})
    env_e2 = {} if striped else {"ST_SIGN2": "2"}
    port = _free_port()
    peers = []
    try:
        t0 = time.perf_counter()
        peers.append(create_or_fetch("127.0.0.1", port, seed_tree, cfg, timeout=60.0, device=device))
        peers.append(_with_env(env_e1, lambda: create_or_fetch("127.0.0.1", port, template, cfg, timeout=60.0,
                                                              host_tier=True)))
        peers.append(_with_env(env_e2, lambda: create_or_fetch("127.0.0.1", port, template, cfg, timeout=60.0,
                                                              host_tier=True)))
        t_join = time.perf_counter() - t0
        master, e1, e2 = peers
        if e1._engine is None or e2._engine is None or len(master.node.links) != 1 or len(e1.node.links) != 2:
            raise AssertionError(f"{tag}: want the chain master - E1 - E2 with E1 and E2 engine peers")
        up0 = e1._uplink
        t_seed, _ = _wait_agree(peers, seed_flat, seed_mag, spec, AGREE_REL, deadline_s)
        t_lane = None
        if not striped:
            t1 = time.perf_counter()
            while any(v != 2 for p in peers for v in
                      [_link_rows(p.metrics()).get(l, {}).get("st_shm_active", 0) for l in p.node.links]):
                if time.perf_counter() - t1 > 10:
                    raise AssertionError(f"{tag}: a link is not on the lane: "
                                         + str([{l: r.get("st_shm_active") for l, r in _link_rows(p.metrics()).items()}
                                                for p in peers]))
                time.sleep(0.02)
            t_lane = time.perf_counter() - t1
        before = [p.metrics() for p in peers]
        t1 = time.perf_counter()
        master.add(d_master)
        e2.add(d_e2)
        for d in d_e1:
            e1.add(d)
            time.sleep(WIRE_ADD_GAP_S)
        t_conv, err = _wait_agree(peers, target, mag, spec, AGREE_REL, deadline_s)
        window = time.perf_counter() - t1
        _sync(device)
        after = [p.metrics() for p in peers]
        rows = [_link_rows(a) for a in after]
        stripes = {f"{name} link {l}": p.node.stripe_stats(l) for name, p in zip(("master", "E1", "E2"), peers)
                   for l in p.node.links}
        prec = {"E1 up": e1._engine.link_precision(e1._uplink),
                "E1 down": e1._engine.link_precision(next(l for l in e1.node.links if l != e1._uplink)),
                "E2 up": e2._engine.link_precision(e2._uplink)}
        e1_up_same = e1._uplink == up0
        state = master.st.snapshot_all() + (flatten(d_master, spec, device), master.st.codec)
    finally:
        for p in reversed(peers):
            p.close()
    delta = [{k: a[k] - b.get(k, 0) for k in a if "{link=" not in k and isinstance(a[k], (int, float))}
             for b, a in zip(before, after)]
    res = {"striped": striped, "join_s": t_join, "seed_agree_s": t_seed, "lane_live_s": t_lane,
           "first_add_to_agree_s": window, "last_add_to_agree_s": t_conv,
           "worst_rel_err": err, "links": rows, "precision": prec, "stripe_stats": stripes,
           "frames2_out": [d["st_frames2_out_total"] for d in delta[1:]],
           "frames_out": [d["st_frames_out_total"] for d in delta], "shm_fallbacks": [a["st_shm_fallback_total"]
                                                                                      for a in after]}
    names = ("master", "E1", "E2")
    print(f"[{tag}] chain CUDA master - E1 - E2 on the char-RNN table ({spec.num_leaves} leaves, {spec.total_n} "
          f"elements): joined in {t_join:.3f} s, seed agreed in {t_seed:.3f} s"
          + (f", every link on the lane {t_lane:.3f} s later" if t_lane is not None else "")
          + f"; last add to agreement {t_conv:.3f} s, first add to agreement {window:.3f} s (E1's {E1_ADDS} adds "
          f"{WIRE_ADD_GAP_S} s apart; worst error {err:.3e}, limit {AGREE_REL})")
    for name, r, d in zip(names, rows, delta):
        for l, row in sorted(r.items()):
            print(f"[{tag}]   {name} link {l}: " + ", ".join(f"{k[3:]} {v}" for k, v in sorted(row.items())
                                                       if k.startswith(("st_shm", "st_stripe", "st_link_precision"))))
        print(f"[{tag}]   {name}: frames out {d['st_frames_out_total']}, in {d['st_frames_in_total']}, "
              f"sign2 frames out {d.get('st_frames2_out_total', 0)} in {d.get('st_frames2_in_total', 0)}; shm msgs "
              f"out {d.get('st_shm_msgs_out_total', 0)} in {d.get('st_shm_msgs_in_total', 0)}, bytes out "
              f"{d.get('st_shm_bytes_out_total', 0)} in {d.get('st_shm_bytes_in_total', 0)}")
    print(f"[{tag}] link precision {prec}; stripes {stripes}")
    bad = []
    if err > AGREE_REL:
        bad.append(f"worst error {err:.3e}")
    if striped:
        if any(s is None or s["stripes"] != 4 for s in stripes.values()):
            bad.append("a link without 4 stripes")
        s1 = stripes.get(f"E1 link {up0}")
        if not (s1 and s1["deaths"] >= 1 and s1["reroutes"] >= 1 and e1_up_same):
            bad.append(f"E1's uplink did not lose a stripe, re-route and stay up: {s1}, same link {e1_up_same}")
    else:
        if prec["E1 down"] != 2 or prec["E2 up"] != 2 or prec["E1 up"] != 1:
            bad.append(f"precision {prec}")
        if not any(res["frames2_out"]):
            bad.append("no sign2 frame sent on E1-E2")
        if any(res["shm_fallbacks"]):
            bad.append(f"lane fallbacks {res['shm_fallbacks']}")
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))
    return res, state


def shm_df() -> str:
    """``df -B1 /dev/shm`` (its last line), or why it could not run."""
    try:
        out = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True, text=True, timeout=10)
        return out.stdout.strip().splitlines()[-1] if out.returncode == 0 else f"df failed: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"df failed: {e}"


def wire_phase(device, seed: int, agree_12b_s: float, smi: str) -> tuple[dict, dict, dict]:
    """Phase 14: the peer's wire capabilities (14a, 14b, 14c). Returns the
    report, the launches of A and B over the phase, and A and B against
    their plain versions on each arm's CUDA master (14a's and 14b's one-leaf
    compat tables, 14c's char-RNN table): {kernel: {"mismatches" (the sum),
    "max_abs_err" (the worst), "by_arm": {arm: mismatches}}}."""
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.table import make_spec

    t0 = time.perf_counter()
    df = shm_df()
    print(f"[14] /dev/shm: {df}")
    CC.reset_launches()
    out = {"dev_shm_df": df}
    masters = {}
    out["14a"], masters["14a"] = compat_example(device)
    launches = {"14a": {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}}
    char_template = char_rnn_template()
    n = make_spec(char_template).total_n
    CC.reset_launches()
    out["14b"], masters["14b"] = compat_wide(device, seed, n)
    launches["14b"] = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    CC.reset_launches()
    out["14c"], masters["14c"] = lane_chain(char_template, device, seed, striped=False)
    out["14c_striped"], _ = lane_chain(char_template, device, seed, striped=True)
    launches["14c"] = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    total = {k: sum(v[k] for v in launches.values()) for k in ("quantize_rows", "apply_rows_batch")}
    specs = {"14a": make_spec(np.zeros((4, 5, 6, 2), np.float32)), "14b": make_spec(np.zeros(n, np.float32)),
             "14c": make_spec(char_template)}
    by_arm = {arm: tree_kernel_check(masters[arm], specs[arm], arm) for arm in masters}
    check = {k: {"mismatches": sum(c[k]["mismatches"] for c in by_arm.values()),
                 "max_abs_err": max(c[k]["max_abs_err"] for c in by_arm.values()),
                 "by_arm": {arm: c[k]["mismatches"] for arm, c in by_arm.items()}}
             for k in ("quantize_rows", "apply_rows_batch")}
    out["launches"] = launches
    out["agree_s_vs_12b"] = {"14c_lane_sign2": out["14c"]["last_add_to_agree_s"],
                             "14c_striped": out["14c_striped"]["last_add_to_agree_s"], "12b": agree_12b_s}
    out["seconds"] = time.perf_counter() - t0
    ring = {f"{p} link {l}": r.get("st_shm_ring_bytes") for p, rows in zip(("master", "E1", "E2"), out["14c"]["links"])
            for l, r in rows.items()}
    print(f"[14] ring bytes a direction per link {ring}; last add to agreement: 14c {out['14c']['last_add_to_agree_s']:.3f}"
          f" s (lane, sign2 on E1-E2), striped {out['14c_striped']['last_add_to_agree_s']:.3f} s, 12b in this run "
          f"{agree_12b_s:.3f} s")
    print(f"[14] launches {launches}; phase 14 {out['seconds']:.3f} s; on {smi}")
    if not (launches["14b"]["quantize_rows"] and launches["14b"]["apply_rows_batch"]) or not all(total.values()):
        raise AssertionError(f"phase 14: a kernel of the path never launched: {launches}")
    bad = {k: v["by_arm"] for k, v in check.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 14: kernel vs plain mismatches on the masters' states: {bad}")
    return out, total, check


SOURCES = {
    "quantize_rows":("shared_tensor_tpu_torch/csrc/quantize_rows.cu", "shared_tensor_tpu/ops/codec_pallas.py:286"),
    "apply_rows_batch": ("shared_tensor_tpu_torch/csrc/apply_rows.cu", "shared_tensor_tpu/ops/codec_pallas.py:337"),
    "quantize": ("shared_tensor_tpu_torch/csrc/quantize.cu", "shared_tensor_tpu/ops/codec_pallas.py:160"),
    "apply_frame_many": ("shared_tensor_tpu_torch/csrc/apply_frame.cu", "shared_tensor_tpu/ops/codec_pallas.py:216"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from shared_tensor_tpu_torch.comm import wire
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.table import make_spec

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # 1. build: the kernels (one nvcc each) and, beside them, the transport,
    # the host codec and the engine (g++ and gcc, the three in parallel)
    from concurrent.futures import ThreadPoolExecutor

    from shared_tensor_tpu_torch import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        native = pool.submit(lambda: (_build.build_engine(), time.perf_counter() - t0))
        harness = pool.submit(_build.build_harness)
        report = CC.build()
        lib, native_s = native.result()
        harness.result()
    print(f"[1] build {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in report.items())
          + f"; {_build.transport_path().name}, {_build.codec_path().name} and {lib.name} {native_s:.2f} s; "
          f"{_build.harness_path().name}")
    for k, v in report.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[1] {k}: {line.strip()}")

    template = resnet18_template()
    spec = make_spec(template)
    if (spec.num_leaves, spec.total_n, spec.total) != (56, 11172170, 11200512):
        raise AssertionError(f"unexpected ResNet-18 table {spec.num_leaves} {spec.total_n} {spec.total}")

    # 2. kernel vs plain
    parity = kernel_vs_plain(spec, dev, np.random.default_rng(args.seed + 1))
    bad = {k: v["mismatches"] for k, v in parity.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"kernel vs plain mismatches: {bad}")

    # 3. tree drive (the launch counts of A and B are this phase's)
    CC.reset_launches()
    drive = tree_drive(template, dev, args.seed)
    launches = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    print(f"[3] launches {launches}, frames out {drive['frames_out']}, in {drive['frames_in']}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # 4. times at the drive's shapes; B's row in the kernels line is the
    # interior's flood (K = BATCH, N = 2), its other shapes beside it
    rate = hbm_rate(name)
    t = times(spec, dev, rate)
    b_rows = t["apply_rows_batch"]
    t["apply_rows_batch"] = dict(b_rows[B_SHAPES.index((BATCH, 2))], shapes=b_rows)

    # 5. C and D against plain, then all four kernels past 2^31 bytes
    parity.update(scalar_kernel_vs_plain(dev, seed=args.seed))
    big = big_index_check(dev, seed=args.seed)
    bad = {k: v["mismatches"] for k, v in parity.items() if v["mismatches"]}
    bad.update({f"{k} at {BIG_PAD}": m for k, m in big.items() if m})
    if bad:
        raise AssertionError(f"kernel vs plain mismatches: {bad}")
    torch.cuda.empty_cache()

    # 6. the headline codec bench (the launch counts of C and D are this phase's)
    bench = codec_bench(dev, rate, 1 << 20, BENCH_SECONDS)
    launches.update(bench["launches"])
    if not all(bench["launches"].values()):
        raise AssertionError(f"a kernel of the bench never launched: {bench['launches']}")
    sp = bench["split"]
    for k in ("quantize", "apply_frame_many"):
        t[k] = {"ms": sp[f"{k}_ms"], "plain_ms": sp[f"{k}_plain_ms"], "bound_ms": sp[f"{k}_bound_ms"],
                "shape": f"n={1 << 20} K=1" if k == "apply_frame_many" else f"n={1 << 20}"}
    for k in ("quantize", "apply_frame_many"):
        t[k]["copy_ms"] = sp[f"{k}_copy_ms"]

    # 7. the config-5 sweep up to 2^30
    sw = sweep(dev, rate)
    if not all(sw["launches"].values()):
        raise AssertionError(f"a kernel of the sweep never launched: {sw['launches']}")
    t["quantize"]["ms_2e30"] = sw["big"]["quantize_ms"]
    t["quantize"]["bound_ms_2e30"] = sw["big"]["quantize_bound_ms"]
    for k in D_TARGETS:
        d = sw["big"][f"apply_frame_many_k{k}"]
        suffix = "_2e30" if k == 1 else f"_2e30_k{k}"
        t["apply_frame_many"].update({f"{x}{suffix}": d[x] for x in ("ms", "bound_ms", "copy_ms")})

    # 8. the peer tier over loopback TCP (the launch counts of A and B are this phase's)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    CC.reset_launches()
    t8 = time.perf_counter()
    example = peer_example(dev)
    tree = peer_tree(template, dev, args.seed)
    peer_launches = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    tree["seconds"] = time.perf_counter() - t8
    tree["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"[8] launches {peer_launches}; peak device memory {tree['max_memory_allocated'] / 2**30:.3f} GiB; "
          f"phase 8a+8b {tree['seconds']:.3f} s; on {smi}")
    if not all(peer_launches.values()):
        raise AssertionError(f"a kernel of the peer path never launched: {peer_launches}")
    fetch = fetch_ab(template, dev, min(16, wire.burst_frames_cap(spec)))
    for k, n in peer_launches.items():
        t[k]["launches_phase3"] = launches[k]
        launches[k] = n

    # 9, 10 and 11. the pod tier: BASELINE config 2 (4 ranks, and 2 x 2), config 4 (8 ranks, both arms)
    # and config 2 as two pods of 2 bridged over TCP
    torch.cuda.empty_cache()
    pod = pod_phases(dev, rate, args.seed)
    for k in ("quantize_rows", "apply_rows_batch"):
        pt = pod["times"][k]
        t[k].update({
            "launches_pod": sum(r["launches"][k] for r in pod["char_rnn"]),
            "launches_pod_per_rank": [r["launches"][k] for r in pod["char_rnn"]],
            "mismatches_pod": sum(r["check"][k]["mismatches"] + r["sharded"]["check"][k]["mismatches"]
                                  for r in pod["char_rnn"]),
            "ms_pod": pt["ms"], "ms_pod_hot": pt["ms_hot"], "plain_ms_pod": pt["plain_ms"],
            "bound_ms_pod": pt["bound_ms"], "copy_ms_pod": pt["copy_ms"], "shape_pod": pt["shape"],
            "launches_phase11": sum(r["launches"][k] for r in pod["bridge"]),
            "launches_phase11_per_rank": [r["launches"][k] for r in pod["bridge"]],
            "mismatches_phase11": sum(r["check"][k]["mismatches"] for r in pod["bridge"]),
        })

    # 12. the host tier: the C loops on this machine's CPU, then a CUDA
    # master with two engine peers (the launch counts of A and B are 12b's)
    t12 = time.perf_counter()
    char_template = char_rnn_template()
    host = host_codec_check(char_template, args.seed)
    print(f"[12a] on {smi}; CPU {host['cpu']}")
    if any(host["mismatches"][k] for k in ("quantize_table", "apply_table_batch", "accumulate_table",
                                           "scales_off_octave")):
        raise AssertionError(f"phase 12a: the C loops disagree with their plain versions: {host['mismatches']}")
    CC.reset_launches()
    mixed, master = mixed_tier_tree(char_template, dev, args.seed)
    mixed_launches = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    if not all(mixed_launches.values()):
        raise AssertionError(f"a kernel of the mixed-tier tree never launched: {mixed_launches}")
    check12 = tree_kernel_check(master, make_spec(char_template))
    del master
    secs12 = time.perf_counter() - t12
    print(f"[12] launches {mixed_launches}; phase 12 {secs12:.3f} s")
    for k, n in mixed_launches.items():
        t[k]["launches_phase12"] = n
        t[k]["mismatches_phase12"] = check12[k]["mismatches"]
        t[k]["max_abs_err_phase12"] = check12[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check12.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 12b: kernel vs plain mismatches on the master's state: {bad}")

    # 13. the serving path: a CUDA master, an engine writer and two subscribers
    # (the launch counts of A and B are this phase's)
    t13 = time.perf_counter()
    CC.reset_launches()
    from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig

    serve_out, master = serve_tree(CharRNNConfig(), dev, args.seed)
    serve_launches = {k: CC.LAUNCHES[k] for k in ("quantize_rows", "apply_rows_batch")}
    if not all(serve_launches.values()):
        raise AssertionError(f"a kernel of the serving path never launched: {serve_launches}")
    check13 = tree_kernel_check(master, make_spec(char_template), "13")
    del master
    serve_out["seconds"] = time.perf_counter() - t13
    serve_out["launches"] = serve_launches
    print(f"[13] launches {serve_launches}; phase 13 {serve_out['seconds']:.3f} s; on {smi}")
    for k, n in serve_launches.items():
        t[k]["launches_phase13"] = n
        t[k]["mismatches_phase13"] = check13[k]["mismatches"]
        t[k]["max_abs_err_phase13"] = check13[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check13.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 13: kernel vs plain mismatches on the master's state: {bad}")

    # 14. the peer's wire capabilities: the reference wire (with the C peer),
    # the shared-memory lane, sign2 and striping (the launch counts of A and
    # B are this phase's)
    wire_out, wire_launches, check14 = wire_phase(dev, args.seed, mixed["last_add_to_converged_s"], smi)
    for k, n in wire_launches.items():
        t[k]["launches_phase14"] = n
        t[k]["launches_phase14_by_arm"] = {arm: v[k] for arm, v in wire_out["launches"].items()}
        t[k]["mismatches_phase14"] = check14[k]["mismatches"]
        t[k]["mismatches_phase14_by_arm"] = check14[k]["by_arm"]
        t[k]["max_abs_err_phase14"] = check14[k]["max_abs_err"]
    serve_out["script_s"] = time.perf_counter() - t_script
    print(f"[14] script {serve_out['script_s']:.3f} s")

    print(smi)
    kernels = []
    for k in SOURCES:
        row = {
            "name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
            "launches": launches[k], "mismatches": parity[k]["mismatches"],
            "max_abs_err": parity[k]["max_abs_err"], "ms": t[k]["ms"],
            "plain_ms": t[k]["plain_ms"], "bound_ms": t[k]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shape": t[k]["shape"],
        }
        row.update({x: v for x, v in t[k].items() if x not in row})
        kernels.append(row)
    print(json.dumps({"drive": drive}))
    print(json.dumps({"peer_example": example, "peer_tree": tree, "fetch_ab": fetch}))
    print(json.dumps({"bench_split": sp, "sweep": sw["rows"], "big_2e30": sw["big"]}))
    print(json.dumps({"pod": pod["summary"]}))
    print(json.dumps({"host_codec": host, "mixed_tier_tree": mixed, "phase12_s": secs12}))
    print(json.dumps({"serve": serve_out}))
    print(json.dumps({"wire": wire_out}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
