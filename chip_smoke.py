#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shared_tensor_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --phase20-cost    # phase 20a's cost alone (phase20_cost)
    python3 chip_smoke.py --kill-storm      # phase 23 alone, after the build

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
5. Kernel vs plain on the card for the scalar codec: kernel C (quantize,
   with its scale from the scale pass) and kernel D (apply_frame_many) at n
   in {17, 1000, 2^20 + 3, 2^24 + 5}, all three scale policies, garbage in
   the padding, scale 0 given explicitly, D with K in {1, 3, 9}; the scale
   pass (frame_scale) against its plain twin, bit for bit, at each n and
   policy, twice; then all four kernels at 2^30 + 1024 elements (byte
   offsets past 2^31), against their plain versions chunk by chunk. Any
   mismatch fails.
6. The headline codec bench (shared_tensor_tpu_torch.bench) at N = 1 Mi
   with the kernel and the plain codec: its JSON lines, frames/s and us
   per frame; the launches of the scale pass, C and D in the kernel run;
   the device time per launch of the scale pass, C and D and of one whole
   frame, each from a CUDA graph of many launches, so the eager frame
   splits into scale, C, D and launch/host overhead; the scale pass, C and
   D also over buffer sets that hold four times the L2, as phase 4 times A
   and B, C and D each beside copy_ms over as many sets (the kernel table's
   time); the scale pass beside the torch chain it replaces
   (ops/codec.compute_scale) and its plain twin; a torch.profiler window
   of the eager chain (busy share of the device; trace in profiles/).
7. The config-5 sweep (shared_tensor_tpu_torch.benchmarks.pareto) at 2^20,
   2^24, 2^27 and 2^30 elements with a short target: one JSON line per
   size, RMS decay per frame within 0.45-0.55, peak device memory, the
   launches of the scale pass, C and D, and the times per launch at 2^30
   by CUDA events: C; D with K = 1 and K = 3 targets, each beside its
   bound and copy_ms; the scale pass beside its bound and the torch chain,
   and against its twin, bit for bit.
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
   10's 8 ranks (one parallel.run_mesh for phases 9-11, started right
   after the build so that the ranks' start runs beside phases 2-8; they
   wait at a go file until phase 9, and the other 4 then wait at a
   barrier until phase 10), all on the one card with backend gloo (NCCL refuses two
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
   classes), 8 ranks on the card (gloo), 8 steps of the compressed arm and
   8 of the exact arm from the same parameters, on synthetic 32x32 images
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
   (refused fraction, staleness, time to a FRESH past the step, frames
   applied, S1's distance from the master, and on a line before it S1's
   link's frames in flight at the step and the most in the arm: the
   master's frames sent minus S1's applied seq, beside their bound; a FRESH
   past the step must come
   within the arm, since the subscriber links burst by the cascade, and S1
   must have taken in most of the step). The launches of A-cascade, the
   finish kernel and B in the phase (each > 0), then A and B against their
   plain versions on the master's state (tree_kernel_check), 0 mismatches
   required; the subscriber's host ms per applied frame. One {"serve": ...}
   line.
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
15. The observability plane on BASELINE config 2's table (the default
   CharRNNConfig, benchmarks/serve.tables' power-of-two data from --seed):
   a CUDA master M (max_children 3; cluster_json_path and health_json_path
   under profiles/, digests and clock probes every OBS_BEAT_S, a staleness
   objective of OBS_SLO_S), an engine child E whose stamps are skewed
   +OBS_SKEW_S, a CUDA child C skewed -OBS_SKEW_S and a subscriber S, all
   below M. E, C and M add in turn (each add agreed within AGREE_REL, the
   adding child drained, S fresh past it). Fails unless: M's cluster view
   counts 4 nodes within OBS_VIEW_S of the last add, its summed
   st_frames_out_total equal to the nodes' own; E's and C's clock offsets
   lie within their uncertainty of their skews; health.json parses and,
   read right after E's add (while E's stamp is the newest in the tree),
   M's record is its link to E, corrected by E's skew within the record's
   uncertainty, with E in its clock table; obs.top renders one row per live node of cluster.json; the
   hub's timeline exports as Chrome trace JSON (profiles/phase15_trace.json)
   holding a contiguous path from an update's origin to every other writer;
   M's st_encode_seconds and st_apply_seconds and E's st_update_hops
   counted; and A and B match their plain versions on M's state
   (tree_kernel_check). The launches of A and B in the phase.
16. The cluster lifecycle on BASELINE config 2's table (benchmarks/serve.tables'
   power-of-two data from --seed): a CUDA master m (LifecycleConfig.ctl_dir
   under profiles/), an engine peer e below it, a CUDA peer c below e (m
   takes two children, e then the subscriber s, so c is redirected below e
   and the marker and the acks cross an engine hop). (16a) m, e and c each
   add an update and m.snapshot_cluster(profiles/phase16_snap) starts
   before they agree: 3 shards, verify_manifest clean, the seconds and the
   shard bytes; the tree then agrees on the cut's total. (16b) two more
   adds, agreed and held by s; m.restore_cluster in place: every writer
   back at the cut's total within AGREE_REL within LC_AGREE_S, and no read
   of s verified by a mark stamped after the restore began holds the two
   adds (its projection on them stays under LC_SUB_PROJ) while s returns to
   the cut. (16c) e adds once more and `ctl drain e` (the port's CLI, through
   cmd.json in m's ctl_dir): e leaves, c re-grafts under m, and m and c
   agree on the cut plus e's add. (16d) everything closed, m, e and c
   restart from their shards of 16a's cut (restore_path) in the same chain
   on a new port: re-converged to the cut's total within LC_RESTART_S (the
   JAX kill-restore arm's 45 s). (16e) A and B against their plain versions
   on m's state after 16b (tree_kernel_check); the launches of A and B in
   16a-16d. Then the kill-restore arm of benchmarks/lifecycle.py (seven
   engine peers, 25% drops on one link, the whole tree killed and restarted
   from its shards, against an uninterrupted arm). One {"lifecycle": ...}
   line.
17. The cluster-sharded tensor on BASELINE config 2's table (the default
   CharRNNConfig: 9 leaves, 3,870,976 elements; benchmarks/serve.tables'
   power-of-two data from --seed), ShardRun: n_shards 4, the master n0 and
   n1 on the engine lane, n2 on the Python plane, n3 on the lane joined at
   n1's address so that it sits below n1 and its FWD frames cross a relay;
   every node with the ACK timeout of JAX's sharded benches (SHARD_ACK_S).
   (17a) each node adds one whole-table update (three quarters of it leave
   as FWD); every node drains within SHARD_WAIT_S (the seconds from the
   last add reported); FWD messages out, in, relayed (> 0) and
   dedup-discarded, park drops 0; each node's alloc_bytes after the drain
   under half of the table (and its peak during the adds, with up to three
   outboxes alive); a ShardGather over the four owners at the total within
   AGREE_REL of each leaf's max |value|. (17b) torch_view() on the card,
   bit-equal to the gather; its milliseconds and the copy's alone. (17c) a
   CUDA classic master and a create_or_fetch_sharded joiner (n_shards 4),
   which falls back to a classic peer on the card (sharded False); both
   add and agree within AGREE_REL within SHARD_WAIT_S. (17d) n2 leaves:
   its parent n0 adopts shard 2 at a higher epoch, with n2's end-to-end
   dedup windows, and a new gather reads the total (no mass lost, none
   applied twice). (17e) every node's save_shards into profiles/phase17/,
   a manifest and verify_shard_coverage clean; every node closes and
   restarts from the files (ShardConfig.restore_dir) on a new port, n0
   re-claiming both its shards, and a gather reads the cut's total. Then
   the launches of A and B in 17a-17e (17c's peers), and A and B against
   their plain versions on 17c's master's state (tree_kernel_check), 0
   mismatches. Each wait has SHARD_WAIT_S, the phase SHARD_PHASE_S; any
   miss fails. One {"shard": ...} line.
18. The codec lab (plain torch: no kernel of its own, and none of A-D).
   (18a) its device twins (ops/codec_lab_torch) on the card at config 2's
   table width (3,870,976 live elements as one flat buffer padded to the
   tile), a gaussian residual from --seed, against the numpy lab
   (ops/codec_lab): Sign2's codes byte-equal, residual and apply bit-equal,
   the scale equal (or one octave apart at an exact boundary); TopK with
   k = n / 32: the index set equal up to ties at the k-th value, the
   residual bit-equal and the apply conserving exactly; each twin's ms per
   call (CUDA events) beside its bytes over the card's memory rate. (18b)
   in the phases 9-11 spawn, on their first 4 ranks (4 peers x 1 shard,
   config 2's table): the production pod step and the lab's 2-bit step
   (parallel/ici_lab) in turns from the same states; uniform updates give
   bit-equal scales, values and residuals step by step, both drain to
   exact zero within LAB_UNIFORM_STEPS and every peer ends on the sum;
   gaussian updates give sign2 an RMS decay per frame over LAB_FRAMES steps
   at least LAB_DECAY_MARGIN under the production step's; ms per step of
   each arm and its bytes received per peer and step. Any failed check
   fails the phase. One {"codec_lab": ...} line.
19. In the phases 9-11 spawn, right after phase 9, on its 4 ranks: config 2
   at full width, PROFILE_WARM compressed steps, then PROFILE_STEPS more
   under the autograd profiler, the device's side alone (kernels, copies
   and the calls that launched them; benchmarks/profile_trace.profile_window,
   read in memory; no trace file):
   each rank's device busy share (the union of its kernel intervals over
   its window, opened after a barrier and closed after a device sync), the
   card's (every rank's intervals merged on the host's wall clock), device
   ms by kernel name, and the MFU of phase 9's tokens/s against the peak
   of the precision its matmuls ran at (benchmarks/train_bench). Fails if a
   trace holds no kernel event, A or B has no device time in it, or a
   rank's launches of A and B in the window are not PROFILE_STEPS each.
20. End to end and conformance: (20a) benchmarks/e2e_sync for E2E_S s at
   n = 1 Mi (the reference's comparison size): its parent a CUDA
   device-tier peer (send_pipeline_depth 8, K-frame device bursts), its
   child a host-tier port peer in a process of its own that sees no GPU,
   started before phase 17 so that its imports overlap phases 17-18 (it
   joins when the parent is up);
   frames/s and equivalent GB/s each way beside the reference's row
   (BASELINE.md, 242 frames/s), the launches of A and B in the exchange
   (both > 0), then A and B against their plain versions on the parent's
   state (0 mismatches). (20b) phase 16's kill-restore arm replays its
   timeline through tools/protospec (benchmarks.conformance): its events,
   routed events and violations are printed, and a violation or no routed
   event fails the arm.
21. A severed uplink's applied prefix counted once, on BASELINE config 2's
   table (benchmarks/serve.tables' power-of-two data, as phases 13-17): a
   CUDA device-tier master seeded from --seed and a CUDA joiner under
   FaultConfig(stall_after_frames=1, sever_after_frames=4, only_link=1)
   with ack_timeout_sec 1.0 and bursts of SEVER_BURST frames that adds one
   update: its uplink's first data
   message goes through, the next ones vanish, the link is severed and the
   joiner re-joins with every unacknowledged frame in its carry, less the
   ones the master reports applied (SYNC_FLAG_PREV_LINK). Every replica
   must reach seed + the update within AGREE_REL of each leaf's max
   |value|, and the fault plan must count a sever and a stall. Prints the
   seconds (against SEVER_BUDGET_S), the frames rolled into the carry and
   those retracted as already applied, the launches of A-cascade and B
   (both > 0), then A and B against their plain versions on the joiner's
   state (0 mismatches).
22. The engine's cascade on the device tier (kernel A-cascade,
   csrc/quantize_rows_cascade.cu, the port of native/stcodec.c's
   stc_quantize_ef_cascade with its partials, and the finish kernel,
   csrc/cascade_round.cu, the round's scales, ladder and stop rule from
   those partials). (22a) at config 2's table (9 leaves, 30,248 rows) and
   at 1 Mi, a gaussian residual with outliers from --seed
   (benchmarks/burst_graph.residual), at each depth of CASCADE_KCS, launch
   by launch (burst_graph.round_trip: the measuring launch, the finish, a
   pass of kc levels, the next finish): both kernels against their plain
   twins on the card (every buffer bit for bit), the pass against the
   port's libstcodec stc_quantize_ef_cascade on the host at the schedule
   the kernel wrote (words and residual bit for bit, max |r| bit for bit
   and the sums within CASCADE_SUM_RTOL), the schedule the halving of the
   finish's top, and the measured scales against the host tier's
   compute_scales_np (reported); then A-cascade's ms per launch at each
   depth of CASCADE_TIMED_KCS from a CUDA graph over buffer sets holding
   four times the L2, beside its bytes bound and copy_ms, the plain twin's
   ms at CASCADE_TIMED_KC; the finish kernel's ms, its bound, its spent
   launch's (a stopped round's, its latency floor), its plain twin's and
   the torch chain's it replaces (table._table_scales and cascade_ladder);
   and a CASCADE_BURST_K-frame core._BurstGraph: ms of a replay alone and
   the node types of its capture, at most 2K + 2 kernel nodes. Then the
   finish alone at ResNet-18's table (56 leaves, 87,504 rows: finish_check):
   kernel against twin over one round trip at CASCADE_TIMED_KC, the same
   times and the burst graph. (22b) benchmarks/drain_tail's device
   row at DRAIN_N under DRAIN_TIMEOUT_S: two CUDA peers, one gaussian add
   drained to exact zero in under DRAIN_MAX_FRAMES frames, and the
   launches of A-cascade, the finish and B in it (all > 0).
23. Hard link kills on the shared-memory lane (ROADMAP queue 3 items 8
   and 7): a CUDA device-tier master with one child slot, an engine child
   (host tier) and an engine leaf on one KILL_STORM_N table, joined over
   the lane, with a liveness timeout of KILL_STORM_PEER_TIMEOUT_S (below
   the phase's length; a peer keeps alive every quarter of it) and a
   metrics digest up every uplink each KILL_STORM_DIGEST_S. Every
   peer streams uniform deltas of +-KILL_STORM_SCALE from --seed for
   KILL_STORM_STREAM_S between kills; KILL_STORM_KILLS hard kills
   (node.drop_link), each when the victim's uplink owes nothing, take the
   child's uplink and the leaf's in turn. The leaf joins after the child's
   first re-graft and re-joins after each of its kills, redirected by the
   full master to the child's newest endpoint, and must land below it.
   Every replica must end within KILL_STORM_TOL of the exact sum of the
   adds, every lane must have gone live, no link may die unkilled (a lane
   link timing out mid-stream), and A-cascade, the finish and B must have
   launched (counts reset at the phase's start). Then KILL_STORM_LEAVES
   rounds of graceful leaves (ROADMAP queue 3 item 11): the child leaves,
   the leaf it orphans takes one more add and leaves once orphaned, and
   both re-join (the leaf below the child again); every leave() must
   return True, and the deviation check above comes after them. Prints the
   lane messages, the kills, the redirected joins, the leaves' verdicts
   and seconds, the signed deviation and the seconds (against
   KILL_STORM_BUDGET_S, 3 s).
   --kill-storm runs it alone after the build.
A CUDA peer's K-frame bursts follow the native engine's cascade
(CodecConfig.cascade_frames, 32 by default): they run kernel A-cascade
and the finish kernel, on ledgered and subscriber links alike, and kernel
A runs on the pod tier, single frames (reference-wire links and
cascade_frames=1) and the direct SharedTensor drives
(phases 3, 8c). Each peer phase reports the launches of A, A-cascade, the
finish and B and requires those of its path.
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
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

#: The kernels a CUDA peer launches: A-cascade and its finish kernel for its
#: bursts (the engine's cascade), A for its single frames, B for every apply.
PEER_KERNELS = ("quantize_rows", "quantize_rows_cascade", "cascade_round", "apply_rows_batch")
#: The kernels a phase of bursting CUDA peers must launch.
BURST_KERNELS = ("quantize_rows_cascade", "cascade_round", "apply_rows_batch")

#: HBM bandwidth by card (NVIDIA data sheets), bytes/s; the SXM part's is
#: the default.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
HBM_DEFAULT = 3.35e12

QUIET_REL = 1e-7  # a frame is quiet when every leaf's scale <= this * its max |value|
AGREE_REL = 1e-5  # replicas agree when every leaf is within this * its max |value|
BATCH = 4  # frames per link per round, delivered together (K of kernel B)
B_SHAPES = ((1, 1), (BATCH, 2), (BATCH, 3), (BATCH, 1), (1, 3))  # phase 4: (K, N) of the flood
D_TARGETS = (1, 3)  # phase 7: target arrays of D at 2^30
#: The kernels of the scalar codec's frame (phases 6-7): the scale pass, C, D.
SCALAR_KERNELS = ("frame_scale", "quantize", "apply_frame_many")
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


def path_counts() -> dict:
    """The launches of A, A-cascade, the finish kernel and B since the last
    reset."""
    from shared_tensor_tpu_torch.ops import codec_cuda as CC

    counts = CC.launches()
    return {k: counts[k] for k in PEER_KERNELS}


def require_launched(counts: dict, names, what: str) -> None:
    if not all(counts[k] for k in names):
        raise AssertionError(f"{what}: a kernel of the path never launched: {counts}")


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
           "apply_frame_many": {"mismatches": 0, "max_abs_err": 0.0},
           "frame_scale": {"mismatches": 0, "max_abs_err": 0.0}}

    def note(name, m, e):
        out[name]["mismatches"] += m
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)

    for n in sizes:
        n_pad = padded_len(n)
        base = torch.randn(n_pad, generator=gen, device=device)  # the padding holds garbage
        base[::97] = 0.0  # zeros count as negative
        base[:3] = torch.tensor([1e-40, -1e-45, 0.0])  # subnormals survive
        for policy in ScalePolicy:  # the scale pass, twice, against its twin
            got = [CC.frame_scale_kernel(base, n, policy) for _ in range(2)]
            want = CC.frame_scale_plain(base, n, policy)
            _sync(device)
            m = _bitdiff(got[0], want) + _bitdiff(got[1], want)
            note("frame_scale", m, _maxerr(got[0], want))
            print(f"[5] scale pass n={n} {policy.name}: {float(want):.6g}, mismatches {m}")
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
    and writes K arrays; each reads the 4-byte scale; the scale pass reads
    the residual and writes the scale."""
    return {"quantize": 8 * n + n / 8 + 4, "apply_frame_many": 8 * k * n + n / 8 + 4, "frame_scale": 4 * n + 4}


def codec_bench(device, rate: float, n: int, seconds: float) -> dict:
    """Phase 6: the bench for both codecs, the launches of the scale pass,
    C and D in the kernel run, and the device time split of one frame."""
    from shared_tensor_tpu_torch import bench
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.codec import compute_scale
    from shared_tensor_tpu_torch.utils.profiling import trace
    from shared_tensor_tpu_torch.utils.timing import copy_ms, event_ms, graph_ms, l2_sets

    CC.reset_launches()
    kern = bench.run("kernel", device, n, target_seconds=seconds)
    launches = {k: CC.launches()[k] for k in SCALAR_KERNELS}
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
    # the sender's two kernels against their twins at the bench's size
    r_k, r_p = r.clone(), r.clone()
    f_k, _ = CC.quantize_kernel(r_k, n, pol)
    f_p, _ = CC.quantize_plain(r_p, n, pol)
    _sync(device)
    check = {"frame_scale": _bitdiff(f_k.scale, f_p.scale),
             "quantize": _bitdiff(f_k.words, f_p.words) + _bitdiff(r_k, r_p)}
    print(f"[6] the scale pass and C against their twins at n={n}: mismatches {check}")
    if any(check.values()):
        raise AssertionError(f"phase 6: kernel vs plain mismatches: {check}")
    del r_k, r_p, f_k, f_p

    def whole_frame():
        f, _ = CC.quantize_kernel(r, n, pol)
        CC.apply_frame(v, f, n)

    # C and D as phase 4 times A and B: each launch of the graph takes the
    # next of enough buffer sets (a residual; an array and its own frame)
    # that they hold four times the L2 (``_ms``, read against the bytes
    # bound), and the same graph on one set (``_ms_hot``: at 2^20 a set
    # stays in the L2)
    nbytes = scalar_bytes(n)
    c_sets = [r.clone() for _ in range(l2_sets(nbytes["quantize"], device))]
    d_sets = [(torch.zeros(n, device=device), CC.quantize_kernel(x.clone(), n, pol)[0])
              for x in c_sets[:l2_sets(nbytes["apply_frame_many"], device)]]
    c_turn, d_turn = itertools.cycle(c_sets), itertools.cycle(d_sets)

    def d_cold():
        arr, f = next(d_turn)
        CC.apply_frame_many_kernel((arr,), f, n)

    s_turn = itertools.cycle(c_sets)
    split = {
        "frame_scale_ms": graph_ms(lambda: CC.frame_scale_kernel(next(s_turn), n, pol), iters),
        "frame_scale_ms_hot": graph_ms(lambda: CC.frame_scale_kernel(r, n, pol), iters),
        "frame_scale_library_ms": graph_ms(lambda: compute_scale(r, n, pol), iters),
        "frame_scale_plain_ms": event_ms(lambda: CC.frame_scale_plain(r, n, pol), 5, 1),
        "quantize_ms": graph_ms(lambda: CC.quantize_kernel(next(c_turn), n, pol, scale=scale), iters),
        "quantize_ms_hot": graph_ms(lambda: CC.quantize_kernel(r, n, pol, scale=scale), iters),
        "apply_frame_many_ms": graph_ms(d_cold, iters),
        "apply_frame_many_ms_hot": graph_ms(lambda: CC.apply_frame_many_kernel((v,), frame, n), iters),
        "frame_graph_ms": graph_ms(whole_frame, iters),
        "quantize_plain_ms": graph_ms(lambda: CC.quantize_plain(r, n, pol, scale=scale), 50),
        "apply_frame_many_plain_ms": graph_ms(lambda: CC.apply_frame_many_plain((v,), frame, n), 50),
    }
    for k, sets in (("quantize", c_sets), ("apply_frame_many", d_sets)):
        split[f"{k}_sets"] = len(sets)
        split[f"{k}_copy_ms"] = copy_ms(nbytes[k], device, lambda fn: graph_ms(fn, iters), sets=len(sets))
    del c_sets, d_sets, c_turn, d_turn, s_turn
    eager_ms = kern["detail"]["frame_s"] * 1e3
    split["frame_eager_ms"] = eager_ms
    split["overhead_ms"] = (eager_ms - split["frame_scale_ms_hot"] - split["quantize_ms_hot"]
                            - split["apply_frame_many_ms_hot"])
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
    return {"bench": {"kernel": kern, "plain": plain}, "launches": launches, "split": split, "check": check}


# -- phase 7 --------------------------------------------------------------------


def sweep(device, rate: float, log2s=SWEEP_LOG2, seconds: float = SWEEP_SECONDS) -> dict:
    """Phase 7: config 5's sweep through the port's pareto.measure_size;
    the RMS decay must be within 0.45-0.55 at every size."""
    from shared_tensor_tpu_torch.benchmarks import pareto
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.codec import compute_scale
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
    launches = {k: CC.launches()[k] for k in SCALAR_KERNELS}
    print(f"[7] launches in the sweep: {launches}")

    n = 1 << log2s[-1]
    gen = torch.Generator(device=device).manual_seed(2)
    r = torch.randn(n, generator=gen, device=device)
    frame, _ = CC.quantize_kernel(r.clone(), n)
    events = lambda fn: event_ms(fn, 10)
    big = {"n": n, "quantize_ms": events(lambda: CC.quantize_kernel(r, n, scale=frame.scale)),
           "quantize_bound_ms": scalar_bytes(n)["quantize"] / rate * 1e3}
    # the scale pass on the residual C left, against its twin and the torch chain
    got = [CC.frame_scale_kernel(r, n, ScalePolicy.POW2_RMS) for _ in range(2)]
    t0 = time.perf_counter()
    want = CC.frame_scale_plain(r, n, ScalePolicy.POW2_RMS)
    _sync(device)
    big.update(frame_scale_plain_ms=(time.perf_counter() - t0) * 1e3,
               frame_scale_mismatches=_bitdiff(got[0], want) + _bitdiff(got[1], want),
               frame_scale_max_abs_err=_maxerr(got[0], want),
               frame_scale_ms=events(lambda: CC.frame_scale_kernel(r, n, ScalePolicy.POW2_RMS)),
               frame_scale_bound_ms=scalar_bytes(n)["frame_scale"] / rate * 1e3,
               frame_scale_library_ms=events(lambda: compute_scale(r, n, ScalePolicy.POW2_RMS)))
    print(f"[7] scale pass at n=2^{log2s[-1]}: {big['frame_scale_ms']:.4f} ms (bound "
          f"{big['frame_scale_bound_ms']:.4f}), the torch chain {big['frame_scale_library_ms']:.4f}, its twin "
          f"{big['frame_scale_plain_ms']:.1f} ms (host clock), mismatches {big['frame_scale_mismatches']}")
    if big["frame_scale_mismatches"]:
        raise AssertionError(f"phase 7: the scale pass disagrees with its twin at 2^{log2s[-1]}")
    del r, got, want
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
        d = {k: a[k] - b.get(k, 0) for k in a if not k.startswith("st_link_") and isinstance(a[k], (int, float))}
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
              f"digests in {d.get('st_digest_msgs_in_total', 0)}, faults "
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
RESNET_STEPS = 8  # per arm (cut from 12 for the script's time)
BRIDGE_STEPS = 4  # timed steps per arm, after one warm-up step
RESUME_STEPS = 2  # steps from the checkpoint, live and restored
PROFILE_WARM, PROFILE_STEPS = 2, 3  # phase 19: untraced, then traced compressed steps


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


def pod_profile(mesh, seed: int) -> dict:
    """Phase 19, on each of phase 9's 4 ranks: BASELINE config 2 at full width,
    PROFILE_WARM compressed steps, then PROFILE_STEPS more under the
    profiler (benchmarks/profile_trace.profile_window): this rank's device
    busy share of the window, device ms by kernel name and the launches of
    A and B in the window; on rank 0 the card's share, every rank's kernel
    intervals merged on the host's clock. The profile holds the device's
    side alone and is read in memory (no trace file: the export and its
    reading cost a second a rank)."""
    from shared_tensor_tpu_torch.benchmarks import profile_trace as PT
    from shared_tensor_tpu_torch.benchmarks import train_bench as TB
    from shared_tensor_tpu_torch.examples.train_char_rnn import PANGRAM
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.train import PodTrainer

    t0 = time.perf_counter()
    dev = mesh.device
    cfg = m.CharRNNConfig()
    params = m.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    tr = PodTrainer(mesh, params, lambda p, b: m.loss_fn(p, b, cfg))
    batch = _char_batches(m.encode_corpus(PANGRAM, device=dev), seed + 19, mesh.n_peer)
    batches = iter([tr.shard_batch(batch(i)) for i in range(PROFILE_WARM + PROFILE_STEPS)])
    t1 = time.perf_counter()
    for _ in range(PROFILE_WARM):
        tr.step(next(batches), lr=CHAR_LR)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    out = PT.profile_window(mesh, lambda: tr.step(next(batches), lr=CHAR_LR), PROFILE_STEPS, None)
    t3 = time.perf_counter()
    del tr
    torch.cuda.empty_cache()
    out["seconds"] = {"setup": t1 - t0, "warm": t2 - t1} | out["seconds"] | {"free": time.perf_counter() - t3}
    return out | {"matmul_peak": TB.matmul_peak(dev)}


def profile_report(prof: list, tokens_per_s: float, secs: float) -> dict:
    """Phase 19's lines and checks from every rank's :func:`pod_profile`
    and phase 9's tokens/s; raises on a failed check."""
    from shared_tensor_tpu_torch.benchmarks import profile_trace as PT
    from shared_tensor_tpu_torch.benchmarks import train_bench as TB
    from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig

    peak, precision = prof[0]["matmul_peak"]
    fpt = TB.flops_per_token(CharRNNConfig())
    mfu = fpt * tokens_per_s / peak
    card = prof[0]["card"]
    bad = []
    for rk, r in enumerate(prof):
        ab = r["codec_ms"]
        share = "no kernel events" if r["busy_share"] is None else f"{r['busy_share']:.4f}"
        print(f"[19] rank {rk}: device busy share {share} of a {r['window_ms']:.3f} ms window "
              f"({PROFILE_STEPS} compressed steps, {r['kernel_events']} kernels, {r['kernel_ms']:.3f} kernel ms, "
              f"copies {r['copy_ms']:.3f} ms); A {ab['quantize_rows']:.4f} ms, B {ab['apply_rows_batch']:.4f} ms; "
              f"launches {r['launches']}; seconds " + ", ".join(f"{k} {v:.3f}" for k, v in r["seconds"].items()))
        if not r["kernel_events"]:
            bad.append(f"rank {rk}: the trace holds no CUDA kernel events")
        if any(n != PROFILE_STEPS for n in r["launches"].values()):
            bad.append(f"rank {rk}: launches {r['launches']} (want {PROFILE_STEPS} each)")
        if not all(v > 0 for v in ab.values()):
            bad.append(f"rank {rk}: A or B has no device time in the trace ({ab})")
    if card["busy_share"] is None:
        bad.append("the card's merged trace holds no kernel events")
    else:
        print(f"[19] the card ({card['ranks']} ranks merged on the host's wall clock, window "
              f"{card['window_ms']:.3f} ms, windows opened within {card['window_start_spread_ms']:.3f} ms): "
              f"busy share {card['busy_share']:.4f}, idle share {card['idle_share']:.4f}")
    for name, ms in PT.top(card["by_name"]):
        print(f"[19]   {ms:10.3f} ms  {name[:100]}")
    print(f"[19] mfu {mfu:.6f} for phase 9's {tokens_per_s:.1f} tokens/s x {fpt} FLOP a token against "
          f"{peak:.3e} FLOP/s ({precision} matmuls); phase 19 {secs:.3f} s")
    if bad:
        raise AssertionError("phase 19: " + "; ".join(bad))
    return {"mfu": mfu, "tokens_per_s": tokens_per_s, "flops_per_token": fpt, "peak_flops": peak,
            "matmul_precision": precision, "seconds": secs,
            "card": {k: v for k, v in card.items() if k != "by_name"} | {"top_kernels_ms": PT.top(card["by_name"])},
            "ranks": [{k: v for k, v in r.items() if k not in ("by_name", "card")} for r in prof]}


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


#: Seconds a started rank waits for the go file before it gives up.
POD_GO_WAIT_S = 600.0


def pod_ranks(world, seed: int, go_dir: str) -> dict:
    """Phases 9, 19, 10, 11 and 18b in one spawn of RESNET_PEERS ranks (a
    spawn and a CUDA context per rank cost seconds, so :class:`PodSpawn`
    starts them early): each rank makes its CUDA context, then waits for
    the file ``go`` in ``go_dir``, which holds phase 11's port; every rank
    builds every mesh; phases 9 and 19 run on the first CHAR_PEERS ranks
    while the others wait at a barrier, then phase 10 on all, then phase
    11 on the first 2 * PEERS of benchmarks/hierarchical.py, then 18b on
    the first CHAR_PEERS."""
    import torch.distributed as dist

    from shared_tensor_tpu_torch.benchmarks import hierarchical as H
    from shared_tensor_tpu_torch.parallel import make_mesh

    torch.zeros(1, device=world.device)  # the CUDA context, before the wait
    t_in = time.time()  # the parent reads each rank's start on the wall clock
    go = os.path.join(go_dir, "go")
    while not os.path.exists(go):
        if time.time() - t_in > POD_GO_WAIT_S:
            raise TimeoutError(f"no go file after {POD_GO_WAIT_S} s")
        time.sleep(0.02)
    with open(go) as f:
        port = int(f.read())
    t_go, p_in = time.time(), time.perf_counter()
    first = range(CHAR_PEERS)
    mesh4 = make_mesh(CHAR_PEERS, 1, device=world.device, backend=world.backend, ranks=first)
    mesh22 = make_mesh(2, 2, device=world.device, backend=world.backend, ranks=first)
    pod, index, both = H.make_pods(world.device, world.backend, ranks=range(2 * H.PEERS))
    t0 = time.perf_counter()
    char = None if mesh4 is None else pod_char_rnn(mesh4, mesh22, seed)
    dist.barrier()
    t1 = time.perf_counter()
    prof = None if mesh4 is None else pod_profile(mesh4, seed)
    dist.barrier()
    t19 = time.perf_counter()
    resnet = pod_resnet(world, seed)
    dist.barrier()
    t2 = time.perf_counter()
    bridge = None if pod is None else pod_bridge(pod, index, both, seed, port)
    dist.barrier()
    t3 = time.perf_counter()
    sign2 = None if mesh4 is None else pod_sign2(mesh4, seed)
    dist.barrier()
    return {"char": char, "profile": prof, "resnet": resnet, "bridge": bridge, "sign2": sign2, "phase9_s": t1 - t0,
            "phase19_s": t19 - t1, "phase10_s": t2 - t19, "phase11_s": t3 - t2, "phase18b_s": time.perf_counter() - t3,
            "t_in": t_in, "t_go": t_go, "meshes_s": t0 - p_in, "t_out": time.time()}


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
        out["cascade_launches"] = CC.ENGINE_LAUNCHES["quantize_rows_cascade"]  # the bridge peer's bursts
        out["round_launches"] = CC.ENGINE_LAUNCHES["cascade_round"]
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


class PodSpawn:
    """The RESNET_PEERS ranks of phases 9-11, started right after the build
    so that their start (an interpreter and a CUDA context each, 15-20 s
    for eight on the card's host) runs beside phases 2-8: each rank waits
    at its go file (:func:`pod_ranks`) until :meth:`go` writes it."""

    def __init__(self, device, seed: int):
        from shared_tensor_tpu_torch.parallel import run_mesh

        # phase 11's resume runs with deterministic algorithms, which need
        # cuBLAS's workspace pinned in every rank before its first matmul
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        self.dir = tempfile.mkdtemp(prefix="st_pod_go_")
        self.w0 = time.time()
        self.out: dict = {}

        def run():
            try:
                self.out["ranks"] = run_mesh(pod_ranks, RESNET_PEERS, 1, seed, self.dir, device=device,
                                             backend=POD_BACKEND, timeout_s=POD_GO_WAIT_S + 600)
            except BaseException as e:  # raised by go()
                self.out["error"] = e

        self.thread = threading.Thread(target=run, daemon=True, name="pod-spawn")
        self.thread.start()

    def go(self, port: int) -> list:
        """Release the ranks with phase 11's port; every rank's result."""
        tmp = os.path.join(self.dir, "go.tmp")
        with open(tmp, "w") as f:
            f.write(str(port))
        self.w_go = time.time()
        os.replace(tmp, os.path.join(self.dir, "go"))
        self.thread.join()
        shutil.rmtree(self.dir, ignore_errors=True)
        if "error" in self.out:
            raise self.out["error"]
        return self.out["ranks"]


def pod_phases(spawn: PodSpawn, device, rate: float, seed: int) -> dict:
    """Phases 9, 10 and 11 (see the module docstring) on the ranks that
    ``spawn`` started; raises on any failed check. Returns their results
    and the pod-shape times of A and B."""
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.ops.table import make_spec

    print(f"[9] {CHAR_PEERS} of {RESNET_PEERS} ranks on one card (the rest wait for phase 10), "
          f"backend={POD_BACKEND} (NCCL refuses two ranks on one device)")
    t0 = time.perf_counter()
    ranks = spawn.go(_free_port())
    spawn_s = time.perf_counter() - t0
    starts = [r["t_in"] - spawn.w0 for r in ranks]
    print(f"[9] the ranks' start: ready {min(starts):.3f}-{max(starts):.3f} s after the spawn, "
          f"{spawn.w_go - spawn.w0:.3f} s before the go; after the go {spawn_s:.3f} s: the ranks' release "
          f"{max(r['t_go'] for r in ranks) - spawn.w_go:.3f} s, their meshes {max(r['meshes_s'] for r in ranks):.3f} s, "
          "phases 9, 19, 10, 11 and 18b "
          + ", ".join(f"{ranks[0][k]:.3f}" for k in ("phase9_s", "phase19_s", "phase10_s", "phase11_s", "phase18b_s"))
          + f" s, the results back {time.time() - max(r['t_out'] for r in ranks):.3f} s after the last rank's")
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
    print(f"[9] phase 9 {secs9:.3f} s (phases 9, 19, 10, 11 and 18b after the go {spawn_s:.3f} s)")
    if bad:
        raise AssertionError("phase 9: " + "; ".join(bad))
    prof = [r["profile"] for r in ranks[:CHAR_PEERS]]
    profile = profile_report(prof, float(np.mean([r["tokens_per_s"] for r in char])), ranks[0]["phase19_s"])

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
        "seconds": {"phase9": secs9, "phase19": ranks[0]["phase19_s"], "phase10": secs10,
                    "phase11": ranks[0]["phase11_s"], "phases_9_19_10_11_18b_after_go": spawn_s,
                    "ranks_ready_after_spawn": max(starts), "go_after_spawn": spawn.w_go - spawn.w0}, "backend": POD_BACKEND,
        "profile": profile,
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
    return {"char_rnn": char, "profile": prof, "bridge": res11, "summary": summary,
            "times": {"quantize_rows": t["quantize_rows"], "apply_rows_batch": t["apply_rows_batch"][0]},
            "sign2": [r["sign2"] for r in ranks[:CHAR_PEERS]], "phase18b_s": ranks[0]["phase18b_s"]}


# -- phase 12 -------------------------------------------------------------------


def char_rnn_template() -> dict:
    """BASELINE config 2's table: the default CharRNNConfig's parameter
    shapes as zero float32 arrays (9 leaves, 3,870,976 elements)."""
    from shared_tensor_tpu_torch.models import char_rnn as m
    from shared_tensor_tpu_torch.ops.table import tree_flatten, tree_unflatten

    params = m.init_params(torch.Generator().manual_seed(0), m.CharRNNConfig(), device="cpu")
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [np.zeros(tuple(x.shape), np.float32) for x in leaves])


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
    from shared_tensor_tpu_torch.benchmarks import cpu_model
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
        d = {k: a[k] - b.get(k, 0) for k in a if not k.startswith("st_link_") and isinstance(a[k], (int, float))}
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
    (12b's, 13's, ...; benchmarks.kernel_check): A as a burst of K = the
    most frames one BURST carries for this table, B with those K frames
    into N = 2 targets. Returns {kernel: {"mismatches", "max_abs_err", "k",
    ...}}."""
    from shared_tensor_tpu_torch.benchmarks import kernel_check

    out = kernel_check(master, spec)
    a, b = out["quantize_rows"], out["apply_rows_batch"]
    print(f"[{tag}] A quantize_rows, a burst of K={a['k']} ({a['live_frames']} frames with a nonzero scale): "
          f"mismatches {a['mismatches']}; B apply_rows_batch K={b['k']} N=2: mismatches {b['mismatches']}")
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


def _record_messages(sub, spec) -> list:
    """Log (monotonic ns, kind, seq, origin stamp) of every data message
    and FRESH mark the subscriber ``sub`` handles, by wrapping its handler
    on the instance (``del sub._on_message`` undoes it). Returns the log."""
    from shared_tensor_tpu_torch.comm import wire

    log, handle = [], sub._on_message

    def on_message(link, payload):
        kind = payload[0]
        if kind in (wire.DATA, wire.BURST, wire.RDATA):
            trace = wire.decode_rdata(payload, spec)[4] if kind == wire.RDATA else wire.data_trace(payload, spec)
            log.append((time.monotonic_ns(), "data", wire.data_seq(payload), None if trace is None else trace[1]))
        elif kind == wire.FRESH:
            stamp, last_seq = wire.decode_fresh(payload)
            log.append((time.monotonic_ns(), "fresh", last_seq, stamp))
        return handle(link, payload)

    sub._on_message = on_message
    return log


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
        # FRESH mark needs a drained residual; the master's subscriber links
        # burst by the cascade, which drains each update in tens of frames.
        writer.add(deltas[1])
        if not writer.drain(timeout=deadline_s):
            raise AssertionError("phase 13: the engine writer did not drain its update")
        ep1 = serve.epoch()
        for sub in subs:
            sub.wait_fresh(ep1, timeout=deadline_s)
        s1_log = _record_messages(s1, spec)
        master.add(deltas[0])
        t_add = time.perf_counter()
        ep = serve.epoch()
        fresh = {}
        for name, sub in zip(("s1", "s2"), subs):
            sub.wait_fresh(ep, timeout=deadline_s)
            fresh[name] = {"last_add_to_fresh_s": time.perf_counter() - t_add}
            if name == "s1":
                s1_fresh_ns = time.monotonic_ns()
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
        swapped = p1 is not handle.params() or handle.refresh(1.0) or handle.params() is not p1
        # every message S1 handled after its wait_fresh(ep) returned: which
        # frame (seq, the origin stamp it carries) and FRESH mark came late
        out["s1_after_fresh"] = [{"after_s": (t - s1_fresh_ns) / 1e9, "kind": kind, "seq": seq,
                                  "stamp_minus_epoch_s": None if stamp is None else (stamp - ep) / 1e9}
                                 for t, kind, seq, stamp in list(s1_log) if t > s1_fresh_ns]
        del s1._on_message  # back to the class's handler
        print(f"[13] S1 handled {len(out['s1_after_fresh'])} messages after its wait_fresh returned: "
              f"{out['s1_after_fresh'][:6]}")
        if swapped:
            raise AssertionError(f"phase 13: params() changed between refreshes of an unchanged state; S1's "
                                 f"messages after its wait_fresh: {out['s1_after_fresh']}")
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


def _sub_in_flight_bound() -> int:
    """A subscriber link's most frames in flight: the writer's send queue
    (SUB_QUEUED_MSGS) and as many in its sender's hand, both sockets at
    twice the SUB_SOCKET_FRAMES asked for, the subscriber's receive queue,
    and one message each in its receiver's hand and its apply (as
    tests/test_torch_serve.py's bound test counts them)."""
    from shared_tensor_tpu_torch.comm import peer
    from shared_tensor_tpu_torch.serve import subscriber

    return 2 * peer.SUB_QUEUED_MSGS + 4 * peer.SUB_SOCKET_FRAMES + subscriber.RECV_QUEUE_MSGS + 2


def _sub_in_flight(writer, link: int, sub) -> tuple[int, int, int]:
    """A subscriber link's frames in flight, one message a frame: (the
    writer's data messages sent on ``link`` minus the subscriber's applied
    seq, sent, applied). The applied seq is read first, so the difference
    never under-counts; both restart at a resync."""
    applied = sub._expected_seq - 1
    with writer._sub_mu.get(link, threading.Lock()):
        held = writer._sub_held.get(link)
        with writer._ack_mu:
            sent = writer._tx_seq.get(link, 0) - (len(held[1]) if held else 0)
    return sent - applied, sent, applied


def sgd_arm(master, s1, loss_fn, batch, cfg_m, spec, offs) -> dict:
    """Phase 13's last arm, on an update whose bounds are no powers of two:
    the master adds one SGD step of the char-RNN at its own weights (as a
    trainer adds it), then nobody writes. The master's subscriber links
    burst by the engine's cascade (kernel A-cascade and the finish kernel),
    which drains such a residual to the exact zero a FRESH mark needs in
    tens of frames; the per-frame schedule of single frames left sparse
    outliers for thousands, and refused 84-100% of the reads here. Reports
    the refused fraction and staleness over SERVE_SGD_ARM_S s of reads at
    the 1 s bound, the time to a FRESH past the step, S1's frames applied
    and its distance from the master at the arm's end; fails unless a FRESH
    past the step comes within the arm and S1 is finite and has taken in
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
    link = next(lk for lk, rng in master._sub_links.items() if rng is None)  # S1's, on the master
    at_step = _sub_in_flight(master, link, s1)
    master.add(step)
    t_add, ep = time.perf_counter(), serve.epoch()
    fresh_at, worst, done = [], [at_step[0]], threading.Event()

    def waiter():
        try:
            s1.wait_fresh(ep, timeout=SERVE_SGD_ARM_S)
            fresh_at.append(time.perf_counter() - t_add)
        except TimeoutError:
            pass

    def sampler():  # every 20 ms: it takes the link's lock, which the sub-push thread holds to send
        while not done.wait(0.02):
            worst[0] = max(worst[0], _sub_in_flight(master, link, s1)[0])

    threads = [threading.Thread(target=waiter), threading.Thread(target=sampler)]
    for th in threads:
        th.start()
    try:
        arm = serve_bench.read_arm(s1, 1.0, SERVE_SGD_ARM_S)
    finally:
        threads[0].join()
        done.set()
        threads[1].join()
    arm["in_flight"] = {"at_step": at_step[0], "sent": at_step[1], "applied": at_step[2], "max_in_arm": worst[0],
                        "bound": _sub_in_flight_bound()}
    print(f"[13] S1's link at the SGD step: {at_step[0]} frames in flight (the master's frames sent {at_step[1]} "
          f"minus S1's applied seq {at_step[2]}); most in the arm {worst[0]} (bound {_sub_in_flight_bound()})")
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
          f"{arm['refused_fraction']} (single frames: 0.84-1.0), staleness p50 {arm['staleness_p50_s']} "
          f"p99 {arm['staleness_p99_s']} s; "
          f"FRESH past the step after {arm['time_to_fresh_s']} s; S1 applied {arm['frames_applied']} frames, "
          f"RMS distance from the master {rms_err:.3e} (the step's RMS {rms_step:.3e}), worst leaf "
          f"{arm['worst_leaf_rel_err']:.3e} (the step's {arm['step_worst_leaf_rel']:.3e})")
    if arm["time_to_fresh_s"] is None:
        raise AssertionError(f"phase 13: no FRESH mark past the SGD step within {SERVE_SGD_ARM_S} s: {arm}")
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
    launches = {"14a": path_counts()}
    char_template = char_rnn_template()
    n = make_spec(char_template).total_n
    CC.reset_launches()
    out["14b"], masters["14b"] = compat_wide(device, seed, n)
    launches["14b"] = path_counts()
    CC.reset_launches()
    out["14c"], masters["14c"] = lane_chain(char_template, device, seed, striped=False)
    out["14c_striped"], _ = lane_chain(char_template, device, seed, striped=True)
    launches["14c"] = path_counts()
    total = {k: sum(v[k] for v in launches.values()) for k in PEER_KERNELS}
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
    # the reference wire's frames run A, the lane chain's bursts A-cascade
    require_launched(launches["14b"], ("quantize_rows", "apply_rows_batch"), "phase 14b")
    require_launched(launches["14c"], BURST_KERNELS, "phase 14c")
    bad = {k: v["by_arm"] for k, v in check.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 14: kernel vs plain mismatches on the masters' states: {bad}")
    return out, total, check


# -- phase 15 -------------------------------------------------------------------

#: Phase 15: the digest and clock-probe interval of every node, the skew
#: simulated on E's and C's stamps, the staleness objective of M's health
#: analyzer, and how long after the last add the cluster view may take.
OBS_BEAT_S = 0.2
OBS_SKEW_S = 0.05
OBS_SLO_S = 1.0
OBS_VIEW_S = 3.0
OBS_CLOCK_REPLIES = 3


def _m_link_to_e(health_path: str, ids: dict) -> tuple[dict, dict]:
    """Phase 15's check 4: wait up to OBS_VIEW_S for health.json to hold
    M's worst record with E as its origin, corrected (an uncertainty, E's
    entry in the clock table). Returns the document and that record."""
    deadline = time.perf_counter() + OBS_VIEW_S
    while True:
        try:
            with open(health_path) as fh:
                health = json.load(fh)
        except (OSError, ValueError):
            health = {}
        rec = health.get("staleness", {}).get("nodes", {}).get(str(ids["M"]))
        if rec is not None and rec["origin"] == ids["E"] and rec["unc_sec"] is not None \
                and str(ids["E"]) in health.get("clock", {}):
            return health, rec
        if time.perf_counter() > deadline:
            raise AssertionError(f"phase 15: health.json has no corrected record of M's link to E: {rec}")
        time.sleep(0.02)


def obs_phase(device, seed: int, smi: str, cfg_m=None) -> tuple[dict, tuple]:
    """Phase 15 (module docstring): the observability plane on the table of
    the char-RNN ``cfg_m`` (None: config 2's). Returns the report and the
    master's state for tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, obs, serve
    from shared_tensor_tpu_torch.benchmarks import serve as serve_bench
    from shared_tensor_tpu_torch.config import ObsConfig
    from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig
    from shared_tensor_tpu_torch.obs import aggregate, top, trace_export
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec, tree_flatten, tree_unflatten

    template, seed_tree, deltas = serve_bench.tables(cfg_m or CharRNNConfig(), seed + 15, n=3)
    spec = make_spec(template)
    os.makedirs(OUT_DIR, exist_ok=True)
    cluster_path, health_path = (os.path.join(OUT_DIR, n) for n in ("cluster.json", "health.json"))
    trace_path = os.path.join(OUT_DIR, "phase15_trace.json")
    for p in (cluster_path, health_path):
        if os.path.exists(p):
            os.remove(p)
    beats = dict(digest_interval_sec=OBS_BEAT_S, clock_sync_interval_sec=OBS_BEAT_S)
    tcfg = TransportConfig(peer_timeout_sec=30.0, max_children=3)
    cfg_m = Config(transport=tcfg, obs=ObsConfig(cluster_json_path=cluster_path, health_json_path=health_path,
                                                 staleness_slo_sec=OBS_SLO_S, **beats))
    cfg_e = Config(transport=tcfg, obs=ObsConfig(clock_skew_sim_sec=OBS_SKEW_S, **beats))
    cfg_c = Config(transport=tcfg, obs=ObsConfig(clock_skew_sim_sec=-OBS_SKEW_S, **beats))
    # the timeline of this phase alone, large enough for every trace_apply
    hub = obs.hub()
    hub.poll_native()
    hub.recorder.clear()
    hub.recorder.set_capacity(1 << 18)
    port = _free_port()
    peers, sub, out = [], None, {}
    t0 = time.perf_counter()
    try:
        m = create_or_fetch("127.0.0.1", port, seed_tree, cfg_m, timeout=60.0, device=device)
        peers.append(m)
        e = create_or_fetch("127.0.0.1", port, template, cfg_e, timeout=60.0, host_tier=True)
        peers.append(e)
        c = create_or_fetch("127.0.0.1", port, template, cfg_c, timeout=60.0, device=device)
        peers.append(c)
        sub = serve.subscribe("127.0.0.1", port, template, Config(transport=tcfg, obs=ObsConfig(**beats)),
                              timeout=60.0)
        ids = {"M": m.node.obs_id, "E": e.node.obs_id, "C": c.node.obs_id, "S": sub.node.obs_id}
        if e._engine is None or c._engine is not None or c.st.device.type != torch.device(device).type \
                or len(m.node.links) != 3 or e._uplink is None or c._uplink is None:
            raise AssertionError(f"phase 15: want a {device} master with an engine child, a {device} child and a "
                                 f"subscriber below it; the master has {len(m.node.links)} links")
        out["join_s"] = time.perf_counter() - t0
        leaves = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
        # the writers add in turn, E first, each add agreed, the adding
        # child drained and S fresh past it before the next: a link residual
        # holding two updates of unrelated bounds drains in thousands of
        # frames (PERF.md §4). Check 4 reads M's record right after E's add,
        # while E's stamp is the newest in the tree: a link's record is its
        # latest traced message, and once M has added, a frame E sends
        # carries M's stamp, so E's origin may then be on no link of M's
        for who, p, d in (("E", e, deltas[0]), ("C", c, deltas[1]), ("M", m, deltas[2])):
            for j, x in enumerate(tree_flatten(d)[0]):
                leaves[j] += x
            target = flatten(tree_unflatten(spec.treedef, [x.astype(np.float32) for x in leaves]), spec, device)
            mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
            p.add(d)
            t_add = time.perf_counter()
            out[f"agree_s_{who}"], out[f"err_{who}"] = _wait_agree(peers, target, mag, spec, AGREE_REL, 30.0, 0.01)
            if p is not m and not p.drain(timeout=10.0):
                raise AssertionError(f"phase 15: {who} did not drain its add")
            sub.wait_fresh(serve.epoch(), timeout=10.0)
            out[f"fresh_s_{who}"] = time.perf_counter() - t_add
            if who == "E":
                health, rec = _m_link_to_e(health_path, ids)
        master = m.st.snapshot_all() + (flatten(deltas[2], spec, device), m.st.codec)
        # 2: the cluster view at M: four nodes (the subscriber counted), and
        # the summed frames equal to the nodes' own counts at quiescence
        while True:
            view = m.metrics(cluster=True)
            own = sum(p.metrics()["st_frames_out_total"] for p in peers)
            got = view["counters"].get("st_frames_out_total", 0)
            late = time.perf_counter() - t_add > OBS_VIEW_S
            if aggregate.cluster_nodes(view) == 4 and got == own and not late:
                break
            if late:
                raise AssertionError(f"phase 15: {OBS_VIEW_S} s after the last add M's view has "
                                     f"{aggregate.cluster_nodes(view)} nodes, frames out {got} against {own}")
            time.sleep(0.02)
        out["view_s"] = time.perf_counter() - t_add
        out["cluster"] = {"nodes": aggregate.cluster_nodes(view), "frames_out": got, "own_frames_out": own,
                          "st_cluster_nodes": m.metrics()["st_cluster_nodes"], "ids": ids}
        # 3: the clock: E's and C's offsets within their uncertainty of the skew
        deadline = time.perf_counter() + OBS_VIEW_S
        while not all(p._clock.replies >= OBS_CLOCK_REPLIES for p in (e, c)) and time.perf_counter() < deadline:
            time.sleep(0.02)
        clock = {}
        for who, p, skew in (("E", e, OBS_SKEW_S), ("C", c, -OBS_SKEW_S)):
            mm = p.metrics()
            clock[who] = {"offset_s": mm.get("st_clock_offset_seconds"), "unc_s": mm.get("st_clock_uncertainty_seconds"),
                          "skew_s": skew, "probes": mm["st_clock_probes_total"], "replies": p._clock.replies}
            if clock[who]["offset_s"] is None or abs(clock[who]["offset_s"] - skew) > clock[who]["unc_s"]:
                raise AssertionError(f"phase 15: {who}'s clock offset {clock[who]} misses its skew")
        out["clock"] = clock
        # 4: health.json, read after E's add: M's record (its link to E),
        # whose correction is E's offset (M's is 0) within its uncertainty
        shift = rec["corrected_sec"] - rec["raw_sec"]
        out["health"] = {"m_link_to_e": rec, "correction_s": shift, "clock": health["clock"],
                         "slo": {"alert": health["slo"]["alert"], "bad_beats": m.metrics().get("st_slo_bad_beats_total")},
                         "heat_shards": len(health["heat"]["shards"]), "beats": health["beats"]}
        if abs(shift - OBS_SKEW_S) > rec["unc_sec"]:
            raise AssertionError(f"phase 15: the correction of M's link to E, {shift} s, misses E's offset "
                                 f"{OBS_SKEW_S} s by more than {rec['unc_sec']} s")
        # 5: obs.top renders one row per live node of cluster.json
        with open(cluster_path) as fh:
            cdoc = json.load(fh)
        frame = top.render(cdoc, None, 0.0)
        rows = [ln.split()[0] for ln in frame.splitlines() if ln.split() and ln.split()[0].isdigit()]
        out["top_rows"] = len(rows)
        if sorted(rows) != sorted(str(i) for i in ids.values()):
            raise AssertionError(f"phase 15: obs.top rows {rows} are not the live nodes {ids}")
        # 6: the trace export: valid Chrome trace JSON with a causal path from
        # an update's origin to every other writer
        hub.poll_native()
        timeline = hub.recorder.timeline()
        trace_export.export_file(trace_path, timeline)
        with open(trace_path) as fh:
            tdoc = json.load(fh)
        if not tdoc["traceEvents"] or any("ph" not in t or "pid" not in t for t in tdoc["traceEvents"]):
            raise AssertionError("phase 15: the exported trace is not Chrome trace JSON")
        paths = trace_export.trace_paths(timeline)
        writers = {ids["M"], ids["E"], ids["C"]}
        full = [(k, v) for k, v in paths.items() if k[0] in writers and writers - {k[0]} <= {r["node"] for r in v}
                and trace_export.contiguous(v)]
        stats = trace_export.path_stats(paths)
        out["trace"] = {"events": len(timeline), "paths": stats, "paths_to_every_writer": len(full),
                        "file": trace_path, "trace_events": len(tdoc["traceEvents"])}
        if not full:
            raise AssertionError(f"phase 15: no update's path reaches every other writer: {stats}")
        # 7: histograms and hops
        mm, em = m.metrics(), e.metrics()
        out["hist"] = {"m_encode": mm["st_encode_seconds"], "m_apply": mm["st_apply_seconds"],
                       "m_ack_rtt": mm["st_ack_rtt_seconds"], "e_hops_count": em["st_update_hops_count"],
                       "e_hops_sum": em["st_update_hops_sum"]}
        if not (mm["st_encode_seconds"]["count"] > 0 and mm["st_apply_seconds"]["count"] > 0
                and em["st_update_hops_count"] > 0):
            raise AssertionError(f"phase 15: histograms or hops did not count: {out['hist']}")
        out["events"] = dict(hub.recorder.counts)
        out["obs_events_dropped"] = mm["st_obs_events_dropped_total"]
        _healthy(peers)
    finally:
        if sub is not None:
            sub.close()
        for p in reversed(peers):
            p.close()
        hub.recorder.set_capacity(4096)
    out["seconds"] = time.perf_counter() - t0
    print(f"[15] M, E (engine, +{OBS_SKEW_S} s), C (-{OBS_SKEW_S} s) and S joined in {out['join_s']:.3f} s; "
          f"agreement after each add: E {out['agree_s_E']:.3f}, C {out['agree_s_C']:.3f}, M {out['agree_s_M']:.3f} s")
    print(f"[15] cluster view {out['view_s']:.3f} s after the last add: {out['cluster']}")
    print(f"[15] clock: E {clock['E']['offset_s']:.6f} +- {clock['E']['unc_s']:.6f} s, "
          f"C {clock['C']['offset_s']:.6f} +- {clock['C']['unc_s']:.6f} s")
    print(f"[15] health: M's link to E raw {rec['raw_sec']:.4f} s, corrected {rec['corrected_sec']:.4f} s "
          f"(+{shift:.6f} +- {rec['unc_sec']:.6f}); top rows {out['top_rows']}; trace {out['trace']['paths']}, "
          f"{out['trace']['paths_to_every_writer']} paths reach every writer")
    print(f"[15] M encode {mm['st_encode_seconds']['count']} ({mm['st_encode_seconds']['sum']:.4f} s), apply "
          f"{mm['st_apply_seconds']['count']} ({mm['st_apply_seconds']['sum']:.4f} s); E hops count "
          f"{em['st_update_hops_count']}; phase 15 {out['seconds']:.3f} s; on {smi}")
    print(frame)
    return out, master


# -- phase 16 -------------------------------------------------------------------

#: Phase 16: the deadline of each agreement, the restart's re-convergence
#: budget (the JAX kill-restore arm's), and the projection of a verified
#: subscriber read onto the post-snapshot adds above which it holds them.
LC_AGREE_S = 30.0
LC_RESTART_S = 45.0
LC_SUB_PROJ = 0.5


def _lc_target(seed_tree, deltas, spec, device):
    """(flat target on ``device``, per-leaf max |target|, flat f64 on the
    host) of the seed plus ``deltas``."""
    from shared_tensor_tpu_torch.ops import codec_np
    from shared_tensor_tpu_torch.ops.table import flatten, tree_flatten, tree_unflatten

    leaves = [np.asarray(x, np.float64) for x in tree_flatten(seed_tree)[0]]
    for d in deltas:
        for j, x in enumerate(tree_flatten(d)[0]):
            leaves[j] += x
    tree = tree_unflatten(spec.treedef, [x.astype(np.float32) for x in leaves])
    mag = torch.tensor([np.abs(x).max() for x in leaves], dtype=torch.float64, device=device)
    return flatten(tree, spec, device), mag, codec_np.flatten_np(tree, spec).astype(np.float64)


def lifecycle_phase(device, seed: int, smi: str, cfg_m=None) -> tuple[dict, tuple]:
    """Phase 16 (module docstring): the cluster lifecycle on the table of
    the char-RNN ``cfg_m`` (None: config 2's). Returns the report and the
    master's state after 16b for tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, ctl, serve
    from shared_tensor_tpu_torch.benchmarks import serve as serve_bench
    from shared_tensor_tpu_torch.config import LifecycleConfig
    from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig
    from shared_tensor_tpu_torch.ops import codec_np
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec
    from shared_tensor_tpu_torch.serve import StalenessError
    from shared_tensor_tpu_torch.utils import checkpoint as ckpt

    template, seed_tree, deltas = serve_bench.tables(cfg_m or CharRNNConfig(), seed + 16, n=6)
    spec = make_spec(template)
    snapdir, ctl_dir = os.path.join(OUT_DIR, "phase16_snap"), os.path.join(OUT_DIR, "phase16_ctl")
    for d in (snapdir, ctl_dir):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(ctl_dir)

    def cfg(name: str, restore: str = "", **lc):
        # m takes two children (e, then s): c is redirected below e
        return Config(transport=TransportConfig(peer_timeout_sec=30.0, max_children=2),
                      lifecycle=LifecycleConfig(node_name=name, restore_path=restore, **lc))

    port = _free_port()
    peers, sub, out, steps = [], None, {}, {}
    t0 = time.perf_counter()

    def step(name: str) -> None:  # the wall seconds of each step, in order
        steps[name] = time.perf_counter() - t0 - sum(steps.values())

    try:
        m = create_or_fetch("127.0.0.1", port, seed_tree, cfg("m", ctl_dir=ctl_dir), timeout=60.0, device=device)
        peers.append(m)
        e = create_or_fetch("127.0.0.1", port, template, cfg("e"), timeout=60.0, host_tier=True)
        peers.append(e)
        sub = serve.subscribe("127.0.0.1", port, template, Config(transport=TransportConfig(peer_timeout_sec=30.0)),
                              timeout=60.0)
        c = create_or_fetch("127.0.0.1", port, template, cfg("c"), timeout=60.0, device=device)
        peers.append(c)
        deadline = time.perf_counter() + 10.0
        while len(e.node.links) < 2 and time.perf_counter() < deadline:
            time.sleep(0.01)
        if e._engine is None or c._engine is not None or len(m.node.links) != 2 or len(e.node.links) != 2:
            raise AssertionError(f"phase 16: want {device} m - engine e - {device} c with a subscriber below m; "
                                 f"m has {len(m.node.links)} links, e {len(e.node.links)}")
        out["join_s"] = time.perf_counter() - t0
        step("join")
        # 16a: each writer adds, and the snapshot starts before they agree
        for p, d in zip((m, e, c), deltas[:3]):
            p.add(d)
        res = m.snapshot_cluster(snapdir)
        problems = ckpt.verify_manifest(snapdir)
        man = ckpt.load_manifest(snapdir)
        out["snapshot"] = {"duration_sec": res["duration_sec"], "nodes": res["nodes"],
                           "shard_bytes": sum(x["bytes"] for x in man["nodes"]), "verify": problems}
        if res["nodes"] != 3 or problems:
            raise AssertionError(f"phase 16a: snapshot {out['snapshot']}")
        cut, cut_mag, cut_np = _lc_target(seed_tree, deltas[:3], spec, device)
        out["cut_agree_s"], _ = _wait_agree(peers, cut, cut_mag, spec, AGREE_REL, LC_AGREE_S, 0.01)
        step("16a")
        # 16b: two more adds, agreed, and held by s; then the in-place restore
        m.add(deltas[3])
        e.add(deltas[4])
        post, post_mag, _ = _lc_target(seed_tree, deltas[:5], spec, device)
        out["post_agree_s"], _ = _wait_agree(peers, post, post_mag, spec, AGREE_REL, LC_AGREE_S, 0.01)
        after = codec_np.flatten_np(deltas[3], spec).astype(np.float64) + codec_np.flatten_np(deltas[4], spec)
        norm = float(after @ after)

        def proj(arr) -> float:  # the share of the post-snapshot adds that ``arr`` holds
            return float((arr.astype(np.float64) - cut_np) @ after) / norm

        t1 = time.perf_counter()
        deadline = t1 + LC_AGREE_S
        while proj(sub._pub.acquire()[0]) < 1.0 - LC_SUB_PROJ:
            if time.perf_counter() > deadline:
                raise AssertionError("phase 16b: s never took in the post-snapshot adds")
            time.sleep(0.01)
        out["sub_hold_s"] = time.perf_counter() - t1
        t_restore_ns = time.monotonic_ns()
        t1 = time.perf_counter()
        res = m.restore_cluster(snapdir)
        out["restore"] = {"duration_sec": res["duration_sec"], "nodes": res["nodes"],
                          "call_s": time.perf_counter() - t1}
        out["restore"]["agree_s"], out["restore"]["err"] = _wait_agree(peers, cut, cut_mag, spec, AGREE_REL,
                                                                       LC_AGREE_S, 0.01)
        master = m.st.snapshot_all() + (flatten(deltas[0], spec, device), m.st.codec)
        # s: m re-seeded it at the cut, so a read verified by a mark stamped
        # after the restore began holds none of the post-snapshot adds (a
        # refused read is the contract's other answer); its state returns
        # to the cut
        reads = {"verified": 0, "refused": 0, "old_marks": 0, "worst_proj": 0.0}
        tol = AGREE_REL * float(cut_mag.max())
        deadline = time.perf_counter() + LC_AGREE_S
        while True:
            try:
                arr, stale, _ = sub.read_flat(max_staleness=1.0)
                reads["verified"] += 1
                if time.monotonic_ns() - stale * 1e9 < t_restore_ns:
                    reads["old_marks"] += 1
                else:
                    reads["worst_proj"] = max(reads["worst_proj"], proj(arr))
                    if reads["worst_proj"] > LC_SUB_PROJ:
                        raise AssertionError(f"phase 16b: s read as fresh across the cut: {reads}")
            except StalenessError:
                reads["refused"] += 1
            if float(np.abs(sub._pub.acquire()[0] - cut_np).max()) <= tol:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 16b: s never came back to the cut: {reads}")
            time.sleep(0.01)
        reads["back_s"] = time.perf_counter() - t1
        out["subscriber"] = reads
        step("16b")
        # 16c: e owes an add when ctl drains it; c re-grafts under m, no mass lost
        e.add(deltas[5])
        t1 = time.perf_counter()
        rc = ctl.main(["--ctl-dir", ctl_dir, "--timeout", str(LC_AGREE_S), "drain", "e"])
        if rc != 0:
            raise AssertionError(f"phase 16c: ctl drain e exited {rc}")
        deadline = time.perf_counter() + LC_AGREE_S
        while not (e._stop.is_set() and c._uplink is not None and len(m.node.links) == 2):
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 16c: e closed {e._stop.is_set()}, m has {len(m.node.links)} links")
            time.sleep(0.01)
        drained, drained_mag, _ = _lc_target(seed_tree, deltas[:3] + [deltas[5]], spec, device)
        out["drain"] = {"regraft_s": time.perf_counter() - t1, "drain_total": e.metrics()["st_drain_total"]}
        out["drain"]["agree_s"], _ = _wait_agree([m, c], drained, drained_mag, spec, AGREE_REL, LC_AGREE_S, 0.01)
        _healthy([m, c])
        step("16c")
    finally:
        if sub is not None:
            sub.close()
        for p in reversed(peers):
            p.close()
    step("close")
    # 16d: every writer restarts from its shard of 16a's cut (e's holds what
    # it owed at the cut) in the same chain on a new port
    t1 = time.perf_counter()
    port, peers = _free_port(), []
    try:
        for name, tree in (("m", seed_tree), ("e", template), ("c", template)):
            restore = os.path.join(snapdir, ckpt.shard_filename(name))
            c1 = Config(transport=TransportConfig(peer_timeout_sec=30.0, max_children=1),
                        lifecycle=LifecycleConfig(node_name=name, restore_path=restore))
            kw = {"host_tier": True} if name == "e" else {"device": device}
            peers.append(create_or_fetch("127.0.0.1", port, tree, c1, timeout=60.0, **kw))
        agree_s, err = _wait_agree(peers, cut, cut_mag, spec, AGREE_REL, LC_RESTART_S, 0.01)
        out["restart"] = {"seconds": time.perf_counter() - t1, "agree_s": agree_s, "err": err,
                          "restored": [p.metrics()["st_restore_total"] for p in peers]}
        _healthy(peers)
        step("16d")
    finally:
        for p in reversed(peers):
            p.close()
    step("close_16d")
    out["steps_s"] = steps
    out["seconds"] = time.perf_counter() - t0
    print(f"[16] m ({device}), e (engine), c ({device}) and s joined in {out['join_s']:.3f} s; 16a snapshot "
          f"{out['snapshot']['duration_sec']:.3f} s, {out['snapshot']['nodes']} shards, "
          f"{out['snapshot']['shard_bytes']} bytes, manifest verified; cut agreed {out['cut_agree_s']:.3f} s later")
    print(f"[16] 16b restore {out['restore']['duration_sec']:.3f} s (call {out['restore']['call_s']:.3f} s), "
          f"back at the cut {out['restore']['agree_s']:.3f} s later; s {reads}")
    print(f"[16] 16c ctl drain e: c re-grafted under m {out['drain']['regraft_s']:.3f} s, m and c agreed "
          f"{out['drain']['agree_s']:.3f} s later; 16d restart from shards re-converged in "
          f"{out['restart']['seconds']:.3f} s; phase 16 {out['seconds']:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in steps.items())}); "
          f"on {smi}")
    return out, master


# -- phase 17 -------------------------------------------------------------------

#: Phase 17: the shards of config 2's table, the phase's budget, and each
#: wait's deadline (a drain, an alloc settle, an adoption, a restart).
SHARD_N = 4
SHARD_PHASE_S = 10.0
SHARD_WAIT_S = 8.0
#: Phase 17's go-back-N ACK timeout, the one JAX's sharded benches and lane
#: tests run with (benchmarks/shard_bench.py, cluster_chaos.py --sharded):
#: a FWD or an ACK that bounces off a full send queue waits for this timer
#: in both packages, and at the 5 s default one such wait (then 10 s) ran a
#: node past SHARD_WAIT_S.
SHARD_ACK_S = 0.4
SHARD_FWD_KEYS = ("st_shard_fwd_msgs_out_total", "st_shard_fwd_msgs_in_total", "st_shard_fwd_relayed_total",
                  "st_shard_fwd_dedup_total", "st_shard_park_drops_total", "st_shard_fwd_retx_total")


def _flat_rel_err(flat, target, spec) -> float:
    """Worst per-leaf max |flat - target| / the leaf's max |target| of two
    flat host arrays of the padded layout."""
    from shared_tensor_tpu_torch.ops.codec_np import _layout

    offs, ns, _ = _layout(spec)
    worst = 0.0
    for o, n in zip(offs, ns):
        t = np.asarray(target[o:o + n], np.float64)
        mag = float(np.abs(t).max())
        err = float(np.abs(np.asarray(flat[o:o + n], np.float64) - t).max())
        worst = max(worst, err / mag if mag > 0 else err)
    return worst


class ShardRun:
    """Phase 17's sharded cluster on the table of the char-RNN ``cfg_m``
    (None: config 2's), data from ``seed``: n0 (the master) and n1 on the
    engine lane, n2 on the Python plane, n3 on the lane below n1."""

    def __init__(self, seed: int, cfg_m=None):
        from shared_tensor_tpu_torch.benchmarks import serve as serve_bench
        from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig
        from shared_tensor_tpu_torch.ops import codec_np
        from shared_tensor_tpu_torch.ops.table import make_spec

        self.template, self.seed_tree, self.deltas = serve_bench.tables(cfg_m or CharRNNConfig(), seed + 17, n=6)
        self.spec = make_spec(self.template)
        self.full = self.spec.total * 4
        self.total = np.sum([codec_np.flatten_np(d, self.spec).astype(np.float64) for d in self.deltas[:SHARD_N]],
                            axis=0)
        self.hs: list = []
        self.out: dict = {}

    def cfg(self, i: int, lane: bool = True, restore: str = ""):
        from shared_tensor_tpu_torch import Config, TransportConfig
        from shared_tensor_tpu_torch.config import LifecycleConfig, ShardConfig

        return Config(shard=ShardConfig(n_shards=SHARD_N, shard_index=i, engine_lane=lane, restore_dir=restore),
                      lifecycle=LifecycleConfig(node_name=f"n{i}"),
                      transport=TransportConfig(peer_timeout_sec=30.0, ack_timeout_sec=SHARD_ACK_S))

    def cluster(self, port: int, restore: str = "", lanes=(True, True, False, True), names=(0, 1, 2, 3)) -> list:
        """The nodes, joined in order. n3 joins at n1's address, so it sits
        below n1 and its FWD frames cross a relay: a ShardNode's fan-out is
        ShardConfig.max_children, and capping n0's would turn the gather's
        leg to shard 0 away too."""
        from shared_tensor_tpu_torch.shard import create_or_fetch_sharded

        hs = []
        try:
            for i, lane in zip(names, lanes):
                at = hs[1].node.node.listen_port if i == 3 else port
                hs.append(create_or_fetch_sharded("127.0.0.1", at, self.template, self.cfg(i, lane, restore),
                                                  timeout=60.0))
        except BaseException:
            for h in reversed(hs):
                h.close()
            raise
        self.hs = hs
        return hs

    def gather(self, node) -> tuple[float, np.ndarray, float]:
        """(worst per-leaf error against the total, the flat gather, seconds)."""
        from shared_tensor_tpu_torch.shard import ShardGather

        t1 = time.perf_counter()
        with ShardGather(node, self.template) as g:
            flat, _worst = g.read(max_staleness=60.0)
        return _flat_rel_err(flat, self.total, self.spec), flat, time.perf_counter() - t1

    @staticmethod
    def wait(pred, what: str) -> float:
        t1 = time.perf_counter()
        while not pred():
            if time.perf_counter() - t1 > SHARD_WAIT_S:
                raise AssertionError(f"phase 17: {what} not within {SHARD_WAIT_S} s")
            time.sleep(0.005)
        return time.perf_counter() - t1

    def close(self) -> None:
        for h in reversed(self.hs):
            h.close()
        self.hs = []

    def phase_a(self) -> np.ndarray:
        """17a: the join, one whole-table add on each node (three quarters of
        each leave as FWD), the drain, each node's alloc against the table,
        and a gather at the total. Returns the gather."""
        out, t0 = self.out, time.perf_counter()
        n0, n1, n2, n3 = hs = self.cluster(_free_port())
        lanes = [h.node._lane is not None for h in hs]
        if not all(h.sharded for h in hs) or lanes != [True, True, False, True] or n3.node.is_master \
                or len(n0.node.node.links) != 2 or len(n1.node.node.links) != 2:
            raise AssertionError(f"phase 17: want n0, n1 (lane), n2 (Python plane) below n0 and n3 (lane) below "
                                 f"n1; lanes {lanes}, n0 links {len(n0.node.node.links)}, n1 links "
                                 f"{len(n1.node.node.links)}")
        out["join_s"] = time.perf_counter() - t0
        peak, stop = [0] * len(hs), threading.Event()

        def sample():  # each node's peak, with up to three outboxes alive
            while not stop.is_set():
                for i, h in enumerate(hs):
                    peak[i] = max(peak[i], h.node.alloc_bytes())
                time.sleep(0.002)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        try:
            for h, d in zip(hs, self.deltas):
                h.add(d)
            t_add = time.perf_counter()
            for h in hs:
                if not h.drain(timeout=SHARD_WAIT_S):
                    state = [{"drained": x.node.drained(), "outbox_bytes": x.node.metrics().get("st_shard_outbox_bytes"),
                              "parked": x.node.metrics().get("st_shard_parked_msgs"),
                              **{k: x.node.metrics().get(k) for k in SHARD_FWD_KEYS}} for x in hs]
                    raise AssertionError(f"phase 17a: {h.node.node_name} did not drain within {SHARD_WAIT_S} s: "
                                         f"{state}")
            out["drain_s"] = time.perf_counter() - t_add
        finally:
            stop.set()
            sampler.join()
        # idle outboxes are freed on the plane's next pass
        full = self.full
        out["settle_s"] = self.wait(lambda: all(h.node.alloc_bytes() < full // 2 for h in hs), "idle outboxes freed")
        alloc = [h.node.alloc_bytes() for h in hs]
        snaps = [h.node.metrics() for h in hs]
        out["fwd"] = {k: [int(m_.get(k, 0)) for m_ in snaps] for k in SHARD_FWD_KEYS}
        out["alloc"] = {"full_bytes": full, "after_drain": alloc, "after_drain_frac": [b / full for b in alloc],
                        "peak": peak, "peak_frac": [b / full for b in peak]}
        if sum(out["fwd"]["st_shard_park_drops_total"]) or not sum(out["fwd"]["st_shard_fwd_relayed_total"]):
            raise AssertionError(f"phase 17a: park drops or no relay: {out['fwd']}")
        err, flat, gather_s = self.gather(n0.node)
        out["gather"] = {"err": err, "seconds": gather_s}
        if not err <= AGREE_REL:
            raise AssertionError(f"phase 17a: the gather is {err:.3e} off the total")
        fw = out["fwd"]
        print(f"[17] n0, n1, n3 (lane) and n2 (Python plane), n3 below n1, joined in {out['join_s']:.3f} s; 17a "
              f"drained {out['drain_s']:.3f} s after the last add; FWD out {sum(fw['st_shard_fwd_msgs_out_total'])}, "
              f"in {sum(fw['st_shard_fwd_msgs_in_total'])}, relayed {sum(fw['st_shard_fwd_relayed_total'])}, dedup "
              f"{sum(fw['st_shard_fwd_dedup_total'])}, park drops {sum(fw['st_shard_park_drops_total'])}, "
              f"retransmitted {sum(fw['st_shard_fwd_retx_total'])}; alloc "
              f"after the drain {[round(x, 4) for x in out['alloc']['after_drain_frac']]} of the table, peak "
              f"{[round(x, 4) for x in out['alloc']['peak_frac']]}; gather err {err:.3e} ({gather_s:.3f} s)")
        return flat

    def phase_d(self) -> None:
        """17d: n2 (the Python plane) leaves; its parent n0 adopts shard 2 at
        a higher epoch with n2's dedup windows; a new gather at the total."""
        n0, n1, n2, n3 = self.hs
        t1 = time.perf_counter()
        epoch = n0.node.map.owners[2].epoch
        ok = n2.leave(timeout=SHARD_WAIT_S)
        self.hs = [n0, n1, n3]
        if not ok:
            raise AssertionError("phase 17d: n2's leave did not complete")
        self.wait(lambda: n0.node.owned_shards() == [0, 2], "n0's adoption of shard 2")
        err, _, _ = self.gather(n0.node)
        d = self.out["handoff"] = {"seconds": time.perf_counter() - t1, "epoch": [epoch, n0.node.map.owners[2].epoch],
                                   "err": err, "handoffs": int(n0.node.metrics().get("st_shard_handoffs_total", 0))}
        if not err <= AGREE_REL or d["epoch"][1] <= epoch:
            raise AssertionError(f"phase 17d: {d}")

    def phase_e(self, snapdir: str) -> None:
        """17e: every node writes its shard state into ``snapdir``, the
        exactly-one-owner audit is clean, the nodes close and restart from
        the files on a new port, and a gather reads the cut's total."""
        from shared_tensor_tpu_torch.utils import checkpoint as ckpt

        shutil.rmtree(snapdir, ignore_errors=True)
        t1 = time.perf_counter()
        entries = [h.node.save_shards(snapdir) for h in self.hs]
        ckpt.write_manifest(snapdir, "phase17", entries)
        problems = ckpt.verify_shard_coverage(snapdir, SHARD_N)
        self.out["snapshot"] = {"seconds": time.perf_counter() - t1, "problems": problems,
                                "bytes": sum(e["bytes"] for e in entries)}
        if problems:
            raise AssertionError(f"phase 17e: coverage audit {problems}")
        self.close()
        t1 = time.perf_counter()
        hs = self.cluster(_free_port(), snapdir, lanes=(True, True, True), names=(0, 1, 3))
        owned = [h.node.owned_shards() for h in hs]
        err, _, _ = self.gather(hs[0].node)
        d = self.out["restart"] = {"seconds": time.perf_counter() - t1, "owned": owned, "err": err}
        if owned != [[0, 2], [1], [3]] or not err <= AGREE_REL:
            raise AssertionError(f"phase 17e: {d}")


def shard_phase(device, seed: int, smi: str, cfg_m=None) -> tuple[dict, tuple]:
    """Phase 17 (module docstring) on the table of the char-RNN ``cfg_m``
    (None: config 2's). Returns the report and 17c's CUDA master's state
    for tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.ops.table import flatten
    from shared_tensor_tpu_torch.shard import create_or_fetch_sharded

    run = ShardRun(seed, cfg_m)
    out, spec = run.out, run.spec
    t0 = time.perf_counter()
    try:
        flat = run.phase_a()
        # 17b: the view on the card is that gather, copied; then the copy alone
        t1 = time.perf_counter()
        view = run.hs[0].torch_view(device=device)
        _sync(device)
        view_s = time.perf_counter() - t1
        same = _bitdiff(view, torch.from_numpy(flat).to(device))
        t1 = time.perf_counter()
        torch.from_numpy(flat).to(device)
        _sync(device)
        out["view"] = {"device": str(view.device), "mismatches": same, "torch_view_ms": view_s * 1e3,
                       "copy_ms": (time.perf_counter() - t1) * 1e3, "bytes": flat.nbytes}
        if same or view.device.type != device.type:
            raise AssertionError(f"phase 17b: torch_view is not the gather on {device}: {out['view']}")
        # 17c: the fallback on the device tier: a classic master on the card
        # and a sharded joiner, which comes back as a classic peer on the card
        t1 = time.perf_counter()
        port = _free_port()
        c2 = Config(transport=TransportConfig(peer_timeout_sec=30.0))
        with create_or_fetch("127.0.0.1", port, run.seed_tree, c2, timeout=60.0, device=device) as m:
            with create_or_fetch_sharded("127.0.0.1", port, run.template, run.cfg(1), timeout=60.0,
                                         device=device) as j:
                if j.sharded or j.peer.st.device.type != device.type or j.peer._engine is not None:
                    raise AssertionError(f"phase 17c: the joiner did not fall back to a {device} classic peer")
                m.add(run.deltas[4])
                j.add(run.deltas[5])
                target, mag, _ = _lc_target(run.seed_tree, run.deltas[4:6], spec, device)
                agree_s, cerr = _wait_agree([m, j.peer], target, mag, spec, AGREE_REL, SHARD_WAIT_S, 0.01)
                _healthy([m, j.peer])
                master = m.st.snapshot_all() + (flatten(run.deltas[4], spec, device), m.st.codec)
        out["fallback"] = {"agree_s": agree_s, "err": cerr, "seconds": time.perf_counter() - t1}
        run.phase_d()
        run.phase_e(os.path.join(OUT_DIR, "phase17"))
    finally:
        run.close()
    out["seconds"] = time.perf_counter() - t0
    print(f"[17] 17b torch_view {out['view']['torch_view_ms']:.3f} ms, the copy {out['view']['copy_ms']:.3f} ms "
          f"({flat.nbytes} bytes); 17c fallback on {device}: agreed {agree_s:.3f} s after the adds "
          f"({out['fallback']['seconds']:.3f} s with the joins)")
    print(f"[17] 17d handoff {out['handoff']['seconds']:.3f} s, epoch {out['handoff']['epoch']}, gather err "
          f"{out['handoff']['err']:.3e}; 17e {out['snapshot']['bytes']} bytes of shard state in "
          f"{out['snapshot']['seconds']:.3f} s, audit clean, restart and gather {out['restart']['seconds']:.3f} s "
          f"(owned {out['restart']['owned']}); phase 17 {out['seconds']:.3f} s; on {smi}")
    if out["seconds"] > SHARD_PHASE_S:
        raise AssertionError(f"phase 17 took {out['seconds']:.3f} s, over its {SHARD_PHASE_S} s budget")
    return out, master


# -- phase 18 -------------------------------------------------------------------

LAB_TIMED = 20  # 18a: calls per CUDA-event timing of a twin
LAB_UNIFORM_STEPS = 60  # 18b uniform: at most this many steps of each arm to exact zero
LAB_FRAMES = 20  # 18b gaussian: steps of each arm over which the RMS decay is taken
LAB_DECAY_MARGIN = 0.02  # 18b gaussian: sign2's decay per frame under the production step's by this (test_ici_lab.py)


def _topk_sets_agree(idx_a: np.ndarray, idx_b: np.ndarray, absr: np.ndarray) -> bool:
    """Two top-k index sets of ``absr`` agree: equal, or differing only in
    coordinates tied at the k-th largest value (either choice is a top k)."""
    a, b = np.unique(idx_a), np.unique(idx_b)
    if a.size != idx_a.size or b.size != idx_b.size or a.size != b.size:
        return False
    thr = absr[a].min()
    diff = np.setxor1d(a, b)
    return bool(thr == absr[b].min() and np.all(absr[diff] == thr))


def lab_twins(device, rate: float, seed: int) -> dict:
    """18a: the codec lab's device twins (ops/codec_lab_torch) on the card at
    config 2's table width (its live elements as one flat buffer, padded to
    the tile), a gaussian residual and gaussian values from ``seed``,
    against the numpy lab (ops/codec_lab): Sign2's codes byte-equal, its
    residual and apply bit-equal, the scale equal (or one octave off at an
    exact boundary, then the frame is not compared); TopK (k = n / 32) its
    index set equal (up to ties at the k-th value), its residual bit-equal,
    and its apply conserving exactly. Each twin's ms per call (CUDA events)
    beside the bytes it must move over the card's memory rate."""
    from shared_tensor_tpu_torch.ops import codec_lab_torch as lt
    from shared_tensor_tpu_torch.ops.codec_lab import Sign2, TopK
    from shared_tensor_tpu_torch.ops.packing import padded_len, words_to_host, words_to_wire
    from shared_tensor_tpu_torch.ops.table import make_spec
    from shared_tensor_tpu_torch.utils.timing import event_ms

    n = make_spec(char_rnn_template()).total_n
    n_pad, k = padded_len(n), n // 32
    rng = np.random.default_rng(seed + 18)
    r, v = np.zeros(n_pad, np.float32), np.zeros(n_pad, np.float32)
    r[:n] = rng.standard_normal(n)
    v[:n] = rng.standard_normal(n)
    r_d, v_d = torch.from_numpy(r).to(device), torch.from_numpy(v).to(device)
    u32 = lambda a: np.ascontiguousarray(a).view(np.uint32)
    mism = {}

    frame, new_np = Sign2().encode(r[:n].copy())
    scale, words, new_d = lt.sign2_quantize(r_d, n)
    s = float(scale)
    octave = s != frame.scale
    if octave:
        mism["sign2_scale"] = int(max(s, frame.scale) != 2 * min(s, frame.scale))
    else:
        got = np.frombuffer(words_to_wire(words_to_host(words), 2 * n), np.uint8)
        mism["sign2_codes"] = int((got != frame.data).sum()) + abs(got.size - frame.data.size)
        new_h = new_d.cpu().numpy()
        mism["sign2_residual"] = int((u32(new_h[:n]) != u32(new_np)).sum() + np.count_nonzero(new_h[n:]))
        applied = lt.sign2_apply(v_d, scale, words, n).cpu().numpy()
        want = v[:n] + Sign2().decode(frame, n)
        mism["sign2_apply"] = int((u32(applied[:n]) != u32(want)).sum() + np.count_nonzero(applied[n:]))

    tf, _ = TopK(k).encode(r[:n].copy())
    idx, vals, rk = lt.topk_quantize(r_d, k)
    idx_h = idx.cpu().numpy()
    mism["topk_index_set"] = int(not _topk_sets_agree(idx_h, tf.data[:, 0].view(np.uint32).astype(np.int64), np.abs(r)))
    want = r.copy()
    want[idx_h] = 0.0  # the lab's rule at the card's indices: the lab's residual where the sets are equal
    mism["topk_residual"] = int((u32(rk.cpu().numpy()) != u32(want)).sum())
    back = lt.topk_apply(rk, idx, vals, n).cpu().numpy()
    mism["topk_conservation"] = int((u32(back) != u32(r)).sum())

    bytes_ = {
        "sign2_quantize": 8 * n_pad + n_pad // 4, "sign2_apply": 8 * n_pad + n_pad // 4,
        "topk_quantize": 8 * n_pad + 12 * k, "topk_apply": 8 * n_pad + 12 * k,
    }
    calls = {
        "sign2_quantize": lambda: lt.sign2_quantize(r_d, n),
        "sign2_apply": lambda: lt.sign2_apply(v_d, scale, words, n),
        "topk_quantize": lambda: lt.topk_quantize(r_d, k),
        "topk_apply": lambda: lt.topk_apply(rk, idx, vals, n),
    }
    times = {name: {"ms": event_ms(fn, LAB_TIMED), "bytes": bytes_[name], "bound_ms": bytes_[name] / rate * 1e3}
             for name, fn in calls.items()}
    return {"n": n, "n_pad": n_pad, "k": k, "scale": s, "lab_scale": frame.scale, "octave_boundary": octave,
            "mismatches": mism, "times": times}


def pod_sign2(mesh, seed: int) -> dict:
    """18b, on each of the 4 ranks of ``mesh`` (4 peers x 1 shard, config 2's
    table): the production step and the codec lab's 2-bit step
    (parallel/ici_lab) from the same states, in turns. Uniform updates (one
    per peer, from ``seed``): each step leaves the two arms' scales, values
    and residuals bit-equal, both drain to exact zero within
    LAB_UNIFORM_STEPS, and every peer ends on the sum of the updates.
    Gaussian updates: the RMS of every peer's residual over LAB_FRAMES
    steps, as a decay per frame for each arm. Each step's host ms (a
    synchronize after it), and each arm's bytes received per peer and
    step."""
    import torch.distributed as dist

    from shared_tensor_tpu_torch.ops import codec_np
    from shared_tensor_tpu_torch.ops.table import make_spec
    from shared_tensor_tpu_torch.parallel import add_updates, build_sync_step, frame_ici_bytes, init_state
    from shared_tensor_tpu_torch.parallel.ici_lab import build_sign2_sync_step
    from shared_tensor_tpu_torch.parallel.mesh import all_reduce_, all_true

    dev = mesh.device
    spec = make_spec(char_rnn_template())
    live = codec_np._live_mask(spec)

    def updates(kind: str) -> list[np.ndarray]:
        ups = []
        for p in range(mesh.n_peer):
            rng = np.random.default_rng(seed + 1800 + p)
            u = rng.uniform(-1.0, 1.0, spec.total) if kind == "uniform" else rng.standard_normal(spec.total)
            ups.append(u.astype(np.float32) * live)
        return ups

    def arms(ups):
        out = []
        for _ in range(2):
            st = init_state(mesh, spec)
            add_updates(st, torch.from_numpy(ups[mesh.peer]).to(dev))
            out.append(st)
        return out

    step1, step2 = build_sync_step(mesh, spec), build_sign2_sync_step(mesh, spec)
    ms = {"production": [], "sign2": []}

    def timed(name, step, st):
        _sync(dev)
        t = time.perf_counter()
        st, sc = step(st)
        _sync(dev)
        ms[name].append((time.perf_counter() - t) * 1e3)
        return st, sc

    same = lambda a, b: torch.equal(a.view(torch.int32), b.view(torch.int32))
    ups = updates("uniform")
    s1, s2 = arms(ups)
    equal, steps = True, 0
    for steps in range(1, LAB_UNIFORM_STEPS + 1):
        s1, sc1 = timed("production", step1, s1)
        s2, sc2 = timed("sign2", step2, s2)
        equal = all_true(mesh, same(sc1, sc2) and same(s1.values, s2.values) and same(s1.residual, s2.residual)) \
            and equal
        if all_true(mesh, not bool(s1.residual.any()) and not bool(s2.residual.any())):
            break
    drained = all_true(mesh, not bool(s1.residual.any()) and not bool(s2.residual.any()))
    target = np.sum(np.stack(ups), axis=0)
    got = s2.values.cpu().numpy()
    sum_err = float(np.abs(got - target).max())
    on_sum = all_true(mesh, bool(np.allclose(got, target, rtol=1e-4, atol=1e-5)))
    del s1, s2

    def rms(st) -> float:
        t = torch.sum(st.residual.to(torch.float64) ** 2).reshape(1)
        all_reduce_(mesh, t, dist.ReduceOp.SUM, mesh.peer_group)
        return math.sqrt(float(t.item()) / (mesh.n_peer * spec.total))

    g1, g2 = arms(updates("gaussian"))
    rms0 = rms(g1)
    for _ in range(LAB_FRAMES):
        g1, _ = timed("production", step1, g1)
        g2, _ = timed("sign2", step2, g2)
    decay = {"production": (rms(g1) / rms0) ** (1.0 / LAB_FRAMES), "sign2": (rms(g2) / rms0) ** (1.0 / LAB_FRAMES)}
    del g1, g2
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    per_frame2 = spec.total // 32 * 4 * 2 + spec.num_leaves * 4
    return {
        "peer": mesh.peer, "device": str(dev), "uniform_steps": steps, "uniform_bit_equal": equal,
        "uniform_drained": drained, "uniform_on_sum": on_sum, "uniform_sum_max_err": sum_err,
        "gaussian_decay_per_frame": decay, "ms_per_step_median": {k: float(np.median(v)) for k, v in ms.items()},
        "ms_per_step_min": {k: float(np.min(v)) for k, v in ms.items()},
        "frame_bytes_received": {"production": frame_ici_bytes(spec, mesh.n_peer),
                                 "sign2": (mesh.n_peer - 1) * per_frame2},
    }


def lab_phase(device, rate: float, seed: int, sign2_ranks: list, secs_18b: float, smi: str) -> dict:
    """Phase 18 (module docstring): 18a here, 18b's results from the
    phases 9-11 spawn; raises on any failed check."""
    t0 = time.perf_counter()
    twins = lab_twins(device, rate, seed)
    secs_18a = time.perf_counter() - t0
    print(f"[18a] codec lab twins on {device} at n={twins['n']} (padded {twins['n_pad']}), k={twins['k']}: "
          f"scale {twins['scale']!r} (numpy lab {twins['lab_scale']!r}), mismatches {twins['mismatches']}; "
          + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} ms, {v['bytes']} bytes)"
                      for k, v in twins["times"].items())
          + f"; {secs_18a:.3f} s; on {smi}")
    bad = [f"18a {k}: {v}" for k, v in twins["mismatches"].items() if v]
    r0 = sign2_ranks[0]
    d = r0["gaussian_decay_per_frame"]
    print(f"[18b] sign2 pod step, {len(sign2_ranks)} peers on one card, config 2's table: uniform "
          f"{'bit-equal to the production step' if all(r['uniform_bit_equal'] for r in sign2_ranks) else 'DIVERGED'}"
          f" frame by frame over {r0['uniform_steps']} steps, drained "
          f"{all(r['uniform_drained'] for r in sign2_ranks)}, on the sum "
          f"{all(r['uniform_on_sum'] for r in sign2_ranks)} (max err {max(r['uniform_sum_max_err'] for r in sign2_ranks):.3e}); "
          f"gaussian RMS decay per frame over {LAB_FRAMES} frames: sign2 {d['sign2']:.4f}, production "
          f"{d['production']:.4f}; ms per step (median) sign2 {r0['ms_per_step_median']['sign2']:.3f}, production "
          f"{r0['ms_per_step_median']['production']:.3f}; bytes received per peer and step sign2 "
          f"{r0['frame_bytes_received']['sign2']}, production {r0['frame_bytes_received']['production']}; "
          f"{secs_18b:.3f} s")
    for rk, r in enumerate(sign2_ranks):
        for key in ("uniform_bit_equal", "uniform_drained", "uniform_on_sum"):
            if not r[key]:
                bad.append(f"18b rank {rk} {key}")
        dr = r["gaussian_decay_per_frame"]
        if not dr["sign2"] < dr["production"] - LAB_DECAY_MARGIN:
            bad.append(f"18b rank {rk} gaussian decay {dr}")
    if bad:
        raise AssertionError("phase 18: " + "; ".join(bad))
    return {"twins": twins, "twins_s": secs_18a, "pod_sign2": sign2_ranks, "pod_sign2_s": secs_18b}


# -- phase 20 -------------------------------------------------------------------

E2E_N = 1 << 20  # the reference's comparison size (BASELINE.md: 242 frames/s)
E2E_WARMUP_S = 0.5
E2E_S = 2.0


def e2e_phase(device, smi: str, child) -> dict:
    """20a: benchmarks/e2e_sync at E2E_N, its parent on the card's device
    tier and ``child``, a host-tier child process started ahead (an
    e2e_sync.Child: its imports overlap the phases before), E2E_S s after
    E2E_WARMUP_S s: frames/s and
    equivalent GB/s each way against the reference's row; the launches of
    A and B in the exchange (both > 0), then both against their plain
    versions on the parent's state (benchmarks.kernel_check), 0
    mismatches."""
    from shared_tensor_tpu_torch.benchmarks import e2e_sync
    from shared_tensor_tpu_torch.ops import codec_cuda as CC

    t0 = time.perf_counter()
    CC.reset_launches()
    out = e2e_sync.run(n=E2E_N, seconds=E2E_S, warmup=E2E_WARMUP_S, device=device, child=child)
    out["phase_s"] = time.perf_counter() - t0
    a, b = out["kernel_check"]["quantize_rows"], out["kernel_check"]["apply_rows_batch"]
    print(f"[20a] e2e_sync at n={E2E_N}, CUDA parent and a host-tier child process, {out['seconds']} s: out "
          f"{out['frames_out_per_s']} frames/s = {out['equiv_out_GBps']} GB/s equiv ({out['vs_baseline_out']}x the "
          f"reference's row), in {out['frames_in_per_s']} frames/s = {out['equiv_in_GBps']} GB/s equiv "
          f"({out['vs_baseline_in']}x); wire out {out['wire_out_GBps']} in {out['wire_in_GBps']} GB/s; the parent's "
          f"frames by the exponent of their scale {out['frame_scales']['max_scale_log2']}; launches "
          f"{out['launches']}; A a burst of K={a['k']}: mismatches {a['mismatches']}, B K={b['k']} N=2: mismatches "
          f"{b['mismatches']}; phase {out['phase_s']:.3f} s on {smi}")
    if not all(out["launches"].values()):
        raise AssertionError(f"phase 20a: a kernel of the exchange never launched: {out['launches']}")
    if a["mismatches"] or b["mismatches"]:
        raise AssertionError(f"phase 20a: kernel vs plain mismatches on the parent's state: {out['kernel_check']}")
    if not (out["frames_out_per_s"] > 0 and out["frames_in_per_s"] > 0):
        raise AssertionError(f"phase 20a: frames did not flow both ways: {out}")
    return out


# -- phase 21 -------------------------------------------------------------------

SEVER_BUDGET_S = 6.0  # phase 21's time budget (reported, not enforced)
SEVER_AGREE_S = 30.0  # phase 21's deadlines: the join, the re-join and the agreement
SEVER_BURST = 4  # phase 21: the joiner's frames per device burst (the default is 16)


def sever_phase(device, seed: int, smi: str, cfg_m=None) -> tuple[dict, tuple]:
    """Phase 21 (module docstring) on the table of the char-RNN ``cfg_m``
    (None: config 2's). Returns the report and the joiner's state for
    tree_kernel_check."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.benchmarks import serve as serve_bench
    from shared_tensor_tpu_torch.config import FaultConfig
    from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec

    template, seed_tree, (delta,) = serve_bench.tables(cfg_m or CharRNNConfig(), seed + 21, n=1)
    spec = make_spec(template)
    fault = FaultConfig(enabled=True, seed=11, stall_after_frames=1, sever_after_frames=4, only_link=1)
    port, peers, out = _free_port(), [], {}
    t0 = time.perf_counter()
    try:
        m = create_or_fetch("127.0.0.1", port, seed_tree, Config(transport=TransportConfig(peer_timeout_sec=30.0)),
                            timeout=SEVER_AGREE_S, device=device)
        peers.append(m)
        # bursts of SEVER_BURST frames: the update spans more than four
        # messages, so the plan's four data sends (and the sever) come at
        # once, not after two rounds of retransmission
        cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0, ack_timeout_sec=1.0), faults=fault,
                     device_frame_burst=SEVER_BURST)
        j = create_or_fetch("127.0.0.1", port, template, cfg, timeout=SEVER_AGREE_S, device=device)
        peers.append(j)
        seed_flat, seed_mag, _ = _lc_target(seed_tree, [], spec, device)
        out["join_s"], _ = _wait_agree([j], seed_flat, seed_mag, spec, AGREE_REL, SEVER_AGREE_S, 0.01)
        first = j._uplink
        t1 = time.perf_counter()
        j.add(delta)
        deadline = t1 + SEVER_AGREE_S
        while j._uplink in (None, first) or j._kept is not None or not j.ready:
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 21: the joiner did not re-join (plan {dict(j._faults.counts)})")
            time.sleep(0.005)
        out["rejoin_s"] = time.perf_counter() - t1
        target, mag, _ = _lc_target(seed_tree, [delta], spec, device)
        out["agree_s"], out["err"] = _wait_agree(peers, target, mag, spec, AGREE_REL, SEVER_AGREE_S, 0.01)
        out["add_to_agree_s"] = time.perf_counter() - t1
        out["plan"] = dict(j._faults.counts)
        got = j.metrics()
        out["rolled_frames"] = got["st_carry_frames_rolled_total"]
        out["retracted_frames"] = got["st_carry_frames_retracted_total"]
        out["retransmits"] = got["st_retransmit_msgs_total"]
        state = j.st.snapshot_all() + (flatten(delta, spec, device), j.st.codec)
    finally:
        for p in reversed(peers):
            p.close()
    out["seconds"] = time.perf_counter() - t0
    out["budget_s"] = SEVER_BUDGET_S
    print(f"[21] sever and re-join on the char-RNN table ({spec.num_leaves} leaves, {spec.total_n} elements), "
          f"device {device}: join {out['join_s']:.3f} s; from the add, re-joined {out['rejoin_s']:.3f} s, agreed "
          f"{out['add_to_agree_s']:.3f} s (worst leaf error {out['err']:.3e}); plan {out['plan']}; frames rolled into "
          f"the carry {out['rolled_frames']}, retracted as applied {out['retracted_frames']}; retransmits "
          f"{out['retransmits']}; phase {out['seconds']:.3f} s (budget {SEVER_BUDGET_S} s) on {smi}")
    if out["plan"].get("severed", 0) < 1 or out["plan"].get("stalled", 0) < 1:
        raise AssertionError(f"phase 21: the fault plan did not sever and stall the uplink: {out['plan']}")
    return out, state


# -- phase 22 -------------------------------------------------------------------

CASCADE_KCS = (1, 11, 16, 32, 64)  # phase 22a's depths
CASCADE_TIMED_KCS = (1, 11, 16, 32)  # phase 22a's timed depths
CASCADE_TIMED_KC = 16  # the kernels line's depth: a 16-frame burst's longest round
CASCADE_BURST_K = 16  # phase 22a's burst graph: AUTO_BURST frames at the peer's cascade of 32
CASCADE_SUM_RTOL = 1e-12  # A-cascade's partial sums against the C pass's (another order)
DRAIN_N = 1 << 20  # phase 22b: drain_tail's table
DRAIN_TIMEOUT_S = 10.0
DRAIN_MAX_FRAMES = 200


def cascade_kernel_check(spec, device, rate: float, seed: int) -> dict:
    """Phase 22a (module docstring) at one table. Returns its mismatches,
    largest residual error, times, bounds, and the burst graph's replay
    and nodes."""
    from shared_tensor_tpu_torch.benchmarks import burst_graph as BG
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops import codec_np as N
    from shared_tensor_tpu_torch.ops import table as TT
    from shared_tensor_tpu_torch.utils.timing import event_ms

    pol = ScalePolicy.POW2_RMS
    resid = BG.residual(spec, device, seed)
    host = resid.cpu().numpy()
    n_leaves, slots = spec.num_leaves, CC.partial_slots(spec.rows)
    bounds = TT._cascade_consts(spec, "cpu").leaf_slots.tolist()
    offs, ns, padded = N._layout(spec)
    out = {"shape": f"rows={spec.rows} leaves={n_leaves}", "mismatches_plain": 0, "mismatches_c": 0,
           "mismatches_schedule": 0, "scales_off_host_rule": 0, "max_abs_err": 0.0, "depths": list(CASCADE_KCS)}
    for kc in CASCADE_KCS:
        # the measuring launch, the first finish, a pass of kc levels, the next finish
        got = BG.round_trip(spec, resid, kc, CC.quantize_rows_cascade_kernel, CC.cascade_round_kernel, pol, cap=kc)
        want = BG.round_trip(spec, resid, kc, CC.quantize_rows_cascade_plain, CC.cascade_round_plain, pol, cap=kc)
        _sync(device)
        out["mismatches_plain"] += sum(_bitdiff(x, y) for g, w in zip(got, want) for x, y in zip(g, w))
        r_k, s_k, w_k, _, lad, part = got[2][:6]
        out["max_abs_err"] = max(out["max_abs_err"], _maxerr(r_k, want[2][0]))
        # the schedule is the halving of the finish's ladder top; the
        # measured scales are the host tier's (the sums' order aside)
        rows_np = [got[1][4][2].numpy()]
        for _ in range(1, kc):
            rows_np.append(rows_np[-1] * np.float32(0.5))
        out["mismatches_schedule"] += _bitdiff(s_k, torch.from_numpy(np.stack(rows_np)))
        out["scales_off_host_rule"] += _bitdiff(got[1][4][0], torch.from_numpy(N.compute_scales_np(host, spec, pol)))
        # the C pass at the schedule the kernel wrote: words, residual, partials
        sched = s_k.numpy()
        r_c = np.empty_like(host)
        w_c = np.empty((kc, spec.total // 32), np.uint32)
        amax, ss, sabs = np.zeros(n_leaves), np.zeros(n_leaves), np.zeros(n_leaves)
        N.native().stc_quantize_ef_cascade(host, r_c, offs, ns, padded, n_leaves, kc, sched, w_c.reshape(-1),
                                           spec.total // 32, amax, ss, sabs)
        out["mismatches_c"] += _bitdiff(w_k, torch.from_numpy(w_c.view(np.int32))) \
            + _bitdiff(r_k, torch.from_numpy(r_c))
        p = part.numpy()
        leaf = np.array([[p[0, a:b].max(), p[1, a:b].sum(), p[2, a:b].sum()] for a, b in zip(bounds, bounds[1:])]).T
        out["mismatches_c"] += int(np.sum(leaf[0] != amax)) + int(np.sum(
            np.abs(leaf[1:] - np.stack([ss, sabs])) > CASCADE_SUM_RTOL * np.abs(np.stack([ss, sabs]))))
        out["max_abs_err"] = max(out["max_abs_err"], _maxerr(r_k, torch.from_numpy(r_c)))
    out["mismatches"] = out["mismatches_plain"] + out["mismatches_c"] + out["mismatches_schedule"]

    times = BG.cascade_times(spec, device, CASCADE_TIMED_KCS, seed, rate)
    t = times[CASCADE_TIMED_KC]
    kc = CASCADE_TIMED_KC
    row_leaf, rowcount, *_ = TT._consts(spec, str(torch.device(device)))
    c = TT._cascade_consts(spec, str(torch.device(device)))
    b = TT.cascade_buffers(spec, kc, device)
    CC.quantize_rows_cascade_kernel(b.ladder[2], row_leaf, rowcount, b.state, resid.clone(), b.words, b.scales,
                                    b.partials, begin=True)
    CC.cascade_round_kernel(b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder, b.leaf_sums, kc, 32, pol,
                            True, True)
    state = torch.tensor([0, kc], dtype=torch.int32, device=device)
    r = resid.clone()
    plain_ms = event_ms(lambda: CC.quantize_rows_cascade_plain(b.ladder[2], row_leaf, rowcount, state, r, b.words,
                                                               b.scales, b.partials), 3, 1)
    meas = BG.measure_times(spec, device, seed, CASCADE_BURST_K, 32)
    finish_plain_ms = event_ms(lambda: CC.cascade_round_plain(b.partials, c.leaf_slots, c.ns, b.scales, b.state,
                                                              b.ladder, b.leaf_sums, kc, 32, pol, True, True), 3, 1)
    finish_bytes = finish_bytes_of(spec)
    burst = BG.burst_replay(spec, device, seed, CASCADE_BURST_K, 32)
    out.update(kc=kc, ms=t["ms"], sets=t["sets"], bytes=t["bytes"], bound_ms=t["bound_ms"], copy_ms=t["copy_ms"],
               plain_ms=plain_ms, times={str(k): v for k, v in times.items()},
               finish={"ms": meas["finish_ms"], "plain_ms": finish_plain_ms, "bytes": finish_bytes,
                       "bound_ms": finish_bytes / rate * 1e3, "library_ms": meas["torch_chain_ms"],
                       "spent_ms": meas["spent_finish_ms"]},
               burst=burst)
    return out


def finish_bytes_of(spec) -> int:
    """The finish's bytes at a table: it reads the partials, the leaf bounds
    and counts, the last scale row and the state; writes the ladder, the
    leaf sums and the state."""
    n_leaves, slots = spec.num_leaves, spec.rows // 8
    return 24 * slots + 8 * (n_leaves + 1) + 8 * n_leaves + 4 * n_leaves + 12 + 36 * n_leaves + 12


def finish_check(spec, device, rate: float, seed: int) -> dict:
    """Phase 22a's finish alone at a table (ResNet-18's): kernel against
    twin over one round trip at depth CASCADE_TIMED_KC, the finish's time
    beside its spent launch, its bound, its twin and the torch chain, and
    the 16-frame burst graph's replay and nodes."""
    from shared_tensor_tpu_torch.benchmarks import burst_graph as BG
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops import table as TT
    from shared_tensor_tpu_torch.utils.timing import event_ms

    pol, kc = ScalePolicy.POW2_RMS, CASCADE_TIMED_KC
    resid = BG.residual(spec, device, seed)
    got = BG.round_trip(spec, resid, kc, CC.quantize_rows_cascade_kernel, CC.cascade_round_kernel, pol, cap=kc)
    want = BG.round_trip(spec, resid, kc, CC.quantize_rows_cascade_plain, CC.cascade_round_plain, pol, cap=kc)
    _sync(device)
    out = {"shape": f"rows={spec.rows} leaves={spec.num_leaves}",
           "mismatches": sum(_bitdiff(x, y) for g, w in zip(got, want) for x, y in zip(g, w)),
           "max_abs_err": _maxerr(got[2][0], want[2][0])}
    meas = BG.measure_times(spec, device, seed, CASCADE_BURST_K, 32)
    c = TT._cascade_consts(spec, str(torch.device(device)))
    b = TT.cascade_buffers(spec, kc, device)
    row_leaf, rowcount, *_ = TT._consts(spec, str(torch.device(device)))
    CC.quantize_rows_cascade_kernel(b.ladder[2], row_leaf, rowcount, b.state, resid.clone(), b.words, b.scales,
                                    b.partials, begin=True)
    plain_ms = event_ms(lambda: CC.cascade_round_plain(b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder,
                                                       b.leaf_sums, kc, 32, pol, True, True), 3, 1)
    nbytes = finish_bytes_of(spec)
    out.update(finish={"ms": meas["finish_ms"], "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": nbytes / rate * 1e3,
                       "library_ms": meas["torch_chain_ms"], "spent_ms": meas["spent_finish_ms"]},
               burst=BG.burst_replay(spec, device, seed, CASCADE_BURST_K, 32))
    return out


def cascade_phase(device, rate: float, seed: int, smi: str) -> dict:
    """Phase 22 (module docstring): 22a at config 2's table and at 1 Mi,
    then 22b. Returns the report; any failed check raises."""
    from shared_tensor_tpu_torch.benchmarks import drain_tail
    from shared_tensor_tpu_torch.ops import codec_cuda as CC
    from shared_tensor_tpu_torch.ops.table import make_spec

    t0 = time.perf_counter()
    # the timings' captures are thread-local; a thread left running by an
    # earlier phase would still share the card, so it is named here
    out = {"22a": {}, "threads": sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())}
    print(f"[22] threads besides the main one: {out['threads']}")
    for name, tmpl in (("config2", char_rnn_template()), ("1Mi", {"t": np.zeros(1 << 20, np.float32)})):
        r = out["22a"][name] = cascade_kernel_check(make_spec(tmpl), device, rate, seed + 22)
        f, g = r["finish"], r["burst"]
        print(f"[22a] A-cascade and the finish at {name} ({r['shape']}), depths {r['depths']}: mismatches against "
              f"the plain twins {r['mismatches_plain']}, against libstcodec's stc_quantize_ef_cascade "
              f"{r['mismatches_c']}, schedule {r['mismatches_schedule']}; measured scales off the host rule "
              f"{r['scales_off_host_rule']}; on {smi}")
        print(f"[22a] A-cascade at {name}: " + ", ".join(
            f"kc={k} {v['ms']:.6f} ms ({100 * v['bound_ms'] / v['ms']:.1f}% of {v['bound_ms']:.6f}, copy_ms "
            f"{v['copy_ms']:.6f})" for k, v in r["times"].items()) + f"; plain at kc={r['kc']} {r['plain_ms']:.4f} ms")
        print(f"[22a] finish at {name}: {f['ms']:.6f} ms (bound {f['bound_ms']:.6f}, spent launch "
              f"{f['spent_ms']:.6f}, plain {f['plain_ms']:.4f}, the torch chain it replaces {f['library_ms']:.6f}); "
              f"the {CASCADE_BURST_K}-frame burst graph {g['replay_ms']:.6f} ms a replay ({g['replay_ms_min']:.6f}-"
              f"{g['replay_ms_max']:.6f}), {g['frames']} frames, nodes {g['nodes']}")
    r = out["22a"]["resnet18"] = finish_check(make_spec(resnet18_template()), device, rate, seed + 22)
    f, g = r["finish"], r["burst"]
    print(f"[22a] finish at resnet18 ({r['shape']}): mismatches against the plain twins {r['mismatches']}; "
          f"{f['ms']:.6f} ms (bound {f['bound_ms']:.6f}, spent launch {f['spent_ms']:.6f}, plain "
          f"{f['plain_ms']:.4f}, the torch chain it replaces {f['library_ms']:.6f}); the {CASCADE_BURST_K}-frame burst "
          f"graph {g['replay_ms']:.6f} ms a replay ({g['replay_ms_min']:.6f}-{g['replay_ms_max']:.6f}), "
          f"{g['frames']} frames, nodes {g['nodes']}; on {smi}")
    bad = {k: v["mismatches"] for k, v in out["22a"].items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 22a: A-cascade or finish mismatches: {bad}")
    over = {k: v["burst"]["nodes"] for k, v in out["22a"].items()
            if v["burst"]["nodes"].get("kernel", 0) > 2 * CASCADE_BURST_K + 2}
    if over:
        raise AssertionError(f"phase 22a: a burst graph holds more than 2K + 2 kernels: {over}")
    t1 = time.perf_counter()
    CC.reset_launches()
    row = out["22b"] = drain_tail.run_tier("device", n=DRAIN_N, timeout=DRAIN_TIMEOUT_S, device=device)
    row["launches"] = path_counts()
    print(f"[22b] drain_tail's device row at n={DRAIN_N}: drained {row['drained']} in {row['seconds']:.3f} s, "
          f"{row['frames_out']} frames (max {DRAIN_MAX_FRAMES}), residual norm {row['residual_norm']}, joiner's max "
          f"error {row['joiner_max_err']:.3e}; launches {row['launches']}; {time.perf_counter() - t1:.3f} s on {smi}")
    require_launched(row["launches"], BURST_KERNELS, "phase 22b")
    if not (row["drained"] and row["residual_norm"] == 0.0 and row["frames_out"] < DRAIN_MAX_FRAMES):
        raise AssertionError(f"phase 22b: one gaussian add did not drain within its bounds: {row}")
    out["seconds"] = time.perf_counter() - t0
    print(f"[22] phase 22 {out['seconds']:.3f} s")
    return out


def phase20_cost(device, rate: float, seed: int, smi: str) -> list:
    """``--phase20-cost``: what phase 20a adds to the script. Phases 17 and
    18a, then 20a, four times, in the order early, late, late, early: an
    early run starts 20a's child before phase 17, as the script does, a
    late one at 20a. Prints each run and the net cost of 20a with the early
    child (the early runs' whole less the late runs' phases 17-18a);
    returns the runs."""
    from shared_tensor_tpu_torch.benchmarks import e2e_sync

    runs = []
    for arm in ("early", "late", "late", "early"):
        t0 = time.perf_counter()
        child = e2e_sync.Child(E2E_N, warmup=E2E_WARMUP_S, seconds=E2E_S) if arm == "early" else None
        shard_phase(device, seed, smi)
        lab_twins(device, rate, seed)
        t1 = time.perf_counter()
        e2e_phase(device, smi, child or e2e_sync.Child(E2E_N, warmup=E2E_WARMUP_S, seconds=E2E_S))
        t2 = time.perf_counter()
        runs.append({"arm": arm, "p17_18a_s": t1 - t0, "p20a_s": t2 - t1, "whole_s": t2 - t0})
        print(f"[20c] {arm} child: phases 17-18a {t1 - t0:.3f} s, 20a {t2 - t1:.3f} s, whole {t2 - t0:.3f} s")

    def mean(arm: str, key: str) -> float:
        return float(np.mean([r[key] for r in runs if r["arm"] == arm]))

    print(f"[20c] phase 20a's net cost with the early child {mean('early', 'whole_s') - mean('late', 'p17_18a_s'):.3f}"
          f" s, with the late child {mean('late', 'p20a_s'):.3f} s; phases 17-18a early "
          f"{mean('early', 'p17_18a_s'):.3f} s, late {mean('late', 'p17_18a_s'):.3f} s; on {smi}")
    return runs


SOURCES = {
    "quantize_rows":("shared_tensor_tpu_torch/csrc/quantize_rows.cu", "shared_tensor_tpu/ops/codec_pallas.py:286"),
    "apply_rows_batch": ("shared_tensor_tpu_torch/csrc/apply_rows.cu", "shared_tensor_tpu/ops/codec_pallas.py:337"),
    "quantize": ("shared_tensor_tpu_torch/csrc/quantize.cu", "shared_tensor_tpu/ops/codec_pallas.py:160"),
    "apply_frame_many": ("shared_tensor_tpu_torch/csrc/apply_frame.cu", "shared_tensor_tpu/ops/codec_pallas.py:216"),
    # the scale JAX computes in XLA before kernel C's Pallas call
    "frame_scale": ("shared_tensor_tpu_torch/csrc/frame_scale.cu",
                    "shared_tensor_tpu/ops/codec.py:67 via shared_tensor_tpu/ops/codec_pallas.py:174"),
    # no TPU kernel: the native engine's C pass (stc_quantize_ef_cascade)
    "quantize_rows_cascade": ("shared_tensor_tpu_torch/csrc/quantize_rows_cascade.cu", "native/stcodec.c:2088"),
    # no TPU kernel: the engine's scales_from_partials and its cascade round (stengine.cpp:1200-1309)
    "cascade_round": ("shared_tensor_tpu_torch/csrc/cascade_round.cu", "native/stengine.cpp:697"),
}


# -- phase 23 -------------------------------------------------------------------

KILL_STORM_N = 1 << 16  # phase 23's table
KILL_STORM_KILLS = 4  # alternately the interior child's uplink and the leaf's
KILL_STORM_SCALE = 1.0 / 32  # each add's bound: far from float32's noise at the 1e-4 check
KILL_STORM_TOL = 1e-4
KILL_STORM_BUDGET_S = 3.0  # reported, not enforced
KILL_STORM_WAIT_S = 10.0  # each wait's deadline: the lane, a quiet uplink, a re-graft, the agreement
# The lane links' liveness timeout, below the phase's length: a lane link
# whose socket carries no keepalive while its ring is busy times out here
# mid-stream (each round's stream outlasts it), and the phase fails.
KILL_STORM_PEER_TIMEOUT_S = 0.25
KILL_STORM_STREAM_S = 0.3  # each round's stream: an add from every peer each KILL_STORM_STEP_S
KILL_STORM_STEP_S = 0.005
# Each peer's metrics digest up its uplink: with the adds, it keeps a child's
# send queue from idling for a keepalive interval (a quarter of the liveness
# timeout), as the soak's 0.5 s digests do under its 1 s keepalive.
KILL_STORM_DIGEST_S = 0.02
# After the kills, rounds of graceful leaves: the child leaves, the leaf it
# orphans takes an add into its carry and leaves too, and both re-join.
KILL_STORM_LEAVES = 2


def _lane_live(peer) -> bool:
    return any(k.startswith("st_shm_active") and v == 2 for k, v in peer.metrics().items())


def kill_storm_phase(device, seed: int, smi: str) -> dict:
    """Phase 23 (module docstring). Returns its report."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.config import ObsConfig
    from shared_tensor_tpu_torch.obs import schema

    def wait(pred, what: str) -> None:
        deadline = time.perf_counter() + KILL_STORM_WAIT_S
        while not pred():
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 23: {what} within {KILL_STORM_WAIT_S} s")
            time.sleep(0.002)

    def uplink_live(p) -> bool:
        up = p.node.uplink
        return up is not None and p.ready and p.metrics().get(schema.link_key("st_shm_active", up)) == 2

    rng = np.random.default_rng(seed + 23)
    total = np.zeros(KILL_STORM_N, np.float64)
    port, peers = _free_port(), []
    out = {"kills": 0, "lanes": 0, "redirected_joins": 0}
    lane_msgs = {"master_out": 0, "master_in": 0, "child_out": 0, "child_in": 0}
    uplinks = {}  # each child's uplink as the phase last saw it join: any other is an unkilled death

    def count_lane() -> None:  # the lanes' messages until now (a link's counts die with it)
        for who, peer in (("master", m), ("child", c)):
            met = peer.metrics()
            lane_msgs[f"{who}_out"] += met.get("st_shm_msgs_out_total", 0)
            lane_msgs[f"{who}_in"] += met.get("st_shm_msgs_in_total", 0)

    def stream() -> None:
        t_end = time.perf_counter() + KILL_STORM_STREAM_S
        while time.perf_counter() < t_end:
            for p in peers:
                u = rng.uniform(-KILL_STORM_SCALE, KILL_STORM_SCALE, KILL_STORM_N).astype(np.float32)
                p.add({"w": u})
                total[:] += u
            time.sleep(KILL_STORM_STEP_S)
        planned()

    def planned() -> bool:
        for p in peers[1:]:
            if p.node.uplink != uplinks[p]:
                raise AssertionError(f"phase 23: a lane link died unkilled (its liveness timeout, "
                                     f"{KILL_STORM_PEER_TIMEOUT_S} s, mid-stream)")
        return True

    def joined(p) -> None:
        wait(lambda: uplink_live(p), "an uplink never went live on the lane")
        uplinks[p] = p.node.uplink
        out["lanes"] += 1

    def tcfg(**kw):
        return Config(transport=TransportConfig(
            peer_timeout_sec=KILL_STORM_PEER_TIMEOUT_S, join_timeout_sec=KILL_STORM_WAIT_S, **kw),
            obs=ObsConfig(digest_interval_sec=KILL_STORM_DIGEST_S))

    t0 = time.perf_counter()
    try:
        # the master takes one child, so the leaf is redirected to the
        # interior child, at the endpoint of that child's newest uplink
        m = create_or_fetch("127.0.0.1", port, {"w": np.zeros(KILL_STORM_N, np.float32)}, tcfg(max_children=1),
                            timeout=KILL_STORM_WAIT_S, device=device)
        peers.append(m)
        c = create_or_fetch("127.0.0.1", port, {"w": np.zeros(KILL_STORM_N, np.float32)}, tcfg(),
                            timeout=KILL_STORM_WAIT_S, host_tier=True)
        peers.append(c)
        if c._engine is None:
            raise AssertionError("phase 23: the child is not on the native engine")
        joined(c)
        leaf = None
        for k in range(KILL_STORM_KILLS):
            stream()
            victim = c if leaf is None or k % 2 == 0 else leaf
            up = victim.node.uplink
            wait(lambda: planned() and victim._engine.inflight_total() == 0
                 and victim._engine.residual_rms(up) == 0.0,
                 "the victim's uplink never drained")
            count_lane()
            victim.node.drop_link(up)
            out["kills"] += 1
            wait(lambda: victim.node.uplink not in (None, up), "a killed child never re-grafted")
            joined(victim)
            if leaf is None:
                leaf = create_or_fetch("127.0.0.1", port, {"w": np.zeros(KILL_STORM_N, np.float32)}, tcfg(),
                                       timeout=KILL_STORM_WAIT_S, host_tier=True)
                peers.append(leaf)
                joined(leaf)
            if k == 0 or victim is leaf:
                # the leaf joined after a re-graft of the child: the full
                # master redirected it to the child's newest endpoint
                if len(c.node.links) != 2:
                    raise AssertionError("phase 23: the leaf did not join below the re-grafted child")
                out["redirected_joins"] += 1
        t_leaves = time.perf_counter()
        out["leave_verdicts"] = []
        for _ in range(KILL_STORM_LEAVES):
            stream()
            count_lane()
            # the child leaves gracefully; the leaf it orphans still owes
            # the tree what the sealed child discarded, and takes one more
            # add while orphaned: its leave must wait for the re-graft that
            # hands that carry on
            out["leave_verdicts"].append(c.leave(timeout=KILL_STORM_WAIT_S))
            peers.remove(c)
            wait(lambda: leaf.node.uplink is None or leaf.node.uplink != uplinks[leaf], "the orphan never noticed")
            u = rng.uniform(-KILL_STORM_SCALE, KILL_STORM_SCALE, KILL_STORM_N).astype(np.float32)
            leaf.add({"w": u})
            total[:] += u
            out["leave_verdicts"].append(leaf.leave(timeout=KILL_STORM_WAIT_S))
            peers.remove(leaf)
            c = create_or_fetch("127.0.0.1", port, {"w": np.zeros(KILL_STORM_N, np.float32)}, tcfg(),
                                timeout=KILL_STORM_WAIT_S, host_tier=True)
            peers.append(c)
            joined(c)
            leaf = create_or_fetch("127.0.0.1", port, {"w": np.zeros(KILL_STORM_N, np.float32)}, tcfg(),
                                   timeout=KILL_STORM_WAIT_S, host_tier=True)
            peers.append(leaf)
            joined(leaf)
            if len(c.node.links) != 2:
                raise AssertionError("phase 23: the re-joined leaf did not land below the re-joined child")
        out["leave_s"] = time.perf_counter() - t_leaves
        stream()
        deadline = time.perf_counter() + KILL_STORM_WAIT_S
        while True:
            devs = [np.asarray(p.read()["w"].cpu(), np.float64) - total for p in peers]
            if max(float(np.abs(d).max()) for d in devs) < KILL_STORM_TOL or time.perf_counter() > deadline:
                break
            time.sleep(0.005)
        out["dev_neg"] = max(0.0, -min(float(d.min()) for d in devs))
        out["dev_pos"] = max(0.0, max(float(d.max()) for d in devs))
        count_lane()
        out["lane_msgs"] = lane_msgs
    finally:
        for p in reversed(peers):
            p.close()
    out["seconds"] = time.perf_counter() - t0
    out["budget_s"] = KILL_STORM_BUDGET_S
    print(f"[23] hard link kills on the lane: a {device} device-tier master, an engine child and an engine leaf "
          f"on {KILL_STORM_N} elements, liveness timeout {KILL_STORM_PEER_TIMEOUT_S} s; {out['kills']} kills, "
          f"none died unkilled, {out['redirected_joins']} joins redirected to the re-grafted "
          f"child, {out['lanes']} lanes live; then {KILL_STORM_LEAVES} rounds of the child's and its orphaned "
          f"leaf's graceful leaves and re-joins in {out['leave_s']:.3f} s, verdicts {out['leave_verdicts']}; "
          f"lane messages {out['lane_msgs']}; signed deviation from the exact "
          f"sum -{out['dev_neg']:.3e} / +{out['dev_pos']:.3e} (tolerance {KILL_STORM_TOL}); phase "
          f"{out['seconds']:.3f} s (budget {KILL_STORM_BUDGET_S} s) on {smi}")
    if min(out["lane_msgs"].values()) < 1:
        raise AssertionError(f"phase 23: no traffic on the lane: {out['lane_msgs']}")
    if not all(out["leave_verdicts"]):
        raise AssertionError(f"phase 23: a graceful leave's drain timed out: {out['leave_verdicts']}")
    if max(out["dev_neg"], out["dev_pos"]) > KILL_STORM_TOL:
        raise AssertionError(f"phase 23: the replicas are off the exact sum after {out['kills']} kills and "
                             f"{len(out['leave_verdicts'])} leaves: {out}")
    return out


class PhaseClock:
    """Wall seconds of the script's phases, in order: :meth:`lap` closes the
    phase that ends there. ``s`` is printed on one line before the kernels'
    line."""

    def __init__(self):
        self.t = time.perf_counter()
        self.s: dict[str, float] = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = round(now - self.t, 3)
        self.t = now


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase20-cost", action="store_true",
                    help="after the build, time phases 17-18a and 20a with and without the early child, and stop")
    ap.add_argument("--kill-storm", action="store_true", help="after the build, run phase 23 alone, and stop")
    args = ap.parse_args()
    t_script = time.perf_counter()
    clock = PhaseClock()
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
    clock.lap("1")
    if args.phase20_cost:
        phase20_cost(dev, hbm_rate(name), args.seed, smi)
        return 0
    if args.kill_storm:
        CC.reset_launches()
        kill_storm_phase(dev, args.seed, smi)
        require_launched(path_counts(), BURST_KERNELS, "phase 23")
        return 0
    # the ranks of phases 9-11 start now and wait for their go
    pods = PodSpawn(dev, args.seed)

    template = resnet18_template()
    spec = make_spec(template)
    if (spec.num_leaves, spec.total_n, spec.total) != (56, 11172170, 11200512):
        raise AssertionError(f"unexpected ResNet-18 table {spec.num_leaves} {spec.total_n} {spec.total}")

    # 2. kernel vs plain
    parity = kernel_vs_plain(spec, dev, np.random.default_rng(args.seed + 1))
    bad = {k: v["mismatches"] for k, v in parity.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"kernel vs plain mismatches: {bad}")
    clock.lap("2")

    # 3. tree drive (the launch counts of A and B are this phase's)
    CC.reset_launches()
    drive = tree_drive(template, dev, args.seed)
    launches = path_counts()
    print(f"[3] launches {launches}, frames out {drive['frames_out']}, in {drive['frames_in']}")
    require_launched(launches, ("quantize_rows", "apply_rows_batch"), "phase 3")
    clock.lap("3")

    # 4. times at the drive's shapes; B's row in the kernels line is the
    # interior's flood (K = BATCH, N = 2), its other shapes beside it
    rate = hbm_rate(name)
    t = times(spec, dev, rate)
    b_rows = t["apply_rows_batch"]
    t["apply_rows_batch"] = dict(b_rows[B_SHAPES.index((BATCH, 2))], shapes=b_rows)
    t["quantize_rows_cascade"] = {}  # phase 22 times it
    t["cascade_round"] = {}
    clock.lap("4")

    # 5. C and D against plain, then all four kernels past 2^31 bytes
    parity.update(scalar_kernel_vs_plain(dev, seed=args.seed))
    big = big_index_check(dev, seed=args.seed)
    bad = {k: v["mismatches"] for k, v in parity.items() if v["mismatches"]}
    bad.update({f"{k} at {BIG_PAD}": m for k, m in big.items() if m})
    if bad:
        raise AssertionError(f"kernel vs plain mismatches: {bad}")
    torch.cuda.empty_cache()
    clock.lap("5")

    # 6. the headline codec bench (the launch counts of C and D are this phase's)
    bench = codec_bench(dev, rate, 1 << 20, BENCH_SECONDS)
    launches.update(bench["launches"])
    if not all(bench["launches"].values()):
        raise AssertionError(f"a kernel of the bench never launched: {bench['launches']}")
    sp = bench["split"]
    for k in SCALAR_KERNELS:
        t[k] = {"ms": sp[f"{k}_ms"], "plain_ms": sp[f"{k}_plain_ms"], "bound_ms": sp[f"{k}_bound_ms"],
                "shape": f"n={1 << 20} K=1" if k == "apply_frame_many" else f"n={1 << 20}"}
    for k in ("quantize", "apply_frame_many"):
        t[k].update({x: sp[f"{k}_{x}"] for x in ("copy_ms", "ms_hot", "sets")})
    t["frame_scale"].update(ms_hot=sp["frame_scale_ms_hot"], sets=sp["quantize_sets"],
                            library_ms=sp["frame_scale_library_ms"])
    clock.lap("6")

    # 7. the config-5 sweep up to 2^30
    sw = sweep(dev, rate)
    if not all(sw["launches"].values()):
        raise AssertionError(f"a kernel of the sweep never launched: {sw['launches']}")
    t["quantize"]["ms_2e30"] = sw["big"]["quantize_ms"]
    t["quantize"]["bound_ms_2e30"] = sw["big"]["quantize_bound_ms"]
    t["frame_scale"].update({f"{x}_2e30": sw["big"][f"frame_scale_{x}"]
                             for x in ("ms", "bound_ms", "library_ms", "plain_ms")})
    t["frame_scale"]["launches_sweep"] = sw["launches"]["frame_scale"]
    parity["frame_scale"]["mismatches"] += sw["big"]["frame_scale_mismatches"]
    parity["frame_scale"]["max_abs_err"] = max(parity["frame_scale"]["max_abs_err"],
                                               sw["big"]["frame_scale_max_abs_err"])
    for k in D_TARGETS:
        d = sw["big"][f"apply_frame_many_k{k}"]
        suffix = "_2e30" if k == 1 else f"_2e30_k{k}"
        t["apply_frame_many"].update({f"{x}{suffix}": d[x] for x in ("ms", "bound_ms", "copy_ms")})
    clock.lap("7")

    # 8. the peer tier over loopback TCP (the launch counts of A and B are this phase's)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    CC.reset_launches()
    t8 = time.perf_counter()
    example = peer_example(dev)
    clock.lap("8a")
    tree = peer_tree(template, dev, args.seed)
    peer_launches = path_counts()
    tree["seconds"] = time.perf_counter() - t8
    tree["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"[8] launches {peer_launches}; peak device memory {tree['max_memory_allocated'] / 2**30:.3f} GiB; "
          f"phase 8a+8b {tree['seconds']:.3f} s; on {smi}")
    require_launched(peer_launches, BURST_KERNELS, "phase 8")
    clock.lap("8b")
    fetch = fetch_ab(template, dev, min(16, wire.burst_frames_cap(spec)))
    clock.lap("8c")
    for k, n in peer_launches.items():
        t[k]["launches_phase3"] = launches[k]
        t[k]["launches_phase8"] = launches[k] = n

    # 9, 10 and 11. the pod tier: BASELINE config 2 (4 ranks, and 2 x 2), config 4 (8 ranks, both arms)
    # and config 2 as two pods of 2 bridged over TCP
    torch.cuda.empty_cache()
    pod = pod_phases(pods, dev, rate, args.seed)
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
    # kernel A's main path is the pod step: a CUDA peer's bursts run A-cascade
    launches["quantize_rows"] = t["quantize_rows"]["launches_pod"]
    t["quantize_rows_cascade"]["launches_phase11"] = sum(r["cascade_launches"] for r in pod["bridge"])
    t["cascade_round"]["launches_phase11"] = sum(r["round_launches"] for r in pod["bridge"])
    clock.lap("9-11")

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
    mixed_launches = path_counts()
    require_launched(mixed_launches, BURST_KERNELS, "phase 12b")
    check12 = tree_kernel_check(master, make_spec(char_template))
    del master
    secs12 = time.perf_counter() - t12
    print(f"[12] launches {mixed_launches}; phase 12 {secs12:.3f} s")
    for k, n in mixed_launches.items():
        t[k]["launches_phase12"] = n
    for k in check12:
        t[k]["mismatches_phase12"] = check12[k]["mismatches"]
        t[k]["max_abs_err_phase12"] = check12[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check12.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 12b: kernel vs plain mismatches on the master's state: {bad}")
    clock.lap("12")

    # 13. the serving path: a CUDA master, an engine writer and two subscribers
    # (the launch counts of A and B are this phase's)
    t13 = time.perf_counter()
    CC.reset_launches()
    from shared_tensor_tpu_torch.models.char_rnn import CharRNNConfig

    serve_out, master = serve_tree(CharRNNConfig(), dev, args.seed)
    serve_launches = path_counts()
    # the master's bursts to the engine writer and to both subscribers run
    # A-cascade and the finish kernel, its applies B
    require_launched(serve_launches, BURST_KERNELS, "phase 13")
    check13 = tree_kernel_check(master, make_spec(char_template), "13")
    del master
    serve_out["seconds"] = time.perf_counter() - t13
    serve_out["launches"] = serve_launches
    print(f"[13] launches {serve_launches}; phase 13 {serve_out['seconds']:.3f} s; on {smi}")
    for k, n in serve_launches.items():
        t[k]["launches_phase13"] = n
    for k in check13:
        t[k]["mismatches_phase13"] = check13[k]["mismatches"]
        t[k]["max_abs_err_phase13"] = check13[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check13.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 13: kernel vs plain mismatches on the master's state: {bad}")
    clock.lap("13")

    # 14. the peer's wire capabilities: the reference wire (with the C peer),
    # the shared-memory lane, sign2 and striping (the launch counts of A and
    # B are this phase's)
    wire_out, wire_launches, check14 = wire_phase(dev, args.seed, mixed["last_add_to_converged_s"], smi)
    for k, n in wire_launches.items():
        t[k]["launches_phase14"] = n
        t[k]["launches_phase14_by_arm"] = {arm: v[k] for arm, v in wire_out["launches"].items()}
    for k in check14:
        t[k]["mismatches_phase14"] = check14[k]["mismatches"]
        t[k]["mismatches_phase14_by_arm"] = check14[k]["by_arm"]
        t[k]["max_abs_err_phase14"] = check14[k]["max_abs_err"]
    clock.lap("14")

    # 15. the observability plane on config 2's table (the launch counts of A
    # and B are this phase's)
    CC.reset_launches()
    obs_out, master = obs_phase(dev, args.seed, smi)
    obs_launches = path_counts()
    require_launched(obs_launches, BURST_KERNELS, "phase 15")
    check15 = tree_kernel_check(master, make_spec(char_template), "15")
    del master
    obs_out["launches"] = obs_launches
    for k, n in obs_launches.items():
        t[k]["launches_phase15"] = n
    for k in check15:
        t[k]["mismatches_phase15"] = check15[k]["mismatches"]
        t[k]["max_abs_err_phase15"] = check15[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check15.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 15: kernel vs plain mismatches on the master's state: {bad}")
    print(f"[15] launches {obs_launches}")
    clock.lap("15")

    # 16. the cluster lifecycle on config 2's table (the launch counts of A
    # and B are 16a-16d's), then the kill-restore arm
    CC.reset_launches()
    lc_out, master = lifecycle_phase(dev, args.seed, smi)
    lc_launches = path_counts()
    require_launched(lc_launches, BURST_KERNELS, "phase 16")
    check16 = tree_kernel_check(master, make_spec(char_template), "16")
    del master
    lc_out["launches"] = lc_launches
    for k, n in lc_launches.items():
        t[k]["launches_phase16"] = n
    for k in check16:
        t[k]["mismatches_phase16"] = check16[k]["mismatches"]
        t[k]["max_abs_err_phase16"] = check16[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check16.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 16e: kernel vs plain mismatches on the master's state: {bad}")
    print(f"[16] launches {lc_launches}")
    from shared_tensor_tpu_torch.benchmarks import lifecycle as lc_bench

    bench_dir = os.path.join(OUT_DIR, "phase16_kill_restore")
    shutil.rmtree(bench_dir, ignore_errors=True)
    lc_out["kill_restore"] = lc_bench.run_kill_restore(bench_dir)
    kr = lc_out["kill_restore"]
    print(f"[16] kill-restore arm ({kr['nodes']} engine peers, n={kr['n']}, 25% drops): snapshot "
          f"{kr['snapshot']['duration_sec']:.3f} s, restart re-converged {kr['restore']['duration_sec']:.3f} s, "
          f"arms max dev {kr['arms_max_deviation']:.3e}, {kr['seconds']:.3f} s: {'PASS' if kr['pass'] else 'FAIL'}")
    conf = kr["conformance"]
    print(f"[20b] the kill-restore arm's timeline against tools/protospec: {conf['events']} events, "
          f"{conf['routed_events']} routed to {conf['scopes']} scopes, violations {conf['violations']}")
    if not kr["pass"]:
        raise AssertionError(f"phase 16: the kill-restore arm failed: {kr}")
    clock.lap("16")

    # phase 20's child process starts now: its imports overlap phases 17-18
    from shared_tensor_tpu_torch.benchmarks import e2e_sync

    e2e_child = e2e_sync.Child(E2E_N, warmup=E2E_WARMUP_S, seconds=E2E_S)

    # 17. the cluster-sharded tensor on config 2's table (the launch counts of
    # A and B are 17a-17e's: the fallback's CUDA peers in 17c)
    CC.reset_launches()
    shard_out, master = shard_phase(dev, args.seed, smi)
    shard_launches = path_counts()
    require_launched(shard_launches, BURST_KERNELS, "phase 17")
    check17 = tree_kernel_check(master, make_spec(char_template), "17c")
    del master
    shard_out["launches"] = shard_launches
    for k, n in shard_launches.items():
        t[k]["launches_phase17"] = n
    for k in check17:
        t[k]["mismatches_phase17"] = check17[k]["mismatches"]
        t[k]["max_abs_err_phase17"] = check17[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check17.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 17c: kernel vs plain mismatches on the master's state: {bad}")
    print(f"[17] launches {shard_launches}")
    clock.lap("17")

    # 18. the codec lab: its device twins on the card (18a); the sign2 pod
    # step ran as 18b in the phases 9-11 spawn
    lab = lab_phase(dev, rate, args.seed, pod["sign2"], pod["phase18b_s"], smi)
    clock.lap("18")

    # 20. an end-to-end exchange: the CUDA parent and a host-tier child
    # process (the launch counts of A and B are 20a's)
    e2e = e2e_phase(dev, smi, e2e_child)
    for k, n in e2e["launches"].items():
        t[k]["launches_phase20"] = n
    for k in e2e["kernel_check"]:
        t[k]["mismatches_phase20"] = e2e["kernel_check"][k]["mismatches"]
        t[k]["max_abs_err_phase20"] = e2e["kernel_check"][k]["max_abs_err"]
    clock.lap("20")

    # 21. a severed uplink's applied prefix counted once (the launch counts
    # of A and B are this phase's)
    CC.reset_launches()
    sever, state = sever_phase(dev, args.seed, smi)
    sever["launches"] = path_counts()
    require_launched(sever["launches"], BURST_KERNELS, "phase 21")
    check21 = tree_kernel_check(state, make_spec(char_template), "21")
    del state
    for k, n in sever["launches"].items():
        t[k]["launches_phase21"] = n
    for k in check21:
        t[k]["mismatches_phase21"] = check21[k]["mismatches"]
        t[k]["max_abs_err_phase21"] = check21[k]["max_abs_err"]
    bad = {k: v["mismatches"] for k, v in check21.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"phase 21: kernel vs plain mismatches on the joiner's state: {bad}")
    print(f"[21] launches {sever['launches']}")
    clock.lap("21")

    # 22. the engine's cascade on the device tier: A-cascade and the finish
    # against their plain twins and the C pass, timed, and the burst graph;
    # then drain_tail's device row (the launch counts of A-cascade, the
    # finish and B are 22b's)
    cascade = cascade_phase(dev, rate, args.seed, smi)
    c2, c1, c4 = cascade["22a"]["config2"], cascade["22a"]["1Mi"], cascade["22a"]["resnet18"]
    for k in ("quantize_rows_cascade", "cascade_round"):
        parity[k] = {"mismatches": sum(r["mismatches"] for r in cascade["22a"].values()),
                     "max_abs_err": max(r["max_abs_err"] for r in cascade["22a"].values())}
    t["quantize_rows_cascade"].update(
        {x: c2[x] for x in ("ms", "plain_ms", "bound_ms", "copy_ms", "kc")}, shape=f"{c2['shape']} kc={c2['kc']}",
        **{f"{x}_1Mi": c1[x] for x in ("ms", "plain_ms", "bound_ms", "copy_ms")},
        times=c2["times"], times_1Mi=c1["times"],
        launches_phase22=cascade["22b"]["launches"]["quantize_rows_cascade"])
    t["cascade_round"].update(
        c2["finish"], shape=c2["shape"],
        **{f"{x}_1Mi": c1["finish"][x] for x in ("ms", "plain_ms", "bound_ms", "library_ms", "spent_ms")},
        **{f"{x}_resnet18": c4["finish"][x] for x in ("ms", "plain_ms", "bound_ms", "library_ms", "spent_ms")},
        burst={"config2": c2["burst"], "1Mi": c1["burst"], "resnet18": c4["burst"]},
        launches_phase22=cascade["22b"]["launches"]["cascade_round"])
    t["apply_rows_batch"]["launches_phase22"] = cascade["22b"]["launches"]["apply_rows_batch"]
    clock.lap("22")

    # 23. hard link kills on the lane (the launch counts of A-cascade, the
    # finish and B are this phase's)
    CC.reset_launches()
    storm = kill_storm_phase(dev, args.seed, smi)
    storm["launches"] = path_counts()
    require_launched(storm["launches"], BURST_KERNELS, "phase 23")
    print(f"[23] launches {storm['launches']}")
    clock.lap("23")
    serve_out["script_s"] = time.perf_counter() - t_script
    print(f"[23] script {serve_out['script_s']:.3f} s")
    print(json.dumps({"phase_s": clock.s, "script_s": round(serve_out["script_s"], 3)}))

    print(smi)
    kernels = []
    for k in SOURCES:
        row = {
            "name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
            "launches": launches[k], "mismatches": parity[k]["mismatches"],
            "max_abs_err": parity[k]["max_abs_err"], "ms": t[k]["ms"],
            "plain_ms": t[k]["plain_ms"], "bound_ms": t[k]["bound_ms"], "bound_by": "bytes",
            "library_ms": t[k].get("library_ms"), "shape": t[k]["shape"],
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
    print(json.dumps({"obs": obs_out}))
    print(json.dumps({"lifecycle": lc_out}))
    print(json.dumps({"shard": shard_out}))
    print(json.dumps({"codec_lab": lab}))
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"sever": sever}))
    print(json.dumps({"cascade": cascade}))
    print(json.dumps({"kill_storm": storm}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
