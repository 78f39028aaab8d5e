"""Configuration for the PyTorch/CUDA port.

Only what the port reads: the codec (scale policy, per-leaf scales,
idle-frame suppression, adaptive sign2 precision and its governor, the
engine's cascade depth), the TCP transport (the reference wire format,
link striping and the same-host shared-memory lane among its knobs), the
peer's send loop and burst sizes, the native engine switch, fault
injection (``FaultConfig``), the serving tier (``ServeConfig``), the
observability plane (``ObsConfig``), the cluster lifecycle
(``LifecycleConfig``) and the cluster-sharded tensor (``ShardConfig``).
Names, defaults and meaning are those of ``shared_tensor_tpu.config``, so a
port peer and a JAX peer built from the same settings produce the same
frames and join the same tree. JAX's top-level ``rendezvous_host``,
``rendezvous_port`` and ``mesh`` are absent: ``create_or_fetch`` takes the
host and port as arguments, and the pod tier takes its mesh from
``parallel.run_mesh``; asking for them is a ``TypeError``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ScalePolicy(enum.Enum):
    """How the per-frame quantization scale is chosen from the residual.

    POW2_RMS is the reference policy ``2^floor(log2(rms(residual)))``.
    RMS skips the power-of-two floor; ABS_MEAN uses mean(|r|).
    """

    POW2_RMS = "pow2_rms"
    RMS = "rms"
    ABS_MEAN = "abs_mean"


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Approximate-delta codec configuration: 1 sign bit per element, a scale
    per frame (per leaf when ``per_leaf_scale``), error feedback through a
    per-link residual."""

    scale_policy: ScalePolicy = ScalePolicy.POW2_RMS
    per_leaf_scale: bool = True
    #: Skip sending a frame whose scales are all 0 (it is a no-op on every
    #: receiver).
    suppress_zero_frames: bool = True
    #: Telemetry-adaptive link precision (native engine, native framing):
    #: a link whose residual RMS stops decaying upshifts to the sign2 2-bit
    #: codec (sign + magnitude bit: +/-s or +/-3s), a quiet link downshifts
    #: back to 1 bit. Emission is capability-gated per link (the SIGN2 flag
    #: of SYNC and WELCOME), so links toward peers that do not advertise it
    #: stay 1-bit. ``ST_SIGN2=0`` in the environment turns it off,
    #: ``ST_SIGN2=2`` pins sign2 on every capable link.
    adaptive_precision: bool = True
    #: The governor: upshift after 2 consecutive beats where the link's
    #: residual RMS grows past up_ratio x the previous beat's, downshift
    #: after 2 beats below down_ratio x; one beat every interval seconds.
    precision_up_ratio: float = 1.05
    precision_down_ratio: float = 0.5
    precision_interval_sec: float = 0.1
    #: Frames the native engine quantizes per memory pass over a residual:
    #: frame 0's scales are measured, frames 1..k-1 take the halving
    #: schedule the measured sequence converges to (the scales ride the
    #: wire, so receivers are oblivious). 1 = re-measure every frame.
    cascade_frames: int = 32


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """The native TCP tree (``native/sttransport.cpp``): fan-out, liveness,
    join bounds and the go-back-N delivery timer."""

    #: Max outgoing wire bytes/sec per link; 0 = unlimited.
    bandwidth_cap_bytes_per_sec: int = 0
    #: Speak the reference's exact wire format: raw [f32 scale][LSB-first
    #: bitmask] frames of one flat tensor, the 'Y'/'N' + sockaddr join, no
    #: handshake and no ACKs; idle links send one zero-scale keepalive
    #: frame per keepalive interval (in the native transport). Interoperates
    #: with reference (C) peers.
    wire_compat: bool = False
    listen_backlog: int = 128
    #: Seconds of link silence before a peer is declared dead and the link
    #: torn down and re-grafted.
    peer_timeout_sec: float = 30.0
    #: Reconnect/rejoin attempts before a node reports itself isolated.
    max_rejoin_attempts: int = 8
    #: Children per node before the listener redirects joiners down the
    #: tree; 1..16.
    max_children: int = 2
    #: Per-attempt bound on connect() and on the join walk's reply read.
    connect_timeout_sec: float = 5.0
    #: Total budget of the create-time join-or-become-master loop.
    join_timeout_sec: float = 30.0
    #: Go-back-N timer: when the oldest unacknowledged DATA/BURST message
    #: of a live link waits this long, the head of the unacknowledged tail
    #: is re-sent byte for byte; 0 disables it.
    ack_timeout_sec: float = 5.0
    #: Retransmission rounds without ACK progress before the link is torn
    #: down for re-graft (<= 0 means 1).
    ack_retry_limit: int = 8
    #: Consecutive failed send attempts (~0.1 s each) before a link whose
    #: peer stopped draining is torn down for re-graft; 0 = never.
    quarantine_send_failures: int = 100
    #: TCP connections per link (native framing), messages round-robin
    #: across them and reassembled in order by a per-message stripe
    #: sequence. A stripe whose death the sender sees degrades the link to
    #: the stripes left; the last stripe's death is the link's. A joiner
    #: with more than one stripe opens with the STT4 hello. 1..8.
    stripe_count: int = 1
    #: The same-host shared-memory lane: when both ends of a link are on
    #: one host (boot id, exchanged in the SYNC and WELCOME tails), its data
    #: plane moves into two SPSC rings of a /dev/shm segment while TCP
    #: stays the control and liveness channel. Any mismatch or failed
    #: attach keeps the link on TCP. ``ST_SHM=0`` in the environment turns
    #: it off.
    shm_enabled: bool = True
    #: Cap on one ring's bytes (two rings a link); the peer sizes them to
    #: twice its table's largest sign2 burst, at least 1 MiB.
    shm_ring_bytes: int = 1 << 26

    def __post_init__(self):
        if not 1 <= self.max_children <= 16:
            raise ValueError(f"max_children must be in 1..16, got {self.max_children}")
        if not 1 <= self.stripe_count <= 8:
            raise ValueError(f"stripe_count must be in 1..8, got {self.stripe_count}")
        if self.shm_ring_bytes < (1 << 16):
            raise ValueError(f"shm_ring_bytes must be >= 64 KiB, got {self.shm_ring_bytes}")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Deterministic, seeded fault injection at the wire boundary
    (``comm/faults.py``); off by default, when a send pays one None check.

    On the device tier and the Python host tier the peer consults a
    :class:`~shared_tensor_tpu_torch.comm.faults.FaultPlan` built from this
    config at its data send boundary. The native engine's C sender never
    crosses that boundary: there the wire knobs reach the transport as the
    ``ST_FAULT_PLAN`` / ``ST_FAULT_CRASH`` environment strings
    (:func:`~shared_tensor_tpu_torch.comm.faults.to_env`), read when the
    node is created, and the peer warns when wire faults are set on an
    engine peer with no such string. The crash points fire on every tier.
    Faults touch DATA, BURST and RDATA messages only, never the handshake,
    ACK or FRESH traffic, so every injected fault exercises a recovery path
    (ledger rollback, carry, re-graft, quarantine, subscriber resync)
    instead of wedging a join."""

    #: Master switch; False injects nothing, as no plan at all.
    enabled: bool = False
    #: RNG seed: the whole schedule is a function of (seed, per-link frame
    #: sequence), so runs repeat.
    seed: int = 0
    #: Probability a data message is silently dropped (the sender believes
    #: it delivered; its ledger entry stays unacknowledged).
    drop_pct: float = 0.0
    #: Probability a data message is sent twice (the receiver's seq check
    #: discards the echo).
    dup_pct: float = 0.0
    #: Probability a data message is cut to a random shorter length (the
    #: receiver's decode rejects it without consuming its seq; go-back-N
    #: re-sends it whole).
    truncate_pct: float = 0.0
    #: Probability one bit is flipped: in a frame's sign words on the
    #: Python tiers (one element mis-applied by 2*scale, a bounded fault);
    #: anywhere in the message on the native tier (survival chaos only).
    corrupt_pct: float = 0.0
    #: Probability a data message's send is delayed by ``delay_sec``.
    delay_pct: float = 0.0
    delay_sec: float = 0.005
    #: >= 0: every data message past the Nth (per link) is swallowed.
    stall_after_frames: int = -1
    #: > 0: tear the link down at its Nth data message.
    sever_after_frames: int = 0
    #: > 0: every fault only on this link id (a re-grafted link gets a new
    #: id and runs clean). 0 = every link.
    only_link: int = 0
    #: >= 0: every (native-tier) fault only on this stripe index of each
    #: striped link; ``sever_after_frames`` then kills just that socket and
    #: the link must degrade to the stripes left. -1 = every stripe.
    only_stripe: int = -1
    #: Named protocol point at which to kill the process (os._exit):
    #: "mid-join-walk" (SYNC sent, snapshot not), "mid-burst" (frames
    #: ledgered, message not yet on the wire), "between-apply-and-ack"
    #: (mass applied and flooded, ACK not sent). "" = never.
    crash_point: str = ""
    #: Fire the crash at the Nth arrival at the point (1 = first).
    crash_after: int = 1


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The observability plane (``shared_tensor_tpu_torch/obs``), with the
    JAX package's names and defaults. On by default; ``ST_OBS=0`` in the
    environment disables it process-wide whatever this config says (the
    overhead bench's paired arms flip it with ``obs.set_enabled``)."""

    #: Master switch for THIS peer's Python-tier instrumentation (registry
    #: histograms, event emission, native-ring draining). The native ring
    #: itself is process-wide (env ST_OBS).
    enabled: bool = True
    #: How often this peer's recv loop drains the native event ring into
    #: the process flight recorder. Small enough that a 2048-event
    #: per-thread ring survives chaos bursts; large enough to stay off the
    #: drain mutex.
    native_drain_interval_sec: float = 0.2
    #: Background JSONL metrics sink: one snapshot line per interval
    #: appended to this path ("" = no sink).
    jsonl_path: str = ""
    jsonl_interval_sec: float = 5.0
    #: trace propagation: stamp outgoing DATA/BURST messages with the
    #: v2 wire framing's 13-byte trace context (origin node, origin
    #: monotonic ns, hop count — compat.WIRE_VERSION). Decoders accept
    #: both framings regardless; ST_WIRE_TRACE=0 force-pins v1 emission
    #: (e.g. to join a tree of pre-peers). The obs-overhead gate holds
    #: the stamping cost inside the same <2% budget.
    trace_wire: bool = True
    #: in-band metric aggregation: how often this peer piggybacks its
    #: subtree's bounded metrics digest up the tree on the existing link
    #: (counters merged by sum, histograms by bucket-add, gauges by
    #: labeled max/min — obs/aggregate.py). The root's
    #: ``peer.metrics(cluster=True)`` / Prometheus exposition then serve a
    #: live whole-tree view. 0 = digests off. Native framing only (the
    #: reference compat protocol has no typed control messages).
    digest_interval_sec: float = 0.5
    #: Root-side live cluster view: when set, a peer with no uplink (the
    #: tree root) writes the merged cluster digest JSON to this path every
    #: digest interval — the file ``python -m shared_tensor_tpu_torch.obs.top``
    #: tails for its terminal dashboard. "" = don't write.
    cluster_json_path: str = ""
    #: fleet health plane (root-side, obs/health.py): when set, the
    #: tree root runs the health analyzer every digest beat — time-series
    #: store, per-shard heat, staleness SLO burn-rate alerts — and writes
    #: the machine-readable health document to this path (atomic replace,
    #: same discipline as cluster_json_path). "" = analyzer off.
    health_json_path: str = ""
    #: Ring depth per time-series (beats kept). 256 beats at the default
    #: 0.5s digest interval is ~2 minutes of history.
    health_history: int = 256
    #: Staleness SLO objective: a digest beat is "bad" when the fleet's
    #: worst offset-corrected staleness exceeds this many seconds.
    staleness_slo_sec: float = 1.0
    #: SLO error budget: the tolerated bad-beat fraction (burn rate 1.0
    #: means burning exactly the budget).
    slo_budget: float = 0.01
    #: Multi-window burn-rate severities: (name, long_sec, short_sec,
    #: threshold). A severity fires when BOTH windows burn past the
    #: threshold and clears when the short window recovers.
    slo_windows: tuple = (
        ("page", 60.0, 5.0, 14.4),
        ("ticket", 300.0, 30.0, 6.0),
    )
    #: Zipf-skew naming bar: the hot shard must out-rate the mean of the
    #: other shards by this factor before health.json names it.
    heat_skew_ratio: float = 3.0
    #: clock plane: how often a non-root node probes its uplink with a
    #: wire.CLOCK offset sample (obs/clock.py; chaos-exempt control op).
    #: 0 = clock sync off (staleness stays raw).
    clock_sync_interval_sec: float = 1.0
    #: TEST/BENCH ONLY — simulated clock skew in seconds applied to this
    #: node's cross-node-comparable stamps (trace stamps, clock probes).
    #: Lets a single-host harness prove the offset estimator recovers a
    #: known skew. Env ``ST_CLOCK_SKEW_SEC`` overrides. 0 = off.
    clock_skew_sim_sec: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving tier (``serve/``): read-only subscribers with verified
    bounded-staleness reads. Read by ``serve.Subscriber`` and by a writer's
    FRESH pacing on its subscriber links."""

    #: Default bound of ``Subscriber.read()``: the read raises
    #: ``StalenessError`` unless the subscriber can show its state is at
    #: most this many seconds behind (the newest applied origin stamp or
    #: the parent's FRESH mark; one host's CLOCK_MONOTONIC).
    max_staleness_sec: float = 1.0
    #: Seconds between FRESH marks on an idle subscriber link (residual
    #: drained: "as of t you have everything I have").
    fresh_interval_sec: float = 0.25
    #: Least seconds between a subscriber's resync handshakes (a seq gap on
    #: its unledgered link re-seeds it over the control plane).
    resync_min_interval_sec: float = 0.25
    #: Element range [lo, hi) to subscribe to, rounded outward to 32-element
    #: words on the wire. None = the whole table.
    range: Optional[tuple[int, int]] = None


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """The cluster lifecycle: consistent-cut snapshot and restore, the
    restart from shards, the routed drain, and the
    ``python -m shared_tensor_tpu_torch.ctl`` operator surface. The
    snapshot barrier is root-initiated (``peer.snapshot_cluster``): a
    quiesce marker (``wire.SNAP``) floods down the tree on the control
    plane, every node pauses new production, drains its in-flight ledgers
    to empty, writes a shard file and acks up; the root writes
    ``MANIFEST.json`` with each shard's sha256 and releases the barrier
    (``wire.RESUME``)."""

    #: Stable node name used for shard files (``shard_<name>.npz``) and as
    #: the ``ctl drain`` target. "" = ``node-<obs_id>`` (unique in the
    #: process but NOT stable across restarts: set explicit names in any
    #: deployment that intends to restore).
    node_name: str = ""
    #: Shard file to restore from BEFORE joining the tree (the full-cluster
    #: restart): values load into the replica, and a non-master node's
    #: checkpointed uplink residual (+ old carry) becomes the re-graft
    #: carry, so the join's diff handshake re-delivers exactly the owed
    #: mass. "" = fresh start.
    restore_path: str = ""
    #: Root-side operator command channel: when set, a peer with no uplink
    #: polls ``<ctl_dir>/cmd.json`` for commands written by
    #: ``python -m shared_tensor_tpu_torch.ctl`` (snapshot / restore /
    #: drain) and writes ``<ctl_dir>/result.json`` back. File-based like
    #: ``ObsConfig.cluster_json_path``, so the CLI needs no socket into the
    #: cluster. "" = disabled.
    ctl_dir: str = ""
    #: Root-side budget for one whole-cluster snapshot/restore barrier
    #: (marker flood + drain-to-quiesce + shard I/O + acks). Past it the
    #: root RESUMEs the tree anyway and reports failure: a lifecycle
    #: operation may fail, but it must never leave the cluster paused.
    snapshot_timeout_sec: float = 60.0
    #: Safety net on every non-root node: if a barrier's RESUME never
    #: arrives (the root died mid-barrier), unpause after this long and
    #: log.
    pause_timeout_sec: float = 30.0
    #: ``leave()`` budget for a routed ``ctl drain <node>`` (seal + drain +
    #: close on the target node).
    drain_grace_sec: float = 30.0


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """The cluster-sharded tensor (``shared_tensor_tpu_torch/shard``): the
    table is partitioned into contiguous word ranges, each owned by exactly
    one cluster node. Per-node memory is the owned slice plus transient
    outboxes, O(total / n_shards) at steady state, instead of a full
    replica; a writer's out-of-shard delta rides owner-routed ``wire.FWD``
    frames toward the shard's owner (no per-hop re-quantization), and
    readers assemble views by subscribing to owner shards
    (``shard.gather``)."""

    #: Number of contiguous shards the master partitions the word space
    #: into at creation. 0 = sharding off (the classic full-replica
    #: protocol; ``create_or_fetch_sharded`` then returns a classic peer).
    n_shards: int = 0
    #: The shard index this node claims at join (the master claims its own
    #: index locally). -1 = a member that owns no shard: it still joins the
    #: tree, routes FWD traffic and may write and read, but holds no slice.
    #: Claims are arbitrated by the master; a taken index is DENIED and
    #: creation fails.
    shard_index: int = -1
    #: The address other nodes (gather legs, takeover peers) dial to reach
    #: this node's listener, recorded in its OwnerEntry at claim and
    #: handoff. "" = the rendezvous host argument, which is right exactly
    #: when every node shares one host; a multi-host cluster must set each
    #: node's reachable address here.
    advertise_host: str = ""
    #: Restart path: a directory holding a sharded snapshot (MANIFEST.json
    #: and ``shard_<node_name>.npz``). The node loads its slices, outboxes
    #: and dedup windows BEFORE joining and claims with takeover semantics
    #: (the master re-grants the index at a higher epoch). "" = fresh start.
    restore_dir: str = ""
    #: Tree fan-out for sharded nodes (separate from
    #: ``TransportConfig.max_children``): owners also serve read-only
    #: subscriber leaves on the same listener, and the transport redirects
    #: joiners down the tree when slots fill, which breaks a gather leg
    #: that must land on one specific owner. So the default sits near the
    #: transport's cap (16).
    max_children: int = 12
    #: Budget for the join-time claim round trip (SYNC, map, claim, grant
    #: flood). Past it, creation fails instead of waiting forever.
    claim_timeout_sec: float = 20.0
    #: Bound on FWD messages parked while a shard's route is unknown (owner
    #: not yet granted, route purged by a LINK_DOWN, owner being restored).
    #: Overflow drops the OLDEST parked message and counts it
    #: (``st_shard_park_drops_total``): loud bounded loss, never unbounded
    #: memory.
    park_cap: int = 4096
    #: Run the FWD hot loop (outbox pump, verbatim relay, owner dedup and
    #: apply, go-back-N) in the native engine (``shard/engine_lane.py``).
    #: False pins the Python plane, the semantic reference and
    #: wire-identical; ``ST_SHARD_ENGINE=0`` pins it process-wide.
    engine_lane: bool = True
    #: Writer admission control: a bound on resident per-target-shard
    #: outbox bytes. An add() whose out-of-shard deposits would exceed it
    #: waits for the FWD plane to drain room (``outbox_overflow="block"``)
    #: or raises ``ShardBackpressure`` (``"raise"``). 0 = unlimited. The
    #: projection is conservative at slice granularity: each target shard
    #: of the delta counts one full outbox slice.
    outbox_limit_bytes: int = 0
    #: "block" (wait up to ``outbox_block_timeout_sec``, then raise) or
    #: "raise" (fail the add() at once).
    outbox_overflow: str = "block"
    #: How long a blocking add() waits for outbox room before raising
    #: ``ShardBackpressure``: a stalled link fails the writer loudly.
    outbox_block_timeout_sec: float = 30.0


@dataclasses.dataclass(frozen=True)
class Config:
    """A peer's configuration."""

    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    transport: TransportConfig = dataclasses.field(default_factory=TransportConfig)
    #: Target seconds between frames per link; 0 = free-running.
    sync_interval_sec: float = 0.0
    #: Quantized-but-unsent frames per link in the send loop, each with its
    #: device-to-host copy started at dispatch; 1 = plain double buffering.
    send_pipeline_depth: int = 8
    #: Free send-buffer slots the frame pool keeps (idle memory bound).
    frame_pool_keep: int = 4
    #: Frames per wire message: K successive halvings of a link's residual
    #: quantized in one call and fetched with one copy. 0 = auto (16, capped
    #: by what every peer sized its receive buffer for); 1 = single frames.
    device_frame_burst: int = 0
    #: Frames per wire message on the host tier: K successive halvings of a
    #: link's residual quantized back to back and sent as ONE message, one
    #: ledger entry and one ACK. 0 = auto (the engine fills the wire
    #: message budget; the Python host tier bursts small tables only);
    #: 1 = single frames; K > 1 = K, capped by what every peer sized its
    #: receive buffer for.
    frame_burst: int = 0
    #: Run a host-tier peer's steady-state data plane (quantize, encode,
    #: send, receive, flood apply, ACK ledger) in the native engine
    #: (``native/stengine.cpp``, two C threads over the ``stcodec.c``
    #: loops); Python keeps the handshakes and membership. False selects
    #: the Python host tier.
    native_engine: bool = True
    #: Fault injection (off by default).
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    #: The serving tier: subscriber reads and the writers' FRESH pacing.
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    #: The observability plane: metrics registry, native event ring,
    #: cluster digests, the clock probe and the root's health analyzer.
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    #: The cluster lifecycle: snapshot, restore, drain and the ctl channel.
    lifecycle: LifecycleConfig = dataclasses.field(default_factory=LifecycleConfig)
    #: The cluster-sharded tensor: shard count, this node's claim,
    #: restart-restore, routing bounds. n_shards=0 keeps the classic
    #: full-replica protocol.
    shard: ShardConfig = dataclasses.field(default_factory=ShardConfig)
