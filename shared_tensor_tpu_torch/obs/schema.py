"""The metric-name schema: one name per number.

The counterpart of ``shared_tensor_tpu/obs/schema.py``. ``SCHEMA`` holds
the JAX package's names with their kinds and help, then a section of its
own for the names only the port emits. Every telemetry surface of the port
(registry snapshots, the Prometheus text, the postmortem header, the
cluster digest) speaks these names, and
``tests/test_torch_obs.py::test_schema_lint_every_emitted_st_name_is_documented``
fails if a ``st_*`` literal in the package is not here.

Naming rules (Prometheus conventions):

- ``st_`` prefix; ``_total`` suffix on monotone counters; unit suffixes
  (``_seconds``, ``_bytes``) on measured quantities;
- per-link series carry a ``{link="N"}`` label rendered into the key
  (:func:`link_key`; snapshots are flat dicts);
- histograms export as ``{"sum":..,"count":..,"buckets":{le: cum}}`` dicts
  in snapshots and the standard ``_bucket/_sum/_count`` series in
  Prometheus text.

The latency histograms time host work. On the device tier a received
batch's apply stages its frames, copies them to the card and LAUNCHES
kernel B without waiting for it, so ``st_apply_seconds`` is not device
time; no device sync is added to the hot path to make it one.
"""

from __future__ import annotations

#: name -> (kind, help). The contract: anything a peer exports uses a name
#: from this table (per-link names via :func:`link_key`).
SCHEMA: dict[str, tuple[str, str]] = {
    # codec-frame taxonomy (peer.metrics() docstring, unchanged semantics)
    "st_frames_out_total": ("counter", "non-idle codec frames handed toward the wire"),
    "st_frames_in_total": ("counter", "codec frames applied from the wire"),
    "st_updates_total": ("counter", "local add() calls merged into the replica"),
    # delivery / go-back-N ledger
    "st_msgs_out_total": ("counter", "wire DATA/BURST messages sent (ACK-ledgered)"),
    "st_msgs_in_total": ("counter", "wire DATA/BURST messages accepted in order"),
    "st_inflight_msgs": ("gauge", "sent-but-unacked messages (0 after drain)"),
    "st_retransmit_msgs_total": ("counter", "go-back-N messages re-sent byte-identical"),
    "st_dedup_discards_total": ("counter", "duplicate/out-of-order data messages discarded unapplied"),
    "st_corrupt_scales_zeroed_total": ("counter", "non-finite scales zeroed at the decode trust boundary"),
    # latency (python tier: true histograms; engine tier: sum/count from the
    # counters ABI — mean-only, the C hot path keeps no buckets)
    "st_ack_rtt_seconds": ("histogram", "ledger-append to cumulative-ACK-pop round trip"),
    "st_ack_rtt_seconds_sum": ("counter", "engine-tier ACK RTT aggregate (seconds)"),
    "st_ack_rtt_seconds_count": ("counter", "engine-tier ACK RTT sample count"),
    "st_encode_seconds": ("histogram", "host seconds to wire-encode one ledgered DATA/BURST message (device tier: the copy of a frame already fetched to the host into its pooled slot; Python host tier: the same encode; the engine does not report it)"),
    "st_apply_seconds": ("histogram", "host seconds to apply one received batch (device tier: staging into pinned memory, the H2D copy and the LAUNCH of kernel B, no device sync, so not device time; Python host tier: the C loops; the engine does not report it)"),
    # pool occupancy (zero-allocation steady-state assertion)
    "st_tx_slot_acquires_total": ("counter", "frame-slot ring acquires (engine tx ring or wire.FramePool)"),
    "st_tx_slot_alloc_events_total": ("counter", "frame-slot ring fresh allocations (flat in steady state)"),
    "st_tx_slots_allocated": ("gauge", "frame slots currently allocated (engine) / free (python pool)"),
    "st_transport_tx_acquires_total": ("counter", "transport tx buffer acquires"),
    "st_transport_tx_misses_total": ("counter", "transport tx buffer pool misses"),
    "st_transport_rx_acquires_total": ("counter", "transport rx buffer acquires"),
    "st_transport_rx_misses_total": ("counter", "transport rx buffer pool misses"),
    "st_transport_zc_msgs_total": ("counter", "zero-copy (borrowed-slot) sends enqueued"),
    # native event ring health
    "st_obs_events_dropped_total": ("counter", "native ring events lost to overflow (undrained)"),
    # convergence/staleness telemetry (trace context at apply)
    "st_staleness_seconds": ("gauge", "live age of the link's freshest traced update (per-link; raw CLOCK_MONOTONIC delta — the r18 health plane widens it to offset-corrected +/- uncertainty via st_clock_*)"),
    "st_staleness_origin": ("gauge", "origin node id of the link's freshest traced update (per-link; feeds the r18 offset correction)"),
    "st_residual_norm": ("gauge", "L2 norm over every link's error-feedback residual (0 = quiesced)"),
    "st_update_hops": ("histogram", "tree hops traversed by applied traced updates (python tier buckets)"),
    "st_update_hops_sum": ("counter", "engine-tier hop-count aggregate (sum over applied traced msgs)"),
    "st_update_hops_count": ("counter", "engine-tier hop-count sample count"),
    "st_update_hops_last": ("gauge", "hop distance of the latest traced update applied on the link (per-link)"),
    "st_traced_msgs_in_total": ("counter", "applied data messages that carried a v2 trace stamp"),
    # in-band cluster digest aggregation
    "st_digest_sends_total": ("counter", "cluster metrics digests sent up the tree"),
    "st_digest_msgs_in_total": ("counter", "cluster metrics digests received from subtree links"),
    "st_cluster_nodes": ("gauge", "nodes represented in this peer's latest merged cluster digest"),
    # read-path serving tier. st_read_* live on the SUBSCRIBER
    # (serve/subscriber.py registry); st_sub_* split: resyncs/gap/fresh-in/
    # freshness/range on the subscriber, links/msgs-out/fresh-out on the
    # WRITER (peer collector; engine tier serves the counts over the
    # widened counters ABI). Staleness semantics follow the caveat above:
    # same-host CLOCK_MONOTONIC deltas.
    "st_read_total": ("counter", "serving reads served (staleness bound verified)"),
    "st_read_stale_total": ("counter", "serving reads REFUSED: staleness bound not verifiable (raised, never silently stale)"),
    "st_read_staleness_seconds": ("histogram", "verified staleness observed at read time"),
    "st_sub_resyncs_total": ("counter", "subscriber re-seed handshakes (seq gap or re-join)"),
    "st_sub_gap_discards_total": ("counter", "data messages discarded while desynced (gap -> resync window)"),
    "st_sub_fresh_marks_total": ("counter", "FRESH drain marks applied by the subscriber"),
    "st_sub_freshness_seconds": ("gauge", "age of the subscriber's newest verified-fresh instant (stamp or FRESH mark)"),
    "st_sub_range_words": ("gauge", "subscribed word count (full table when it equals total/32)"),
    "st_sub_links": ("gauge", "writer: attached read-only subscriber links"),
    "st_sub_msgs_out_total": ("counter", "writer: unledgered data messages sent to subscriber links"),
    "st_sub_fresh_out_total": ("counter", "writer: FRESH drain marks delivered to subscriber links"),
    # data plane: multi-socket link striping + telemetry-adaptive
    # precision. st_stripe_count/live are per-link gauges (negotiated vs
    # surviving sockets); deaths/reroutes count stripe teardowns and the
    # messages re-routed off a dying stripe. st_link_precision is the
    # governor's current wire precision for the link (1 = sign-bit,
    # 2 = sign2); upshifts/downshifts count its flips (ring event
    # precision_shift carries each one); st_frames2_* are the sign2
    # subsets of st_frames_*_total.
    "st_stripe_count": ("gauge", "negotiated sockets striping the link (per-link)"),
    "st_stripe_live": ("gauge", "surviving stripe sockets on the link (per-link)"),
    "st_stripe_deaths_total": ("counter", "stripe sockets torn down (link degraded to survivors)"),
    "st_stripe_reroutes_total": ("counter", "messages re-routed off a dying stripe to survivors"),
    "st_link_precision": ("gauge", "wire precision the governor chose for the link (1=sign, 2=sign2)"),
    "st_precision_upshifts_total": ("counter", "governor upshifts to the sign2 2-bit codec"),
    "st_precision_downshifts_total": ("counter", "governor downshifts back to 1-bit"),
    "st_frames2_out_total": ("counter", "sign2 (2-bit) frames sent (subset of st_frames_out_total)"),
    "st_frames2_in_total": ("counter", "sign2 (2-bit) frames applied (subset of st_frames_in_total)"),
    # same-host shm transport lane: st_shm_active is a per-link gauge
    # (1 = segment mapped, 2 = the link's data plane is live on the shm
    # rings); the *_total counters isolate the lane's share of the link
    # wire traffic (also counted in st_link_wire_* — the lane slots in
    # below the wire-seq layer, like striping). The ring events
    # shm_lane_up / shm_fallback carry each lane switch and each
    # negotiation failure reason.
    "st_shm_active": ("gauge", "shm lane state for the link (1=mapped, 2=data plane live)"),
    "st_shm_msgs_out_total": ("counter", "wire messages sent over shm rings (subset of st_link_wire_msgs_out_total)"),
    "st_shm_msgs_in_total": ("counter", "wire messages received over shm rings (subset of st_link_wire_msgs_in_total)"),
    "st_shm_bytes_out_total": ("counter", "bytes written into shm tx rings (record headers included)"),
    "st_shm_bytes_in_total": ("counter", "bytes drained from shm rx rings (record headers included)"),
    # cluster lifecycle (consistent-cut snapshot/restore, drain-node,
    # rolling upgrade). Gauges ride the per-node digest breakdown, which
    # is what obs.top's lifecycle rows and ``ctl versions`` read at the
    # root: st_wire_version audits a mid-upgrade version skew per node,
    # st_lifecycle_paused / st_snapshot_in_progress / st_drain_in_progress
    # show who is inside a barrier or leaving, and
    # st_snapshot_shards_acked shows barrier progress (subtree shard acks
    # folded at each node so far).
    "st_wire_version": ("gauge", "DATA/BURST framing version this node emits (compat.WIRE_VERSION; the ctl versions / rolling-upgrade audit)"),
    "st_lifecycle_paused": ("gauge", "1 while the node's data production is quiesced by a lifecycle barrier"),
    "st_snapshot_in_progress": ("gauge", "1 while a consistent-cut snapshot barrier is active at this node"),
    "st_snapshot_shards_acked": ("gauge", "subtree shard acks folded into this node's barriers so far"),
    "st_snapshot_total": ("counter", "consistent-cut shards this node captured"),
    "st_snapshot_last_duration_seconds": ("gauge", "root: wall time of the last snapshot/restore barrier"),
    "st_restore_total": ("counter", "shard restores applied (in-place barrier or restart load)"),
    "st_drain_in_progress": ("gauge", "1 while this node is executing a routed drain (seal+drain+close)"),
    "st_drain_total": ("counter", "routed drain commands this node accepted"),
    "st_lifecycle_errors_total": ("counter", "lifecycle barrier/ctl failures (overlap, timeout, lost RESUME, shard I/O)"),
    # cluster-sharded tensor (shared_tensor_tpu/shard). The write
    # plane: fwd_out counts frames a node ORIGINATED (its outbox drains),
    # fwd_in frames applied to an owned shard, relayed frames forwarded
    # verbatim toward their owner, dedup the end-to-end (origin, fwd_seq)
    # discards that close the re-route at-least-once window. park_drops is
    # the bounded-park overflow (loud bounded loss — ShardConfig.park_cap).
    # The read plane: the gather histogram records each assembled view's
    # WORST per-shard verified staleness. owned_words/alloc_bytes ride the
    # per-node digest breakdown (obs.top's shard column, and the chaos
    # harness's per-node memory bound).
    "st_shard_owned_words": ("gauge", "words of the table this node currently owns (0 = pure writer/relay)"),
    "st_shard_alloc_bytes": ("gauge", "resident shard-state bytes: owned slices + subscriber residuals + live outboxes"),
    "st_shard_routes": ("gauge", "shards with a learned next-hop route at this node"),
    "st_shard_parked_msgs": ("gauge", "FWD frames parked awaiting a route (bounded by ShardConfig.park_cap)"),
    "st_shard_fwd_msgs_out_total": ("counter", "FWD frames this node originated (outbox drains)"),
    "st_shard_fwd_msgs_in_total": ("counter", "FWD frames applied to an owned shard"),
    "st_shard_fwd_relayed_total": ("counter", "FWD frames relayed verbatim toward their owner (no re-quantization)"),
    "st_shard_fwd_dedup_total": ("counter", "FWD frames discarded by the owner's (origin, fwd_seq) dedup window"),
    "st_shard_park_drops_total": ("counter", "parked FWD frames dropped at the park-buffer cap (bounded loud loss)"),
    # engine-tier shard plane twins: the same write-plane numbers,
    # served off the native st_shard_counters ABI for engine-lane nodes
    # (the python tier reports them from its own registry — obs.top and
    # the chaos harness stay lane-blind). frames_in is the codec-frame
    # subtotal behind fwd_msgs_in (one FWD message bursts many halving
    # frames — the shard-perf bench's GB/s-equiv numerator); retx counts
    # go-back-N re-sends on the FWD ledger.
    "st_shard_fwd_frames_in_total": ("counter", "codec frames applied from FWD messages (burst subtotal of st_shard_fwd_msgs_in_total)"),
    "st_shard_fwd_retx_total": ("counter", "FWD messages re-sent byte-identical by the shard plane's go-back-N"),
    "st_shard_handoffs_total": ("counter", "shard ownership handoffs completed (counted at both endpoints)"),
    "st_shard_gather_staleness_seconds": ("histogram", "worst per-shard verified staleness per assembled gather view"),
    # fleet health plane. Clock gauges are per-NODE estimates against
    # the tree root's CLOCK_MONOTONIC (obs/clock.py: NTP-style four-stamp
    # exchange over wire.CLOCK, min-RTT selected; the root pins 0/0).
    # Heat numerators are per-SHARD labeled gauges (shard_key) so they
    # ride the digest's per-node breakdown — heat_applies is a monotone
    # cumulative count served as a gauge (the health store derives the
    # rate), heat_outbox is the node's pending backlog toward the shard.
    # st_heat_*/st_slo_* are the ROOT's analyzer verdicts (obs/health.py).
    "st_clock_offset_seconds": ("gauge", "estimated clock offset of this node vs the tree root (C_node - C_root; 0 at the root)"),
    "st_clock_uncertainty_seconds": ("gauge", "error bound on st_clock_offset_seconds (accumulated min-RTT/2 down the tree)"),
    "st_clock_probes_total": ("counter", "clock-offset probes sent up the uplink (wire.CLOCK round trips)"),
    "st_shard_heat_applies": ("gauge", "cumulative FWD applies attributed to the shard at this node (per-shard; rate = shard heat numerator)"),
    "st_shard_heat_outbox_bytes": ("gauge", "pending outbox bytes at this node destined to the shard (per-shard backlog)"),
    "st_shard_heat_deposit_msgs": ("gauge", "cumulative pre-coalesce outbox deposits destined to the shard at this node (writer-side; its rate vs the st_shard_fwd_msgs_out_total drain rate is the coalescing ratio — diverging deposits with flat msgs_out = saturated writer)"),
    "st_shard_heat_deposit_bytes": ("gauge", "cumulative pre-coalesce payload bytes deposited toward the shard at this node (writer-side byte twin of st_shard_heat_deposit_msgs)"),
    "st_shard_outbox_bytes": ("gauge", "total pending outbox bytes across all shards at this node"),
    "st_shard_outbox_limit_bytes": ("gauge", "configured outbox byte cap (ShardConfig.outbox_limit_bytes; 0 = unlimited)"),
    "st_heat_score": ("gauge", "root analyzer: hottest shard's heat score (0.6*rate + 0.3*outbox + 0.1*alloc, each max-normalized)"),
    "st_heat_hot_shard": ("gauge", "root analyzer: zipf-skew hot shard id (-1 = no shard dominates)"),
    "st_slo_burn_rate": ("gauge", "root analyzer: staleness SLO burn rate over the severity's long window (per-window label)"),
    "st_slo_alert": ("gauge", "root analyzer: staleness SLO alert severity (0=ok, 1=ticket, 2=page)"),
    "st_slo_bad_beats_total": ("counter", "root analyzer: digest beats whose worst corrected staleness broke the objective"),
    # per-link series (rendered via link_key)
    "st_link_bytes_out_total": ("counter", "wire bytes sent on the link (incl. framing/keepalives)"),
    "st_link_bytes_in_total": ("counter", "wire bytes received on the link"),
    "st_link_wire_msgs_out_total": ("counter", "transport messages sent (data AND control, no keepalives)"),
    "st_link_wire_msgs_in_total": ("counter", "transport messages received"),
    "st_link_send_queue": ("gauge", "transport send-queue depth"),
    "st_link_recv_queue": ("gauge", "transport recv-queue depth"),
    "st_link_residual_rms": ("gauge", "outgoing residual RMS (0 = quiesced)"),
    # -- names the PyTorch/CUDA port emits that the JAX package does not.
    # Every counter ends in _total and every gauge does not, so a JAX root
    # (aggregate._kind classifies unknown names by suffix) merges them right.
    "st_unknown_msgs_total": ("counter", "messages of a kind this peer does not speak (logged and dropped)"),
    "st_apply_dropped_total": ("counter", "received frames dropped because their apply raised (acknowledged all the same, never re-sent)"),
    "st_msg_errors_total": ("counter", "received messages whose handler raised (logged and dropped)"),
    "st_recv_restarts_total": ("counter", "restarts of the receive loop after an unhandled exception"),
    "st_data_bytes_out_total": ("counter", "DATA/BURST/RDATA payload bytes handed to the transport (re-sends included)"),
    "st_data_bytes_in_total": ("counter", "DATA/BURST payload bytes accepted from the transport"),
    "st_fetch_wait_seconds_total": ("counter", "host seconds the send thread waited for frames' device-to-host copies (device tier)"),
    "st_h2d_seconds_total": ("counter", "host seconds staging received frames into pinned memory and starting their copy to the card (device tier)"),
    "st_apply_lock_wait_seconds_total": ("counter", "host seconds the receive thread waited for the replica's state lock"),
    "st_send_loop_busy_seconds_total": ("counter", "host seconds the send loop spent in its passes over the links"),
    "st_encode_seconds_total": ("counter", "host seconds encoding DATA/BURST messages (sum of st_encode_seconds)"),
    "st_send_seconds_total": ("counter", "host seconds handing data messages to the transport, backpressure included"),
    "st_decode_seconds_total": ("counter", "host seconds decoding received DATA/BURST messages"),
    "st_apply_seconds_total": ("counter", "host seconds applying received batches (sum of st_apply_seconds)"),
    "st_link_frames_out_total": ("counter", "non-idle codec frames sent on the link, ever (per-link)"),
    "st_shm_fallback_total": ("counter", "same-host links whose shared-memory lane did not attach and that kept TCP"),
    "st_carry_frames_rolled_total": ("counter", "unacknowledged frames of severed uplinks rolled into the re-graft carry (device and Python host tiers)"),
    "st_carry_frames_retracted_total": ("counter", "of those, frames the parent reported applied at the re-join, taken back out of this node's state"),
    "st_shm_ring_bytes": ("gauge", "bytes of one shared-memory ring of the link, each direction (per-link)"),
}

#: Names whose value is PROCESS-scoped, not peer-scoped: every peer in a
#: process reports the same module- or ring-global number
#: (``wire.corrupt_scales_zeroed()``, the native ring's drop count). The
#: cluster digest (obs/aggregate.py) deduplicates these by pid before
#: summing, or a tree of 7 peers in one process would report them 7x.
#: The port keeps no other process-wide counter.
PROCESS_GLOBAL = frozenset(
    {
        "st_corrupt_scales_zeroed_total",
        "st_obs_events_dropped_total",
    }
)

def label_key(name: str, label: str, value) -> str:
    """Canonical single-label series key: ``name{label="value"}``, the
    one way to build a labeled variant of a schema name. Numeric values
    render as integers (link/shard ids); strings (the SLO window names)
    pass through verbatim."""
    if isinstance(value, (int, float)):
        value = int(value)
    return f'{name}{{{label}="{value}"}}'


def link_key(name: str, link: int) -> str:
    """Canonical per-link series key: ``st_link_..._total{link="3"}``."""
    return label_key(name, "link", link)


def shard_key(name: str, shard: int) -> str:
    """Canonical per-shard series key: ``st_shard_...{shard="2"}``."""
    return label_key(name, "shard", shard)
