"""Configuration for the PyTorch/CUDA port.

Only what the port reads: the codec (scale policy, per-leaf scales,
idle-frame suppression, adaptive sign2 precision and its governor, the
engine's cascade depth), the TCP transport (the reference wire format,
link striping and the same-host shared-memory lane among its knobs), the
peer's send loop and burst sizes, the native engine switch, fault
injection (``FaultConfig``) and the serving tier (``ServeConfig``). Names,
defaults and meaning are those of ``shared_tensor_tpu.config``, so a port
peer and a JAX peer built from the same settings produce the same frames
and join the same tree. Knobs of features the port does not have
(observability, lifecycle, sharding) are absent, so asking for one is a
``TypeError``.
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
