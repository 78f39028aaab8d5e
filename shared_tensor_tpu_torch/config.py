"""Configuration for the PyTorch/CUDA port.

Only what the port reads: the codec (scale policy, per-leaf scales,
idle-frame suppression, the engine's cascade depth), the TCP transport,
the peer's send loop and burst sizes, and the native engine switch. Names,
defaults and meaning are those of ``shared_tensor_tpu.config``, so a port
peer and a JAX peer built from the same settings produce the same frames
and join the same tree. Knobs of features the port does not have (the
reference wire format, link striping, the shared-memory lane, adaptive
precision (sign2), fault injection, observability, serving, lifecycle,
sharding) are absent, so asking for one is a ``TypeError``.
"""

from __future__ import annotations

import dataclasses
import enum


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

    def __post_init__(self):
        if not 1 <= self.max_children <= 16:
            raise ValueError(f"max_children must be in 1..16, got {self.max_children}")


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
