"""Codec configuration for the PyTorch/CUDA port.

Only what the per-frame data plane reads: the scale policy, per-leaf
scales and idle-frame suppression. The values and their meaning are those
of ``shared_tensor_tpu.config`` (``ScalePolicy``, ``CodecConfig``), so a
port peer and a JAX peer built from the same settings produce the same
frames.
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
