"""ResNet-18: the async-DP benchmark arm model (BASELINE config 4: "ResNet-18
data-parallel async SGD, 8 peers, compressed-delta vs exact allreduce"), in
PyTorch.

The counterpart of ``shared_tensor_tpu/models/resnet.py``, on the same
parameter pytree: conv weights keep JAX's HWIO shapes and images come in
NHWC, so the table's layout is the JAX package's. :func:`forward` permutes
inside, to NCHW activations and OIHW weights for ``conv2d``.

- Convs as in JAX: both operands rounded to bf16, the sum in f32, the
  result rounded to bf16 and cast to f32 (JAX's bf16 conv returns bf16).
  Here the rounded operands are convolved in f32, so the CPU and the GPU
  compute the same function (on the GPU cuDNN may use TF32, which holds
  bf16 operands exactly).
- ``padding="SAME"``: the output is ceil(n / stride) and the padding is
  split with the odd pixel at the END, so stride 2 on an even input pads
  (0, 1) and the 7x7 stride-2 stem pads (2, 3); the max pool pads with -inf
  the same way.
- BatchNorm uses the current batch's statistics (population variance): a
  pure function of (params, batch), every learnable tensor in the table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..core import resolve_device
from .char_rnn import _bf16, _mm, _to


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stages: tuple[int, ...] = (2, 2, 2, 2)  # ResNet-18: two basic blocks per stage
    width: int = 64
    classes: int = 10
    stem_kernel: int = 3
    stem_stride: int = 1
    stem_pool: bool = False  # True for the ImageNet 7x7/s2 + max-pool stem


def _conv_init(gen, kh, kw, cin, cout) -> torch.Tensor:
    return torch.randn((kh, kw, cin, cout), generator=gen) * math.sqrt(2.0 / (kh * kw * cin))


def init_params(generator: torch.Generator, cfg: ResNetConfig, device=None) -> dict:
    """Parameter pytree drawn from ``generator`` (a CPU generator);
    ``device=None`` is the GPU. Each block's last norm scale starts at 0,
    so every block starts as the identity."""
    dev = resolve_device(device)
    w = cfg.width
    params: dict[str, Any] = {
        "stem": {
            "conv": _conv_init(generator, cfg.stem_kernel, cfg.stem_kernel, 3, w),
            "scale": torch.ones(w),
            "bias": torch.zeros(w),
        }
    }
    blocks = []
    cin = w
    for si, depth in enumerate(cfg.stages):
        cout = w * 2**si
        for bi in range(depth):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {
                "conv1": _conv_init(generator, 3, 3, cin, cout),
                "scale1": torch.ones(cout),
                "bias1": torch.zeros(cout),
                "conv2": _conv_init(generator, 3, 3, cout, cout),
                "scale2": torch.zeros(cout),
                "bias2": torch.zeros(cout),
            }
            if stride != 1 or cin != cout:
                blk["proj"] = _conv_init(generator, 1, 1, cin, cout)
            blocks.append(blk)
            cin = cout
    params["blocks"] = blocks
    params["head"] = {
        "w": torch.randn((cin, cfg.classes), generator=generator) * (1.0 / math.sqrt(cin)),
        "b": torch.zeros(cfg.classes),
    }
    return _to(params, dev)


def same_padding(n: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of XLA's ``"SAME"`` for size ``n``, window
    ``k`` and ``stride``: output ceil(n / stride), the odd pixel after."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    ph = same_padding(x.shape[2], k, stride)
    pw = same_padding(x.shape[3], k, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW x, HWIO w -> NCHW f32: bf16 operands, SAME padding, the result
    rounded to bf16."""
    w = _bf16(w_hwio).permute(3, 2, 0, 1)  # OIHW
    out = F.conv2d(_pad_same(_bf16(x), w_hwio.shape[0], stride), w, stride=stride)
    return _bf16(out)


def _bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Batch statistics over (N, H, W); f32 throughout."""
    mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=(0, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * scale[None, :, None, None] + bias[None, :, None, None]


def forward(params: Any, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """f32[N, H, W, 3] -> logits f32[N, classes]."""
    x = _conv(images.permute(0, 3, 1, 2), params["stem"]["conv"], cfg.stem_stride)
    x = torch.relu(_bn(x, params["stem"]["scale"], params["stem"]["bias"]))
    if cfg.stem_pool:
        x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, 2)
    bi = 0
    for si, depth in enumerate(cfg.stages):
        for b in range(depth):
            blk = params["blocks"][bi]
            stride = 2 if (si > 0 and b == 0) else 1
            y = torch.relu(_bn(_conv(x, blk["conv1"], stride), blk["scale1"], blk["bias1"]))
            y = _bn(_conv(y, blk["conv2"]), blk["scale2"], blk["bias2"])
            sc = _conv(x, blk["proj"], stride) if "proj" in blk else x
            x = torch.relu(sc + y)
            bi += 1
    x = torch.mean(x, dim=(2, 3))  # global average pool
    return _mm(x, params["head"]["w"]) + params["head"]["b"]


def loss_fn(params: Any, batch: tuple[torch.Tensor, torch.Tensor], cfg: ResNetConfig) -> torch.Tensor:
    """Mean softmax cross-entropy; ``batch`` = (images f32[N, H, W, 3],
    labels int[N])."""
    images, labels = batch
    logp = torch.log_softmax(forward(params, images, cfg), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()
