"""shared-tensor-tpu on PyTorch and CUDA: a replicated, eventually
consistent table of tensors (1-bit sign codec with pow2-RMS per-leaf
scales and error feedback) synced over a self-organising TCP tree, with
hand-written CUDA kernels for an NVIDIA H100.

    peer = create_or_fetch("127.0.0.1", 50000, template)  # master or joiner
    peer.add(delta)
    state = peer.read()

A port of ``shared_tensor_tpu``: the same table layout, frames and wire
bytes, so JAX and PyTorch peers share one tree; checked against that
package by ``tests/test_torch_*.py``. This package imports PyTorch and
numpy only.
"""

from .comm.peer import SharedTensorPeer, SpecMismatch, create_or_fetch
from .config import CodecConfig, Config, ScalePolicy, TransportConfig
from .core import DuplicateLink, SharedTensor

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "Config",
    "DuplicateLink",
    "ScalePolicy",
    "SharedTensor",
    "SharedTensorPeer",
    "SpecMismatch",
    "TransportConfig",
    "__version__",
    "create_or_fetch",
]
