"""shared-tensor-tpu on PyTorch and CUDA: the per-frame data plane of a
replicated, eventually consistent table of tensors (1-bit sign codec with
pow2-RMS per-leaf scales and error feedback), with hand-written CUDA
kernels for an NVIDIA H100.

A port of ``shared_tensor_tpu``: the same table layout, frames and wire
bytes, checked against that package by ``tests/test_torch_*.py``. This
package imports PyTorch and numpy only.
"""

from .config import CodecConfig, ScalePolicy
from .core import DuplicateLink, SharedTensor

__version__ = "0.1.0"

__all__ = ["CodecConfig", "DuplicateLink", "ScalePolicy", "SharedTensor", "__version__"]
