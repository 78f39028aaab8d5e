"""Workload models of the training story (BASELINE configs 2 and 4), the
counterparts of ``shared_tensor_tpu.models``: plain functions on parameter
pytrees whose layout is the JAX package's."""

from . import char_rnn, resnet
from .char_rnn import CharRNNConfig
from .resnet import ResNetConfig

__all__ = ["char_rnn", "resnet", "CharRNNConfig", "ResNetConfig"]
