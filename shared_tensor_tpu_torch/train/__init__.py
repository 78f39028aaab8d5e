"""Training tier: async data-parallel SGD over the pod's compressed sync,
and pods bridged over the TCP peer tree; the counterpart of
``shared_tensor_tpu.train``."""

from .async_sgd import PodTrainer, build_train_step
from .hierarchical import HierarchicalTrainer

__all__ = ["PodTrainer", "build_train_step", "HierarchicalTrainer"]
