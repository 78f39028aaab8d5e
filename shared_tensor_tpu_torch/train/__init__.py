"""Training tier: async data-parallel SGD over the pod's compressed sync,
the counterpart of ``shared_tensor_tpu.train`` (its hierarchical trainer
is not ported yet)."""

from .async_sgd import PodTrainer, build_train_step

__all__ = ["PodTrainer", "build_train_step"]
