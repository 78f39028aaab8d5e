"""Runnable examples of the port (``python -m shared_tensor_tpu_torch.examples.<name>``)."""
