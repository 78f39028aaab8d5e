"""The serving tier: parameter subscription for inference fleets.

The counterpart of ``shared_tensor_tpu/serve``. Writers (``add``) stream
updates through the tree; fleets of inference replicas need fresh-enough
weights, not write access:

- :class:`Subscriber` is a read-only leaf. It says so in its SYNC
  (``SYNC_FLAG_READ_ONLY``), so a writer on any tier attaches its link
  unledgered: no ACK, no window, no re-send; a lost message is repaired by
  a re-seed over the control plane.
- ``Subscriber.read(max_staleness=...)`` verifies its bound against the
  trace stamps of what it applied and the writer's FRESH marks, and raises
  :class:`StalenessError` when it cannot: a read is never silently stale.
  ``wait_fresh(epoch)`` blocks until the state provably includes every
  update up to an :func:`epoch` token (one host's CLOCK_MONOTONIC).
- A range subscription (``ServeConfig.range``) receives RDATA, only its
  words of each frame, and buffers only its pages.
- :class:`ServingHandle` hot-swaps verified snapshots into torch tensors
  on the card for an inference loop: ``refresh()`` builds and swaps,
  ``params()`` is a lock-free reference read.
"""

from .handle import ServingHandle
from .subscriber import StalenessError, Subscriber, epoch, subscribe

__all__ = ["ServingHandle", "StalenessError", "Subscriber", "epoch", "subscribe"]
