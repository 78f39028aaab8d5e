"""ServingHandle: hot-swap publication of verified weights into an
inference loop, as torch tensors on the card.

The counterpart of ``shared_tensor_tpu/serve/handle.py``, whose ``as_jax``
builds JAX arrays: this one builds torch tensors on ``device`` (None: the
GPU, which raises without one; ``device="cpu"`` for the CPU).
``params()`` is a plain reference read (lock-free, never touches the
subscriber's apply, the transport or any data-plane lock), and
``refresh()`` swaps a new verified snapshot in underneath it. A model
server calls ``refresh`` on its own schedule while writers stream updates
through the tree; a request in flight keeps the tensors it started with.

``refresh`` builds NEW tensors every time it swaps: the snapshot goes to
the card with a blocking copy, and the reference is swapped only once it
has returned, so a forward pass on any stream or thread that reads
``params()`` after the swap sees finished data. It never writes into
tensors that an earlier ``params()`` returned.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..core import resolve_device
from ..ops.table import unflatten
from .subscriber import Subscriber


class ServingHandle:
    """Hot-swap view of a :class:`Subscriber` for an inference loop."""

    def __init__(self, sub: Subscriber, max_staleness: Optional[float] = None, device=None):
        self._sub = sub
        self._bound = max_staleness
        self.device = resolve_device(device)
        self._params: Any = None
        self._version = -1
        self._staleness = float("inf")
        self._at = 0.0
        self._swaps = 0
        # refresh() may run on several serving threads: the (version check,
        # rebuild, swap) sequence runs once per version
        self._mu = threading.Lock()

    def params(self) -> Any:
        """The current published params: the template's tree of tensors on
        the handle's device (for a range, the page array as one 1-D tensor),
        or None before the first refresh. A lock-free reference read."""
        return self._params

    @property
    def version(self) -> int:
        return self._version

    @property
    def staleness(self) -> float:
        """The current params' verified staleness at their last refresh plus
        the time since: the bound a request served now gets."""
        return self._staleness + (time.monotonic() - self._at)

    @property
    def swaps(self) -> int:
        """How many times refresh() swapped new weights in."""
        return self._swaps

    def refresh(self, max_staleness: Optional[float] = None) -> bool:
        """Verify and swap: take the subscriber's latest snapshot, verify its
        staleness bound (else raise ``StalenessError``: a serving loop fails
        loudly rather than serve stale weights) and publish it. True when
        new weights were swapped in, False when the state had not moved
        (params untouched; the freshness clock advances either way)."""
        bound = self._bound if max_staleness is None else max_staleness
        with self._mu:
            # one acquire: array, staleness and version belong together
            flat, staleness, ver = self._sub.read_flat(bound)
            self._staleness = staleness
            self._at = time.monotonic()
            if ver == self._version and self._params is not None:
                return False
            dev = self._to_device(flat)
            new = dev if self._sub._ranged else unflatten(dev, self._sub.spec)
            self._params = new  # the swap: in-flight readers keep theirs
            self._version = ver
            self._swaps += 1
            return True

    def _to_device(self, flat: np.ndarray) -> torch.Tensor:
        """A new tensor on the device holding ``flat``, complete on return:
        a blocking copy, never an alias of the published snapshot."""
        return torch.from_numpy(flat).to(self.device, copy=True)
