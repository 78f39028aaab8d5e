"""Reader-side async all-gather over owner shards.

The counterpart of ``shared_tensor_tpu/shard/gather.py``, over the port's
``serve.Subscriber``. A sharded cluster has no node holding the full
table, so a reader assembles its view from the owners directly: one
ranged read-only subscription per shard (serve/subscriber.py: unledgered
stream, seq-gap resync, verified freshness), running CONCURRENTLY so the gather is an
async all-gather rather than a sequential walk. ``read()`` stitches the
per-shard pages into one flat array and verifies EVERY shard's staleness
bound: a gather is only as fresh as its stalest shard, and the serving
contract ("fresh enough or loud", serve.StalenessError) holds per shard
and therefore for the whole view.

Partial views (``ShardGather(..., elements=(lo, hi))``) subscribe only to
the covering shards: embedding and page reads touch exactly the owners
they need.

Capacity caveat: a subscription must land on ONE SPECIFIC owner, but the
transport redirects joiners down the tree once a node's child slots fill
(harmless for classic full-replica subscriptions, fatal here: the
redirect target rejects the out-of-shard range loudly). ShardConfig
.max_children therefore defaults near the transport cap; an owner whose
slots are saturated by writers + subscribers will refuse further gather
legs rather than silently serve the wrong range.

The per-read verified staleness lands in the
``st_shard_gather_staleness_seconds`` histogram (obs/schema.py), the
read-path twin of the writer's FWD counters. ``ShardHandle.torch_view``
copies one verified read to the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Optional

import numpy as np

from .. import obs as _obs
from ..config import Config
from ..serve.subscriber import StalenessError, Subscriber
from .map import ShardMap

__all__ = ["ShardGather", "StalenessError"]

#: distinguishes concurrent gathers' registries at the process obs hub
_GATHER_IDS = itertools.count(1)


@dataclasses.dataclass
class _Leg:
    shard: int
    elo: int
    ehi: int
    sub: Subscriber


class ShardGather:
    """One reader's set of per-owner subscriptions (see module docstring).

    ``source`` is a :class:`~shared_tensor_tpu_torch.shard.map.ShardMap`, a map
    document (``ShardNode.map_doc()``), or a ``ShardNode`` (its live map).
    Every targeted shard must have a granted owner — gathering an
    unowned shard raises at once (there is nothing to subscribe to).
    """

    def __init__(
        self,
        source: Any,
        template: Any,
        config: Config | None = None,
        elements: Optional[tuple[int, int]] = None,
        timeout: float = 30.0,
    ):
        from .node import ShardNode  # local: avoid a cycle at import time

        if isinstance(source, ShardNode):
            m = source.map
            if m is None:
                raise RuntimeError("node has no shard map yet")
        elif isinstance(source, ShardMap):
            m = source
        else:
            m = ShardMap.from_doc(dict(source))
        self.map = m
        self.config = config or Config()
        self._template = template
        total = m.total_words * 32
        if elements is None:
            self._elo, self._ehi = 0, total
        else:
            lo, hi = elements
            if not (0 <= lo < hi <= total):
                raise ValueError(
                    f"gather range [{lo}, {hi}) outside the {total}-element "
                    f"table"
                )
            self._elo, self._ehi = lo, hi
        self._obs_on = _obs.obs_enabled() and self.config.obs.enabled
        self._reg = _obs.Registry()
        self._m_staleness = self._reg.histogram(
            "st_shard_gather_staleness_seconds",
            buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0),
            help="stalest-shard verified staleness per assembled gather",
        )
        # published to the process hub as ShardNode and Subscriber are:
        # unregistered, the gather-staleness series would be invisible to
        # obs.top, digests and scrapes
        self._hub = _obs.hub() if self._obs_on else None
        self._label = f"shard-gather-{next(_GATHER_IDS)}"
        if self._hub is not None:
            self._hub.register_registry(self._label, self._reg)
        self.legs: list[_Leg] = []
        try:
            for k in range(m.n_shards):
                s_lo, s_hi = m.element_range(k)
                lo = max(s_lo, self._elo)
                hi = min(s_hi, self._ehi)
                if lo >= hi:
                    continue  # shard outside the requested view
                e = m.owner_of_shard(k)
                if e is None:
                    raise RuntimeError(
                        f"shard {k} has no granted owner — nothing to "
                        f"subscribe to"
                    )
                cfg = dataclasses.replace(
                    self.config,
                    serve=dataclasses.replace(
                        self.config.serve, range=(lo, hi)
                    ),
                )
                self.legs.append(
                    _Leg(k, lo, hi, Subscriber(e.host, e.port, template, cfg))
                )
            deadline = time.monotonic() + timeout
            for leg in self.legs:
                leg.sub.wait_ready(max(0.1, deadline - time.monotonic()))
        except BaseException:
            self.close()
            raise

    def read(
        self, max_staleness: Optional[float] = None
    ) -> tuple[np.ndarray, float]:
        """(flat f32 view of [elo, ehi), worst verified staleness): every
        shard's bound verified, or :class:`StalenessError` (the gather
        refuses rather than stitch a stale shard in silently)."""
        out = np.zeros(self._ehi - self._elo, np.float32)
        worst = 0.0
        for leg in self.legs:
            flat, staleness, _ver = leg.sub.read_flat(max_staleness)
            worst = max(worst, staleness)
            # the subscription is word-aligned (outward-rounded); slice
            # the requested element window back out of the page
            p_lo, p_hi = leg.sub.range_elements
            i0 = leg.elo - p_lo
            out[leg.elo - self._elo : leg.ehi - self._elo] = flat[
                i0 : i0 + (leg.ehi - leg.elo)
            ]
        if self._obs_on:
            self._m_staleness.observe(worst)
        return out, worst

    def read_tree(self, max_staleness: Optional[float] = None) -> Any:
        """The full table as the caller's pytree structure (full-table
        gathers only)."""
        if (self._elo, self._ehi) != (0, self.map.total_words * 32):
            raise ValueError("read_tree needs a full-table gather")
        from ..ops.codec_np import unflatten_np
        from ..ops.table import make_spec

        flat, _worst = self.read(max_staleness)
        return unflatten_np(flat, make_spec(self._template))

    @property
    def range_elements(self) -> tuple[int, int]:
        return self._elo, self._ehi

    def staleness(self) -> float:
        """Worst staleness across the legs (inf before first verify)."""
        return max(
            (leg.sub.staleness() for leg in self.legs), default=float("inf")
        )

    def metrics(self) -> dict:
        return self._reg.snapshot()

    def close(self) -> None:
        if self._hub is not None:
            self._hub.unregister_registry(self._label)
            self._hub = None
        for leg in self.legs:
            try:
                leg.sub.close()
            except Exception:
                pass
        self.legs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
