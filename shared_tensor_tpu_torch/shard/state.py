"""Shard-local state: owned slices, per-link residual slices, and
per-remote-shard outboxes, with a word-range slice codec.

The counterpart of ``shared_tensor_tpu/shard/state.py``, bit for bit, over
the port's own ``ops/codec_np`` layout and ``ops/codec.SAT``. Host numpy on
every tier, as JAX's is: a slice's word range is not aligned to the device
kernels' 128-element rows, and no TPU kernel computes it.

The memory contract this file carries: a sharded node allocates
O(owned slices) persistent state plus O(active outbox ranges) transient
state, NEVER the full table. Residuals stay shard-local: error feedback
for a subscriber link lives in a slice the size of the subscription;
error feedback for out-of-shard writes lives in a per-target-shard outbox
slice that drains to zero at quiesce and is freed once idle.

:class:`SliceCodec` is the 1-bit error-feedback codec restricted to a word
range of the GLOBAL table layout: scales are per GLOBAL leaf (the full-L
scale row RDATA/FWD carry, so subscribers and owners decode with the
unmodified serving machinery), bits cover only the range's words, and
quantize/apply are bit-compatible with codec_np and
``serve.Subscriber``'s apply over the same elements (value +=
scale[leaf] * (1 - 2*bit) on live lanes, ±SAT saturation, padding
untouched).

A node may own SEVERAL shards (a drain-handoff leaves the successor with
two); ``owned`` is keyed by shard index and every receive/serve path
routes by word range.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..config import ScalePolicy
from ..ops.codec import SAT as _SAT
from ..ops.codec_np import _layout, _pow2_floor as _pow2_floor_np
from ..ops.table import TableSpec


class SliceCodec:
    """1-bit sign codec over ``[word_lo, word_lo + word_cnt)`` of a global
    table spec. Precomputes the range's leaf geometry once; quantize and
    apply are then two-pass numpy over the slice only."""

    def __init__(self, spec: TableSpec, word_lo: int, word_cnt: int):
        words = spec.total // 32
        if not (0 <= word_lo and 0 < word_cnt and word_lo + word_cnt <= words):
            raise ValueError(
                f"slice [{word_lo}, {word_lo + word_cnt}) outside the "
                f"{words}-word table"
            )
        self.spec = spec
        self.word_lo = int(word_lo)
        self.word_cnt = int(word_cnt)
        self.elo = self.word_lo * 32
        self.n_el = self.word_cnt * 32
        offs, ns, padded = _layout(spec)
        bounds = np.cumsum(padded)
        el = np.arange(self.elo, self.elo + self.n_el)
        #: global leaf index per slice element (the RDATA/FWD scale row is
        #: indexed by GLOBAL leaf, serve/subscriber.py's geometry)
        self.leaf_of = np.searchsorted(bounds, el, side="right").astype(
            np.int64
        )
        starts = offs[self.leaf_of]
        #: 1.0 on live (non-padding) elements, 0.0 on padding
        self.live = ((el - starts) < ns[self.leaf_of]).astype(np.float32)
        #: distinct global leaves intersecting the range, with their slice
        #: bounds and live counts — the per-leaf scale segments
        self.segments: list[tuple[int, int, int, float]] = []
        uniq, first = np.unique(self.leaf_of, return_index=True)
        for g, i0 in zip(uniq, first):
            i1 = int(np.searchsorted(self.leaf_of, g, side="right"))
            n_live = float(self.live[int(i0) : i1].sum())
            self.segments.append((int(g), int(i0), i1, n_live))

    def zeros(self) -> np.ndarray:
        return np.zeros(self.n_el, np.float32)

    def measure(
        self,
        resid: np.ndarray,
        policy: ScalePolicy = ScalePolicy.POW2_RMS,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-segment scale measurement: (scales f32[L] — zero outside
        the range's leaves, amax f32[L]). Reductions accumulate EXACT f64
        products (f32->f64 squares are exact, so the only inexactness is
        the accumulation order) — the engine-tier twin (stengine.cpp
        slice_measure) sums the same doubles with interleaved
        accumulators, and the f32-cast results agree to the last bit in
        practice (the parity test pins it on shared random state). Like
        the main codec, subnormal rms pow2-floors to 0, so residual dust
        below ~1.2e-38 reads as idle (the documented drain caveat)."""
        L = self.spec.num_leaves
        scales = np.zeros(L, np.float32)
        amaxes = np.zeros(L, np.float32)
        for g, i0, i1, n_live in self.segments:
            if n_live <= 0:
                continue
            seg = resid[i0:i1]
            amax = np.float32(np.max(np.abs(seg)))
            if not (amax > 0) or not np.isfinite(amax):
                continue
            amaxes[g] = amax
            seg64 = seg.astype(np.float64)
            if policy == ScalePolicy.ABS_MEAN:
                s = np.float32(
                    np.sum(np.abs(seg64)) / np.float32(n_live)
                )
            else:
                rms = np.float32(
                    np.sqrt(np.sum(seg64 * seg64) / np.float32(n_live))
                )
                s = (
                    _pow2_floor_np(rms)[()]
                    if policy == ScalePolicy.POW2_RMS
                    else rms
                )
            scales[g] = s if np.isfinite(s) else 0.0
        return scales, amaxes

    def quantize_at(
        self, resid: np.ndarray, scales: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pack + error-feedback one frame at a GIVEN scale row (the
        cascade rung): (words u32[word_cnt], new_resid). The caller owns
        the schedule; an all-zero row is the caller's stop condition.
        Padding lanes pack as 0 bits (the stcodec cascade loop's
        convention, which the engine lane rides; receivers mask by
        ``live`` either way, so only the parity bytes care)."""
        s_el = scales[self.leaf_of] * self.live
        neg = (resid <= 0) & (self.live > 0)
        words = (
            np.packbits(neg, bitorder="little").view("<u4").astype(np.uint32)
        )
        sent = np.where(neg, -s_el, s_el)
        new_r = np.where(s_el > 0, resid - sent, resid).astype(np.float32)
        new_r *= self.live  # padding stays exactly 0
        return words, new_r

    def cascade_rows(
        self, scales: np.ndarray, amaxes: np.ndarray, k: int
    ) -> list[np.ndarray]:
        """The engine's cascade schedule restricted to this slice: frame 0's
        row anchors each segment at max(policy scale, pow2_floor(amax))
        (the amax anchor is what drains OUTLIERS geometrically; an
        rms-anchored ladder starves the gaussian tail), and
        rows 1..k-1 halve, +8 refinement rungs below the measured
        scale (finer lattice for the next message's measured frame to
        terminate on), stopping at the subnormal floor. Exponent math is
        integer (f32 bit fields), so the engine twin is bit-identical."""
        if not scales.any():
            return []
        tops = np.where(scales > 0, _pow2_floor_np(amaxes), 0.0).astype(
            np.float32
        )
        row0 = np.maximum(scales, tops).astype(np.float32)
        # ladder depth: binades from the anchor down to the measured
        # scale (+1), +8 refinement; collapses to 1 when anchor == scale
        exp = lambda x: (  # noqa: E731 — biased f32 exponents, vectorized
            ((np.asarray(x, np.float32).view(np.uint32) >> 23) & 0xFF)
            .astype(np.int64)
        )
        nz = scales > 0
        d = int(np.max(np.where(nz, exp(tops) - exp(scales), 0), initial=0))
        maxd = d + 1 + (8 if d > 0 else 0)
        rows = []
        row = row0
        for j in range(min(max(1, k), maxd)):
            if j > 0:
                row = (row * np.float32(0.5)).astype(np.float32)
                if not row.any():
                    break  # halved into the subnormal floor
            rows.append(row)
        return rows

    def quantize(
        self,
        resid: np.ndarray,
        policy: ScalePolicy = ScalePolicy.POW2_RMS,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One measured sender step (the serving tier's shape): (scales,
        words, new_resid); all-zero scales = idle (residual returned
        unchanged). The FWD outbox drain uses measure + cascade_rows +
        quantize_at instead — one measurement per message."""
        scales, _amax = self.measure(resid, policy)
        if not scales.any():
            return scales, np.zeros(self.word_cnt, np.uint32), resid
        words, new_r = self.quantize_at(resid, scales)
        return scales, words, new_r

    def apply(
        self, target: np.ndarray, scales: np.ndarray, words: np.ndarray
    ) -> bool:
        """Receiver step IN PLACE: target += scale[leaf]*(1-2*bit) on live
        lanes, saturated at ±SAT. Returns False for an all-zero-scale
        no-op. Bit-compatible with serve.Subscriber._apply_frame."""
        if not np.asarray(scales).any():
            return False
        bits = np.unpackbits(
            np.ascontiguousarray(words, "<u4").view(np.uint8),
            bitorder="little",
        ).astype(np.float32)
        s_el = np.asarray(scales, np.float32)[self.leaf_of] * self.live
        target += s_el * (1.0 - 2.0 * bits)
        np.clip(target, -_SAT, _SAT, out=target)
        return True


class ShardState:
    """One sharded node's resident arrays, under one lock:

    - ``owned``: shard index -> (codec, values slice) for every shard
      this node currently owns;
    - ``sub_resid``: per-subscriber-link (codec, residual slice) — error
      feedback for the serve tier, sized to each subscription;
    - ``outbox``: per-target-shard (codec, residual slice) for
      OUT-of-shard writes (error feedback for the FWD plane), allocated
      lazily on the first write toward a shard and freed once drained.

    All mutation happens under ``_lock``; snapshots copy. ``alloc_bytes``
    is the per-node memory bound the chaos harness enforces (the
    acceptance gate's rss/alloc bound)."""

    def __init__(self, spec: TableSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self.owned: dict[int, tuple[SliceCodec, np.ndarray]] = {}
        self.sub_resid: dict[int, tuple[SliceCodec, np.ndarray]] = {}
        self.outbox: dict[int, tuple[SliceCodec, np.ndarray]] = {}
        self.updates = 0
        self.applies = 0

    # -- ownership -----------------------------------------------------------

    def adopt(
        self,
        shard: int,
        word_lo: int,
        word_cnt: int,
        values: Optional[np.ndarray] = None,
    ) -> None:
        with self._lock:
            c = SliceCodec(self.spec, word_lo, word_cnt)
            if values is not None:
                v = np.asarray(values, np.float32)
                if v.shape != (c.n_el,):
                    raise ValueError(
                        f"adopt: values shape {v.shape} != ({c.n_el},)"
                    )
                self.owned[shard] = (c, v.copy())
            else:
                self.owned[shard] = (c, c.zeros())
            # adopting a shard supersedes any outbox we held toward its
            # previous owner: fold the owed mass straight into the slice
            # (we ARE the owner now — exact local apply)
            ob = self.outbox.pop(shard, None)
            if ob is not None:
                _oc, r = ob
                v = self.owned[shard][1]
                np.clip(v + r, -_SAT, _SAT, out=v)

    def release(self, shard: int) -> Optional[np.ndarray]:
        """Drop ownership of one shard (handoff tail): returns the slice
        and drops subscriber residuals inside it (those links resync
        against the new owner)."""
        with self._lock:
            ent = self.owned.pop(shard, None)
            if ent is None:
                return None
            c, vals = ent
            for link in [
                l
                for l, (sc, _r) in self.sub_resid.items()
                if c.word_lo <= sc.word_lo < c.word_lo + c.word_cnt
            ]:
                self.sub_resid.pop(link, None)
            return vals

    def owned_entry(self, shard: int):
        with self._lock:
            return self.owned.get(shard)

    def owns(self, shard: int) -> bool:
        with self._lock:
            return shard in self.owned

    def owned_words(self) -> int:
        with self._lock:
            return sum(c.word_cnt for c, _v in self.owned.values())

    # -- write paths ---------------------------------------------------------

    def add_delta(
        self, shard: int, codec_fn, elo: int, delta: np.ndarray
    ) -> bool:
        """Apply an in-shard delta exactly OR deposit it into the shard's
        outbox — decided and written under ONE lock acquisition, so a
        caller-thread ``add()`` cannot race the loop thread's ``adopt()``/
        ``release()`` into a stranded outbox (adopt folds outboxes under
        this same lock) or a spurious does-not-own raise. ``codec_fn``
        builds the outbox SliceCodec lazily (owned applies never need
        one). Returns True iff the delta landed in the outbox (the
        caller's pre-coalesce deposit twins key on the decision this
        lock made, not on a racy owns() re-check)."""
        with self._lock:
            if shard in self.owned:
                self._add_in_shard_locked(shard, elo, delta)
                return False
            self._add_outbox_locked(shard, codec_fn(), elo, delta)
            return True

    def add_in_shard(self, shard: int, elo: int, delta: np.ndarray) -> None:
        """Apply an in-shard delta slice [elo, elo+len) — exact f32, no
        codec (local applies are exact; only LINKS quantize). Also feeds
        every overlapping subscriber residual."""
        with self._lock:
            self._add_in_shard_locked(shard, elo, delta)

    def _add_in_shard_locked(
        self, shard: int, elo: int, delta: np.ndarray
    ) -> None:
        ent = self.owned.get(shard)
        if ent is None:
            raise RuntimeError(f"node does not own shard {shard}")
        c, vals = ent
        i0 = elo - c.elo
        if i0 < 0 or i0 + delta.size > c.n_el:
            raise ValueError(
                f"delta [{elo}, {elo + delta.size}) outside owned "
                f"slice [{c.elo}, {c.elo + c.n_el})"
            )
        d = np.asarray(delta, np.float32) * c.live[i0 : i0 + delta.size]
        np.clip(
            vals[i0 : i0 + delta.size] + d,
            -_SAT,
            _SAT,
            out=vals[i0 : i0 + delta.size],
        )
        self.updates += 1
        self._feed_subs(elo, d)

    def _feed_subs(self, elo: int, d: np.ndarray) -> None:
        """Accumulate an applied delta into overlapping subscriber
        residuals (caller holds the lock)."""
        for sc, r in self.sub_resid.values():
            j0 = elo - sc.elo
            lo = max(0, j0)
            hi = min(sc.n_el, j0 + d.size)
            if lo < hi:
                r[lo:hi] += d[lo - j0 : hi - j0]

    def add_outbox(
        self, shard: int, codec: SliceCodec, elo: int, delta: np.ndarray
    ) -> None:
        """Accumulate an out-of-shard delta slice into shard's outbox
        (allocating it lazily)."""
        with self._lock:
            self._add_outbox_locked(shard, codec, elo, delta)

    def _add_outbox_locked(
        self, shard: int, codec: SliceCodec, elo: int, delta: np.ndarray
    ) -> None:
        ob = self.outbox.get(shard)
        if ob is None:
            ob = (codec, codec.zeros())
            self.outbox[shard] = ob
        c, r = ob
        i0 = elo - c.elo
        if i0 < 0 or i0 + delta.size > c.n_el:
            raise ValueError(
                f"delta [{elo}, {elo + delta.size}) outside shard "
                f"{shard}'s range [{c.elo}, {c.elo + c.n_el})"
            )
        r[i0 : i0 + delta.size] += (
            np.asarray(delta, np.float32) * c.live[i0 : i0 + delta.size]
        )
        self.updates += 1

    def drain_outbox_frames(
        self, shard: int, policy: ScalePolicy, k: int = 1
    ) -> Optional[tuple[list, int]]:
        """Quantize up to ``k`` cascade frames off a shard's outbox: ONE
        scale measurement per message, then the halving schedule
        (SliceCodec.cascade_rows: frame 0 amax-anchored, +8 refinement
        rungs), error feedback applied per frame, as the engine lane does
        at native speed (per-frame re-measurement costs a division per
        element per frame, and the measured sequence converges to the
        halving schedule anyway). Returns ([(scales, words), ...],
        word_lo) with 1..k frames, or None when idle; an idle outbox is
        FREED (the transient-memory contract)."""
        with self._lock:
            ob = self.outbox.get(shard)
            if ob is None:
                return None
            c, r = ob
            scales, amaxes = c.measure(r, policy)
            rows = c.cascade_rows(scales, amaxes, k)
            frames = []
            for row in rows:
                words, r = c.quantize_at(r, row)
                frames.append((row, words))
            if not frames:
                self.outbox.pop(shard, None)  # drained to dust: free it
                return None
            self.outbox[shard] = (c, r)
            return frames, c.word_lo

    def outbox_shards(self) -> list[int]:
        with self._lock:
            return list(self.outbox)

    def restore_outbox(
        self, shard: int, codec: SliceCodec, resid: np.ndarray
    ) -> None:
        """Re-seat a checkpointed outbox residual (restart path): the owed
        out-of-shard mass survives the restart and drains normally once a
        route exists."""
        with self._lock:
            r = np.asarray(resid, np.float32)
            if r.shape != (codec.n_el,):
                raise ValueError(
                    f"outbox residual shape {r.shape} != ({codec.n_el},)"
                )
            prev = self.outbox.get(shard)
            if prev is not None:
                r = r + prev[1]
            self.outbox[shard] = (codec, r.copy())

    # -- receive path --------------------------------------------------------

    def apply_owned(
        self, scales: np.ndarray, words: np.ndarray, word_lo: int
    ) -> bool:
        """Apply a FWD frame addressed to an owned shard: the slice and
        every overlapping subscriber residual move together (the
        split-horizon analog for the serve tier). False when no owned
        shard starts at ``word_lo``."""
        with self._lock:
            for c, vals in self.owned.values():
                if c.word_lo == word_lo:
                    changed = c.apply(vals, scales, words)
                    if changed:
                        self.applies += 1
                        for sc, r in self.sub_resid.values():
                            if (
                                sc.word_lo >= c.word_lo
                                and sc.word_lo + sc.word_cnt
                                <= c.word_lo + c.word_cnt
                            ):
                                i0 = sc.word_lo - c.word_lo
                                sc.apply(
                                    r,
                                    scales,
                                    words[i0 : i0 + sc.word_cnt],
                                )
                    return changed
            return False

    # -- serve tier ----------------------------------------------------------

    def attach_sub(self, link: int, word_lo: int, word_cnt: int) -> np.ndarray:
        """Open (or re-seed) a subscriber link's residual slice; returns
        the CURRENT values for the range (the seed snapshot) — taken and
        attached under ONE lock so no add can fall between them."""
        with self._lock:
            for c, vals in self.owned.values():
                if (
                    c.word_lo <= word_lo
                    and word_lo + word_cnt <= c.word_lo + c.word_cnt
                ):
                    sc = SliceCodec(self.spec, word_lo, word_cnt)
                    self.sub_resid[link] = (sc, sc.zeros())
                    i0 = (word_lo - c.word_lo) * 32
                    return vals[i0 : i0 + word_cnt * 32].copy()
            raise ValueError(
                f"subscription [{word_lo}, {word_lo + word_cnt}) not "
                f"within any owned shard"
            )

    def drop_sub(self, link: int) -> None:
        with self._lock:
            self.sub_resid.pop(link, None)

    def sub_frame(
        self, link: int, policy: ScalePolicy
    ) -> Optional[tuple[np.ndarray, np.ndarray, int, int]]:
        """Quantize one RDATA frame off a subscriber link's residual.
        None = idle or unknown link."""
        with self._lock:
            ob = self.sub_resid.get(link)
            if ob is None:
                return None
            sc, r = ob
            scales, words, new_r = sc.quantize(r, policy)
            if not scales.any():
                return None
            self.sub_resid[link] = (sc, new_r)
            return scales, words, sc.word_lo, sc.word_cnt

    def sub_idle(self, link: int) -> bool:
        """True when the link's residual is exactly drained (safe to
        FRESH-mark: only a drained link is marked)."""
        with self._lock:
            ob = self.sub_resid.get(link)
            if ob is None:
                return True
            return not np.any(ob[1])

    # -- snapshots / accounting ----------------------------------------------

    def snapshot_owned(self) -> dict[int, tuple[int, int, np.ndarray]]:
        """{shard: (word_lo, word_cnt, values copy)} of every owned
        slice."""
        with self._lock:
            return {
                k: (c.word_lo, c.word_cnt, v.copy())
                for k, (c, v) in self.owned.items()
            }

    def snapshot_outboxes(self) -> dict[int, tuple[int, np.ndarray]]:
        """{shard: (word_lo, residual copy)} for every live outbox."""
        with self._lock:
            return {
                k: (c.word_lo, r.copy()) for k, (c, r) in self.outbox.items()
            }

    def outbox_bytes(self) -> int:
        """Resident outbox residual bytes (the admission-control gauge
        that ShardConfig.outbox_limit_bytes bounds)."""
        with self._lock:
            return sum(r.nbytes for _, r in self.outbox.values())

    def outbox_backlog_by_shard(self) -> dict[int, int]:
        """{shard: nonzero residual bytes}: the LIVE backlog destined to
        each shard (drains to 0 at quiesce, unlike the resident-bytes
        gauge above). The per-shard heat numerator: one nonzero scan per
        outbox per digest beat, off the hot path."""
        with self._lock:
            return {
                k: int(np.count_nonzero(r)) * 4
                for k, (_, r) in self.outbox.items()
            }

    def outboxes_idle(self, tol: float = 0.0) -> bool:
        with self._lock:
            return all(
                float(np.max(np.abs(r), initial=0.0)) <= tol
                for _, r in self.outbox.values()
            )

    def alloc_bytes(self) -> int:
        """Resident f32 state bytes: owned slices + subscriber residuals +
        live outboxes, the number the chaos harness bounds per node."""
        with self._lock:
            total = 0
            for _, v in self.owned.values():
                total += v.nbytes
            for _, r in self.sub_resid.values():
                total += r.nbytes
            for _, r in self.outbox.values():
                total += r.nbytes
            return total
