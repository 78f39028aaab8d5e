"""SharedTensor on PyTorch: the process-local replica + per-link codec state.

The counterpart of ``shared_tensor_tpu/core.py``'s ``SharedTensor``: a full
replica ``values`` of a table of tensors plus one residual per tree link,
with the same link operations, in-flight ledger, frame calls and counters.
Two tiers, as in the JAX package:

- the device tier (the default): the codec runs on ``device`` (the GPU by
  default) through the kernels of ``ops/codec_cuda.py``; ``device="cpu"``
  runs their plain versions and exists for tests;
- the host tier (``host_tier=True``, the JAX package's numpy tier, which
  it selects with ``ST_HOST_CODEC``): replica and residuals are CPU
  tensors, and the codec is the C loops of ``native/stcodec.c``
  (``ops/codec_np.py``), run synchronously on zero-copy numpy views of
  them. Frames are numpy arrays from the start, with no fetch, and a
  burst is up to K halvings quantized in one call (``begin_frame_burst``).

A burst on either tier follows one of two schedules. ``cascade=1`` (the
default, and the JAX package's only one) re-measures the scales every
frame. ``cascade > 1`` is the native engine's: rounds of one measurement
and an amax-anchored halving ladder of up to ``cascade`` frames quantized
in one pass (``ops/table.quantize_table_cascade`` through kernel
A-cascade on the device tier, ``ops/codec_np.quantize_table_cascade_np``
through ``stc_quantize_ef_cascade`` on the host tier), so an outlier's
bound halves every frame instead of moving by one shrinking step. The
peer sets it from ``CodecConfig.cascade_frames``.

Where the JAX core swaps immutable arrays, this one updates its buffers in
place (as the TPU kernels' ``input_output_aliases`` do). So every buffer
it holds is its own: a link seeded from the replica, a residual handed in,
a re-graft that sets replica and residual to one carry, each gets a copy,
and ``read``/``snapshot_flat``/``snapshot_all`` return copies.

All state changes hold one mutex, as in the JAX core.

On a CUDA device the frame fetch is asynchronous: ``begin_frame`` and
``begin_frame_burst_device`` start the copy of the new frame into pinned
host buffers on a side stream that waits for the quantize, and
``finish_frame`` / ``finish_frame_burst`` wait only for that copy's own
event. So a sender that keeps several frames in flight (the peer's send
loop) overlaps their transfers with each other and with its host work.
The frame comes back as numpy views of the pinned tensors, with no copy
out. The pinned memory comes from PyTorch's caching host allocator: it
hands a block out again only once no array references it and the copies
recorded on it have completed, so a steady sender allocates no pinned
memory per frame (``cudaHostAlloc`` per frame would cost more than the
frame), and a fetch that is never finished (its link died) frees its
block safely. On the CPU the fetch is the plain synchronous copy.

On a CUDA device a link's K-frame burst (``begin_frame_burst_device``)
replays one CUDA graph, captured on that link's residual tensor, where the
eager burst launches some 30 operations a frame from the host: the JAX
device tier's one jitted dispatch per burst. The state lock is held
throughout a burst, so its host time is what every other state change of
the node waits for. A graph is captured again whenever the link's residual
is a new tensor (a new link, a re-graft).

On the CPU the same burst is the plain cascade, some 30 operations a
level run from Python: milliseconds for even a small table. So there it
quantizes off the lock. The burst takes the link's residual out under the
lock and leaves in its place a buffer of -0.0, into which every add,
apply, NACK or retraction meanwhile lands; then it quantizes the taken
residual with no lock held, and folds the buffer back into what remains
under the lock, where it takes its ledger entry. -0.0 is the identity of
IEEE addition (``-0.0 + x`` is ``x`` for every x, a signed zero
included), so a burst that nothing raced leaves the residual bit for bit
as the locked burst did. A call that reads or replaces a link's
residual whole (a drop, a carry, a snapshot, a mask, the link's next
frame) first waits for that link's burst to fold (:meth:`_settle`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .config import CodecConfig
from .ops import codec_cuda, codec_np
from .ops.codec import SAT
from .ops.packing import words_from_host, words_to_host
from .ops.table import (
    TableFrame,
    TableSpec,
    accumulate_table,
    apply_delta,
    apply_table_batch,
    apply_table_many,
    flatten,
    frames_delta,
    make_spec,
    quantize_table,
    quantize_table_burst,
    quantize_table_cascade,
    unflatten,
)
from .utils import locktrace
from .utils.timing import no_collection


class DuplicateLink(ValueError):
    """A link id that is already attached."""


class SnapshotPublisher:
    """Lock-free publication of snapshots, for the serving tier.

    The writer (a subscriber's receive thread) builds a new snapshot and
    publishes it (:meth:`publish`) as one reference swap; readers :meth:`acquire`
    the current (array, freshness ns, version) tuple, one attribute read
    (atomic under the GIL), so a read never waits for an apply and an
    apply never waits for a read. The writer hands over an array that it
    no longer changes (a copy): that copy is the double buffer."""

    __slots__ = ("_cur",)

    def __init__(self):
        self._cur: tuple = (None, 0, 0)  # (array, freshness_ns, version)

    def publish(self, array, freshness_ns: int, version: int) -> None:
        self._cur = (array, int(freshness_ns), int(version))

    def touch(self, freshness_ns: int) -> None:
        """Advance the freshness mark without a new array (an idle FRESH
        mark: the state did not change, only its verified age)."""
        arr, old, ver = self._cur
        if freshness_ns > old:
            self._cur = (arr, int(freshness_ns), ver)

    def acquire(self) -> tuple:
        """(array, freshness ns, version) of the latest publication; the
        array is None before the first."""
        return self._cur


def resolve_device(device=None, host_tier: bool = False) -> torch.device:
    """``None`` means the GPU, or the CPU for the host tier; raise if there
    is no GPU (never carry on on the CPU unasked) and for a host tier on
    anything but the CPU."""
    if host_tier:
        dev = torch.device("cpu" if device is None else device)
        if dev.type != "cpu":
            raise ValueError(f"the host tier runs on the CPU, not {str(dev)!r}")
        return dev
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' explicitly for the CPU")
    return dev


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _HostFetch:
    """A frame's device-to-host copy in flight: pinned host tensors filled on
    ``stream`` after everything already queued on the current stream (the
    quantize). The device tensors stay referenced, and marked as used on
    the side stream, until the copy's event has completed."""

    def __init__(self, scales: torch.Tensor, words: torch.Tensor, stream):
        self._src = (scales, words)
        self._dst = (
            torch.empty(scales.shape, dtype=scales.dtype, pin_memory=True),
            torch.empty(words.shape, dtype=words.dtype, pin_memory=True),
        )
        stream.wait_stream(torch.cuda.current_stream(scales.device))
        with torch.cuda.stream(stream):
            self._dst[0].copy_(scales, non_blocking=True)
            self._dst[1].copy_(words, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(stream)
        scales.record_stream(stream)
        words.record_stream(stream)

    def wait(self) -> tuple[np.ndarray, np.ndarray]:
        """Block on the copy's event; the f32 scales and the uint32 words
        as numpy views of the pinned tensors (which they keep alive)."""
        if self._dst is None:
            raise RuntimeError("frame already finished")
        self._done.synchronize()
        hs, hw = self._dst
        self._dst = self._src = None
        return hs.numpy(), hw.numpy().view(np.uint32)


class _BurstGraph:
    """``quantize_table_cascade`` of K frames on one residual tensor (with
    ``cascade=1``, ``quantize_table_burst``), captured as a CUDA graph:
    :meth:`run` replays it (updating the residual in place) and returns the
    stacked frame as fresh tensors, since the next replay overwrites the
    graph's own outputs. The capture runs on ``stream`` in
    thread-local mode, so other threads (other nodes of the process) may
    keep using the device meanwhile, and with the garbage collector held
    off (:func:`.utils.timing.no_collection`): a collection inside it would
    run, in this thread, the finalizers of CUDA objects of earlier work,
    and one of those invalidates the capture. It is preceded by one eager
    burst on a copy of the residual, which loads the kernel and the layout
    constants (a capture may not). ``tally`` holds the kernel launches the
    capture recorded, which every replay adds to ``codec_cuda``'s launch
    counts."""

    def __init__(self, resid: torch.Tensor, spec: TableSpec, k: int, cascade: int, codec: CodecConfig, stream):
        self.resid = resid
        self.k = k
        self.cascade = cascade
        burst = lambda r: quantize_table_cascade(r, spec, k, cascade, codec.scale_policy, codec.per_leaf_scale)[0]
        burst(resid.clone())
        self.graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(resid.device))
        with no_collection(), torch.cuda.stream(stream), codec_cuda.capture_tally() as self.tally:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = burst(resid)
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(resid.device).wait_stream(stream)

    def run(self) -> TableFrame:
        self.graph.replay()
        codec_cuda.count_replay(self.tally)
        return TableFrame(self.out.scales.clone(), self.out.words.clone())


class DeviceFrame(TableFrame):
    """A frame as ``begin_frame`` returns it: device tensors (scales,
    words) and, on a CUDA device, ``fetch``, their host copy in flight."""

    fetch: Optional[_HostFetch] = None


class SharedTensor:
    """Replica + per-link residuals for one shared table of tensors.

    ``read`` snapshots the replica, ``add`` merges a local update, links
    are driven with ``begin_frame``/``finish_frame`` (sender) and
    ``receive_frame(s)`` (receiver)."""

    def __init__(
        self,
        template: Any,
        codec: CodecConfig | None = None,
        seed_values: bool = False,
        device=None,
        host_tier: bool = False,
        cascade: int = 1,
    ):
        self.device = resolve_device(device, host_tier)
        self._np = host_tier
        self.spec: TableSpec = make_spec(template)
        self.codec = codec or CodecConfig()
        # the schedule of every begin_frame_burst* call: 1 re-measures
        # every frame, K > 1 is the engine's cascade (module docstring)
        self.cascade = max(1, int(cascade))
        self._lock = locktrace.new_lock()  # traced under ST_LOCK_TRACE=1
        if host_tier:
            codec_np.native()  # build (or fail) now, not at the first frame
        if seed_values and host_tier:
            self.values = torch.from_numpy(codec_np.flatten_np(template, self.spec))
        elif seed_values:
            self.values = flatten(template, self.spec, self.device)
        else:
            self.values = self._zeros()
        self._links: dict[int, torch.Tensor] = {}
        # links whose CPU device-tier burst quantizes off the lock, each
        # with the event its fold sets (module docstring)
        self._bursting: dict[int, threading.Event] = {}
        # Per-link ledger of dispatched-but-unacknowledged frames, keyed by
        # sequence number. Quantizing applies error feedback at once, but
        # delivery is certain only when the receiver acknowledges: if the
        # link dies first, re-applying each frame to the residual restores
        # the pre-quantize state bit for bit (a frame's delta is exactly
        # scale*(1-2*bit)), so the replacement link re-owes it. Entries are
        # tuples of frames (a burst rolls back whole).
        self._inflight: dict[int, dict[int, tuple[TableFrame, ...]]] = {}
        self._frame_seq = 0
        # frames_out: non-idle frames handed toward the wire (counted at
        # fetch); frames_in: non-idle frames applied from the wire; idle
        # (all-zero-scale) frames count in neither.
        self.frames_out = 0
        self.frames_in = 0
        self.updates = 0
        # asynchronous frame fetch (CUDA only; see the module docstring) on
        # a side stream of this node's own
        self._fetch_stream = codec_cuda.own_stream(self, self.device) if self.device.type == "cuda" else None
        # per-link burst graphs, captured on the side stream (CUDA only; see
        # the module docstring)
        self._graphs: dict[int, _BurstGraph] = {}
        # host seconds spent waiting for frame fetches (finish_frame*), on
        # staging received frames and their host-to-device copies, and
        # waiting for the state lock to apply them
        self.fetch_wait_s = 0.0
        self.h2d_s = 0.0
        self.apply_lock_wait_s = 0.0
        # the host tier's stack of received frames that the C loops read
        # (reused, under the lock)
        self._rx_np: Optional[tuple[np.ndarray, np.ndarray]] = None

    @property
    def host_tier(self) -> bool:
        """True when the codec runs as synchronous host (C) work on the
        CPU rather than as device work."""
        return self._np

    # -- buffers -----------------------------------------------------------

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(self.spec.total, dtype=torch.float32, device=self.device)

    def _own(self, x) -> torch.Tensor:
        """A fresh flat f32 buffer on this device holding a copy of ``x``."""
        if tuple(np.shape(x)) != (self.spec.total,):
            raise ValueError(f"shape {tuple(np.shape(x))} != ({self.spec.total},)")
        if not isinstance(x, torch.Tensor):
            # np.array copies: the result is ours whatever the device
            return torch.from_numpy(np.array(x, dtype=np.float32)).to(self.device)
        out = torch.empty(self.spec.total, dtype=torch.float32, device=self.device)
        out.copy_(x.detach())
        return out

    def _device_frame(self, frame: TableFrame) -> TableFrame:
        t0 = time.perf_counter()
        scales = frame.scales
        if isinstance(scales, torch.Tensor):
            scales = scales.to(device=self.device, dtype=torch.float32)
        else:
            scales = torch.from_numpy(np.asarray(scales, np.float32).copy()).to(self.device)
        out = TableFrame(scales, words_from_host(frame.words, self.device))
        self.h2d_s += time.perf_counter() - t0
        return out

    def _start_fetch(self, frame: TableFrame) -> DeviceFrame:
        out = DeviceFrame(*frame)
        if self._fetch_stream is not None:
            out.fetch = _HostFetch(frame.scales, frame.words, self._fetch_stream)
        return out

    def _fetched(self, frame: TableFrame) -> tuple[np.ndarray, np.ndarray]:
        """Host (f32 scales, uint32 words) of a frame from begin_frame*."""
        t0 = time.perf_counter()
        fetch = getattr(frame, "fetch", None)
        if fetch is not None:
            out = fetch.wait()
        elif self._np:
            out = frame.scales, frame.words  # already host arrays
        else:
            out = _host(frame.scales), words_to_host(frame.words)
        self.fetch_wait_s += time.perf_counter() - t0
        return out

    def _settle(self, link_id: Optional[int] = None) -> None:
        """Under the lock: return once no burst quantizes ``link_id``'s
        residual off the lock (any link's when None), releasing the lock
        while one does."""
        while self._bursting:
            done = self._bursting.get(link_id) if link_id is not None else next(iter(self._bursting.values()))
            if done is None:
                return
            self._lock.release()
            try:
                done.wait()
            finally:
                self._lock.acquire()

    # -- links -------------------------------------------------------------

    def new_link(self, link_id: int, seed: bool = True, residual=None) -> None:
        """Open a link. ``seed=True`` preloads the residual with a copy of
        the current replica, so the peer on the other end receives the full
        state through normal frames. ``residual`` overrides the seed with an
        explicit starting residual (copied)."""
        with self._lock:
            if link_id in self._links:
                raise DuplicateLink(f"link {link_id} already exists")
            if residual is not None:
                self._links[link_id] = self._own(residual)
            elif seed:
                self._links[link_id] = self.values.clone()
            else:
                self._links[link_id] = self._zeros()

    def new_link_diff(self, link_id: int, peer_snapshot) -> None:
        """Open a link toward a peer whose replica equals ``peer_snapshot``,
        seeding the residual with (our replica - theirs)."""
        with self._lock:
            if link_id in self._links:
                raise DuplicateLink(f"link {link_id} already exists")
            snap = self._own(peer_snapshot)
            self._links[link_id] = self.values - snap

    def stash_carry(self, link_id: int, carry_id: int) -> bool:
        """Move a dead link's residual (unacked frames rolled back) into the
        carry pseudo-slot ``carry_id``, merging with any existing carry, in
        one lock acquisition. False if ``link_id`` is unknown."""
        with self._lock:
            self._settle(link_id)
            resid = self._links.pop(link_id, None)
            self._graphs.pop(link_id, None)
            if resid is None:
                return False
            resid = self._unapply(resid, self._inflight.pop(link_id, {}))
            prev = self._links.pop(carry_id, None)
            if prev is not None:
                resid = resid + prev
            self._links[carry_id] = resid
            return True

    def take_link_and_snapshot(self, link_id: int) -> tuple[Optional[torch.Tensor], torch.Tensor]:
        """drop_link + a copy of the replica under one lock acquisition."""
        with self._lock:
            self._settle(link_id)
            resid = self._links.pop(link_id, None)
            self._graphs.pop(link_id, None)
            inflight = self._inflight.pop(link_id, {})
            if resid is not None:
                resid = self._unapply(resid, inflight)
            return resid, self.values.clone()

    def drop_link(self, link_id: int) -> Optional[torch.Tensor]:
        """Close a link; returns its undelivered residual (None if unknown)
        with every unacknowledged frame rolled back into it."""
        with self._lock:
            self._settle(link_id)
            resid = self._links.pop(link_id, None)
            self._graphs.pop(link_id, None)
            inflight = self._inflight.pop(link_id, {})
            if resid is not None:
                resid = self._unapply(resid, inflight)
            return resid

    def _unapply(self, resid: torch.Tensor, frames: dict) -> torch.Tensor:
        """Roll back unacknowledged frames by re-applying them (in place)."""
        for entry in frames.values():
            for f in entry:
                if self._np:
                    codec_np.apply_table_many_np((resid.numpy(),), f.scales, f.words, self.spec, inplace=True)
                else:
                    apply_table_many((resid,), f, self.spec)
        return resid

    def inflight_frames(self, link_id: int, seqs) -> list[tuple[TableFrame, ...]]:
        """The non-idle frames of a link's ledger entries ``seqs`` (an entry
        that is gone gives ``()``), read before a roll-back consumes them."""
        with self._lock:
            q = self._inflight.get(link_id, {})
            return [tuple(f for f in q.get(s, ()) if _host(f.scales).any()) for s in seqs]

    def retract_frames(self, frames: list[TableFrame]) -> None:
        """Take frames back out of the replica and every link's residual:
        the inverse of receiving them from a link that is not attached
        here. A severed uplink's frames that its parent applied
        were rolled into the carry with the rest; the re-join's diff
        handshake then brings them back from the parent, so they must leave
        this node's state first. Counted nowhere."""
        if not frames:
            return
        with self._lock:
            if self._np:
                targets = [self.values.numpy(), *(r.numpy() for r in self._links.values())]
                scales = -np.stack([_host(f.scales) for f in frames])
                words = np.stack([codec_np._u32(f.words) for f in frames])
                codec_np.apply_table_batch_np(targets, scales, words, self.spec, inplace=True)
            else:
                stacked = TableFrame(-torch.stack([f.scales for f in frames]), torch.stack([f.words for f in frames]))
                apply_table_batch((self.values, *self._links.values()), stacked, self.spec)

    @property
    def link_ids(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(self._links)

    def inflight_total(self) -> int:
        """Ledger entries (a burst counts once) not yet acknowledged."""
        with self._lock:
            return sum(len(q) for q in self._inflight.values())

    def snapshot_all(self) -> tuple[torch.Tensor, dict[int, torch.Tensor]]:
        """Consistent copies of (replica, {link: residual}) under one lock
        acquisition: the checkpoint primitive."""
        with self._lock:
            self._settle()
            return self.values.clone(), {i: r.clone() for i, r in self._links.items()}

    def restore_state(self, values, links: dict) -> None:
        """Checkpoint restore (the inverse of :meth:`snapshot_all`) under one
        lock acquisition: the replica, and the residuals of the given links
        that exist here (and of a carry pseudo-slot, a negative id, which
        is recreated)."""
        with self._lock:
            self._settle()
            self.values = self._own(values)
            for lid, r in links.items():
                if lid in self._links or lid < 0:
                    self._links[lid] = self._own(r)

    # -- user API ----------------------------------------------------------

    def read(self) -> Any:
        """A copy of the replica in the template's tree structure."""
        with self._lock:
            snap = self.values.clone()
        return unflatten(snap, self.spec)

    def reset_values(self) -> None:
        """Zero the replica (links and residuals kept)."""
        with self._lock:
            self.values = self._zeros()

    def regraft_reset_to_carry(self, carry_id: int, new_link_id: int) -> None:
        """Consume the carry pseudo-slot, set the replica to EXACTLY the
        carry and open the new uplink with (a copy of) the carry as its
        residual, as one atomic step."""
        with self._lock:
            if new_link_id in self._links:
                raise DuplicateLink(f"link {new_link_id} already exists")
            carry = self._links.pop(carry_id, None)
            if carry is None:
                self.values = self._zeros()
                self._links[new_link_id] = self._zeros()
            else:
                # buffers are updated in place: replica and residual must not
                # share storage
                self.values = carry
                self._links[new_link_id] = carry.clone()

    def snapshot_flat(self) -> torch.Tensor:
        """A copy of the padded flat replica."""
        with self._lock:
            return self.values.clone()

    def add(self, delta: Any) -> None:
        """Merge an additive update into the replica and every link residual."""
        if self._np:
            update = codec_np.flatten_np(delta, self.spec)
            with self._lock:
                targets = [t.numpy() for t in (self.values, *self._links.values())]
                codec_np.accumulate_table_np(targets, update, self.spec, inplace=True)
                self.updates += 1
            return
        update = flatten(delta, self.spec, self.device)
        with self._lock:
            accumulate_table((self.values, *self._links.values()), update, self.spec)
            self.updates += 1

    def mask_link_residual(self, link_id: int, elo: int, ehi: int) -> None:
        """Zero a link's residual outside [elo, ehi): a ranged subscriber
        never receives that mass, so the sender drops it before the scales
        are chosen (the engine does the same in C). In place, under the
        lock: on a CUDA device the two fills go on the current stream,
        ahead of the link's next quantize there (a burst graph's replay
        included, which launches on the current stream); the port's
        buffers are never shared, so no snapshot sees them."""
        with self._lock:
            self._settle(link_id)
            r = self._links.get(link_id)
            if r is None:
                return
            r[:elo] = 0.0
            r[ehi:] = 0.0

    # -- sync engine hooks -------------------------------------------------

    def begin_frame(
        self, link_id: int, at_lock: Optional[Callable[[], None]] = None
    ) -> Optional[tuple[int, DeviceFrame]]:
        """Quantize a link's residual into a frame (device tensors, their
        host copy started) and apply error feedback. Returns (seq, frame),
        or None if the link is gone. The caller must eventually ack it, or
        let nack/drop roll it back. ``at_lock`` is called under the state
        lock just before the residual is read: what it observes is in the
        frame (no add or apply lands in between)."""
        with self._lock:
            self._settle(link_id)
            resid = self._links.get(link_id)
            if resid is None:
                return None
            if at_lock is not None:
                at_lock()
            if self._np:
                r = resid.numpy()
                scales, words, _ = codec_np.quantize_table_np(
                    r, self.spec, self.codec.scale_policy, self.codec.per_leaf_scale, out=r
                )
                frame = TableFrame(scales, words)
            else:
                frame, _ = quantize_table(
                    resid, self.spec, self.codec.scale_policy, self.codec.per_leaf_scale
                )
            self._frame_seq += 1
            seq = self._frame_seq
            self._inflight.setdefault(link_id, {})[seq] = (frame,)
        return seq, self._start_fetch(frame)

    def begin_frame_burst(
        self, link_id: int, k: int, at_lock: Optional[Callable[[], None]] = None
    ) -> Optional[tuple[int, list[TableFrame]]]:
        """Host tier: up to ``k`` successive halvings of a link's residual in
        one call, stopping at the first all-zero-scale frame; ONE ledger
        entry (one wire message, one ACK). ``self.cascade`` > 1 quantizes
        them by the engine's cascade (module docstring). Returns (seq,
        frames), numpy frames ready for the wire (0 frames: the link is
        idle), or None if the link is gone. ``at_lock`` as in
        :meth:`begin_frame`."""
        if not self._np:
            raise RuntimeError("begin_frame_burst is the host tier's; the device tier bursts with "
                               "begin_frame_burst_device")
        with self._lock:
            resid = self._links.get(link_id)
            if resid is None:
                return None
            if at_lock is not None:
                at_lock()
            r = resid.numpy()
            frames: list[TableFrame] = []
            if self.cascade > 1:
                scales, words, _ = codec_np.quantize_table_cascade_np(
                    r, self.spec, k, self.cascade, self.codec.scale_policy, self.codec.per_leaf_scale, out=r
                )
                frames = [TableFrame(s, w) for s, w in zip(scales, words)]
            else:
                for _ in range(k):
                    scales, words, _ = codec_np.quantize_table_np(
                        r, self.spec, self.codec.scale_policy, self.codec.per_leaf_scale, out=r
                    )
                    if not scales.any():
                        break  # idle: nothing left the codec can express
                    frames.append(TableFrame(scales, words))
            self._frame_seq += 1
            seq = self._frame_seq
            if frames:
                self._inflight.setdefault(link_id, {})[seq] = tuple(frames)
            self.frames_out += len(frames)
        return seq, frames

    def begin_frame_burst_device(
        self, link_id: int, k: int, at_lock: Optional[Callable[[], None]] = None
    ) -> Optional[tuple[int, DeviceFrame]]:
        """K successive halvings of a link's residual in one call; one
        ledger entry. ``self.cascade`` > 1 quantizes them by the engine's
        cascade (module docstring). Returns (seq, stacked frame with a
        leading K axis), device tensors, their host copy started.
        ``at_lock`` as in :meth:`begin_frame`. On a CUDA device the burst
        graph replays under the lock; on the CPU the burst quantizes off it
        (module docstring)."""
        with self._lock:
            self._settle(link_id)
            resid = self._links.get(link_id)
            if resid is None:
                return None
            if at_lock is not None:
                at_lock()
            if self.device.type == "cuda":
                frames = self._burst_graph(link_id, resid, k).run()
                seq = self._ledger_burst(link_id, frames, k)
            else:
                self._links[link_id] = torch.full_like(resid, -0.0)
                done = self._bursting[link_id] = threading.Event()
        if self.device.type != "cuda":
            seq, frames = self._burst_off_lock(link_id, resid, k, done)
        return seq, self._start_fetch(frames)

    def _burst_off_lock(self, link_id: int, resid: torch.Tensor, k: int, done: threading.Event):
        """The CPU burst of a residual taken out of its link (module
        docstring): quantize it with no lock held, then, under the lock,
        fold in what came in meanwhile and take the ledger entry, in one
        section, so a drop or a NACK sees the burst whole or not at all."""
        frames = None
        try:
            frames, _ = quantize_table_cascade(
                resid, self.spec, k, self.cascade, self.codec.scale_policy, self.codec.per_leaf_scale
            )
        finally:
            with self._lock:
                # in place (the link keeps its tensor), clamped as an add is
                resid.add_(self._links[link_id]).clamp_(-SAT, SAT)
                self._links[link_id] = resid
                del self._bursting[link_id]
                done.set()
                if frames is not None:
                    seq = self._ledger_burst(link_id, frames, k)
        return seq, frames

    def _ledger_burst(self, link_id: int, frames: TableFrame, k: int) -> int:
        """A burst's ledger entry and its seq. The caller holds the lock."""
        self._frame_seq += 1
        seq = self._frame_seq
        # zero-scale tail frames are exact no-ops, so storing all K is right
        # (a cascade writes no non-zero frame after a zero one)
        self._inflight.setdefault(link_id, {})[seq] = tuple(
            TableFrame(frames.scales[i], frames.words[i]) for i in range(k)
        )
        return seq

    def _burst_graph(self, link_id: int, resid: torch.Tensor, k: int) -> _BurstGraph:
        """The link's burst graph, captured anew if the residual is another
        tensor than the one captured (or the burst another shape). The
        caller holds the lock."""
        g = self._graphs.get(link_id)
        if g is None or g.resid is not resid or g.k != k or g.cascade != self.cascade:
            g = self._graphs[link_id] = _BurstGraph(resid, self.spec, k, self.cascade, self.codec, self._fetch_stream)
        return g

    def finish_frame_burst(self, frames: TableFrame) -> Optional[list[TableFrame]]:
        """Wait for a burst's host copy and trim its all-zero-scale tail.
        None for a fully idle burst."""
        scales, words = self._fetched(frames)
        k_eff = 0
        for i in range(scales.shape[0]):
            if not scales[i].any():
                break
            k_eff = i + 1
        if k_eff == 0:
            return None
        self.frames_out += k_eff
        return [TableFrame(scales[i], words[i]) for i in range(k_eff)]

    def ack_frame(self, link_id: int, seq: int) -> None:
        """Frame ``seq`` was delivered (or was an idle no-op): forget it."""
        with self._lock:
            q = self._inflight.get(link_id)
            if q is not None:
                q.pop(seq, None)

    def nack_frame(self, link_id: int) -> None:
        """Delivery failed but the link lives: roll every outstanding frame
        back into the residual."""
        with self._lock:
            q = self._inflight.pop(link_id, None)
            resid = self._links.get(link_id)
            if resid is None or not q:
                return
            self._unapply(resid, q)

    def finish_frame(self, frame: TableFrame) -> Optional[TableFrame]:
        """Wait for a frame's host copy: numpy f32 scales and uint32 words,
        what the wire carries. None for an idle frame when the codec
        suppresses them."""
        scales, words = self._fetched(frame)
        if self.codec.suppress_zero_frames and not scales.any():
            return None
        self.frames_out += 1
        return TableFrame(scales, words)

    def make_frame(self, link_id: int) -> Optional[TableFrame]:
        """begin_frame + finish_frame, acknowledged at once."""
        out = self.begin_frame(link_id)
        if out is None:
            return None
        seq, frame = out
        fetched = self.finish_frame(frame)
        self.ack_frame(link_id, seq)
        return fetched

    def receive_frame(self, link_id: int, frame: TableFrame) -> None:
        """Apply an incoming frame to the replica and to every OTHER link's
        residual (split-horizon flood). ``link_id`` may be unknown. An
        all-zero-scale frame is a no-op and counts nowhere."""
        if not _host(frame.scales).any():
            return
        if self._np:
            return self._receive_host(link_id, [frame], 1)
        dframe = self._device_frame(frame)
        if self.device.type == "cpu":
            stacked = TableFrame(dframe.scales.reshape(1, -1), dframe.words.reshape(1, -1))
            return self._receive_cpu(link_id, stacked, 1)
        t0 = time.perf_counter()
        with self._lock:
            self.apply_lock_wait_s += time.perf_counter() - t0
            others = [r for i, r in self._links.items() if i != link_id]
            apply_table_many((self.values, *others), dframe, self.spec)
            self.frames_in += 1

    def receive_frames(self, link_id: int, frames: list[TableFrame]) -> None:
        """Apply K queued frames from one link in one pass (their summed
        delta); all-zero-scale frames count nowhere. On a CUDA device the K
        frames are stacked in pinned memory and copied to the device without
        blocking the host, ahead of the apply on the same stream; on the
        host tier into a reused aligned stack that the C loop reads."""
        if not frames:
            return
        if len(frames) == 1:
            return self.receive_frame(link_id, frames[0])
        host_scales = [_host(f.scales) for f in frames]
        applied = sum(1 for s in host_scales if s.any())
        if applied == 0:
            return
        if self._np:
            return self._receive_host(link_id, frames, applied)
        t0 = time.perf_counter()
        pin = self.device.type == "cuda"
        k = len(frames)
        scales = torch.empty((k, self.spec.num_leaves), dtype=torch.float32, pin_memory=pin)
        words = torch.empty((k, self.spec.total // 32), dtype=torch.int32, pin_memory=pin)
        s_host, w_host = scales.numpy(), words.numpy().view(np.uint32)
        for i, f in enumerate(frames):
            s_host[i] = host_scales[i]
            w_host[i] = _host(f.words).view(np.uint32)
        stacked = TableFrame(scales.to(self.device, non_blocking=True), words.to(self.device, non_blocking=True))
        self.h2d_s += time.perf_counter() - t0
        if self.device.type == "cpu":
            return self._receive_cpu(link_id, stacked, applied)
        t0 = time.perf_counter()
        with self._lock:
            self.apply_lock_wait_s += time.perf_counter() - t0
            others = [r for i, r in self._links.items() if i != link_id]
            apply_table_batch((self.values, *others), stacked, self.spec)
            self.frames_in += applied

    def _receive_cpu(self, link_id: int, stacked: TableFrame, applied: int) -> None:
        """The device tier on the CPU: the frames' summed delta before the
        lock, only its add under it (plain kernel B in its two halves, bit
        for bit), so a receive holds the state lock for one pass over the
        targets."""
        delta = frames_delta(stacked, self.spec)
        t0 = time.perf_counter()
        with self._lock:
            self.apply_lock_wait_s += time.perf_counter() - t0
            others = [r for i, r in self._links.items() if i != link_id]
            apply_delta((self.values, *others), delta, self.spec)
            self.frames_in += applied

    def _receive_host(self, link_id: int, frames: list, applied: int) -> None:
        """Host tier: the K frames (wire views, possibly unaligned) copied
        into the reused stack, then one C pass over each target, in place."""
        k = len(frames)
        t0 = time.perf_counter()
        with self._lock:
            self.apply_lock_wait_s += time.perf_counter() - t0
            if self._rx_np is None or self._rx_np[0].shape[0] < k:
                self._rx_np = (
                    np.empty((k, self.spec.num_leaves), np.float32),
                    np.empty((k, self.spec.total // 32), np.uint32),
                )
            scales, words = self._rx_np[0][:k], self._rx_np[1][:k]
            for i, f in enumerate(frames):
                scales[i] = _host(f.scales)
                words[i] = codec_np._u32(f.words)
            targets = [r.numpy() for i, r in self._links.items() if i != link_id]
            codec_np.apply_table_batch_np((self.values.numpy(), *targets), scales, words, self.spec, inplace=True)
            self.frames_in += applied

    # -- introspection -----------------------------------------------------

    def state_version(self) -> int:
        """Monotone change counter of the replica: local adds + applied
        foreign frames (JAX's, on both tiers). A ranged subscriber link's
        send pass masks its residual only when this moved."""
        return self.updates + self.frames_in

    def lock_stats(self) -> dict[str, dict]:
        """Per call site, the state lock's acquisitions, wait and hold
        seconds (``utils/locktrace``); {} unless ``ST_LOCK_TRACE=1`` was set
        when this tensor was made."""
        return locktrace.stats(self._lock)

    def residual_rms(self, link_id: int) -> float:
        with self._lock:
            self._settle(link_id)
            r = self._links.get(link_id)
            if r is None:
                return 0.0
            if self._np:
                r64 = r.numpy().astype(np.float64)
                return float(np.sqrt(np.dot(r64, r64) / self.spec.total_n))
            r64 = r.to(torch.float64)
            return float(torch.sqrt(torch.dot(r64, r64) / self.spec.total_n))

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"SharedTensor(leaves={self.spec.num_leaves}, n={self.spec.total_n}, "
            f"device={self.device}, host_tier={self._np}, links={list(self._links)}, "
            f"out={self.frames_out}, in={self.frames_in})"
        )
