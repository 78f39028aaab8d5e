"""SharedTensor on PyTorch: the process-local replica + per-link codec state,
device tier.

The counterpart of ``shared_tensor_tpu/core.py``'s ``SharedTensor``: a full
replica ``values`` of a table of tensors plus one residual per tree link,
with the same link operations, in-flight ledger, frame calls and counters.
The codec runs on ``device`` (the GPU by default) through the two kernels
of ``ops/codec_cuda.py``; ``device="cpu"`` runs their plain versions and
exists for tests.

Where the JAX core swaps immutable arrays, this one updates its buffers in
place (as the TPU kernels' ``input_output_aliases`` do). So every buffer
it holds is its own: a link seeded from the replica, a residual handed in,
a re-graft that sets replica and residual to one carry, each gets a copy,
and ``read``/``snapshot_flat``/``snapshot_all`` return copies.

All state changes hold one mutex, as in the JAX core.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

from .config import CodecConfig
from .ops.packing import words_from_host, words_to_host
from .ops.table import (
    TableFrame,
    TableSpec,
    accumulate_table,
    apply_table_batch,
    apply_table_many,
    flatten,
    make_spec,
    quantize_table,
    quantize_table_burst,
    unflatten,
)


class DuplicateLink(ValueError):
    """A link id that is already attached."""


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; raise if there is none (never carry on on the
    CPU unasked)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SharedTensor needs a CUDA device; pass device='cpu' explicitly for the CPU")
    return dev


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
    ):
        self.device = resolve_device(device)
        self.spec: TableSpec = make_spec(template)
        self.codec = codec or CodecConfig()
        self._lock = threading.Lock()
        if seed_values:
            self.values = flatten(template, self.spec, self.device)
        else:
            self.values = self._zeros()
        self._links: dict[int, torch.Tensor] = {}
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
        scales = frame.scales
        if isinstance(scales, torch.Tensor):
            scales = scales.to(device=self.device, dtype=torch.float32)
        else:
            scales = torch.from_numpy(np.asarray(scales, np.float32).copy()).to(self.device)
        return TableFrame(scales, words_from_host(frame.words, self.device))

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
            resid = self._links.pop(link_id, None)
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
            resid = self._links.pop(link_id, None)
            inflight = self._inflight.pop(link_id, {})
            if resid is not None:
                resid = self._unapply(resid, inflight)
            return resid, self.values.clone()

    def drop_link(self, link_id: int) -> Optional[torch.Tensor]:
        """Close a link; returns its undelivered residual (None if unknown)
        with every unacknowledged frame rolled back into it."""
        with self._lock:
            resid = self._links.pop(link_id, None)
            inflight = self._inflight.pop(link_id, {})
            if resid is not None:
                resid = self._unapply(resid, inflight)
            return resid

    def _unapply(self, resid: torch.Tensor, frames: dict) -> torch.Tensor:
        """Roll back unacknowledged frames by re-applying them (in place)."""
        for entry in frames.values():
            for f in entry:
                apply_table_many((resid,), f, self.spec)
        return resid

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
            return self.values.clone(), {i: r.clone() for i, r in self._links.items()}

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
        update = flatten(delta, self.spec, self.device)
        with self._lock:
            accumulate_table((self.values, *self._links.values()), update, self.spec)
            self.updates += 1

    def mask_link_residual(self, link_id: int, elo: int, ehi: int) -> None:
        """Zero a link's residual outside [elo, ehi) (ranged subscriber)."""
        with self._lock:
            r = self._links.get(link_id)
            if r is None:
                return
            r[:elo] = 0.0
            r[ehi:] = 0.0

    # -- sync engine hooks -------------------------------------------------

    def begin_frame(self, link_id: int) -> Optional[tuple[int, TableFrame]]:
        """Quantize a link's residual into a frame (device tensors, not yet
        fetched) and apply error feedback. Returns (seq, frame), or None if
        the link is gone. The caller must eventually ack it, or let
        nack/drop roll it back."""
        with self._lock:
            resid = self._links.get(link_id)
            if resid is None:
                return None
            frame, _ = quantize_table(
                resid, self.spec, self.codec.scale_policy, self.codec.per_leaf_scale
            )
            self._frame_seq += 1
            seq = self._frame_seq
            self._inflight.setdefault(link_id, {})[seq] = (frame,)
        return seq, frame

    def begin_frame_burst_device(self, link_id: int, k: int) -> Optional[tuple[int, TableFrame]]:
        """K successive halvings of a link's residual in one call; one
        ledger entry. Returns (seq, stacked TableFrame with a leading K
        axis), device tensors not yet fetched."""
        with self._lock:
            resid = self._links.get(link_id)
            if resid is None:
                return None
            frames, _ = quantize_table_burst(
                resid, self.spec, k, self.codec.scale_policy, self.codec.per_leaf_scale
            )
            self._frame_seq += 1
            seq = self._frame_seq
            # zero-scale tail frames are exact no-ops, so storing all K is right
            self._inflight.setdefault(link_id, {})[seq] = tuple(
                TableFrame(frames.scales[i], frames.words[i]) for i in range(k)
            )
        return seq, frames

    def finish_frame_burst(self, frames: TableFrame) -> Optional[list[TableFrame]]:
        """Fetch a burst to the host and trim its all-zero-scale tail. None
        for a fully idle burst."""
        scales = _host(frames.scales)
        words = words_to_host(frames.words)
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
        """Fetch a frame to host memory: numpy f32 scales and uint32 words,
        what the wire carries. None for an idle frame when the codec
        suppresses them."""
        scales = _host(frame.scales)
        if self.codec.suppress_zero_frames and not scales.any():
            return None
        words = words_to_host(frame.words)
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
        dframe = self._device_frame(frame)
        with self._lock:
            others = [r for i, r in self._links.items() if i != link_id]
            apply_table_many((self.values, *others), dframe, self.spec)
            self.frames_in += 1

    def receive_frames(self, link_id: int, frames: list[TableFrame]) -> None:
        """Apply K queued frames from one link in one pass (their summed
        delta). K is padded with zero-scale no-op frames to the next power
        of two; all-zero-scale frames count nowhere."""
        if not frames:
            return
        if len(frames) == 1:
            return self.receive_frame(link_id, frames[0])
        host_scales = [_host(f.scales) for f in frames]
        applied = sum(1 for s in host_scales if s.any())
        if applied == 0:
            return
        k = 1
        while k < len(frames):
            k *= 2
        scales = np.zeros((k, self.spec.num_leaves), np.float32)
        words = np.zeros((k, self.spec.total // 32), np.uint32)
        for i, f in enumerate(frames):
            scales[i] = host_scales[i]
            words[i] = _host(f.words).view(np.uint32)
        stacked = self._device_frame(TableFrame(scales, words))
        with self._lock:
            others = [r for i, r in self._links.items() if i != link_id]
            apply_table_batch((self.values, *others), stacked, self.spec)
            self.frames_in += applied

    # -- introspection -----------------------------------------------------

    def state_version(self) -> int:
        """Monotone change counter: local adds + applied foreign frames."""
        return self.updates + self.frames_in

    def residual_rms(self, link_id: int) -> float:
        with self._lock:
            r = self._links.get(link_id)
            if r is None:
                return 0.0
            r64 = r.to(torch.float64)
            return float(torch.sqrt(torch.dot(r64, r64) / self.spec.total_n))

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"SharedTensor(leaves={self.spec.num_leaves}, n={self.spec.total_n}, "
            f"device={self.device}, links={list(self._links)}, "
            f"out={self.frames_out}, in={self.frames_in})"
        )
