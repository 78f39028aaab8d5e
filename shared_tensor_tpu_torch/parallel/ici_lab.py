"""The codec lab's pod-tier test bed: a 2-bit (Sign2) pod sync step.

The counterpart of ``shared_tensor_tpu/parallel/ici_lab.py``. The step is
the production step's (``parallel/ici.build_sync_step``): the same per-leaf
cross-shard scales (``ici._leaf_scales``: the per-leaf scale pass, its
float64 sums reduced over the shard group), the same one
all-gather over the peer group, split horizon and +-SAT clamps; only the
quantizer differs. Each element sends ``+-s``, or ``+-3s`` where
``|r| > 2s`` (``ops/codec_lab.Sign2``), so the wire carries 2 bits per
element: a sign plane and a magnitude plane, each packed LSB-first into
its own words (not interleaved per element as the single-buffer twins of
``ops/codec_lab_torch.py`` are).

A separate function, not an option of the production one: the 1-bit step
is the reference-parity path and stays as it is; this one measures the
method's convergence on the real pod path. Past its scales it is plain
PyTorch on the mesh's device (the JAX package's is XLA only): the row
kernels A and B are pinned to the 1-bit layout.

On uniform residuals ``|r|`` never exceeds ``2s``: the magnitude bit
idles and the state tracks the production step's bit for bit, to exact
zero. On gaussian residuals the RMS falls faster per frame than under the
production step (the host lab's 0.79 against 0.85 over 20 frames).
"""

from __future__ import annotations

import torch

from ..config import ScalePolicy
from ..ops.codec import SAT
from ..ops.packing import BITS_PER_WORD, LANES, pack_bits, unpack_bits
from ..ops.table import TableSpec
from .ici import PeerSyncState, _leaf_scales, _make_ctx
from .mesh import Mesh, all_gather


def build_sign2_sync_step(
    mesh: Mesh,
    spec: TableSpec,
    policy: ScalePolicy = ScalePolicy.POW2_RMS,
    per_leaf: bool = True,
):
    """One 2-bit pod sync step ``state -> (state, scales)``, with
    ``build_sync_step``'s contract: the state's tensors updated in place,
    ``scales`` f32[n_peer, k] the step sizes each peer sent (rows of 0 =
    idle peers), on every rank. Collective: every rank of the mesh calls
    it once per step.

    One all-gather over the peer group carries ``[scales | sign words |
    magnitude words]``; each rank then adds every OTHER peer's frame to its
    replica block in peer order from 0.0, clamps to +-SAT and zeroes the pad
    lanes."""
    ctx = _make_ctx(mesh, spec, per_leaf)
    n_words = ctx.rows_local * LANES // BITS_PER_WORD
    zero = torch.zeros((), dtype=torch.float32, device=mesh.device)

    def step(state: PeerSyncState):
        values, residual = state
        r = residual.view(ctx.rows_local, LANES)
        scales = _leaf_scales(ctx, r, policy)
        s_row = scales[ctx.row_leaf][:, None]
        # the Sign2 rule, with the production codec's sign convention
        neg = r <= 0.0
        big = r.abs() > 2.0 * s_row
        mag = torch.where(big, 3.0 * s_row, s_row)
        sent = torch.where(neg, -mag, mag)
        r2 = torch.where(ctx.live & (s_row > 0), r - sent, torch.where(ctx.live, r, zero))
        planes = [pack_bits((ctx.live & b).reshape(-1)) for b in (neg, big)]
        packed = torch.cat([scales.view(torch.int32), *planes])
        buf = all_gather(mesh, packed, mesh.peer_group).wait()  # int32[n_peer, k + 2 * n_words]
        scales_all = buf[:, : ctx.k].contiguous().view(torch.float32)
        shape = (mesh.n_peer, ctx.rows_local, LANES)
        neg_all = unpack_bits(buf[:, ctx.k : ctx.k + n_words]).reshape(shape).to(torch.float32)
        big_all = unpack_bits(buf[:, ctx.k + n_words :]).reshape(shape).to(torch.float32)
        s_all = scales_all[:, ctx.row_leaf]  # [n_peer, rows_local]
        s_all[mesh.peer] = 0.0  # split horizon
        delta = torch.zeros_like(r)
        for p in range(mesh.n_peer):
            delta = delta + s_all[p][:, None] * (1.0 - 2.0 * neg_all[p]) * (1.0 + 2.0 * big_all[p])
        v = values.view(ctx.rows_local, LANES)
        v.copy_(torch.where(ctx.live, torch.clamp(v + delta, -SAT, SAT), zero))
        r.copy_(r2)
        return state, scales_all

    return step
