"""The host tier of the port's SharedTensor (host_tier=True) against the JAX
package's host-tier SharedTensor (numpy over its native libstcodec, the tier
JAX_PLATFORMS=cpu selects): the same calls on the same seeded inputs give
the same frames, replicas and residuals, bit for bit.

The sequence covers add, begin_frame / finish_frame with acknowledgement,
the host burst (begin_frame_burst), receive_frame(s) from frames decoded
off the wire, nack and drop_link with unacknowledged frames rolled back,
the carry, and mask_link_residual; read() returns CPU torch tensors."""

import numpy as np
import pytest
import torch

from shared_tensor_tpu.core import SharedTensor as JaxSharedTensor
from shared_tensor_tpu.core import host_tier_active
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.core import SharedTensor
from shared_tensor_tpu_torch.ops.table import make_spec


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.uniform(-2.0, 2.0, (24, 40)).astype(np.float32),
        "b": (rng.standard_normal(300) * 50).astype(np.float32),
        "z": np.zeros(7, np.float32),
    }


def _pair(seed=0, **kw):
    assert host_tier_active(), "the JAX package's SharedTensor must be on its host tier"
    tree = _tree(seed)
    j = JaxSharedTensor(tree, seed_values=True, **kw)
    p = SharedTensor(tree, seed_values=True, host_tier=True, **kw)
    assert j.host_tier and p.host_tier
    return j, p


def _same_state(j, p):
    jv, jl = j.snapshot_all()
    pv, pl = p.snapshot_all()
    np.testing.assert_array_equal(np.asarray(jv), pv.numpy())
    assert sorted(jl) == sorted(pl)
    for lid in jl:
        np.testing.assert_array_equal(np.asarray(jl[lid]), pl[lid].numpy(), err_msg=f"link {lid}")
    assert (j.frames_out, j.frames_in, j.updates) == (p.frames_out, p.frames_in, p.updates)
    assert j.inflight_total() == p.inflight_total()


def _same_frame(fj, fp):
    if fj is None or fp is None:
        assert fj is None and fp is None
        return
    np.testing.assert_array_equal(np.asarray(fj.scales), fp.scales)
    np.testing.assert_array_equal(np.asarray(fj.words), fp.words)


def _on_wire(frames, spec):
    """Frames as the port's receiver decodes them: views into a BURST
    message (the words possibly unaligned)."""
    return wire.decode_burst(wire.encode_burst(frames, spec, 1), spec)


def _copies(frames):
    """The same frames as the JAX receiver decodes them (into aligned
    arrays of its own)."""
    return [f._replace(scales=np.array(f.scales), words=np.array(f.words)) for f in frames]


def test_call_sequence_matches_jax_bit_for_bit():
    j, p = _pair(0)
    spec = p.spec
    for st in (j, p):
        st.new_link(1)  # seeded with the replica
        st.new_link(2, seed=False)
        st.new_link(3, seed=False)
    _same_state(j, p)
    rng = np.random.default_rng(1)
    for step in range(3):
        delta = {k: rng.uniform(-1, 1, v.shape).astype(np.float32) for k, v in _tree(0).items()}
        j.add(delta)
        p.add({k: torch.from_numpy(v) for k, v in delta.items()})
        _same_state(j, p)
        # single frames on link 1, acknowledged
        for _ in range(2):
            (sj, dj), (sp, dp) = j.begin_frame(1), p.begin_frame(1)
            fj, fp = j.finish_frame(dj), p.finish_frame(dp)
            _same_frame(fj, fp)
            j.ack_frame(1, sj)
            p.ack_frame(1, sp)
        # a burst on link 2, acknowledged
        (sj, bj), (sp, bp) = j.begin_frame_burst(2, 6), p.begin_frame_burst(2, 6)
        assert len(bj) == len(bp)
        for a, b in zip(bj, bp):
            _same_frame(a, b)
        j.ack_frame(2, sj)
        p.ack_frame(2, sp)
        _same_state(j, p)
        # frames from a neighbour arrive on link 3 (flood into 1 and 2)
        src = SharedTensor(_tree(10 + step), seed_values=True, host_tier=True)
        src.new_link(9)
        _, burst = src.begin_frame_burst(9, 5)
        incoming = _on_wire(burst, spec)
        j.receive_frames(3, _copies(incoming))
        p.receive_frames(3, incoming)
        j.receive_frame(3, _copies(incoming)[0])
        p.receive_frame(3, incoming[0])
        _same_state(j, p)
    # unacknowledged frames: a nack rolls them back, a drop returns them
    for st in (j, p):
        st.begin_frame(1)
        st.begin_frame_burst(1, 3)
    _same_state(j, p)
    j.nack_frame(1)
    p.nack_frame(1)
    _same_state(j, p)
    for st in (j, p):
        st.begin_frame_burst(2, 4)
    rj, rp = j.drop_link(2), p.drop_link(2)
    np.testing.assert_array_equal(np.asarray(rj), rp.numpy())
    _same_state(j, p)
    # the carry: a dead uplink's residual, its unacked frames rolled back
    for st in (j, p):
        st.begin_frame(1)
        assert st.stash_carry(1, -1)
        st.add(_tree(50))
    _same_state(j, p)
    (cj, vj), (cp, vp) = j.take_link_and_snapshot(-1), p.take_link_and_snapshot(-1)
    np.testing.assert_array_equal(np.asarray(cj), cp.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vp.numpy())
    # a ranged link's residual masked; its RMS as JAX computes it
    for st in (j, p):
        st.mask_link_residual(3, 64, 700)
    _same_state(j, p)
    assert j.residual_rms(3) == p.residual_rms(3)
    assert j.state_version() == p.state_version()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_receive_frames_matches_jax(k):
    """Batches of k frames (some all-zero-scale) decoded off the wire,
    applied to the replica and every other link's residual."""
    j, p = _pair(3)
    for st in (j, p):
        for lid in (1, 2, 3):
            st.new_link(lid, seed=lid == 1)
    src = SharedTensor(_tree(4), seed_values=True, host_tier=True)
    src.new_link(1)
    frames = []
    for _ in range(k):
        _, f = src.begin_frame(1)
        frames.append(src.finish_frame(f))
    if k > 1:
        frames[1] = frames[1]._replace(scales=np.zeros_like(frames[1].scales))
    incoming = [wire.decode_frame(wire.encode_frame(f, i + 1), p.spec) for i, f in enumerate(frames)]
    j.receive_frames(2, _copies(incoming))
    p.receive_frames(2, incoming)
    _same_state(j, p)


def test_read_returns_cpu_tensors_that_are_copies():
    _, p = _pair(5)
    out = p.read()
    assert set(out) == {"w", "b", "z"}
    for k, v in out.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu" and v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), _tree(5)[k])
    out["w"] += 1.0  # an edit of a read result never reaches the replica
    np.testing.assert_array_equal(p.read()["w"].numpy(), _tree(5)["w"])


def test_host_tier_rejects_a_cuda_device():
    with pytest.raises(ValueError, match="host tier"):
        SharedTensor(_tree(0), host_tier=True, device="cuda")
    with pytest.raises(ValueError, match="host tier"):
        SharedTensor(_tree(0), host_tier=True, device="cuda:0")
    st = SharedTensor(_tree(0), host_tier=True)
    assert st.device.type == "cpu" and st.host_tier


def test_device_tier_is_unchanged_by_default():
    st = SharedTensor(_tree(0), seed_values=True, device="cpu")
    assert not st.host_tier
    with pytest.raises(RuntimeError, match="host tier"):
        st.begin_frame_burst(1, 4)


def test_burst_stops_at_the_first_idle_frame():
    """Uniform magnitudes drain exactly: the burst ends early, with every
    frame non-idle, and the next burst is empty (acknowledged as a no-op)."""
    tree = {"u": np.full(256, 0.75, np.float32)}
    j = JaxSharedTensor(tree, seed_values=True)
    p = SharedTensor(tree, seed_values=True, host_tier=True)
    for st in (j, p):
        st.new_link(1)
    (sj, bj), (sp, bp) = j.begin_frame_burst(1, 64), p.begin_frame_burst(1, 64)
    assert 0 < len(bp) == len(bj) < 64 and all(f.scales.any() for f in bp)
    assert p.residual_rms(1) == 0.0
    assert p.begin_frame_burst(1, 64)[1] == []
    assert make_spec(tree).total == p.spec.total
