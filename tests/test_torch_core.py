"""Port: shared_tensor_tpu_torch.core.SharedTensor on the CPU.

The semantics cases of tests/test_core.py, run on the port, then one
three-node schedule run on both packages and compared frame by frame. The
JAX core is pinned to its device tier (``ST_HOST_CODEC=xla``), whose codec
is the XLA golden; the port runs its plain versions on the CPU.

Tolerances: convergence to 1e-5 as in tests/test_core.py; the JAX-vs-port
schedule bit-exact (scales, words, residuals, replicas)."""

import numpy as np
import pytest
import torch

from shared_tensor_tpu_torch.core import DuplicateLink, SharedTensor
from shared_tensor_tpu_torch.ops import codec_cuda
from shared_tensor_tpu_torch.ops.table import TableFrame

CPU = "cpu"


def _st(t, **kw):
    return SharedTensor(t, device=CPU, **kw)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.uniform(-1, 1, size=(20, 30)).astype(np.float32),
        "b": rng.uniform(-1, 1, size=(50,)).astype(np.float32),
    }


def _quiet(f, tol=1e-6):
    return f is None or float(np.max(np.asarray(f.scales))) < tol


def _pump(a, b, la, lb, steps=120):
    for _ in range(steps):
        fa = a.make_frame(la)
        fb = b.make_frame(lb)
        if fa is not None:
            b.receive_frame(lb, fa)
        if fb is not None:
            a.receive_frame(la, fb)
        if _quiet(fa) and _quiet(fb):
            return
    raise AssertionError("links did not quiesce")


def _close(st, want, atol=1e-5):
    got = st.read()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=atol)


def test_default_device_is_cuda_or_raises():
    t = _tree(0)
    if torch.cuda.is_available():
        assert SharedTensor(t).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            SharedTensor(t)


def test_seeded_state_transfer():
    t = _tree(0)
    master, joiner = _st(t, seed_values=True), _st(t)
    master.new_link(1, seed=True)
    joiner.new_link(1, seed=False)
    _pump(master, joiner, 1, 1)
    _close(joiner, t)


def test_concurrent_adds_converge():
    t = _tree(1)
    a, b = _st(t, seed_values=True), _st(t)
    a.new_link(1, seed=True)
    b.new_link(1, seed=False)
    _pump(a, b, 1, 1)
    a.add({k: np.full_like(v, 0.5) for k, v in t.items()})
    b.add({k: np.full_like(v, 0.25) for k, v in t.items()})
    _pump(a, b, 1, 1)
    for st in (a, b):
        _close(st, {k: t[k] + 0.75 for k in t})


def test_three_node_chain_floods():
    t = _tree(2)
    a, b, c = _st(t, seed_values=True), _st(t), _st(t)
    a.new_link(10, seed=True)
    b.new_link(10, seed=False)
    b.new_link(20, seed=True)
    c.new_link(20, seed=False)

    def pump_all(steps=160):
        for _ in range(steps):
            active = False
            for src, dst, l in ((a, b, 10), (b, a, 10), (b, c, 20), (c, b, 20)):
                f = src.make_frame(l)
                if f is not None:
                    dst.receive_frame(l, f)
                    active = active or not _quiet(f)
            if not active:
                return
        raise AssertionError("chain did not quiesce")

    pump_all()
    for st in (b, c):
        _close(st, t)
    a.add({k: np.full_like(v, 1.0) for k, v in t.items()})
    pump_all()
    _close(c, {k: t[k] + 1.0 for k in t})


def test_drop_link_and_regraft():
    t = _tree(3)
    a, b = _st(t, seed_values=True), _st(t)
    a.new_link(1, seed=True)
    b.new_link(1, seed=False)
    _pump(a, b, 1, 1)
    a.drop_link(1)
    a.add({k: np.full_like(v, 2.0) for k, v in t.items()})
    c = _st(t)
    a.new_link(2, seed=True)
    c.new_link(2, seed=False)
    _pump(a, c, 2, 2)
    _close(c, {k: t[k] + 2.0 for k in t})


def test_regraft_carry_algebra():
    t = _tree(7)
    parent, child = _st(t, seed_values=True), _st(t, seed_values=True)
    x = {k: np.full_like(v, 0.5) for k, v in t.items()}
    child.new_link(9, seed=False)
    child.add(x)
    carry = child.drop_link(9)
    snap = child.snapshot_flat() - carry
    child.add({k: np.full_like(v, -0.25) for k, v in t.items()})
    parent.new_link_diff(2, snap)
    child.new_link_diff(2, snap)
    parent.add({k: np.full_like(v, 1.0) for k, v in t.items()})
    _pump(parent, child, 2, 2)
    for st in (parent, child):
        _close(st, {k: t[k] + 0.5 - 0.25 + 1.0 for k in t})


def test_zero_template_no_hang():
    master = _st({"a": np.zeros(100, np.float32)}, seed_values=True)
    master.new_link(1, seed=True)
    assert master.make_frame(1) is None
    assert float(master.read()["a"].abs().max()) == 0.0


def test_size_mismatch_raises():
    st = _st(_tree(5), seed_values=True)
    with pytest.raises(ValueError):
        st.add({"w": np.zeros((2, 2), np.float32), "b": np.zeros(50, np.float32)})


def test_duplicate_link_raises():
    st = _st(_tree(5))
    st.new_link(1)
    with pytest.raises(DuplicateLink):
        st.new_link(1)
    with pytest.raises(DuplicateLink):
        st.new_link_diff(1, np.zeros(st.spec.total, np.float32))


def test_metrics_counters():
    t = _tree(6)
    a = _st(t, seed_values=True)
    a.new_link(1, seed=True)
    f = a.make_frame(1)
    assert f is not None and a.frames_out == 1
    assert f.words.dtype == np.uint32 and f.scales.dtype == np.float32
    a.receive_frame(1, f)
    assert a.frames_in == 1
    a.add(t)
    assert a.updates == 1 and a.state_version() == 2
    assert a.residual_rms(1) >= 0.0 and a.residual_rms(99) == 0.0


def test_zero_scale_frames_count_nowhere():
    t = _tree(16)
    a = _st(t, seed_values=True)
    a.new_link(1, seed=True)
    real = a.make_frame(1)
    zero = TableFrame(np.zeros_like(real.scales), real.words)
    before = a.snapshot_flat()
    a.receive_frame(1, zero)
    assert a.frames_in == 0
    assert torch.equal(a.snapshot_flat(), before)
    a.receive_frames(1, [real, zero, zero])
    assert a.frames_in == 1


def test_receive_frames_backlog_contract(monkeypatch):
    """K frames from one link land in ONE batched pass of K frames and
    equal sequential application to f32 summation order."""
    import shared_tensor_tpu_torch.core as core_mod

    t = _tree(7)
    sender = _st(t, seed_values=True)
    sender.new_link(1, seed=True)
    frames = []
    for _ in range(50):
        f = sender.make_frame(1)
        if f is None:
            break
        frames.append(f)
    assert len(frames) >= 20
    seq = _st(t)
    seq.new_link(1, seed=False)
    seq.new_link(2, seed=False)
    for f in frames:
        seq.receive_frame(1, f)
    batched = _st(t)
    batched.new_link(1, seed=False)
    batched.new_link(2, seed=False)
    calls = {"batch": [], "single": 0}
    orig_batch, orig_many = core_mod.apply_table_batch, core_mod.apply_table_many
    orig_delta = core_mod.frames_delta

    def counting_batch(arrays, frames_, spec, *a, **kw):
        calls["batch"].append(frames_.scales.shape[0])
        return orig_batch(arrays, frames_, spec, *a, **kw)

    def counting_delta(frames_, spec):  # the CPU's one pass: its delta off the lock
        calls["batch"].append(frames_.scales.shape[0])
        return orig_delta(frames_, spec)

    def counting_many(*a, **kw):
        calls["single"] += 1
        return orig_many(*a, **kw)

    monkeypatch.setattr(core_mod, "apply_table_batch", counting_batch)
    monkeypatch.setattr(core_mod, "apply_table_many", counting_many)
    monkeypatch.setattr(core_mod, "frames_delta", counting_delta)
    batched.receive_frames(1, frames)
    assert calls == {"batch": [len(frames)], "single": 0}, calls
    assert batched.frames_in == len(frames)
    np.testing.assert_allclose(batched.snapshot_flat(), seq.snapshot_flat(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(batched._links[2], seq._links[2], rtol=1e-6, atol=1e-6)


def test_read_and_snapshots_are_copies():
    tpl = {"w": np.ones((8, 16), np.float32)}
    st = _st(tpl, seed_values=True)
    st.new_link(1)
    st.read()["w"].add_(99.0)
    st.snapshot_flat().add_(99.0)
    vals, links = st.snapshot_all()
    vals.add_(99.0)
    links[1].add_(99.0)
    assert torch.equal(st.read()["w"], torch.ones(8, 16))
    assert float(st._links[1].max()) == 1.0


def test_no_aliasing_between_replica_and_residuals():
    """The port updates in place, so a seeded link, a handed-in residual and
    a re-grafted carry must each own their buffer: an add must land once."""
    tpl = {"w": np.ones(300, np.float32)}
    st = _st(tpl, seed_values=True)
    st.new_link(1, seed=True)
    given = np.full(st.spec.total, 2.0, np.float32)
    st.new_link(2, residual=given)
    st.add({"w": np.ones(300, np.float32)})
    assert float(st.read()["w"].max()) == 2.0
    assert float(st._links[1].max()) == 2.0
    assert float(st._links[2].max()) == 3.0 and given.max() == 2.0
    st.stash_carry(2, 50)
    st.regraft_reset_to_carry(50, 3)
    assert st.values.untyped_storage().data_ptr() != st._links[3].untyped_storage().data_ptr()
    st.add({"w": np.ones(300, np.float32)})
    assert float(st.read()["w"].max()) == 4.0 and float(st._links[3].max()) == 4.0
    resid, snap = st.take_link_and_snapshot(3)
    snap.add_(1.0)
    assert float(st.read()["w"].max()) == 4.0


def test_mask_link_residual():
    st = _st({"w": np.ones(2048, np.float32)}, seed_values=True)
    st.new_link(1)
    st.mask_link_residual(1, 100, 200)
    r = st._links[1]
    assert float(r[:100].abs().max()) == 0.0 and float(r[200:].abs().max()) == 0.0
    assert float(r[100:200].min()) == 1.0
    assert float(st.read()["w"].min()) == 1.0


def test_nack_rolls_back_and_ack_forgets():
    t = _tree(8)
    st = _st(t, seed_values=True)
    st.new_link(1, seed=True)
    r0 = st._links[1].clone()
    s1, f1 = st.begin_frame(1)
    s2, f2 = st.begin_frame(1)
    assert st.inflight_total() == 2
    st.nack_frame(1)
    assert st.inflight_total() == 0
    np.testing.assert_allclose(st._links[1].numpy(), r0.numpy(), rtol=0, atol=1e-6)
    s3, _ = st.begin_frame(1)
    st.ack_frame(1, s3)
    assert st.inflight_total() == 0
    s4, _ = st.begin_frame(1)
    resid = st.drop_link(1)  # unacked frame rolled back into what is returned
    assert resid is not None and st.drop_link(1) is None


def test_burst_device_equals_sequential_frames():
    """begin_frame_burst_device(k) gives exactly the frames k sequential
    begin_frames would; finish trims the idle tail; nack rolls it back."""
    tpl = np.linspace(-1.0, 1.0, 300).astype(np.float32)
    a, b = _st(tpl, seed_values=True), _st(tpl, seed_values=True)
    a.new_link(7)
    b.new_link(7)
    seq, stacked = a.begin_frame_burst_device(7, 6)
    frames = a.finish_frame_burst(stacked)
    assert len(frames) == 6 and a.frames_out == 6
    for f in frames:
        g = b.make_frame(7)
        np.testing.assert_array_equal(f.scales, g.scales)
        np.testing.assert_array_equal(f.words, g.words)
    assert torch.equal(a._links[7], b._links[7])
    pre = a._links[7].clone()
    a.nack_frame(7)
    assert not torch.equal(a._links[7], pre)


def test_burst_device_idle_and_exhaustion():
    tpl = np.zeros(300, np.float32)
    st = _st(tpl, seed_values=True)
    st.new_link(1, seed=False)
    _, stacked = st.begin_frame_burst_device(1, 8)
    assert st.finish_frame_burst(stacked) is None
    rng = np.random.default_rng(3)
    st2 = _st(tpl, seed_values=True)
    st2.new_link(1, residual=rng.uniform(-1, 1, st2.spec.total).astype(np.float32) * (np.arange(st2.spec.total) < 300))
    _, stacked = st2.begin_frame_burst_device(1, 64)
    frames = st2.finish_frame_burst(stacked)
    assert 0 < len(frames) < 64
    assert float(st2._links[1].abs().max()) == 0.0


@pytest.mark.parametrize("k", [1, 4])
def test_fetch_returns_the_blocking_copy(k):
    """finish_frame / finish_frame_burst return exactly the bytes of a
    blocking .cpu() of the frame begin_frame* produced; on the CPU the
    fetch is that plain copy (no copy in flight). The CUDA twin, with the
    copy on a side stream into pinned buffers, is in test_torch_cuda.py."""
    rng = np.random.default_rng(k)
    tpl = rng.uniform(-1, 1, 3000).astype(np.float32)
    st = _st(tpl, seed_values=True)
    st.new_link(1)
    seq, dev = st.begin_frame(1) if k == 1 else st.begin_frame_burst_device(1, k)
    assert dev.fetch is None
    want_s, want_w = dev.scales.cpu().numpy().copy(), dev.words.cpu().numpy().view(np.uint32).copy()
    if k == 1:
        got = [st.finish_frame(dev)]
        want_s, want_w = want_s[None], want_w[None]
    else:
        got = st.finish_frame_burst(dev)
    assert len(got) == k and st.frames_out == k
    for i, f in enumerate(got):
        assert f.scales.dtype == np.float32 and f.words.dtype == np.uint32
        np.testing.assert_array_equal(f.scales.view(np.uint32), want_s[i].view(np.uint32))
        np.testing.assert_array_equal(f.words, want_w[i])
    assert st.fetch_wait_s > 0.0


def test_plain_path_launches_no_kernel():
    codec_cuda.reset_launches()
    t = _tree(9)
    a, b = _st(t, seed_values=True), _st(t)
    a.new_link(1)
    b.new_link(1, seed=False)
    _pump(a, b, 1, 1)
    assert codec_cuda.LAUNCHES == {"quantize_rows": 0, "apply_rows_batch": 0, "quantize": 0, "apply_frame_many": 0}


# -- JAX vs port, frame by frame ------------------------------------------------


def _schedule(make, t, updates):
    """A three-node chain m - i - l: every node adds its own update, then
    frames are exchanged in batches of up to 3 per link (receive_frames)
    for a fixed number of rounds. Returns every frame sent, in order, and
    the final replicas and residuals as numpy."""
    m, i, l = make(t, True), make(t, False), make(t, False)
    m.new_link(1, seed=True)
    i.new_link(1, seed=False)
    i.new_link(2, seed=True)
    l.new_link(2, seed=False)
    for st, u in zip((m, i, l), updates):
        st.add(u)
    sent = []
    for _ in range(12):
        for src, dst, link in ((m, i, 1), (i, m, 1), (i, l, 2), (l, i, 2)):
            batch = []
            for _ in range(3):
                f = src.make_frame(link)
                if f is None:
                    break
                batch.append(f)
                sent.append((np.asarray(f.scales).copy(), np.asarray(f.words).copy()))
            dst.receive_frames(link, batch)
    state = []
    for st in (m, i, l):
        vals, links = st.snapshot_all()
        state.append((np.asarray(vals), {k: np.asarray(v) for k, v in links.items()}))
    return sent, state


def test_three_node_schedule_matches_jax(monkeypatch):
    monkeypatch.setenv("ST_HOST_CODEC", "xla")
    from shared_tensor_tpu.core import SharedTensor as JaxSharedTensor

    rng = np.random.default_rng(11)
    t = {
        "w": rng.uniform(-1, 1, (20, 30)).astype(np.float32),
        "b": (rng.uniform(-1, 1, (50,)) * 100).astype(np.float32),
    }
    updates = [
        {k: (rng.uniform(-1, 1, v.shape) * s).astype(np.float32) for k, v in t.items()}
        for s in (0.5, 0.25, 2.0)
    ]

    def make_jax(tpl, seed):
        st = JaxSharedTensor(tpl, seed_values=seed)
        assert not st.host_tier
        return st

    jsent, jstate = _schedule(make_jax, t, updates)
    tsent, tstate = _schedule(lambda tpl, seed: _st(tpl, seed_values=seed), t, updates)
    assert len(tsent) == len(jsent) > 20
    for n, ((js, jw), (ts, tw)) in enumerate(zip(jsent, tsent)):
        # no scale of this schedule sits on an octave boundary, so the scales
        # (and with them the whole trajectory) are bit-equal
        np.testing.assert_array_equal(ts, js, err_msg=f"frame {n}")
        np.testing.assert_array_equal(tw, jw, err_msg=f"frame {n}")
    for (jv, jl), (tv, tl) in zip(jstate, tstate):
        np.testing.assert_array_equal(tv, jv)
        assert jl.keys() == tl.keys()
        for k in jl:
            np.testing.assert_array_equal(tl[k], jl[k])
