"""The CPU device tier's burst and the state lock (shared_tensor_tpu_torch.
core.SharedTensor, utils/locktrace).

On the CPU a device-tier burst quantizes its link's residual off the state
lock: it takes the residual out under the lock, leaves a buffer of -0.0 in
its place for whatever comes in meanwhile, and folds that buffer back in
under the lock with the burst's ledger entry. These cases pin it:

- with nothing racing, every burst, residual (signed zeros included),
  replica and ledger entry is bit for bit the burst the lock held
  throughout (the plain cascade on a copy);
- while a burst quantizes, another thread's add, snapshot, read and
  receive each return (each would wait for the whole burst if the lock
  were held), and every add that raced a burst is counted exactly once in
  the residual plus the frames;
- a drop during a burst waits for its fold, so the returned residual
  owes the burst's frames exactly as before;
- the plain halves it relies on stay bit for bit: the CPU's partials and
  the split apply.

Tolerances: bit for bit, except where adds race a burst: those are held
to (adds + frames + 1) * eps(f32) * max|value|, one f32 rounding for each
step of the residual, where a lost or doubled add is off by a whole delta."""

import threading

import numpy as np
import pytest
import torch

import shared_tensor_tpu_torch.core as core_mod
from shared_tensor_tpu_torch.core import SharedTensor
from shared_tensor_tpu_torch.ops import codec_cuda
from shared_tensor_tpu_torch.ops.table import (
    TableFrame,
    apply_delta,
    apply_table_batch,
    frames_delta,
    quantize_table_cascade,
)
from shared_tensor_tpu_torch.utils import locktrace

CPU = "cpu"
JOIN_S = 30.0  # a thread that waits for a held lock never returns: this only bounds the test


def _tree(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n,)).astype(np.float32), "b": rng.normal(size=(7, 5)).astype(np.float32)}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.int32).copy()


def _delta_sum(frames, spec) -> torch.Tensor:
    """The summed delta of wire frames (each one's plain apply onto zeros),
    in f64."""
    out = torch.zeros(spec.total, dtype=torch.float64)
    for f in frames:
        one = torch.zeros(spec.total, dtype=torch.float32)
        stacked = TableFrame(torch.as_tensor(np.asarray(f.scales)).reshape(1, -1),
                             torch.as_tensor(np.asarray(f.words).view(np.int32)).reshape(1, -1))
        apply_table_batch((one,), stacked, spec)
        out += one.double()
    return out


@pytest.mark.parametrize("cascade", [1, 16])
def test_sequential_bursts_are_the_locked_burst_bit_for_bit(cascade):
    """Adds, receives and bursts in turn, with nothing racing: the frames,
    the residuals (signed zeros included), the replica and the ledger equal
    the plain cascade run on a copy of each residual, as the burst under
    the lock ran it."""
    t = _tree(1)
    st = SharedTensor(t, device=CPU, seed_values=True, cascade=cascade)
    st.new_link(1, seed=True)
    st.new_link(2, seed=False)
    ref = {1: st._links[1].clone(), 2: st._links[2].clone()}
    # a negative zero in a residual: -0.0 + -0.0 keeps its sign bit, the
    # sign bit is the codec's bit
    st._links[2][3] = -0.0
    ref[2][3] = -0.0
    rng = np.random.default_rng(2)
    k = 8
    for step in range(12):
        if step % 3 == 0:
            d = {"w": rng.normal(size=(300,)).astype(np.float32), "b": rng.normal(size=(7, 5)).astype(np.float32)}
            st.add(d)
            u = core_mod.flatten(d, st.spec, CPU)
            for r in ref.values():
                r.add_(u).clamp_(-3.0e38, 3.0e38)
        link = 1 + step % 2
        seq, df = st.begin_frame_burst_device(link, k)
        want, _ = quantize_table_cascade(ref[link], st.spec, k, cascade)
        assert np.array_equal(_bits(df.scales), _bits(want.scales))
        assert np.array_equal(_bits(df.words), _bits(want.words))
        for lk in (1, 2):
            assert np.array_equal(_bits(st._links[lk]), _bits(ref[lk])), (step, lk)
        entry = st._inflight[link][seq]
        assert len(entry) == k and all(torch.equal(e.scales, want.scales[i]) for i, e in enumerate(entry))
        st.ack_frame(link, seq)
    assert not st._bursting


@pytest.mark.parametrize("cascade", [1, 16])
def test_a_signed_zero_survives_an_unraced_burst(cascade):
    """A -0.0 in an idle leaf (scale 0: the burst leaves it as it is) is
    still -0.0 after a burst that nothing raced: the fold adds -0.0, and
    -0.0 + -0.0 keeps the sign bit, where +0.0 would clear it."""
    rng = np.random.default_rng(12)
    t = {"w": rng.normal(size=(300,)).astype(np.float32), "z": np.zeros(40, np.float32)}
    st = SharedTensor(t, device=CPU, seed_values=True, cascade=cascade)
    st.new_link(1, seed=True)
    zs = torch.nonzero(core_mod.flatten({"w": np.zeros(300, np.float32), "z": np.ones(40, np.float32)},
                                        st.spec, CPU)).flatten()
    st._links[1][zs[::2]] = -0.0
    want = st._links[1].clone()
    seq, df = st.begin_frame_burst_device(1, 8)
    frames, _ = quantize_table_cascade(want, st.spec, 8, cascade)
    assert np.array_equal(_bits(df.words), _bits(frames.words))
    assert np.array_equal(_bits(st._links[1]), _bits(want))
    assert bool(torch.signbit(st._links[1][zs[::2]]).all())


def _pausing_burst(monkeypatch, during):
    """Make the next CPU burst call ``during()`` from inside its quantize,
    where the state lock is free; returns the list of what ``during``
    returned."""
    real = core_mod.quantize_table_cascade
    out = []

    def burst(*a, **kw):
        out.append(during())
        return real(*a, **kw)

    monkeypatch.setattr(core_mod, "quantize_table_cascade", burst)
    return out


def _in_thread(fn):
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # reported by the caller
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(JOIN_S)
    assert not th.is_alive(), "the call waited for the burst's lock"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def test_calls_of_other_threads_return_during_a_burst(monkeypatch):
    """While a burst quantizes, another thread's add, snapshot_flat, read
    and receive_frames each return: the bridge rank's pull and push no
    longer wait for the send thread's burst."""
    t = _tree(3)
    st = SharedTensor(t, device=CPU, seed_values=True, cascade=16)
    st.new_link(1, seed=True)
    st.new_link(2, seed=False)
    other = SharedTensor(t, device=CPU, seed_values=True, cascade=16)
    other.new_link(9, seed=True)
    _, incoming = other.begin_frame_burst_device(9, 4)
    frames = other.finish_frame_burst(incoming)
    one = {"w": np.ones(300, np.float32), "b": np.ones((7, 5), np.float32)}

    def during():
        assert 1 in st._bursting
        _in_thread(lambda: st.add(one))
        snap = _in_thread(st.snapshot_flat)
        _in_thread(st.read)
        _in_thread(lambda: st.receive_frames(2, frames))
        return snap

    calls = _pausing_burst(monkeypatch, during)
    before = st.snapshot_flat()
    st.begin_frame_burst_device(1, 8)
    assert len(calls) == 1
    # the snapshot taken mid-burst already held the add
    assert torch.allclose(calls[0] - before, core_mod.flatten(one, st.spec, CPU))
    assert not st._bursting


@pytest.mark.parametrize("cascade", [1, 16])
def test_adds_that_race_bursts_are_counted_once(monkeypatch, cascade):
    """Adds from another thread, each landing while a burst quantizes:
    every one is in the replica once, and in the link's residual plus its
    frames once."""
    t = _tree(4)
    st = SharedTensor(t, device=CPU, cascade=cascade)
    st.new_link(1, seed=False)
    rng = np.random.default_rng(5)
    deltas = [{"w": rng.normal(size=(300,)).astype(np.float32), "b": rng.normal(size=(7, 5)).astype(np.float32)}
              for _ in range(6)]
    pending = list(deltas)
    raced = []

    def during():
        if pending:
            d = pending.pop(0)
            _in_thread(lambda: st.add(d))
            raced.append(d)

    _pausing_burst(monkeypatch, during)
    sent = []
    for _ in range(40):
        seq, df = st.begin_frame_burst_device(1, 8)
        got = st.finish_frame_burst(df)
        st.ack_frame(1, seq)
        sent += got or []
    assert len(raced) == len(deltas)
    total = sum(core_mod.flatten(d, st.spec, CPU).double() for d in deltas)
    owed = st._links[1].double() + _delta_sum(sent, st.spec)
    # f32 rounding: one add or one frame's step at a time, each within
    # eps * max|value|; a lost or doubled add is off by a whole delta
    tol = (len(deltas) + len(sent) + 1) * np.finfo(np.float32).eps * float(total.abs().max())
    assert float((owed - total).abs().max()) <= tol
    assert float((st.snapshot_flat().double() - total).abs().max()) <= tol


def test_a_drop_during_a_burst_waits_for_its_fold(monkeypatch):
    """drop_link from another thread while a burst quantizes returns only
    after the burst's fold and ledger entry: the residual it returns owes
    the burst's frames (rolled back) and the add that raced it."""
    t = _tree(6)
    st = SharedTensor(t, device=CPU, seed_values=True, cascade=16)
    st.new_link(1, seed=True)
    seeded = st._links[1].clone().double()
    one = {"w": np.full(300, 0.5, np.float32), "b": np.full((7, 5), 0.5, np.float32)}
    box = {}

    def during():
        _in_thread(lambda: st.add(one))
        th = threading.Thread(target=lambda: box.setdefault("resid", st.drop_link(1)), daemon=True)
        th.start()
        box["thread"] = th

    _pausing_burst(monkeypatch, during)
    out = st.begin_frame_burst_device(1, 8)
    box["thread"].join(JOIN_S)
    assert not box["thread"].is_alive()
    assert out is not None  # the burst went through: the drop waited for it
    want = seeded + core_mod.flatten(one, st.spec, CPU).double()
    got = box["resid"].double()
    assert float((got - want).abs().max()) <= 4 * np.finfo(np.float32).eps * float(want.abs().max())
    assert not st._bursting and 1 not in st._inflight


def test_nack_during_a_burst_rolls_back_what_was_ledgered():
    """A NACK rolls back the link's ledger as it stands: entries ledgered
    before a burst go back into the residual, the burst's own entry (taken
    at its fold) stays for its ACK."""
    t = _tree(7)
    st = SharedTensor(t, device=CPU, seed_values=True, cascade=16)
    st.new_link(1, seed=True)
    seq1, _ = st.begin_frame_burst_device(1, 4)
    st.nack_frame(1)
    assert 1 not in st._inflight or seq1 not in st._inflight[1]
    seq2, _ = st.begin_frame_burst_device(1, 4)
    assert seq2 in st._inflight[1]


def test_cpu_partials_are_the_kernel_order_bit_for_bit():
    """The CPU's partials (a cumsum per word) equal the kernel-order loop of
    each word's 32 values in turn, bit for bit."""
    rng = np.random.default_rng(8)
    v = torch.from_numpy((rng.normal(size=128 * 64) * np.exp(rng.normal(size=128 * 64) * 8)).astype(np.float32))
    v[::97] = 0.0
    got = codec_cuda.slot_partials_plain(v, torch.empty((3, codec_cuda.partial_slots(64)), dtype=torch.float64))
    x = v.reshape(-1, 32).double()
    ss = torch.zeros(x.shape[0], dtype=torch.float64)
    sabs = torch.zeros_like(ss)
    for b in range(32):
        ss = ss + x[:, b] * x[:, b]
        sabs = sabs + x[:, b].abs()
    ss, sabs = ss.view(-1, 32), sabs.view(-1, 32)
    h = 16
    while h:
        ss, sabs = ss[:, :h] + ss[:, h: 2 * h], sabs[:, :h] + sabs[:, h: 2 * h]
        h //= 2
    assert torch.equal(got[1, : ss.shape[0]], ss[:, 0]) and torch.equal(got[2, : ss.shape[0]], sabs[:, 0])


@pytest.mark.parametrize("chunk", [1, 3, 1 << 22])
def test_split_apply_is_plain_kernel_b_bit_for_bit(monkeypatch, chunk):
    """frames_delta then apply_delta (the CPU receive's two halves, and the
    plain kernel B's, unpacked ``chunk`` rows' worth at a time) equal the
    frame-by-frame sum from 0.0, bit for bit."""
    t = _tree(9)
    st = SharedTensor(t, device=CPU, seed_values=True, cascade=16)
    st.new_link(1, seed=True)
    _, df = st.begin_frame_burst_device(1, 6)
    spec = st.spec
    rows = spec.rows
    monkeypatch.setattr(codec_cuda, "APPLY_PLAIN_ELEMS", chunk * rows * codec_cuda.LANES)
    base = [torch.from_numpy(np.random.default_rng(10 + i).normal(size=spec.total).astype(np.float32)) for i in range(2)]
    split = [b.clone() for b in base]
    apply_delta(split, frames_delta(df, spec), spec)
    # the reference: each frame's delta added to a running f32 sum in order
    from shared_tensor_tpu_torch.ops.packing import unpack_bits
    from shared_tensor_tpu_torch.ops.table import _consts

    row_leaf, rowcount, *_ = _consts(spec, CPU)
    delta = torch.zeros(rows, codec_cuda.LANES)
    for kf in range(df.scales.shape[0]):
        bits = unpack_bits(df.words[kf]).view(rows, codec_cuda.LANES).float()
        delta = delta + df.scales[kf][row_leaf][:, None] * (1.0 - 2.0 * bits)
    live = torch.arange(codec_cuda.LANES)[None, :] < rowcount[:, None]
    delta = torch.where(live, delta, torch.zeros_like(delta))
    for b, s in zip(base, split):
        want = torch.where(live, torch.clamp(b.view(rows, -1) + delta, -3.0e38, 3.0e38), torch.zeros_like(delta))
        assert np.array_equal(_bits(s), _bits(want.reshape(-1)))
    batch = [b.clone() for b in base]
    apply_table_batch(batch, df, spec)
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(batch, split))


def test_lock_trace_times_each_call_site(monkeypatch):
    """ST_LOCK_TRACE=1 gives a SharedTensor a traced lock: its table names
    each call site with its acquisitions, wait and hold; without it the
    lock is plain and the table empty."""
    t = _tree(11)
    assert SharedTensor(t, device=CPU).lock_stats() == {}
    monkeypatch.setenv(locktrace.ENV, "1")
    st = SharedTensor(t, device=CPU, seed_values=True, cascade=16)
    st.new_link(1, seed=True)
    for _ in range(3):
        seq, _ = st.begin_frame_burst_device(1, 4)
        st.ack_frame(1, seq)
    st.snapshot_flat()
    stats = st.lock_stats()
    assert stats["begin_frame_burst_device"]["n"] == 3
    assert stats["_burst_off_lock"]["n"] == 3  # the fold
    assert stats["snapshot_flat"]["n"] == 1 and stats["ack_frame"]["n"] == 3
    for row in stats.values():
        assert row["hold_s"] >= 0 and row["wait_s"] >= 0 and row["max_hold_s"] <= row["hold_s"] + 1e-12
    # the table is ordered by total hold
    holds = [row["hold_s"] for row in stats.values()]
    assert holds == sorted(holds, reverse=True)


def test_traced_lock_waits_are_the_holders():
    """A second thread's wait for a TracedLock is the first's hold."""
    lock = locktrace.TracedLock()
    held = threading.Event()

    def holder():
        with lock:
            held.set()
            threading.Event().wait(0.05)

    th = threading.Thread(target=holder)
    th.start()
    held.wait()
    with lock:
        pass
    th.join()
    stats = lock.stats()
    assert stats["holder"]["hold_s"] >= 0.04
    assert stats["test_traced_lock_waits_are_the_holders"]["wait_s"] >= 0.02
