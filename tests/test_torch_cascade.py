"""The native engine's amax-anchored cascade on the port's Python plane.

The schedule (``ops/table.cascade_ladder`` / ``cascade_schedule`` and
``ops/codec_np.cascade_schedule_np``) against a transcription of the
engine's send loop (``native/stengine.cpp``, 1-bit); kernel A-cascade's
plain twin (``codec_cuda.quantize_rows_cascade_plain``) against the C pass
``stc_quantize_ef_cascade``, the port's build and the JAX package's; the
device tier's cascade burst (``table.quantize_table_cascade``, plain, on
the CPU) against the host tier's (``codec_np.quantize_table_cascade_np``);
``cascade=1`` as today's bursts; conservation; the trim invariant; the
drain of one gaussian add on both Python tiers; the peer's wiring; and a
JAX peer under a cascading port parent.

Tolerances: bits, words, scales and residuals are compared bit for bit,
except where stated: measured scales of the two tiers may sit one octave
apart at an exact octave boundary (``ops/codec_np.py``); conservation is
held to one ulp a frame of twice the leaf's max |r|; peers converge to
test_peer.py's rtol 1e-4, atol 1e-6."""

import math

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest
import torch

from shared_tensor_tpu.ops import codec_np as J
from shared_tensor_tpu_torch import Config, CodecConfig, TransportConfig, create_or_fetch
from shared_tensor_tpu_torch.comm import peer as P
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.core import SharedTensor
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.ops import codec_np as N
from shared_tensor_tpu_torch.ops import table as T
from tests._ports import free_port
from tests.test_torch_peer import wait_converged

LEAVES = (1000, 37, 2048, 1, 3000, 129)


def _spec():
    return T.make_spec({f"l{i}": np.zeros(n, np.float32) for i, n in enumerate(LEAVES)})


def _residual(spec, seed, outliers=True):
    """A padded flat residual: gaussian leaves of mixed magnitudes with
    outliers, one leaf of subnormals and one all-zero leaf."""
    rng = np.random.default_rng(seed)
    flat = np.zeros(spec.total, np.float32)
    off = 0
    for i, (n, p) in enumerate(zip(spec.ns, spec.padded)):
        x = rng.normal(size=n).astype(np.float32) * np.float32(10.0 ** rng.integers(-3, 2))
        if i == 1:
            x = (rng.integers(-40, 40, n) * np.float32(2.0 ** -149)).astype(np.float32)  # subnormals
        if i == 3:
            x[:] = 0.0
        if outliers and n > 100:
            x[rng.integers(0, n, 3)] *= 50.0
        flat[off : off + n] = x
        off += p
    return flat


def _f32bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _u32(w):
    w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
    return w.view(np.uint32) if w.dtype == np.int32 else w


# -- the schedule against the engine's rule --------------------------------------------


def _pow2_mask(x):
    """The engine's pow2 floor of (float)x: the f32 exponent bits alone."""
    bits = np.array([x], np.float32).view(np.uint32) & np.uint32(0x7F800000)
    return bits.view(np.float32)[0]


def _ilogbf(x):
    return math.frexp(float(x))[1] - 1


def engine_round(scales, amax, kcmax, left):
    """The engine's round (stengine.cpp's cascade branch, mprec 1), element
    by element: rows of one cascade message segment and its kc."""
    scales = [np.float32(s) for s in scales]
    if not any(s != 0 for s in scales):
        return [], 0
    kc = 1
    if kcmax > 1:
        maxd = 1
        for s, a in zip(scales, amax):
            if s <= 0:
                continue
            st = _pow2_mask(a)
            if st <= s:
                continue
            maxd = max(maxd, _ilogbf(st) - _ilogbf(s) + 1)
        if maxd > 1:
            maxd += 8
        kc = min(maxd, kcmax)
    kc = min(kc, left)
    rows = []
    for j in range(kc):
        if j == 0:
            if kc == 1:
                row = list(scales)
            else:
                row = [max(_pow2_mask(a), s) if s > 0 else s for s, a in zip(scales, amax)]
        else:
            row = [np.float32(x * np.float32(0.5)) for x in rows[-1]]
            if not any(x != 0 for x in row):
                break
        rows.append(row)
    return rows, kc


def _schedule_cases():
    rng = np.random.default_rng(5)
    out = []
    for i in range(40):
        L = int(rng.integers(1, 9))
        exp_s = rng.integers(-30, 10, L)
        s = np.ldexp(np.float32(1.0), exp_s).astype(np.float32)
        s[rng.random(L) < 0.2] = 0.0  # idle leaves
        amax = (s * rng.uniform(0.5, 2.0 ** rng.integers(0, 20, L))).astype(np.float32)
        out.append((f"pow2-{i}", s, amax, int(rng.integers(1, 65)), int(rng.integers(1, 65))))
    # non-pow2 scales (RMS, ABS_MEAN), subnormal ones included
    s = np.array([0.3, 1e-39, 7e-42, 0.0], np.float32)
    out.append(("rms-subnormal", s, np.array([5.0, 1e-36, 1e-40, 0.0], np.float32), 64, 64))
    # the subnormal floor: a ladder from 2^-140 runs out before its depth
    s = np.array([2.0 ** -145, 2.0 ** -147], np.float32)
    out.append(("floor", s, np.array([2.0 ** -130, 2.0 ** -140], np.float32), 64, 64))
    out.append(("all-zero", np.zeros(3, np.float32), np.zeros(3, np.float32), 32, 16))
    # per_leaf_scale=False: one aggregate scale, each leaf its own max |r|
    out.append(("aggregate", np.full(4, 2.0 ** -7, np.float32),
                np.array([0.0, 2.0 ** -7, 0.3, 40.0], np.float32), 32, 16))
    out.append(("depth-one", np.full(2, 0.25, np.float32), np.array([0.4, 0.26], np.float32), 32, 16))
    out.append(("one-slot-left", np.full(2, 0.25, np.float32), np.array([40.0, 0.26], np.float32), 32, 1))
    return out


@pytest.mark.parametrize("case", _schedule_cases(), ids=lambda c: c[0])
def test_schedule_matches_the_engines_rule(case):
    _, s, amax, cascade, left = case
    want, want_kc = engine_round(s, amax, cascade, left)
    k_max = min(cascade, left)
    rows_np, kc_np = N.cascade_schedule_np(s, amax, k_max)
    rows_t, kc_t = T.cascade_schedule(torch.from_numpy(s), torch.from_numpy(amax), k_max)
    assert kc_np == kc_t == want_kc
    want = np.asarray(want, np.float32).reshape(-1, s.shape[0])
    np.testing.assert_array_equal(_f32bits(rows_np), _f32bits(want))
    np.testing.assert_array_equal(_f32bits(rows_t.numpy()), _f32bits(want))
    # the device body: the round's first row and its depth with a tensor cap
    top, kc = T.cascade_ladder(torch.from_numpy(s), torch.from_numpy(amax), torch.tensor(k_max))
    assert int(kc) == want_kc
    if want_kc:
        np.testing.assert_array_equal(_f32bits(top.numpy()), _f32bits(want[0]))


# -- kernel A-cascade's twin against the C pass ---------------------------------------


def _tops(spec, seed):
    """Per-leaf ladder tops: pow2 and not, one zero (an idle leaf), one in
    the subnormals (its levels reach 0 inside the cascade)."""
    rng = np.random.default_rng(seed)
    top = (np.float32(2.0) ** rng.integers(-12, 3, spec.num_leaves)).astype(np.float32)
    top[0] *= np.float32(1.37)
    top[1] = np.float32(3 * 2.0 ** -147)
    top[3] = 0.0
    return top


@pytest.mark.parametrize("kc", [1, 2, 11, 32, 64])
def test_cascade_twin_matches_the_c_pass(kc):
    spec = _spec()
    r0 = _residual(spec, kc)
    top = _tops(spec, kc)
    sched = [top]
    for _ in range(1, kc):
        sched.append(sched[-1] * np.float32(0.5))
    sched = np.stack(sched)
    w_port, r_port = N.quantize_cascade_np(r0, spec, sched)
    # the JAX package's build of the same C pass
    offs, ns, padded = N._layout(spec)
    w_jax = np.empty((kc, spec.total // 32), np.uint32)
    r_jax = np.empty_like(r0)
    L = spec.num_leaves
    J._native().stc_quantize_ef_cascade(r0, r_jax, offs, ns, padded, L, kc, sched, w_jax.reshape(-1),
                                        spec.total // 32, np.zeros(L), np.zeros(L), np.zeros(L))
    # the twin, at frames [j0, j0 + kc) of a larger burst
    j0, k = 3, kc + 5
    row_leaf, rowcount, *_ = T._consts(spec, "cpu")
    resid = torch.from_numpy(r0.copy())
    words = torch.zeros((k, spec.rows * 4), dtype=torch.int32)
    scales = torch.zeros((k, L), dtype=torch.float32)
    CC.quantize_rows_cascade(torch.from_numpy(top), row_leaf, rowcount, torch.tensor([j0, kc], dtype=torch.int32),
                             resid, words, scales)
    for w in (w_port, w_jax):
        np.testing.assert_array_equal(_u32(words[j0 : j0 + kc]), w)
    np.testing.assert_array_equal(_f32bits(resid.numpy()), _f32bits(r_port))
    np.testing.assert_array_equal(_f32bits(r_port), _f32bits(r_jax))
    np.testing.assert_array_equal(_f32bits(scales[j0 : j0 + kc].numpy()), _f32bits(sched))
    # the frames outside the call's range are untouched
    assert not words[:j0].any() and not words[j0 + kc :].any()
    assert not scales[:j0].any() and not scales[j0 + kc :].any()
    # subnormals survive (no flush to zero) and padding stays 0
    assert np.any((np.abs(r_port) > 0) & (np.abs(r_port) < np.finfo(np.float32).tiny))
    live = N._live_mask(spec)
    assert not r_port[~live].any()


def test_cascade_wrapper_checks_and_counts():
    """The wrapper runs the plain twin on CPU tensors (no launch counted),
    refuses the kernel off the GPU, and checks its arguments; a depth past
    the frames left is clipped, and depth 0 does nothing."""
    spec = _spec()
    row_leaf, rowcount, *_ = T._consts(spec, "cpu")
    top = torch.from_numpy(_tops(spec, 0))
    resid = torch.from_numpy(_residual(spec, 0))
    words = torch.zeros((4, spec.rows * 4), dtype=torch.int32)
    scales = torch.zeros((4, spec.num_leaves), dtype=torch.float32)
    CC.reset_launches()
    before = resid.clone()
    CC.quantize_rows_cascade(top, row_leaf, rowcount, torch.tensor([1, 0], dtype=torch.int32), resid, words, scales)
    assert torch.equal(resid, before) and not words.any()
    CC.quantize_rows_cascade(top, row_leaf, rowcount, torch.tensor([2, 9], dtype=torch.int32), resid, words, scales)
    # kc 9 at j0 2 of 4 frames: frames 2 and 3, the idle leaf's scale 0
    assert scales[2:, top != 0].ne(0).all() and not scales[2:, top == 0].any() and not scales[:2].any()
    assert words[2:].any() and not words[:2].any()
    assert CC.ENGINE_LAUNCHES == {"quantize_rows_cascade": 0, "cascade_round": 0, "frame_scale": 0, "leaf_scale": 0}
    assert CC.launches()["quantize_rows_cascade"] == 0
    state = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        CC.quantize_rows_cascade_kernel(top, row_leaf, rowcount, state, resid, words, scales)
    with pytest.raises(TypeError):
        CC.quantize_rows_cascade(top.double(), row_leaf, rowcount, state, resid, words, scales)
    with pytest.raises(ValueError):
        CC.quantize_rows_cascade(top, row_leaf[:-1], rowcount, state, resid, words, scales)
    with pytest.raises(ValueError):  # words and residual share storage
        CC.quantize_rows_cascade(top, row_leaf, rowcount, state, resid, resid.view(torch.int32)[: words.numel()]
                                 .view(words.shape), scales)
    with pytest.raises(ValueError):
        T.quantize_table_cascade(resid, spec, 4, 8, impl="nope")


# -- the two tiers against each other --------------------------------------------------


def _first_measure_within_an_octave(r, spec, per_leaf):
    s_t = T._table_scales(torch.from_numpy(r.copy()), spec, ScalePolicy.POW2_RMS, per_leaf).numpy()
    s_n = N.compute_scales_np(r, spec, ScalePolicy.POW2_RMS, per_leaf)
    ratio = np.where(s_n > 0, s_t / np.where(s_n > 0, s_n, 1), 1.0)
    assert np.all((s_t > 0) == (s_n > 0))
    assert np.all(np.isin(ratio, (0.5, 1.0, 2.0)))
    return np.array_equal(s_t, s_n)


def _trimmed(scales, words):
    n = 0
    while n < scales.shape[0] and scales[n].any():
        n += 1
    assert not scales[n:].any(), "a non-zero frame after a zero one"
    return scales[:n], words[:n]


@pytest.mark.parametrize("cascade", [8, 32])
@pytest.mark.parametrize("k", [4, 16, 64])
def test_device_tier_cascade_equals_the_host_tiers(k, cascade):
    spec = _spec()
    r0 = _residual(spec, 100 + k + cascade)
    assert _first_measure_within_an_octave(r0, spec, True)
    resid = torch.from_numpy(r0.copy())
    frame, _ = T.quantize_table_cascade(resid, spec, k, cascade, impl="plain")
    s_dev, w_dev = _trimmed(frame.scales.numpy(), _u32(frame.words))
    s_host, w_host, r_host = N.quantize_table_cascade_np(r0, spec, k, cascade)
    assert s_host.shape[0] == s_dev.shape[0] > 1
    np.testing.assert_array_equal(_f32bits(s_dev), _f32bits(s_host))
    np.testing.assert_array_equal(w_dev, w_host)
    np.testing.assert_array_equal(_f32bits(resid.numpy()), _f32bits(r_host))


def test_aggregate_scale_cascade_agrees_on_both_tiers():
    """per_leaf_scale=False: one measured scale for every leaf, a ladder top
    per leaf from its own max |r| (the engine's scales_from_partials)."""
    spec = _spec()
    r0 = _residual(spec, 7)
    assert _first_measure_within_an_octave(r0, spec, False)
    resid = torch.from_numpy(r0.copy())
    frame, _ = T.quantize_table_cascade(resid, spec, 32, 32, per_leaf=False, impl="plain")
    s_dev, w_dev = _trimmed(frame.scales.numpy(), _u32(frame.words))
    s_host, w_host, r_host = N.quantize_table_cascade_np(r0, spec, 32, 32, per_leaf=False)
    np.testing.assert_array_equal(_f32bits(s_dev), _f32bits(s_host))
    np.testing.assert_array_equal(w_dev, w_host)
    np.testing.assert_array_equal(_f32bits(resid.numpy()), _f32bits(r_host))
    # the first frame's row differs by leaf though the measurement is one
    assert len(set(s_host[0][s_host[0] > 0].tolist())) > 1


# -- cascade=1 is today's burst ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 16])
def test_cascade_one_is_todays_burst(k):
    spec = _spec()
    r0 = _residual(spec, 11)
    want, r_want = T.quantize_table_burst(torch.from_numpy(r0.copy()), spec, k)
    got, r_got = T.quantize_table_cascade(torch.from_numpy(r0.copy()), spec, k, 1)
    assert torch.equal(got.scales.view(torch.int32), want.scales.view(torch.int32))
    assert torch.equal(got.words, want.words) and torch.equal(r_got.view(torch.int32), r_want.view(torch.int32))
    # SharedTensor's default schedule is 1 on both tiers, and its bursts are today's
    tpl = {f"l{i}": np.zeros(n, np.float32) for i, n in enumerate(LEAVES)}
    for host in (False, True):
        st = SharedTensor(tpl, device="cpu", host_tier=host)
        assert st.cascade == 1
        st.new_link(1)
        st._links[1].copy_(torch.from_numpy(r0))
        if host:
            _, frames = st.begin_frame_burst(1, k)
            r = r0.copy()
            for f in frames:
                s, w, _ = N.quantize_table_np(r, spec, out=r)
                np.testing.assert_array_equal(_f32bits(f.scales), _f32bits(s))
                np.testing.assert_array_equal(f.words, w)
        else:
            _, df = st.begin_frame_burst_device(1, k)
            assert torch.equal(df.scales.view(torch.int32), want.scales.view(torch.int32))
            assert torch.equal(df.words, want.words)


# -- conservation and the trim invariant ---------------------------------------------------


def _decoded_sum(scales, words, spec):
    """float64 sum over frames of s * (1 - 2 bit) on live lanes."""
    live = N._live_mask(spec)
    total = np.zeros(spec.total, np.float64)
    for row, wrow in zip(scales, words):
        bits = np.unpackbits(np.ascontiguousarray(wrow).view(np.uint8), bitorder="little")[: spec.total]
        total += N._scale_per_element(row, spec).astype(np.float64) * (1.0 - 2.0 * bits)
    return np.where(live, total, 0.0)


@pytest.mark.parametrize("tier", ["device", "host"])
def test_decoded_frames_plus_residual_conserve_the_mass(tier):
    spec = _spec()
    r0 = _residual(spec, 21)
    if tier == "device":
        resid = torch.from_numpy(r0.copy())
        frame, _ = T.quantize_table_cascade(resid, spec, 64, 32, impl="plain")
        scales, words = _trimmed(frame.scales.numpy(), _u32(frame.words))
        r1 = resid.numpy()
    else:
        scales, words, r1 = N.quantize_table_cascade_np(r0, spec, 64, 32)
    n = scales.shape[0]
    assert n > 16
    err = np.abs(r0.astype(np.float64) - (r1.astype(np.float64) + _decoded_sum(scales, words, spec)))
    amax = N._scale_per_element(np.array([np.abs(r0[o : o + c]).max(initial=0) for o, c, _ in N._leaf_slices(spec)],
                                         np.float32), spec)
    bound = n * np.spacing(np.float32(2.0) * amax).astype(np.float64)
    assert np.all(err <= bound), float((err - bound).max())


def test_no_frame_after_the_first_zero_frame_and_the_ledger_holds_only_no_ops_past_it():
    """A residual that drains within the burst (values on a coarse pow2
    lattice) and one that hits the subnormal floor mid-round: every frame
    after the first all-zero-scale one is all-zero, no later round touched
    the residual (the host tier, which stops there, leaves the same), and
    the device tier's ledger holds all K frames with zero scales past the
    trim, so rolling it back rolls back exactly the frames on the wire."""
    spec = _spec()
    rng = np.random.default_rng(3)
    live = N._live_mask(spec)
    lattice = np.where(live, rng.integers(-8, 9, spec.total) * np.float32(0.125), 0).astype(np.float32)
    floor = np.where(live, rng.integers(-9, 9, spec.total) * np.float32(2.0 ** -146), 0).astype(np.float32)
    floor[:7] = np.float32(2.0 ** -120)  # a ladder deep into the floor
    tpl = {f"l{i}": np.zeros(n, np.float32) for i, n in enumerate(LEAVES)}
    for r0 in (lattice, floor):
        k = 64
        resid = torch.from_numpy(r0.copy())
        frame, _ = T.quantize_table_cascade(resid, spec, k, 32, impl="plain")
        s_dev, _ = _trimmed(frame.scales.numpy(), _u32(frame.words))
        assert 0 < s_dev.shape[0] < k
        s_host, _, r_host = N.quantize_table_cascade_np(r0, spec, k, 32)
        np.testing.assert_array_equal(_f32bits(s_dev), _f32bits(s_host))
        np.testing.assert_array_equal(_f32bits(resid.numpy()), _f32bits(r_host))
        st = SharedTensor(tpl, device="cpu", cascade=32)
        st.new_link(1)
        st._links[1].copy_(torch.from_numpy(r0))
        seq, df = st.begin_frame_burst_device(1, k)
        got = st.finish_frame_burst(df)
        assert len(got) == s_dev.shape[0]
        ledger = st._inflight[1][seq]
        assert len(ledger) == k and not any(f.scales.any() for f in ledger[len(got) :])
        # rolling the whole ledger entry back is rolling back the wire's frames
        want = st._links[1].clone()
        for f in ledger[: len(got)]:
            T.apply_table_many((want,), f, spec)
        st.nack_frame(1)
        np.testing.assert_array_equal(_f32bits(st._links[1].numpy()), _f32bits(want.numpy()))


def test_a_failed_codec_build_raises_and_never_falls_back(monkeypatch):
    """The host tier's cascade reaches the C pass through codec_np.native():
    a library that cannot build raises, and no per-frame loop runs."""
    from shared_tensor_tpu_torch import _build

    def broken():
        raise RuntimeError("gcc failed")

    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setattr(_build, "build_codec", broken)
    spec = _spec()
    with pytest.raises(RuntimeError, match="gcc failed"):
        N.quantize_table_cascade_np(_residual(spec, 0), spec, 16, 32)


# -- A-cascade's partials and the finish kernel ------------------------------------------------


def _leaf_partials(partials, spec):
    """Per-leaf (max |r|, sum r^2, sum |r|) from per-tile partials, in double."""
    bounds = T._cascade_consts(spec, "cpu").leaf_slots.tolist()
    p = partials.numpy()
    return np.array([[p[0, a:b].max(), p[1, a:b].sum(), p[2, a:b].sum()] for a, b in zip(bounds, bounds[1:])]).T


@pytest.mark.parametrize("kc", [0, 1, 11, 32, 64])
def test_cascade_twin_partials_match_the_c_pass(kc):
    """The partials A-cascade's twin writes (of the residual it leaves; kc 0
    is the burst's first launch, which measures the residual as it finds
    it) against those stc_quantize_ef_cascade returns, on the same residual
    and schedule: max |r| bit-equal, the sums within a relative 1e-12 (the
    two sum in other orders)."""
    spec = _spec()
    r0 = _residual(spec, 40 + kc)
    top = _tops(spec, 40 + kc)
    L = spec.num_leaves
    row_leaf, rowcount, *_ = T._consts(spec, "cpu")
    resid = torch.from_numpy(r0.copy())
    words = torch.zeros((max(kc, 1), spec.rows * 4), dtype=torch.int32)
    scales = torch.zeros((max(kc, 1), L), dtype=torch.float32)
    partials = torch.empty((3, CC.partial_slots(spec.rows)), dtype=torch.float64)
    state = torch.tensor([0, kc], dtype=torch.int32)
    CC.quantize_rows_cascade(torch.from_numpy(top), row_leaf, rowcount, state, resid, words, scales, partials,
                             begin=kc == 0)
    amax, ss, sabs = np.zeros(L), np.zeros(L), np.zeros(L)
    offs, ns, padded = N._layout(spec)
    if kc:
        rows = [top]
        for _ in range(1, kc):
            rows.append(rows[-1] * np.float32(0.5))
        sched = np.stack(rows)
        r_c = np.empty_like(r0)
        N.native().stc_quantize_ef_cascade(r0, r_c, offs, ns, padded, L, kc, sched,
                                           np.empty(kc * spec.total // 32, np.uint32), spec.total // 32,
                                           amax, ss, sabs)
        np.testing.assert_array_equal(_f32bits(resid.numpy()), _f32bits(r_c))
    else:
        N.native().stc_scale_partials(r0, offs, ns, L, amax, ss, sabs)
        np.testing.assert_array_equal(_f32bits(resid.numpy()), _f32bits(r0))  # measured, not moved
        assert not words.any() and not scales.any()
    got = _leaf_partials(partials, spec)
    np.testing.assert_array_equal(got[0], amax)
    np.testing.assert_allclose(got[1], ss, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got[2], sabs, rtol=1e-12, atol=0)
    assert ss[1] > 0 and ss[1] < 1e-80  # the subnormal leaf's squares survive in double


def _c_partials(r, spec):
    L = spec.num_leaves
    amax, ss, sabs = np.zeros(L), np.zeros(L), np.zeros(L)
    offs, ns, _ = N._layout(spec)
    N.native().stc_scale_partials(np.ascontiguousarray(r, np.float32), offs, ns, L, amax, ss, sabs)
    return amax, ss, sabs


def _finish(partials, spec, k, cap, policy, per_leaf, first=True, scales=None, state=None):
    c = T._cascade_consts(spec, "cpu")
    b = T.cascade_buffers(spec, k, "cpu")
    scales = b.scales.zero_() if scales is None else scales
    state = b.state.zero_() if state is None else state
    CC.cascade_round(partials, c.leaf_slots, c.ns, scales, state, b.ladder, b.leaf_sums, k, cap, policy, per_leaf,
                     first)
    return b.ladder, state, b.leaf_sums


@pytest.mark.parametrize("per_leaf", [True, False], ids=["per-leaf", "aggregate"])
@pytest.mark.parametrize("policy", list(ScalePolicy), ids=lambda p: p.name)
def test_finish_twin_follows_the_host_tiers_rule(policy, per_leaf):
    """The finish twin's scales, each leaf's max |r|, ladder top and depth
    against compute_scales_np and cascade_ladder, bit for bit: from the C
    pass's own per-leaf partials (one slot of each leaf holding them), and
    from the partials A-cascade's first launch measures (the sums in its own
    order; the tables' scales sit off octave boundaries)."""
    spec = _spec()
    k, cap = 16, 32
    for seed in (3, 4):
        r = _residual(spec, seed)
        s_np, amax_np = N.compute_scales_np(r, spec, policy, per_leaf, with_amax=True)
        top, kc = T.cascade_ladder(torch.from_numpy(s_np), torch.from_numpy(amax_np), torch.tensor(min(k, cap)))
        c_amax, c_ss, c_sabs = _c_partials(r, spec)
        seeded = torch.zeros((3, CC.partial_slots(spec.rows)), dtype=torch.float64)
        first_slots = T._cascade_consts(spec, "cpu").leaf_slots[:-1]
        seeded[:, first_slots] = torch.from_numpy(np.stack([c_amax, c_ss, c_sabs]))
        row_leaf, rowcount, *_ = T._consts(spec, "cpu")
        measured = torch.empty_like(seeded)
        b = T.cascade_buffers(spec, k, "cpu")
        CC.quantize_rows_cascade(b.ladder[2], row_leaf, rowcount, b.state, torch.from_numpy(r.copy()), b.words,
                                 b.scales, measured, begin=True)
        for partials in (seeded, measured):
            ladder, state, _ = _finish(partials, spec, k, cap, policy, per_leaf)
            np.testing.assert_array_equal(_f32bits(ladder[0].numpy()), _f32bits(s_np))
            np.testing.assert_array_equal(_f32bits(ladder[1].numpy()), _f32bits(amax_np))
            np.testing.assert_array_equal(_f32bits(ladder[2].numpy()), _f32bits(top.numpy()))
            assert state.tolist() == [0, int(kc), int(kc) == 0] and int(kc) > 1


def _finish_in_the_old_order(partials, leaf_slots, ns, state, ladder, leaf_sums, k, cap, policy, per_leaf):
    """The finish's first round as its twin computed it before the kernel's
    redesign: a warp a leaf (lanes strided over the leaf's slots, then a
    halving tree) and, without per_leaf, one sum over the leaves in leaf
    order. Only the order of the double sums differs from today's."""
    n_leaves = ns.shape[0]
    bounds = leaf_slots.tolist()
    for l in range(n_leaves):
        seg = partials[:, bounds[l] : bounds[l + 1]]
        pad = -seg.shape[1] % 32
        seg = torch.cat([seg, seg.new_zeros((3, pad))], dim=1).view(3, -1, 32)
        acc = seg.new_zeros((2, 32))
        for m in range(seg.shape[1]):
            acc = acc + seg[1:, m]
        h = 16
        while h:
            acc = acc[:, :h] + acc[:, h : 2 * h]
            h //= 2
        leaf_sums[0, l] = seg[0].max()
        leaf_sums[1:, l] = acc[:, 0]
    amax, ss, sabs = leaf_sums[0], leaf_sums[1], leaf_sums[2]
    n = ns
    if not per_leaf:
        tot = leaf_sums.new_zeros(4)
        for l in range(n_leaves):
            tot = torch.stack((torch.maximum(tot[0], amax[l]), tot[1] + ss[l], tot[2] + sabs[l], tot[3] + ns[l]))
        amax, ss, sabs, n = (x.expand(n_leaves) for x in tot)
    if policy == ScalePolicy.ABS_MEAN:
        s = (sabs / n).to(torch.float32)
    else:
        s = torch.sqrt(ss / n).to(torch.float32)
        if policy == ScalePolicy.POW2_RMS:
            s = (s.view(torch.int32) & 0x7F800000).view(torch.float32)
    s = torch.where((amax > 0) & torch.isfinite(s), s, torch.zeros_like(s))
    leaf_amax = leaf_sums[0].to(torch.float32)
    top, kc = T.cascade_ladder(s, leaf_amax, torch.tensor(min(int(cap), int(k))))
    kc = max(int(kc), 0)
    ladder[0], ladder[1], ladder[2] = s, leaf_amax, top
    state.copy_(torch.tensor([0, kc, int(kc == 0)], dtype=torch.int32))


def _zeros_like_params(params) -> dict:
    leaves, treedef = T.tree_flatten(params)
    return T.tree_unflatten(treedef, [np.zeros(tuple(x.shape), np.float32) for x in leaves])


def _finish_table(name):
    from shared_tensor_tpu_torch.models import char_rnn, resnet

    if name == "config2":
        return _zeros_like_params(char_rnn.init_params(torch.Generator().manual_seed(0), char_rnn.CharRNNConfig(),
                                                       device="cpu"))
    if name == "resnet18":
        return _zeros_like_params(resnet.init_params(torch.Generator().manual_seed(0), resnet.ResNetConfig(),
                                                     device="cpu"))
    return {"t": np.zeros(1 << 20, np.float32)}


#: the leaf sums' relative tolerance between the two orders: a sum of at
#: most a few thousand positive doubles moves by at most n ulps
FINISH_ORDER_RTOL = 1e-12


@pytest.fixture(scope="module", params=["config2", "resnet18", "1Mi"])
def finish_table(request):
    """A table's spec and a seeded set of A-cascade partials for it:
    gaussian-like per-tile max |r|, sums of squares and of magnitudes
    spread over four octaves, some tiles all zero."""
    spec = T.make_spec(_finish_table(request.param))
    rng = np.random.default_rng(22)
    slots = CC.partial_slots(spec.rows)
    amax = np.abs(rng.normal(0, 1e-2, slots)) * 2.0 ** rng.integers(-2, 3, slots)
    amax[rng.random(slots) < 0.02] = 0.0
    ss = amax**2 * rng.uniform(50, 300, slots)
    sabs = amax * rng.uniform(100, 500, slots)
    return request.param, spec, torch.from_numpy(np.stack([amax, ss, sabs]))


@pytest.mark.parametrize("per_leaf", [True, False], ids=["per-leaf", "aggregate"])
@pytest.mark.parametrize("policy", list(ScalePolicy), ids=lambda p: p.name)
def test_finish_twin_reorders_only_the_sums(finish_table, policy, per_leaf):
    """The finish twin in the redesigned kernel's order (runs of slots a
    thread, then each leaf's parts by one warp) against the order before it,
    at config 2's table (9 leaves, 3,781 slots), ResNet-18's (56 leaves,
    10,938 slots) and a flat 1 Mi table (one leaf): scales, each leaf's max
    |r|, ladder top and state bit for bit; the leaf sums within
    FINISH_ORDER_RTOL, and the max |r| exact."""
    name, spec, partials = finish_table
    k, cap = 16, 32
    c = T._cascade_consts(spec, "cpu")
    assert {"config2": (9, 3781), "resnet18": (56, 10938), "1Mi": (1, 1024)}[name] == (spec.num_leaves,
                                                                                       int(c.leaf_slots[-1]))
    new, old = T.cascade_buffers(spec, k, "cpu"), T.cascade_buffers(spec, k, "cpu")
    scales = new.scales.zero_()
    CC.cascade_round(partials, c.leaf_slots, c.ns, scales, new.state, new.ladder, new.leaf_sums, k, cap, policy,
                     per_leaf, True)
    _finish_in_the_old_order(partials, c.leaf_slots, c.ns, old.state, old.ladder, old.leaf_sums, k, cap, policy,
                             per_leaf)
    assert new.state.tolist() == old.state.tolist() and new.state[1] > 1
    np.testing.assert_array_equal(_f32bits(new.ladder.numpy()), _f32bits(old.ladder.numpy()))
    assert torch.equal(new.leaf_sums[0], old.leaf_sums[0])
    np.testing.assert_allclose(new.leaf_sums[1:].numpy(), old.leaf_sums[1:].numpy(), rtol=FINISH_ORDER_RTOL, atol=0)
    assert not torch.equal(new.leaf_sums, old.leaf_sums) or spec.num_leaves == 1


def _run_rounds(r0, spec, k, cascade, rounds, policy=ScalePolicy.POW2_RMS):
    """A cascade burst driven round by round with the plain twins: a
    snapshot of everything it wrote after each round (the residual, then
    ``table.CascadeBuffers``' fields)."""
    row_leaf, rowcount, *_ = T._consts(spec, "cpu")
    c = T._cascade_consts(spec, "cpu")
    b = T.cascade_buffers(spec, k, "cpu")
    resid = torch.from_numpy(r0.copy())
    CC.quantize_rows_cascade(b.ladder[2], row_leaf, rowcount, b.state, resid, b.words, b.scales, b.partials,
                             begin=True)
    snaps = []
    for i in range(rounds):
        CC.cascade_round(b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder, b.leaf_sums, k, cascade,
                         policy, first=i == 0)
        CC.quantize_rows_cascade(b.ladder[2], row_leaf, rowcount, b.state, resid, b.words, b.scales, b.partials)
        snaps.append([x.clone() for x in (resid, *b)])
    return snaps


def _same(a, b):
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b))


def test_a_burst_whose_first_round_covers_every_frame_writes_nothing_after_it():
    """K = 16 on a gaussian residual (1e-2) of 64 Ki elements with one
    outlier at 4.0: the first round is 16 deep and fills the burst; the
    second round's finish records the stop (j0 16, kc 0) and measures
    nothing, and the 15 spent rounds leave the residual, the frames, the
    ladder and the partials exactly as the first left them; the burst is
    the host tier's."""
    spec = T.make_spec({"b": np.zeros(100, np.float32), "w": np.zeros(1 << 16, np.float32)})
    live = N._live_mask(spec)
    r0 = np.where(live, np.random.default_rng(31).normal(size=spec.total) * 1e-2, 0).astype(np.float32)
    r0[1024 + 7] = 4.0
    k = 16
    snaps = _run_rounds(r0, spec, k, 32, k)
    assert snaps[0][3].tolist() == [0, k, 0] and snaps[1][3].tolist() == [k, 0, 1]
    assert all(_same(snaps[0][:3] + snaps[0][4:], s[:3] + s[4:]) for s in snaps[1:])
    assert all(_same(snaps[1], s) for s in snaps[2:])
    frame, resid = T.quantize_table_cascade(torch.from_numpy(r0.copy()), spec, k, 32)
    assert _same([resid, frame.scales, frame.words], [snaps[0][0], snaps[0][1], snaps[0][2]])
    s_host, w_host, r_host = N.quantize_table_cascade_np(r0, spec, k, 32)
    assert s_host.shape[0] == k
    np.testing.assert_array_equal(_f32bits(frame.scales.numpy()), _f32bits(s_host))
    np.testing.assert_array_equal(_u32(frame.words), w_host)


def test_the_subnormal_floor_stops_the_burst():
    """An ABS_MEAN scale in the subnormals (one element at 2^-126 in 2^17
    zeros: scale 2^-143, depth 18 + 8): the first round's ladder from
    2^-126 reaches 0 at its 25th row, before its depth, so its last scale
    row is all zero; the next finish stops the burst there (j0 past the
    round, kc 0, stop set), no later round writes anything, and the host
    tier ends at the same frame."""
    spec = T.make_spec({"t": np.zeros(1 << 17, np.float32)})
    r0 = np.zeros(spec.total, np.float32)
    r0[12345] = np.float32(2.0 ** -126)
    k = 64
    snaps = _run_rounds(r0, spec, k, 32, 4, ScalePolicy.ABS_MEAN)
    s1 = snaps[0][1]
    j0, kc, stop = snaps[0][3].tolist()
    assert j0 == 0 and 1 < kc and not stop and not s1[kc - 1].any()
    assert snaps[1][3].tolist() == [kc, 0, 1]
    assert all(_same(snaps[1], s) for s in snaps[2:])
    s_host, _, r_host = N.quantize_table_cascade_np(r0, spec, k, 32, ScalePolicy.ABS_MEAN)
    n = s_host.shape[0]
    assert 0 < n < kc
    np.testing.assert_array_equal(_f32bits(s1[:n].numpy()), _f32bits(s_host))
    assert not s1[n:].any()
    np.testing.assert_array_equal(_f32bits(snaps[-1][0].numpy()), _f32bits(r_host))


def test_finish_wrapper_checks_and_counts():
    """The finish wrapper runs its plain twin on CPU tensors (no launch
    counted), refuses the kernel off the GPU, and checks its arguments; a
    stopped burst's state stays as it is."""
    spec = _spec()
    c = T._cascade_consts(spec, "cpu")
    b = T.cascade_buffers(spec, 4, "cpu")
    b.partials.zero_()
    b.scales.zero_()
    CC.reset_launches()
    args = (b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder, b.leaf_sums, 4, 8)
    CC.cascade_round(*args, first=True)
    assert b.state.tolist() == [0, 0, 1]  # nothing live: the burst stops at once
    b.state.copy_(torch.tensor([2, 3, 1], dtype=torch.int32))
    CC.cascade_round(*args)
    assert b.state.tolist() == [2, 3, 1]
    assert CC.launches()["cascade_round"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        CC.cascade_round_kernel(*args)
    with pytest.raises(TypeError):
        CC.cascade_round(b.partials.float(), *args[1:])
    with pytest.raises(ValueError):
        CC.cascade_round(b.partials, c.leaf_slots[:-1], *args[2:])
    with pytest.raises(ValueError):  # leaf_sums written over the partials read
        CC.cascade_round(*args[:6], b.partials.view(-1)[: 3 * spec.num_leaves].view(3, -1), *args[7:])
    with pytest.raises(ValueError):
        CC.cascade_round(*args[:7], 4, 65)
    with pytest.raises(ValueError):  # A-cascade needs whole tiles
        CC.quantize_rows_cascade(b.ladder[2], *T._consts(spec, "cpu")[:2], b.state, torch.zeros(128), b.words,
                                 b.scales)


def test_a_failed_finish_kernel_build_raises_and_never_falls_back(monkeypatch, tmp_path):
    """The finish kernel's library, like A-cascade's, comes from nvcc at its
    first use: a build that fails raises from the wrapper's library lookup,
    and the kernel path refuses CPU tensors instead of running the twin (on
    the card, tests/test_torch_cuda.py holds the burst itself to this)."""

    def broken(names=None):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(CC, "_LIBS", {})
    monkeypatch.setattr(CC, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(CC, "build", broken)
    for name in ("cascade_round", "quantize_rows_cascade"):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            CC._fn(name)
    spec = _spec()
    resid = torch.from_numpy(_residual(spec, 0))
    before = resid.clone()
    CC.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        T.quantize_table_cascade(resid, spec, 4, 8, impl="kernel")
    c = T._cascade_consts(spec, "cpu")
    b = T.cascade_buffers(spec, 4, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        CC.cascade_round_kernel(b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder, b.leaf_sums, 4, 8)
    assert torch.equal(resid, before) and not any(CC.launches().values())


# -- the peer -------------------------------------------------------------------------------


@pytest.mark.parametrize(
    "config, host, cascade",
    [
        (Config(), False, 32),
        (Config(native_engine=False), True, 32),
        (Config(codec=CodecConfig(cascade_frames=1)), False, 1),
        (Config(native_engine=False, codec=CodecConfig(cascade_frames=1)), True, 1),
        (Config(transport=TransportConfig(wire_compat=True)), False, 1),
    ],
    ids=["device", "python-host", "device-off", "python-host-off", "compat"],
)
def test_the_peer_cascades_by_its_codec_config(config, host, cascade):
    """Each peer's SharedTensor bursts with ``codec.cascade_frames`` (1 on
    the reference wire), and a cascading Python host tier bursts
    ``AUTO_BURST`` frames, as the device tier does, where it would not
    burst a table this large without one."""
    n = 1 << 16
    kw = {"host_tier": True} if host else {"device": "cpu"}
    with create_or_fetch("127.0.0.1", free_port(), np.zeros(n, np.float32), config, **kw) as p:
        assert p.st.cascade == cascade
        if host:
            spec = p.st.spec
            want = min(P.AUTO_BURST, wire.burst_frames_cap(spec)) if cascade > 1 else P._python_tier_auto_burst(spec)
            assert p._burst == want and (cascade == 1) == (p._burst == 1)


@pytest.mark.parametrize("tier", ["device", "python-host"])
def test_drain_tail_drains_one_gaussian_add_exactly(tier):
    """drain_tail's Python-plane rows: one gaussian add at 64 Ki drains to
    exact zero in tens of frames, as the engine's row does, and the joiner
    holds the delta."""
    from shared_tensor_tpu_torch.benchmarks import drain_tail

    row = drain_tail.run_tier(tier, n=1 << 16, timeout=20.0, **({"device": "cpu"} if tier == "device" else {}))
    assert row["drained"] and row["residual_norm"] == 0.0
    assert 0 < row["frames_out"] < 200, row
    assert row["joiner_max_err"] < 1e-6


@pytest.mark.parametrize("port_tier", ["device", "python-host"])
def test_jax_child_under_a_cascading_port_parent_converges(port_tier):
    """A JAX peer (its Python host tier) joins a port master that cascades;
    after a gaussian add at the master both replicas hold seed + add."""
    from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
    from shared_tensor_tpu.config import Config as JConfig
    from shared_tensor_tpu.config import TransportConfig as JTransportConfig

    port = free_port()
    rng = np.random.default_rng(9)
    seed = {"w": rng.normal(size=(64, 96)).astype(np.float32), "b": np.arange(40, dtype=np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in seed.items()}
    tcfg = TransportConfig(peer_timeout_sec=10.0)
    if port_tier == "device":
        m = create_or_fetch("127.0.0.1", port, seed, Config(transport=tcfg), device="cpu")
    else:
        m = create_or_fetch("127.0.0.1", port, seed, Config(transport=tcfg, native_engine=False), host_tier=True)
    try:
        assert m.st.cascade == 32
        j = jax_create_or_fetch("127.0.0.1", port, zeros,
                                JConfig(native_engine=False, transport=JTransportConfig(peer_timeout_sec=10.0)))
        try:
            wait_converged([m, j], seed, timeout=60.0)
            delta = {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32) for k, v in seed.items()}
            m.add(delta)
            wait_converged([m, j], {k: seed[k] + delta[k] for k in seed}, timeout=60.0)
            assert m.drain(timeout=30.0, tol=1e-30)
            assert m.threads_alive() and m._error is None
        finally:
            j.close()
    finally:
        m.close()
