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
    assert CC.ENGINE_LAUNCHES == {"quantize_rows_cascade": 0}
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
