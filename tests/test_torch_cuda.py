"""The port on a GPU: its CUDA kernels, the asynchronous frame fetch, a
two-peer round trip over loopback TCP, a two-rank pod step over gloo, and
the sharded tensor's view on the card and its classic fallback there
(marked ``cuda``; each test skips without a CUDA device). This file imports neither jax nor the JAX package,
so it runs on a torch-only machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: kernels and fetches bit-exact against the plain PyTorch
versions and blocking copies on the same inputs; the round trip to 1e-6
(test_peer.py's)."""

import time

import numpy as np
import pytest
import torch

from shared_tensor_tpu_torch.core import SharedTensor
from shared_tensor_tpu_torch.ops import codec_cuda as CC

#: A peer's receive faults, 0 on a healthy peer.
FAULTS = ("st_apply_dropped_total", "st_msg_errors_total", "st_recv_restarts_total", "st_unknown_msgs_total")

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows_case(seed, rows):
    rng = np.random.default_rng(seed)
    rowcount = rng.choice([0, 1, 31, 32, 33, 100, 127, 128, 128, 128], rows).astype(np.int32)
    resid = rng.normal(size=rows * 128).astype(np.float32)
    resid[rng.random(rows * 128) < 0.05] = 0.0
    resid[:3] = [1e-40, -1e-45, 0.0]  # subnormals survive (no FTZ)
    s_row = (2.0 ** rng.integers(-8, 3, rows)).astype(np.float32)
    s_row[rng.random(rows) < 0.25] = 0.0
    s_row[: rows // 4] *= np.float32(1.37)
    return s_row, rowcount, resid


def _same_bits(x, y):
    return torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


@pytest.mark.cuda
def test_quantize_rows_kernel_matches_plain(cuda_device):
    rows = 4099
    s_row, rowcount, resid = _rows_case(5, rows)
    s_d = torch.from_numpy(s_row).to(cuda_device)
    c_d = torch.from_numpy(rowcount).to(cuda_device)
    r_k = torch.from_numpy(resid).to(cuda_device)
    r_p = r_k.clone()
    wk = CC.quantize_rows_kernel(s_d, c_d, r_k)
    wp = CC.quantize_rows_plain(s_d, c_d, r_p)
    torch.cuda.synchronize()
    assert _same_bits(wk, wp)
    assert _same_bits(r_k, r_p)


_SPECIALS = [3e38, -3e38, 1e-40, np.nan, np.float32(-1e-45), 2.9e38, -0.0, np.float32(1e-38)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4099])
@pytest.mark.parametrize("k,n_arr", [(1, 1), (2, 3), (8, 1), (4, 2), (4, 3), (8, 8), (2, 11)])
def test_apply_rows_batch_kernel_matches_plain(cuda_device, k, n_arr, rows):
    """Bit-exact at the main path's (K, N), at 8 targets (one launch) and
    at 11 (two launches); NaN, +-3e38 and subnormals in the targets; a row
    scale of 2^-126 turns subnormal targets into subnormal sums."""
    rng = np.random.default_rng(k)
    _, rowcount, _ = _rows_case(6, rows)
    s = (2.0 ** rng.integers(-6, 2, (k, rows))).astype(np.float32)
    s[rng.random((k, rows)) < 0.2] = 0.0
    s[0] *= np.float32(1.37)
    s[:, -1] = np.float32(2.0**-126)
    rowcount[-1] = 128
    words = rng.integers(0, 2**32, (k, rows * 4), dtype=np.uint64).astype(np.uint32)
    dev = cuda_device
    s_d = torch.from_numpy(s).to(dev)
    c_d = torch.from_numpy(rowcount).to(dev)
    w_d = torch.from_numpy(words.view(np.int32)).to(dev)
    base = [rng.normal(size=rows * 128).astype(np.float32) for _ in range(n_arr)]
    base[0][:8] = _SPECIALS
    base[-1][-8:] = _SPECIALS
    ak = [torch.from_numpy(b).to(dev) for b in base]
    ap = [a.clone() for a in ak]
    CC.reset_launches()
    CC.apply_rows_batch_kernel(s_d, c_d, w_d, ak)
    assert CC.LAUNCHES["apply_rows_batch"] == -(-n_arr // CC.MAX_TARGETS)
    CC.apply_rows_batch_plain(s_d, c_d, w_d, ap)
    torch.cuda.synchronize()
    for x, y in zip(ak, ap):
        assert _same_bits(x, y)


@pytest.mark.cuda
def test_kernels_raise_on_a_misaligned_view(cuda_device):
    """A view 4 bytes off a 16-byte boundary raises ValueError in B and D:
    no fallback to the plain version or to a scalar kernel."""
    from shared_tensor_tpu_torch.ops.codec import Frame

    rows = 8
    dev = cuda_device
    buf = torch.zeros(rows * 128 + 1, device=dev)
    bad, good = buf[1:], torch.zeros(rows * 128, device=dev)
    s_d = torch.ones(1, rows, device=dev)
    c_d = torch.full((rows,), 128, dtype=torch.int32, device=dev)
    w_d = torch.zeros(1, rows * 4, dtype=torch.int32, device=dev)
    w_bad = torch.zeros(rows * 4 + 1, dtype=torch.int32, device=dev)[1:].view(1, -1)
    CC.reset_launches()
    with pytest.raises(ValueError):
        CC.apply_rows_batch_kernel(s_d, c_d, w_d, [good, bad])
    with pytest.raises(ValueError):
        CC.apply_rows_batch(s_d, c_d, w_bad, [good])
    frame = Frame(torch.tensor(0.5, device=dev), w_d[0])
    with pytest.raises(ValueError):
        CC.apply_frame_many_kernel([bad], frame, 100)
    with pytest.raises(ValueError):
        CC.apply_frame_many([good], Frame(frame.scale, w_bad[0]), 100)
    assert CC.LAUNCHES["apply_rows_batch"] == 0 and CC.LAUNCHES["apply_frame_many"] == 0
    assert not good.any()


@pytest.mark.cuda
def test_shared_tensor_on_cuda_matches_cpu(cuda_device):
    """A two-node exchange on the GPU launches both kernels and sends the
    same frames as the same exchange on the CPU plain path."""
    rng = np.random.default_rng(0)
    t = {"w": rng.uniform(-1, 1, (64, 70)).astype(np.float32), "b": rng.uniform(-4, 4, (9,)).astype(np.float32)}
    CC.reset_launches()
    runs = []
    for dev in (cuda_device, "cpu"):
        a = SharedTensor(t, seed_values=True, device=dev)
        b = SharedTensor(t, device=dev)
        a.new_link(1)
        b.new_link(1, seed=False)
        b.new_link(2, seed=False)
        sent = []
        for _ in range(6):
            frames = [a.make_frame(1) for _ in range(3)]
            frames = [f for f in frames if f is not None]
            sent += [(f.scales.copy(), f.words.copy()) for f in frames]
            b.receive_frames(1, frames)
        runs.append((sent, b.snapshot_flat().cpu(), b.snapshot_all()[1][2].cpu()))
    assert CC.LAUNCHES["quantize_rows"] > 0 and CC.LAUNCHES["apply_rows_batch"] > 0
    (gs, gv, gr), (cs, cv, cr) = runs
    assert len(gs) == len(cs)
    for (s1, w1), (s2, w2) in zip(gs, cs):
        np.testing.assert_array_equal(w1, w2)
        # the scale sums run in another order on the GPU: equal or one octave
        assert np.all((s1 == s2) | (s1 == 2 * s2) | (2 * s1 == s2))
    if all(np.array_equal(s1, s2) for (s1, _), (s2, _) in zip(gs, cs)):
        assert _same_bits(gv, cv) and _same_bits(gr, cr)


def _scalar_case(seed, n, n_pad, garbage=True):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=n_pad).astype(np.float32)
    r[rng.random(n_pad) < 0.05] = 0.0
    r[:3] = [1e-40, -1e-45, 0.0]  # subnormals survive (no FTZ)
    if not garbage:
        r[n:] = 0.0
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 1000, 2**20 + 3])
@pytest.mark.parametrize("policy", ["POW2_RMS", "RMS", "ABS_MEAN"])
def test_quantize_kernel_matches_plain(cuda_device, n, policy):
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops.packing import padded_len

    n_pad = padded_len(n)
    r_k = torch.from_numpy(_scalar_case(n, n, n_pad)).to(cuda_device)
    r_p = r_k.clone()
    fk, _ = CC.quantize_kernel(r_k, n, ScalePolicy[policy])
    fp, _ = CC.quantize_plain(r_p, n, ScalePolicy[policy])
    torch.cuda.synchronize()
    assert _same_bits(fk.scale, fp.scale)  # the same compute_scale on the same device
    assert _same_bits(fk.words, fp.words) and _same_bits(r_k, r_p)


@pytest.mark.cuda
def test_quantize_kernel_at_scale_zero_zeroes_padding(cuda_device):
    n, n_pad = 1000, 1024
    r = torch.from_numpy(_scalar_case(1, n, n_pad)).to(cuda_device)
    r_k, r_p = r.clone(), r.clone()
    zero = torch.zeros((), device=cuda_device)
    fk, _ = CC.quantize_kernel(r_k, n, scale=zero)
    fp, _ = CC.quantize_plain(r_p, n, scale=zero.clone())
    torch.cuda.synchronize()
    assert _same_bits(fk.words, fp.words) and _same_bits(r_k, r_p)
    assert _same_bits(r_k[:n], r[:n]) and not r_k[n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 9])
def test_apply_frame_many_kernel_matches_plain(cuda_device, k):
    from shared_tensor_tpu_torch.ops.codec import Frame

    n, n_pad = 2**20 + 3, 2**20 + 1024
    rng = np.random.default_rng(k)
    words = torch.from_numpy(rng.integers(0, 2**32, n_pad // 32, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(cuda_device)
    frame = Frame(torch.tensor(0.37, device=cuda_device), words)
    base = [_scalar_case(10 + i, n, n_pad) for i in range(k)]
    base[0][3:7] = [3e38, -3e38, np.nan, 2.9e38]
    ak = [torch.from_numpy(b).to(cuda_device) for b in base]
    ap = [a.clone() for a in ak]
    CC.apply_frame_many_kernel(ak, frame, n)
    CC.apply_frame_many_plain(ap, frame, n)
    torch.cuda.synchronize()
    for x, y in zip(ak, ap):
        assert _same_bits(x, y) and not x[n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4099])
@pytest.mark.parametrize("scale", [0.37, 2.0**-126, 0.0])
def test_apply_frame_many_kernel_small_and_subnormal(cuda_device, rows, scale):
    """D at one row and at a row count no block size divides, with a live
    count inside the last row; at scale 2^-126 subnormal targets give
    subnormal sums (no FTZ), at scale 0 the padding still becomes 0."""
    from shared_tensor_tpu_torch.ops.codec import Frame

    n_pad = rows * 128
    n = n_pad - 77
    rng = np.random.default_rng(rows)
    words = torch.from_numpy(rng.integers(0, 2**32, n_pad // 32, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(cuda_device)
    frame = Frame(torch.tensor(scale, dtype=torch.float32, device=cuda_device), words)
    base = [_scalar_case(40 + i, n, n_pad) for i in range(2)]
    base[0][:8] = _SPECIALS
    base[1][n - 8 : n] = _SPECIALS
    ak = [torch.from_numpy(b).to(cuda_device) for b in base]
    ap = [a.clone() for a in ak]
    CC.apply_frame_many_kernel(ak, frame, n)
    CC.apply_frame_many_plain(ap, frame, n)
    torch.cuda.synchronize()
    for x, y in zip(ak, ap):
        assert _same_bits(x, y) and not x[n:].any()


@pytest.mark.cuda
def test_scalar_kernels_past_2_gib(cuda_device):
    """64-bit indexing: a buffer of 2^29 + 1024 elements (byte offsets past
    2^31), checked against the plain versions chunk by chunk with the
    kernel's own scale (the plain version at full size would need several
    times the memory)."""
    from shared_tensor_tpu_torch.ops.codec import Frame

    n_pad = 2**29 + 1024
    n = n_pad - 5
    free, _ = torch.cuda.mem_get_info(cuda_device)
    if free < 12 * n_pad * 4:
        pytest.skip(f"needs {12 * n_pad * 4 / 2**30:.0f} GiB free on the GPU, has {free / 2**30:.0f}")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r0 = torch.randn(n_pad, generator=gen, device=cuda_device)
    r = r0.clone()
    frame, _ = CC.quantize_kernel(r, n)
    v0 = torch.randn(n_pad, generator=gen, device=cuda_device)
    v = v0.clone()
    CC.apply_frame(v, frame, n)
    torch.cuda.synchronize()
    chunk = 2**26
    for lo in range(0, n_pad, chunk):
        hi = min(n_pad, lo + chunk)
        live = max(0, min(n, hi) - lo)
        fp, rp = CC.quantize_plain(r0[lo:hi].clone(), live, scale=frame.scale.clone())
        assert _same_bits(fp.words, frame.words[lo // 32 : hi // 32]) and _same_bits(rp, r[lo:hi])
        sub = Frame(frame.scale.clone(), frame.words[lo // 32 : hi // 32].clone())
        (vp,) = CC.apply_frame_many_plain([v0[lo:hi].clone()], sub, live)
        assert _same_bits(vp, v[lo:hi])


#: (rows, live count): inside a float4, inside a word, at a row's edge, at
#: nothing and at everything, on 1, 2, 8 and 4,099 rows (a count no
#: block's 8 rows divide)
_C_EDGES = [(1, 0), (1, 1), (1, 2), (1, 31), (1, 45), (1, 127), (1, 128), (2, 129), (2, 130), (8, 1024),
            (8, 511), (8, 512), (8, 900), (4099, 4099 * 128), (4099, 4098 * 128), (4099, 4098 * 128 + 66),
            (4099, 300_007)]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [None, 0.37, 2.0**-126, 0.0], ids=["pass", "0.37", "2^-126", "0"])
@pytest.mark.parametrize("rows,n", _C_EDGES)
def test_quantize_kernel_on_the_redesigns_edges(cuda_device, rows, n, scale):
    """Kernel C (a warp a row, 16-byte lanes, a row's words from four
    ballots) against its plain version, bit for bit, with the live count
    inside a float4, inside a word and at a row's edge; specials at both
    ends of the live range; the scale from the scale pass or given (0
    zeroes the padding all the same)."""
    n_pad = rows * 128
    base = _scalar_case(rows + n, n, n_pad)
    base[:8] = _SPECIALS[:3] + [-2.0] + _SPECIALS[4:]  # no NaN, so the pass's scale is not 0
    if n >= 16:
        base[n - 8 : n] = base[:8]
    r_k = torch.from_numpy(base).to(cuda_device)
    r_p = r_k.clone()
    s_k = None if scale is None else torch.tensor(scale, dtype=torch.float32, device=cuda_device)
    s_p = None if scale is None else s_k.clone()
    fk, _ = CC.quantize_kernel(r_k, n, scale=s_k)
    fp, _ = CC.quantize_plain(r_p, n, scale=s_p)
    torch.cuda.synchronize()
    assert _same_bits(fk.scale, fp.scale)
    assert _same_bits(fk.words, fp.words) and _same_bits(r_k, r_p)
    assert not r_k[n:].any()


@pytest.mark.cuda
def test_quantize_and_scale_raise_on_a_misaligned_residual(cuda_device):
    """A residual 4 bytes off a 16-byte boundary raises ValueError in C and
    in the scale pass: no fallback, nothing launched, nothing written."""
    buf = torch.ones(1024 + 1, device=cuda_device)
    bad = buf[1:]
    CC.reset_launches()
    with pytest.raises(ValueError):
        CC.quantize_kernel(bad, 1000)
    with pytest.raises(ValueError):
        CC.quantize(bad, 1000, scale=torch.tensor(0.5, device=cuda_device))
    with pytest.raises(ValueError):
        CC.frame_scale_kernel(bad, 1000)
    assert CC.launches()["quantize"] == 0 and CC.launches()["frame_scale"] == 0
    assert bool((buf == 1).all())


def _scale_case(seed, n_pad, kind):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=n_pad).astype(np.float32)
    if kind == "wide":  # magnitudes over the whole f32 range, subnormals to 3e38
        r *= (10.0 ** rng.uniform(-44, 37, n_pad)).astype(np.float32)
    elif kind == "zero":
        r[:] = 0.0
    elif kind == "inf_padding":
        r[-5:] = np.inf
    elif kind == "subnormal":
        r *= np.float32(1e-39)
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["POW2_RMS", "RMS", "ABS_MEAN"])
@pytest.mark.parametrize("n_pad,kind", [(128, "normal"), (1024, "normal"), (1024, "zero"), (1024, "inf_padding"),
                                        (4096, "subnormal"), (540_672, "normal"), (540_800, "wide"),
                                        (2**20 + 1024, "normal"), (2**24 + 1024, "wide")])
def test_frame_scale_kernel_is_its_twin_bit_for_bit(cuda_device, n_pad, kind, policy):
    """The scale pass against its plain twin on the same device, bit for bit,
    for every policy, at sizes from one row to past one pass of its grid
    (540,672 elements: 264 blocks x 512 threads x a float4) with a ragged
    last pass; and the same bits on a second run."""
    from shared_tensor_tpu_torch.config import ScalePolicy

    pol = ScalePolicy[policy]
    n = n_pad - 77 if n_pad > 128 else 100
    r = torch.from_numpy(_scale_case(n_pad, n_pad, kind)).to(cuda_device)
    before = r.clone()
    got = [CC.frame_scale_kernel(r, n, pol) for _ in range(2)]
    want = CC.frame_scale_plain(r, n, pol)
    torch.cuda.synchronize()
    assert _same_bits(got[0], want) and _same_bits(got[1], want)
    assert _same_bits(r, before)  # it only reads
    if kind in ("zero", "inf_padding"):
        assert float(want) == 0.0
    elif kind != "subnormal" or pol != ScalePolicy.POW2_RMS:
        assert float(want) > 0.0


@pytest.mark.cuda
def test_frame_scale_past_2_gib(cuda_device):
    """The scale pass over 2^29 + 1024 elements (byte offsets past 2^31)
    against its twin, bit for bit, for every policy."""
    from shared_tensor_tpu_torch.config import ScalePolicy

    n_pad = 2**29 + 1024
    free, _ = torch.cuda.mem_get_info(cuda_device)
    if free < 6 * n_pad * 4:
        pytest.skip(f"needs {6 * n_pad * 4 / 2**30:.0f} GiB free on the GPU, has {free / 2**30:.0f}")
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    r = torch.randn(n_pad, generator=gen, device=cuda_device)
    r[-1024:] = 0.0
    r[-1025] = 40.0  # the largest |r| lies past 2 GiB
    for pol in ScalePolicy:
        k = CC.frame_scale_kernel(r, n_pad - 1024, pol)
        p = CC.frame_scale_plain(r, n_pad - 1024, pol)
        torch.cuda.synchronize()
        assert _same_bits(k, p), (pol, float(k), float(p))


@pytest.mark.cuda
def test_quantize_without_a_scale_runs_the_pass_and_c_and_no_torch_reduction(cuda_device):
    """A CUDA quantize with no scale launches the scale pass's two kernels
    and kernel C (the launch counters), and on the device runs those three,
    nothing else: no torch reduction, no copy to the host (the profiler's
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    n = 2**20 + 3
    r = torch.randn(n + 1021, device=cuda_device)
    CC.quantize(r.clone(), n)  # builds and loads both
    torch.cuda.synchronize()
    CC.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame, _ = CC.quantize(r, n)
        torch.cuda.synchronize()
    assert CC.launches()["frame_scale"] == 2 and CC.launches()["quantize"] == 1
    assert sum(CC.launches().values()) == 3
    names = {e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}
    kernels = {k for k in names if "Memcpy" not in k and "Memset" not in k}
    assert len(kernels) == 3, names
    assert all(any(s in k for s in ("scale_partials_kernel", "scale_finish_kernel", "quantize_kernel"))
               for k in kernels), names
    assert not any("Memcpy" in k or "reduce" in k.lower() for k in names), names
    assert float(frame.scale) > 0


def _begin(st, k, rng):
    # a fresh normal delta first, so none of the K halvings is idle (a delta
    # of ones can leave a residual that one frame zeroes exactly)
    st.add({"w": rng.normal(size=(300, 70)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)})
    return st.begin_frame(1) if k == 1 else st.begin_frame_burst_device(1, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_async_fetch_equals_blocking_copy(cuda_device, k):
    """finish_frame / finish_frame_burst, which wait on the side stream's
    copy into pinned memory, return the same bits as a blocking .cpu() of
    the same device frame, with eight frames in flight on one link (the
    send loop's depth); a second round reuses the pinned blocks the first
    freed, allocating none."""
    rng = np.random.default_rng(k)
    tpl = {"w": rng.uniform(-1, 1, (300, 70)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    st = SharedTensor(tpl, seed_values=True, device=cuda_device)
    st.new_link(1)
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})
    allocs = []
    for _ in range(2):
        inflight = [_begin(st, k, rng) for _ in range(8)]
        for seq, dev in inflight:
            assert dev.fetch is not None
            got = [st.finish_frame(dev)] if k == 1 else st.finish_frame_burst(dev)
            want_s = dev.scales.cpu().numpy().reshape(k, -1)
            want_w = dev.words.cpu().numpy().view(np.uint32).reshape(k, -1)
            assert len(got) == k
            for i, f in enumerate(got):
                assert f.scales.dtype == np.float32 and f.words.dtype == np.uint32
                assert np.array_equal(f.scales.view(np.uint32), want_s[i].view(np.uint32))
                assert np.array_equal(f.words, want_w[i])
            st.ack_frame(1, seq)
        del got, f, inflight
        allocs.append(stats().get("num_host_alloc"))
    assert allocs[0] == allocs[1]  # None == None where torch has no such counter
    with pytest.raises(RuntimeError):
        dev.fetch.wait()  # a fetch is finished once


@pytest.mark.cuda
def test_burst_graph_equals_the_eager_burst(cuda_device):
    """begin_frame_burst_device replays a CUDA graph of the K-frame quantize:
    its frames and the residual it leaves are bit-equal to the eager
    quantize_table_burst on the same residual, over several replays with
    adds in between; each replay counts K launches of kernel A (the
    capture none, its eager warm-up on a copy K); a link
    whose residual is a new tensor gets a new graph."""
    from shared_tensor_tpu_torch.ops.table import quantize_table_burst

    rng = np.random.default_rng(7)
    tpl = {"w": rng.uniform(-1, 1, (300, 70)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    st = SharedTensor(tpl, seed_values=True, device=cuda_device)
    st.new_link(1)
    k = 5
    for i in range(3):
        ref = st._links[1].clone()
        want, _ = quantize_table_burst(ref, st.spec, k)
        CC.reset_launches()
        seq, dev = st.begin_frame_burst_device(1, k)
        torch.cuda.synchronize()
        # the first call also runs the eager warm-up burst before its capture
        assert CC.LAUNCHES["quantize_rows"] == (2 * k if i == 0 else k)
        assert st._graphs[1].tally == {"quantize_rows": k}  # what the capture recorded
        assert _same_bits(dev.scales, want.scales) and _same_bits(dev.words, want.words)
        assert _same_bits(st._links[1], ref)
        st.finish_frame_burst(dev)
        st.ack_frame(1, seq)
        st.add({"w": rng.normal(size=(300, 70)).astype(np.float32), "b": np.zeros(5, np.float32)})
    graph = st._graphs[1]
    st.drop_link(1)
    assert 1 not in st._graphs
    st.new_link(1)
    st.begin_frame_burst_device(1, k)
    assert st._graphs[1] is not graph and st._graphs[1].resid is st._links[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [1, 2, 11, 16, 32, 64])
def test_quantize_rows_cascade_kernel_matches_plain(cuda_device, kc):
    """Kernel A-cascade against its plain twin at frames [j0, j0 + kc) of a
    larger burst: words, scales, residual and partials bit-equal (ragged
    live rows, leaves of whole 8-row tiles, zero, scaled and subnormal
    ladder tops, subnormal residuals); one launch counted, in
    ENGINE_LAUNCHES."""
    rng = np.random.default_rng(kc)
    rows, n_leaves = 96, 5
    _, rowcount, resid = _rows_case(kc, rows)
    row_leaf = np.repeat(np.sort(rng.integers(0, n_leaves, rows // 8)), 8).astype(np.int64)
    row_leaf[: 8 * n_leaves] = np.repeat(np.arange(n_leaves), 8)  # every leaf owns a tile
    row_leaf.sort()
    top = (2.0 ** rng.integers(-8, 3, n_leaves)).astype(np.float32)
    top[0], top[1], top[2] = 0.0, np.float32(3 * 2.0 ** -147), top[2] * np.float32(1.37)
    j0, k = 2, kc + 4
    outs = []
    CC.reset_launches()
    for dev, fn in ((cuda_device, CC.quantize_rows_cascade_kernel), ("cpu", CC.quantize_rows_cascade_plain)):
        r = torch.from_numpy(resid.copy()).to(dev)
        words = torch.zeros((k, rows * 4), dtype=torch.int32, device=dev)
        scales = torch.zeros((k, n_leaves), dtype=torch.float32, device=dev)
        partials = torch.zeros((3, CC.partial_slots(rows)), dtype=torch.float64, device=dev)
        fn(torch.from_numpy(top).to(dev), torch.from_numpy(row_leaf).to(dev), torch.from_numpy(rowcount).to(dev),
           torch.tensor([j0, kc], dtype=torch.int32, device=dev), r, words, scales, partials)
        outs.append([x.cpu() for x in (r, words, scales, partials)])
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(*outs))
    assert CC.ENGINE_LAUNCHES["quantize_rows_cascade"] == 1 and CC.LAUNCHES["quantize_rows"] == 0


@pytest.mark.cuda
def test_cascade_burst_graph_equals_the_eager_cascade(cuda_device):
    """A SharedTensor with cascade=32 replays a CUDA graph of the cascade
    burst: its frames and residual bit-equal to the eager plain
    quantize_table_cascade on a copy, over replays with adds between;
    each replay counts its K + 1 A-cascade launches and K finish launches
    (a round past the last frame returns at once) and no launch of A."""
    from shared_tensor_tpu_torch.ops.table import quantize_table_cascade

    rng = np.random.default_rng(17)
    tpl = {"w": rng.normal(size=(300, 70)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    st = SharedTensor(tpl, seed_values=True, device=cuda_device, cascade=32)
    st.new_link(1)
    k = 16
    for i in range(3):
        ref = st._links[1].clone()
        want, _ = quantize_table_cascade(ref, st.spec, k, 32, impl="plain")
        CC.reset_launches()
        seq, dev = st.begin_frame_burst_device(1, k)
        torch.cuda.synchronize()
        assert CC.ENGINE_LAUNCHES["quantize_rows_cascade"] == (k + 1) * (2 if i == 0 else 1)
        assert CC.ENGINE_LAUNCHES["cascade_round"] == k * (2 if i == 0 else 1)
        assert CC.LAUNCHES["quantize_rows"] == 0
        assert st._graphs[1].tally == {"quantize_rows_cascade": k + 1, "cascade_round": k}
        assert _same_bits(dev.scales, want.scales) and _same_bits(dev.words, want.words)
        assert _same_bits(st._links[1], ref)
        assert st.finish_frame_burst(dev) is not None
        st.ack_frame(1, seq)
        st.add({"w": (rng.normal(size=(300, 70)) * 1e-2).astype(np.float32), "b": np.zeros(5, np.float32)})


@pytest.mark.cuda
def test_a_burst_capture_runs_no_collection_of_earlier_cuda_objects(cuda_device, monkeypatch):
    """A link's burst-graph capture holds the garbage collector off. A
    collection inside it would run, in the capturing thread, the finalizers
    of an earlier node's CUDA objects, and one of them invalidates the
    capture ("operation failed due to a previous error during capture"),
    as it did to every capture of a link in one run of ``chip_smoke.py``'s
    phase 22b. Here an earlier SharedTensor, with its own burst graph and a
    fetch never finished, becomes cyclic garbage just as the capture
    begins, with the collector's thresholds at 1: the capture completes, no
    collection starts inside it, and the burst is the eager one's."""
    import gc

    from shared_tensor_tpu_torch.ops.table import quantize_table_cascade

    rng = np.random.default_rng(23)
    tpl = {"w": rng.normal(size=(300, 70)).astype(np.float32)}
    held = {}
    collections = []

    def started(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            collections.append(info["generation"])

    class Graph(torch.cuda.CUDAGraph):
        def capture_begin(self, *args, **kwargs):
            super().capture_begin(*args, **kwargs)
            held.clear()  # the last outside reference: only its cycle holds the old node now
            gc.set_threshold(1, 1, 1)
            [[] for _ in range(1000)]  # enough new containers to start a collection, were it allowed

    thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()  # what the process held so far is never collected, so full collections are due
    gc.callbacks.append(started)
    try:
        old = SharedTensor(tpl, seed_values=True, device=cuda_device, cascade=32)
        old.new_link(1)
        old.pending = old.begin_frame_burst_device(1, 8)
        old.cycle = old
        held["old"] = old
        del old
        st = SharedTensor(tpl, seed_values=True, device=cuda_device, cascade=32)
        st.new_link(1)
        ref = st._links[1].clone()
        want, _ = quantize_table_cascade(ref, st.spec, 8, 32, impl="plain")
        monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
        seq, dev = st.begin_frame_burst_device(1, 8)
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*thresholds)
        gc.callbacks.remove(started)
        gc.unfreeze()
    assert collections == []
    assert _same_bits(dev.scales, want.scales) and _same_bits(dev.words, want.words)
    assert _same_bits(st._links[1], ref)
    assert st.finish_frame_burst(dev) is not None


def _burst_table(name):
    from shared_tensor_tpu_torch.benchmarks.burst_graph import config2_template, resnet18_template
    from shared_tensor_tpu_torch.ops.table import make_spec

    if name == "resnet18":
        return make_spec(resnet18_template())
    return make_spec(config2_template() if name == "config2" else {"t": np.zeros(1 << 20, np.float32)})


@pytest.mark.cuda
@pytest.mark.parametrize("per_leaf", [True, False], ids=["per-leaf", "aggregate"])
@pytest.mark.parametrize("table", ["config2", "resnet18", "1Mi", "1500-leaves"])
def test_finish_kernel_matches_plain_on_every_layout(cuda_device, table, per_leaf):
    """The finish kernel alone against its twin on seeded partials, at
    config 2's, ResNet-18's and the 1 Mi table's leaf layouts, and at 1,500
    leaves of 0 to 12 slots (the leaf bounds read from global memory rather
    than staged, leaves with no slots, runs that cross many leaves): leaf
    sums, ladder and state bit-equal."""
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.ops import table as T

    rng = np.random.default_rng(5)
    if table == "1500-leaves":
        sizes = rng.integers(0, 13, 1500)
        bounds = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))
        ns = torch.from_numpy((sizes * 1024 + 1).astype(np.float64))
    else:
        spec = _burst_table(table)
        c = T._cascade_consts(spec, "cpu")
        bounds, ns = c.leaf_slots, c.ns
    slots, n_leaves, k = int(bounds[-1]), ns.shape[0], 16
    amax = np.abs(rng.normal(0, 1e-2, slots)) * 2.0 ** rng.integers(-3, 4, slots)
    partials = torch.from_numpy(np.stack([amax, amax**2 * rng.uniform(50, 300, slots),
                                          amax * rng.uniform(100, 500, slots)]))
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        scales = torch.zeros((k, n_leaves), dtype=torch.float32, device=dev)
        state = torch.zeros(3, dtype=torch.int32, device=dev)
        ladder = torch.zeros((3, n_leaves), dtype=torch.float32, device=dev)
        sums = torch.zeros((3, n_leaves), dtype=torch.float64, device=dev)
        fn = CC.cascade_round_kernel if dev.type == "cuda" else CC.cascade_round_plain
        fn(partials.to(dev), bounds.to(dev), ns.to(dev), scales, state, ladder, sums, k, 32, ScalePolicy.POW2_RMS,
           per_leaf, True)
        outs.append([x.cpu() for x in (sums, ladder, state)])
    assert all(_same_bits(x, y) for x, y in zip(*outs))
    assert outs[0][2].tolist()[1] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["config2", "1Mi"])
@pytest.mark.parametrize("kc", [1, 2, 11, 16, 32, 64])
def test_cascade_kernels_match_plain_on_the_burst_tables(cuda_device, table, kc):
    """A-cascade and the finish kernel against their plain twins at the
    main path's shapes (BASELINE config 2's table and 1 Mi, chip_smoke's
    phase 22a residual), launch by launch (``burst_graph.round_trip``, the
    pass at frames [2, 2 + kc) of kc + 4): frames,
    residual, partials, ladder, per-leaf sums and the next round's state
    bit-equal; the finish's depth is the round's."""
    from shared_tensor_tpu_torch.benchmarks.burst_graph import residual, round_trip
    from shared_tensor_tpu_torch.config import ScalePolicy

    spec = _burst_table(table)
    r0 = residual(spec, cuda_device, 22)
    pol = ScalePolicy.POW2_RMS
    got = round_trip(spec, r0, kc, CC.quantize_rows_cascade_kernel, CC.cascade_round_kernel, pol, j0=2, k=kc + 4)
    want = round_trip(spec, r0, kc, CC.quantize_rows_cascade_plain, CC.cascade_round_plain, pol, j0=2, k=kc + 4)
    for step, (g, w) in enumerate(zip(got, want)):
        bad = [i for i, (x, y) in enumerate(zip(g, w)) if not _same_bits(x, y)]
        assert not bad, (step, bad)
    assert got[1][3].tolist()[1] > 1 and got[2][2][2 : 2 + kc].any(dim=1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("per_leaf", [True, False], ids=["per-leaf", "aggregate"])
@pytest.mark.parametrize("policy", ["POW2_RMS", "RMS", "ABS_MEAN"])
def test_finish_kernel_matches_plain_for_every_policy(cuda_device, policy, per_leaf):
    """The finish kernel against its twin at config 2's table for every
    scale policy, per leaf and aggregated: ladder, per-leaf sums and state
    bit-equal after the measuring launch and after a 16-level pass."""
    from shared_tensor_tpu_torch.benchmarks.burst_graph import residual, round_trip
    from shared_tensor_tpu_torch.config import ScalePolicy

    spec = _burst_table("config2")
    r0 = residual(spec, cuda_device, 7)
    pol = ScalePolicy[policy]
    got = round_trip(spec, r0, 16, CC.quantize_rows_cascade_kernel, CC.cascade_round_kernel, pol, per_leaf, 2, 20)
    want = round_trip(spec, r0, 16, CC.quantize_rows_cascade_plain, CC.cascade_round_plain, pol, per_leaf, 2, 20)
    for g, w in zip(got, want):
        assert all(_same_bits(x, y) for x, y in zip(g, w))


@pytest.mark.cuda
def test_a_cascade_burst_graph_holds_at_most_2k_plus_2_kernels(cuda_device):
    """A 16-frame cascade burst captured as a CUDA graph holds 2K + 1 kernel
    nodes, the codec's own (K + 1 A-cascade, K finish), and no other node
    that runs on the card: nothing of the torch measurement is left."""
    from shared_tensor_tpu_torch.benchmarks.burst_graph import graph_node_types, residual
    from shared_tensor_tpu_torch.ops.table import quantize_table_cascade

    spec = _burst_table("config2")
    r = residual(spec, cuda_device, 22)
    k = 16
    CC.reset_launches()
    with CC.capture_tally() as tally:
        nodes = graph_node_types(lambda: quantize_table_cascade(r, spec, k, 32))
    # the eager call before the capture, then the capture
    assert tally == {"quantize_rows_cascade": 2 * (k + 1), "cascade_round": 2 * k}
    assert nodes.get("kernel", 0) == 2 * k + 1 <= 2 * k + 2, nodes
    assert not {t for t in nodes if t not in ("kernel", "empty")}, nodes


@pytest.mark.cuda
def test_a_failed_cascade_kernel_build_raises_on_the_card(cuda_device, monkeypatch, tmp_path):
    """A burst on a CUDA residual whose kernels cannot be built raises and
    leaves the residual as it was: no fall back to the plain twins or the
    torch measurement."""
    from shared_tensor_tpu_torch.ops.table import make_spec, quantize_table_cascade

    def broken(names=None):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(CC, "_LIBS", {})
    monkeypatch.setattr(CC, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(CC, "build", broken)
    spec = make_spec({"t": np.zeros(4096, np.float32)})
    r = torch.randn(spec.total, device=cuda_device)
    before = r.clone()
    CC.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        quantize_table_cascade(r, spec, 8, 32)
    torch.cuda.synchronize()
    assert torch.equal(r, before) and not any(CC.launches().values())


@pytest.mark.cuda
def test_retract_frames_on_the_card_matches_plain(cuda_device):
    """SharedTensor.retract_frames (a severed uplink's applied frames taken
    back out: kernel B with negated scales into the replica and every
    link's residual) on the card equals the plain version on the CPU bit
    for bit, from the same burst, and launches B."""
    rng = np.random.default_rng(21)
    tpl = {"w": rng.uniform(-1, 1, (300, 70)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        st = SharedTensor(tpl, seed_values=True, device=dev)
        st.new_link(1)
        st.new_link(2, seed=False)
        before = st.values.clone()
        seq, _ = st.begin_frame_burst_device(1, 4)
        frames = st.inflight_frames(1, [seq])[0]
        assert len(frames) == 4
        CC.reset_launches()
        st.retract_frames(list(frames))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert CC.LAUNCHES["apply_rows_batch"] >= 1
        total = sum(f.scales.double().abs().max().item() for f in frames)
        assert 0 < (before - st.values).abs().max().item() <= total * (1 + 1e-6)
        outs.append([x.cpu() for x in (st.values, st._links[1], st._links[2])])
    for got, want in zip(*outs):
        assert _same_bits(got, want)


@pytest.mark.cuda
def test_forty_shared_tensors_each_own_a_stream(cuda_device):
    """Every live CUDA SharedTensor has a side stream no other holds (a
    capture records whatever is enqueued on its stream), with no cap from
    PyTorch's pool of 32; the streams of collected ones are reused."""
    import gc

    tpl = {"w": np.ones((64, 8), np.float32)}
    sts = [SharedTensor(tpl, seed_values=True, device=cuda_device) for _ in range(40)]
    handles = {st._fetch_stream.cuda_stream for st in sts}
    assert len(handles) == 40
    for st in sts:
        st.new_link(1)
        seq, dev = st.begin_frame_burst_device(1, 3)
        assert st.finish_frame_burst(dev) is not None
        st.ack_frame(1, seq)
    del sts, st, dev
    gc.collect()
    again = [SharedTensor(tpl, device=cuda_device) for _ in range(40)]
    assert {st._fetch_stream.cuda_stream for st in again} == handles


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_two_peer_round_trip_runs_the_kernels(cuda_device):
    """Two peers on the GPU over loopback TCP (BASELINE config 1's shape):
    the joiner fetches the seed, both add, both read seed + both deltas,
    and kernels A and B ran on the way."""
    from shared_tensor_tpu_torch import CodecConfig, Config, TransportConfig, create_or_fetch

    # cascade_frames=1: the per-frame burst, kernel A
    cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0), codec=CodecConfig(cascade_frames=1))
    seed = np.arange(1.0, 241.0, dtype=np.float32).reshape(4, 5, 6, 2)
    want = seed + 1.5
    port = _free_port()
    CC.reset_launches()
    with create_or_fetch("127.0.0.1", port, seed, cfg, device=cuda_device) as m, create_or_fetch(
        "127.0.0.1", port, np.zeros_like(seed), cfg, device=cuda_device
    ) as j:
        m.add(np.full_like(seed, 1.0))
        j.add(torch.full(seed.shape, 0.5, device=cuda_device))
        deadline = time.time() + 60
        while time.time() < deadline:
            got = [p.read() for p in (m, j)]
            if all(np.allclose(g.cpu().numpy(), want, rtol=0, atol=1e-6) for g in got):
                break
            time.sleep(0.05)
        for g in got:
            assert g.device.type == "cuda"
            np.testing.assert_allclose(g.cpu().numpy(), want, rtol=0, atol=1e-6)
        assert m.threads_alive() and j.threads_alive() and m._error is None and j._error is None
        for p in (m, j):
            faults = {k: v for k, v in p.metrics().items() if k in FAULTS and v}
            assert faults == {}, faults
    assert CC.LAUNCHES["quantize_rows"] > 0 and CC.LAUNCHES["apply_rows_batch"] > 0, CC.LAUNCHES


@pytest.mark.cuda
def test_two_peer_round_trip_runs_the_cascade_kernel(cuda_device):
    """Two peers on the GPU over loopback TCP (BASELINE config 1's shape):
    the joiner fetches the seed, both add, both read seed + both deltas,
    and the kernels of the path ran on the way: A-cascade (the peers'
    bursts follow the engine's cascade, ``CodecConfig.cascade_frames``)
    and B."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch

    cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0))
    seed = np.arange(1.0, 241.0, dtype=np.float32).reshape(4, 5, 6, 2)
    want = seed + 1.5
    port = _free_port()
    CC.reset_launches()
    with create_or_fetch("127.0.0.1", port, seed, cfg, device=cuda_device) as m, create_or_fetch(
        "127.0.0.1", port, np.zeros_like(seed), cfg, device=cuda_device
    ) as j:
        m.add(np.full_like(seed, 1.0))
        j.add(torch.full(seed.shape, 0.5, device=cuda_device))
        deadline = time.time() + 60
        while time.time() < deadline:
            got = [p.read() for p in (m, j)]
            if all(np.allclose(g.cpu().numpy(), want, rtol=0, atol=1e-6) for g in got):
                break
            time.sleep(0.05)
        for g in got:
            assert g.device.type == "cuda"
            np.testing.assert_allclose(g.cpu().numpy(), want, rtol=0, atol=1e-6)
        assert m.threads_alive() and j.threads_alive() and m._error is None and j._error is None
        for p in (m, j):
            faults = {k: v for k, v in p.metrics().items() if k in FAULTS and v}
            assert faults == {}, faults
    assert CC.ENGINE_LAUNCHES["quantize_rows_cascade"] > 0 and CC.LAUNCHES["apply_rows_batch"] > 0, CC.launches()


@pytest.mark.cuda
def test_cuda_peer_pair_with_obs_on(cuda_device):
    """Two CUDA peers with obs on (fast digest and clock beats): the
    histograms that time the host work around kernels A and B count, the
    child's digest reaches the root's cluster view, and the child learns
    its offset (skewed +50 ms) within its uncertainty."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.config import ObsConfig

    fast = dict(digest_interval_sec=0.1, clock_sync_interval_sec=0.1)
    seed = np.arange(1.0, 241.0, dtype=np.float32).reshape(4, 5, 6, 2)
    port = _free_port()
    with create_or_fetch("127.0.0.1", port, seed, Config(transport=TransportConfig(peer_timeout_sec=10.0),
                                                         obs=ObsConfig(**fast)), device=cuda_device) as m, \
            create_or_fetch("127.0.0.1", port, np.zeros_like(seed), Config(
                transport=TransportConfig(peer_timeout_sec=10.0), obs=ObsConfig(clock_skew_sim_sec=0.05, **fast)),
                device=cuda_device) as j:
        j.add(np.full_like(seed, 0.5))
        m.add(np.full_like(seed, 1.0))
        deadline = time.time() + 30
        while time.time() < deadline:
            if str(j.node.obs_id) in m.metrics(cluster=True)["nodes"] and j._clock.replies >= 3 and \
                    np.allclose(m.read().cpu().numpy(), seed + 1.5, atol=1e-6):
                break
            time.sleep(0.05)
        mm, jm = m.metrics(), j.metrics()
        assert mm["st_encode_seconds"]["count"] > 0 and mm["st_apply_seconds"]["count"] > 0, mm
        assert jm["st_ack_rtt_seconds"]["count"] > 0 and mm["st_update_hops"]["count"] > 0
        assert str(j.node.obs_id) in m.metrics(cluster=True)["nodes"]
        assert abs(jm["st_clock_offset_seconds"] - 0.05) <= jm["st_clock_uncertainty_seconds"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [240, 3870976])
def test_kernels_on_a_compat_frame_match_plain(cuda_device, n):
    """A and B on a one-leaf table, the frame the reference wire carries:
    A's words, scale and residual bit-equal to the plain version's, the
    frame byte-identical to the reference bytes the plain frame encodes
    to, and B's apply of the decoded frame into the replica and a residual
    bit-equal to the plain version's."""
    from shared_tensor_tpu_torch.comm import wire
    from shared_tensor_tpu_torch.ops import table as TT

    rng = np.random.default_rng(n)
    tmpl = np.zeros(n, np.float32)
    spec = TT.make_spec(tmpl)
    resid = torch.from_numpy(rng.normal(size=spec.total).astype(np.float32) * (np.arange(spec.total) < n)).to(
        cuda_device)
    fk, rk = TT.quantize_table(resid.clone(), spec, impl="kernel")
    fp, rp = TT.quantize_table(resid.clone(), spec, impl="plain")
    torch.cuda.synchronize()
    assert _same_bits(fk.words, fp.words) and _same_bits(fk.scales, fp.scales) and _same_bits(rk, rp)
    host = [TT.TableFrame(f.scales.cpu().numpy(), f.words.cpu().numpy().view(np.uint32)) for f in (fk, fp)]
    payload = wire.encode_compat_frame(host[0], spec)
    assert payload == wire.encode_compat_frame(host[1], spec) and len(payload) == wire.compat_frame_bytes(n)
    back = wire.decode_compat_frame(payload, spec)
    dev = TT.TableFrame(torch.from_numpy(back.scales).to(cuda_device).reshape(1, -1),
                        torch.from_numpy(back.words.view(np.int32).copy()).to(cuda_device).reshape(1, -1))
    vals = torch.from_numpy(rng.normal(size=spec.total).astype(np.float32)).to(cuda_device)
    ak = TT.apply_table_batch((vals.clone(), rk.clone()), dev, spec, "kernel")
    ap = TT.apply_table_batch((vals.clone(), rk.clone()), dev, spec, "plain")
    torch.cuda.synchronize()
    assert all(_same_bits(x, y) for x, y in zip(ak, ap))


def _serve_a_subscriber(dev, codec=None) -> None:
    """A CUDA writer (with ``codec``) and one read-only subscriber: one
    add, read once fresh past it (within 1e-6), and the subscriber's
    ServingHandle on the card equal to read(). Launch counts reset before
    the add."""
    from shared_tensor_tpu_torch import CodecConfig, Config, TransportConfig, create_or_fetch, serve

    cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0), codec=codec or CodecConfig())
    seed = {"w": np.arange(4096, dtype=np.float32).reshape(64, 64), "b": np.ones(100, np.float32)}
    zeros = {k: np.zeros_like(v) for k, v in seed.items()}
    port = _free_port()
    with create_or_fetch("127.0.0.1", port, seed, cfg, device=dev) as m:
        with serve.subscribe("127.0.0.1", port, zeros, Config(transport=cfg.transport), timeout=30.0) as sub:
            CC.reset_launches()
            m.add({k: np.full_like(v, 0.5) for k, v in seed.items()})
            sub.wait_fresh(serve.epoch(), timeout=30.0)
            got = sub.read(max_staleness=10.0)
            for k in seed:
                np.testing.assert_allclose(got[k], seed[k] + 0.5, rtol=0, atol=1e-6)
            handle = sub.serving_handle(max_staleness=10.0)
            assert handle.refresh()
            params = handle.params()
            for k in seed:
                assert params[k].device.type == "cuda"
                np.testing.assert_array_equal(params[k].cpu().numpy(), got[k])
            assert m.metrics()["st_sub_links"] == 1
            # an idle pass holds its burst's ledger entry from the quantize
            # to the copy's end: the writer keeps none across passes
            deadline = time.time() + 10.0
            while m.st.inflight_total() and time.time() < deadline:
                time.sleep(0.005)
            assert m.st.inflight_total() == 0


@pytest.mark.cuda
def test_cuda_writer_serves_a_subscriber(cuda_device):
    """A CUDA writer serves a read-only subscriber: its cascade bursts
    (kernel A-cascade and the finish kernel, one CUDA graph) quantize the
    subscriber link, the subscriber converges on the seed plus an add
    within 1e-6 once fresh past the add, and its ServingHandle's tensors
    are on the card and equal read()."""
    _serve_a_subscriber(cuda_device)
    assert CC.ENGINE_LAUNCHES["quantize_rows_cascade"] > 0 and CC.ENGINE_LAUNCHES["cascade_round"] > 0, \
        CC.launches()


@pytest.mark.cuda
def test_cuda_writer_serves_a_subscriber_single_frames(cuda_device):
    """The same with ``cascade_frames=1``: the subscriber link takes one
    frame of kernel A a pass, JAX's schedule."""
    from shared_tensor_tpu_torch import CodecConfig

    _serve_a_subscriber(cuda_device, CodecConfig(cascade_frames=1))
    assert CC.LAUNCHES["quantize_rows"] > 0 and CC.ENGINE_LAUNCHES["quantize_rows_cascade"] == 0, CC.launches()


def _pod_step_kernel_vs_plain(mesh, steps):
    """On each rank: one seeded pod state through ``steps`` sync steps with
    the kernels and again with their plain versions, on the card. Returns
    (bit mismatches, kernel launches)."""
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec
    from shared_tensor_tpu_torch.parallel import add_updates, build_sync_step, init_state

    rng = np.random.default_rng(0)
    shapes = {"w": (300, 70), "b": (9,)}
    tpl = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    spec = make_spec(tpl)
    ups = [flatten({k: rng.normal(size=s).astype(np.float32) * 10.0 ** p for k, s in shapes.items()}, spec)
           for p in range(mesh.n_peer)]
    outs = []
    CC.reset_launches()
    for impl in ("kernel", "plain"):
        state = init_state(mesh, spec, tpl)
        add_updates(state, ups[mesh.peer].to(mesh.device))
        step = build_sync_step(mesh, spec, impl=impl)
        for _ in range(steps):
            state, scales = step(state)
        outs.append([state.values.cpu(), state.residual.cpu(), scales.cpu()])
    launches = dict(CC.LAUNCHES)
    return sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(*outs)), launches


@pytest.mark.cuda
def test_pod_step_kernels_match_plain_on_two_gloo_ranks(cuda_device):
    """Two ranks on the card (gloo, through pinned host buffers): the pod
    step with kernels A and B equals the plain step bit for bit, one launch
    of each per step per rank."""
    from shared_tensor_tpu_torch.parallel import run_mesh

    for mismatches, launches in run_mesh(_pod_step_kernel_vs_plain, 2, 1, 3, device="cuda", backend="gloo",
                                         timeout_s=300):
        assert mismatches == 0
        assert launches == {"quantize_rows": 3, "apply_rows_batch": 3, "quantize": 0, "apply_frame_many": 0}


@pytest.mark.cuda
def test_inplace_restore_recaptures_the_burst_graph(cuda_device):
    """A CUDA peer restores in place (restore_cluster) a link residual that
    its burst graph did not capture: the first burst after the restore
    quantizes the RESTORED residual, its frames and the residual it leaves
    bit-equal to the plain codec's on that residual, through a graph
    captured anew on the restored tensor."""
    import tempfile
    import threading

    from shared_tensor_tpu_torch import CodecConfig, Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.config import LifecycleConfig
    from shared_tensor_tpu_torch.ops.table import quantize_table_burst

    def cfg(name):
        # cascade_frames=1: the per-frame burst, kernel A
        return Config(transport=TransportConfig(peer_timeout_sec=10.0), lifecycle=LifecycleConfig(node_name=name),
                      codec=CodecConfig(cascade_frames=1))

    rng = np.random.default_rng(11)
    n = 1 << 16
    port = _free_port()
    with create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32), cfg("m"), device=cuda_device) as m, \
            create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32), cfg("j"), device=cuda_device) as j, \
            tempfile.TemporaryDirectory() as snap:
        link = m.st.link_ids[0]
        # paused, the add stays in m's link residual: the cut holds it whole
        m.pause()
        x = rng.uniform(-1, 1, n).astype(np.float32)
        m.add(x)
        assert m.snapshot_cluster(snap)["ok"]
        m.add(rng.uniform(-1, 1, n).astype(np.float32))
        deadline = time.time() + 30
        while time.time() < deadline and not m.drain(timeout=0.5):
            pass
        old_graph = m.st._graphs[link]
        rec, armed = [], threading.Event()
        begin, restore = m.st.begin_frame_burst_device, m.st.restore_state

        def recording_begin(lid, k):
            if lid != link or not armed.is_set() or rec:
                return begin(lid, k)
            before = m.st._links[lid].clone()
            out = begin(lid, k)
            # this stream only: a device-wide sync here, in the send thread,
            # fails while another peer's thread captures its burst graph
            torch.cuda.current_stream().synchronize()
            rec.append((before, out[1].scales.clone(), out[1].words.clone(), m.st._links[lid].clone(), k))
            return out

        def arming_restore(values, links):
            restore(values, links)
            armed.set()

        m.st.begin_frame_burst_device, m.st.restore_state = recording_begin, arming_restore
        assert m.restore_cluster(snap)["ok"]
        deadline = time.time() + 30
        while not rec and time.time() < deadline:
            time.sleep(0.01)
        assert rec, "no burst after the restore"
        before, scales, words, after, k = rec[0]
        np.testing.assert_array_equal(before.cpu().numpy(), x)  # the restored residual, whole
        want, resid = quantize_table_burst(before.clone(), m.st.spec, k, m.st.codec.scale_policy,
                                           m.st.codec.per_leaf_scale, "plain")
        torch.cuda.synchronize()
        assert _same_bits(scales, want.scales) and _same_bits(words, want.words)
        assert _same_bits(after, resid)
        assert m.st._graphs[link] is not old_graph and m.st._graphs[link].resid is m.st._links[link]
        assert j.threads_alive() and m.threads_alive()


@pytest.mark.cuda
def test_inplace_restore_recaptures_the_cascade_burst_graph(cuda_device):
    """A CUDA peer restores in place (restore_cluster) a link residual that
    its burst graph did not capture: the first burst after the restore
    quantizes the RESTORED residual, its frames and the residual it leaves
    bit-equal to the plain codec's on that residual (the peer's cascade
    burst), through a graph captured anew on the restored tensor."""
    import tempfile
    import threading

    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.config import LifecycleConfig
    from shared_tensor_tpu_torch.ops.table import quantize_table_cascade

    def cfg(name):
        return Config(transport=TransportConfig(peer_timeout_sec=10.0), lifecycle=LifecycleConfig(node_name=name))

    rng = np.random.default_rng(11)
    n = 1 << 16
    port = _free_port()
    with create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32), cfg("m"), device=cuda_device) as m, \
            create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32), cfg("j"), device=cuda_device) as j, \
            tempfile.TemporaryDirectory() as snap:
        link = m.st.link_ids[0]
        # paused, the add stays in m's link residual: the cut holds it whole
        m.pause()
        x = rng.uniform(-1, 1, n).astype(np.float32)
        m.add(x)
        assert m.snapshot_cluster(snap)["ok"]
        m.add(rng.uniform(-1, 1, n).astype(np.float32))
        deadline = time.time() + 30
        while time.time() < deadline and not m.drain(timeout=0.5):
            pass
        old_graph = m.st._graphs[link]
        rec, armed = [], threading.Event()
        begin, restore = m.st.begin_frame_burst_device, m.st.restore_state

        def recording_begin(lid, k):
            if lid != link or not armed.is_set() or rec:
                return begin(lid, k)
            before = m.st._links[lid].clone()
            out = begin(lid, k)
            # this stream only: a device-wide sync here, in the send thread,
            # fails while another peer's thread captures its burst graph
            torch.cuda.current_stream().synchronize()
            rec.append((before, out[1].scales.clone(), out[1].words.clone(), m.st._links[lid].clone(), k))
            return out

        def arming_restore(values, links):
            restore(values, links)
            armed.set()

        m.st.begin_frame_burst_device, m.st.restore_state = recording_begin, arming_restore
        assert m.restore_cluster(snap)["ok"]
        deadline = time.time() + 30
        while not rec and time.time() < deadline:
            time.sleep(0.01)
        assert rec, "no burst after the restore"
        before, scales, words, after, k = rec[0]
        np.testing.assert_array_equal(before.cpu().numpy(), x)  # the restored residual, whole
        want, resid = quantize_table_cascade(before.clone(), m.st.spec, k, m.st.cascade, m.st.codec.scale_policy,
                                             m.st.codec.per_leaf_scale, "plain")
        torch.cuda.synchronize()
        assert _same_bits(scales, want.scales) and _same_bits(words, want.words)
        assert _same_bits(after, resid)
        assert m.st._graphs[link] is not old_graph and m.st._graphs[link].resid is m.st._links[link]
        assert j.threads_alive() and m.threads_alive()


@pytest.mark.cuda
def test_shard_torch_view_lands_on_the_card(cuda_device):
    """A sharded pair (host code on both planes' nodes) drains two adds;
    ``torch_view()`` (device None: the GPU) is one flat f32 tensor on the
    card, bit-equal to a gather of the owners."""
    from shared_tensor_tpu_torch.config import Config, ShardConfig, TransportConfig
    from shared_tensor_tpu_torch.shard import create_or_fetch_sharded

    tmpl = {"w": np.zeros(4096, np.float32), "b": np.zeros(512, np.float32)}
    port = _free_port()

    def cfg(i, lane):
        return Config(shard=ShardConfig(n_shards=2, shard_index=i, engine_lane=lane),
                      transport=TransportConfig(peer_timeout_sec=10.0))

    rng = np.random.default_rng(12)
    with create_or_fetch_sharded("127.0.0.1", port, tmpl, cfg(0, True)) as h0, \
            create_or_fetch_sharded("127.0.0.1", port, tmpl, cfg(1, False)) as h1:
        assert h0.sharded and h1.sharded
        for h in (h0, h1):
            h.add({"w": rng.uniform(-1, 1, 4096).astype(np.float32), "b": rng.uniform(-1, 1, 512).astype(np.float32)})
        assert h0.drain(timeout=30.0) and h1.drain(timeout=30.0)
        view = h0.torch_view()
        assert view.device.type == "cuda" and view.dtype == torch.float32
        assert view.shape == (h0.node.spec.total,)
        with h0.gather() as g:
            flat, _worst = g.read(60.0)
        assert _same_bits(view.cpu(), torch.from_numpy(flat))


@pytest.mark.cuda
def test_sharded_fallback_peer_runs_the_cuda_tier(cuda_device):
    """A sharded joiner under a CUDA classic master falls back to a classic
    peer on the GPU (device None), whose first burst after an add is
    bit-equal to the plain codec's on the same residual; both converge."""
    from shared_tensor_tpu_torch import CodecConfig, Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.config import ShardConfig
    from shared_tensor_tpu_torch.ops.table import quantize_table_burst
    from shared_tensor_tpu_torch.shard import create_or_fetch_sharded

    n = 1 << 16
    port = _free_port()
    # cascade_frames=1: the per-frame burst, kernel A
    cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0), codec=CodecConfig(cascade_frames=1))
    scfg = Config(transport=cfg.transport, shard=ShardConfig(n_shards=4, shard_index=1), codec=cfg.codec)
    x = np.random.default_rng(13).uniform(-1, 1, n).astype(np.float32)
    CC.reset_launches()
    with create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32), cfg, device=cuda_device) as m:
        with create_or_fetch_sharded("127.0.0.1", port, np.zeros(n, np.float32), scfg) as h:
            assert not h.sharded
            p = h.peer
            assert p.st.device.type == "cuda" and p._engine is None
            link = p.st.link_ids[0]
            rec = []
            begin = p.st.begin_frame_burst_device

            def recording_begin(lid, k):
                first = lid == link and not rec
                before = p.st._links[lid].clone() if first else None
                out = begin(lid, k)
                if first:
                    # this stream only: a device-wide sync here, in the send
                    # thread, fails while another thread captures a burst graph
                    torch.cuda.current_stream().synchronize()
                    rec.append((before, out[1].scales.clone(), out[1].words.clone(), p.st._links[lid].clone(), k))
                return out

            # paused, the add waits whole in the link's residual: the first
            # burst after the resume quantizes exactly it
            p.pause()
            p.st.begin_frame_burst_device = recording_begin
            h.add(x)
            m.add(x)
            p.pause(False)
            deadline = time.time() + 60
            while time.time() < deadline:
                got = [q.read().cpu().numpy() for q in (m, p)]
                if rec and all(np.allclose(g, 2 * x, rtol=0, atol=1e-5) for g in got):
                    break
                time.sleep(0.05)
            assert rec, "no burst after the add"
            for g in got:
                np.testing.assert_allclose(g, 2 * x, rtol=0, atol=1e-5)
            before, scales, words, after, k = rec[0]
            np.testing.assert_array_equal(before.cpu().numpy(), x)  # the add, whole
            want, resid = quantize_table_burst(before.clone(), p.st.spec, k, p.st.codec.scale_policy,
                                               p.st.codec.per_leaf_scale, "plain")
            torch.cuda.synchronize()
            assert _same_bits(scales, want.scales) and _same_bits(words, want.words)
            assert _same_bits(after, resid)
    assert CC.LAUNCHES["quantize_rows"] > 0 and CC.LAUNCHES["apply_rows_batch"] > 0, CC.LAUNCHES


@pytest.mark.cuda
def test_sharded_fallback_peer_runs_the_cuda_cascade(cuda_device):
    """A sharded joiner under a CUDA classic master falls back to a classic
    peer on the GPU (device None), whose first burst after an add is
    bit-equal to the plain codec's on the same residual (the peer's
    cascade burst); both converge."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
    from shared_tensor_tpu_torch.config import ShardConfig
    from shared_tensor_tpu_torch.ops.table import quantize_table_cascade
    from shared_tensor_tpu_torch.shard import create_or_fetch_sharded

    n = 1 << 16
    port = _free_port()
    cfg = Config(transport=TransportConfig(peer_timeout_sec=10.0))
    scfg = Config(transport=cfg.transport, shard=ShardConfig(n_shards=4, shard_index=1))
    x = np.random.default_rng(13).uniform(-1, 1, n).astype(np.float32)
    CC.reset_launches()
    with create_or_fetch("127.0.0.1", port, np.zeros(n, np.float32), cfg, device=cuda_device) as m:
        with create_or_fetch_sharded("127.0.0.1", port, np.zeros(n, np.float32), scfg) as h:
            assert not h.sharded
            p = h.peer
            assert p.st.device.type == "cuda" and p._engine is None
            link = p.st.link_ids[0]
            rec = []
            begin = p.st.begin_frame_burst_device

            def recording_begin(lid, k):
                first = lid == link and not rec
                before = p.st._links[lid].clone() if first else None
                out = begin(lid, k)
                if first:
                    # this stream only: a device-wide sync here, in the send
                    # thread, fails while another thread captures a burst graph
                    torch.cuda.current_stream().synchronize()
                    rec.append((before, out[1].scales.clone(), out[1].words.clone(), p.st._links[lid].clone(), k))
                return out

            # paused, the add waits whole in the link's residual: the first
            # burst after the resume quantizes exactly it
            p.pause()
            p.st.begin_frame_burst_device = recording_begin
            h.add(x)
            m.add(x)
            p.pause(False)
            deadline = time.time() + 60
            while time.time() < deadline:
                got = [q.read().cpu().numpy() for q in (m, p)]
                if rec and all(np.allclose(g, 2 * x, rtol=0, atol=1e-5) for g in got):
                    break
                time.sleep(0.05)
            assert rec, "no burst after the add"
            for g in got:
                np.testing.assert_allclose(g, 2 * x, rtol=0, atol=1e-5)
            before, scales, words, after, k = rec[0]
            np.testing.assert_array_equal(before.cpu().numpy(), x)  # the add, whole
            want, resid = quantize_table_cascade(before.clone(), p.st.spec, k, p.st.cascade,
                                                 p.st.codec.scale_policy, p.st.codec.per_leaf_scale, "plain")
            torch.cuda.synchronize()
            assert _same_bits(scales, want.scales) and _same_bits(words, want.words)
            assert _same_bits(after, resid)
    assert CC.ENGINE_LAUNCHES["quantize_rows_cascade"] > 0 and CC.LAUNCHES["apply_rows_batch"] > 0, CC.launches()


@pytest.mark.cuda
def test_codec_lab_twins_on_the_card_match_the_numpy_lab(cuda_device):
    """The codec lab's device twins (ops/codec_lab_torch) on CUDA tensors
    against the numpy lab (ops/codec_lab): Sign2's codes byte-equal and
    residual bit-equal at the same scale (or the scales one octave apart at
    an exact boundary), and its apply equal to the lab's decode added;
    TopK's index set equal and its apply conserving exactly."""
    from shared_tensor_tpu_torch.ops import codec_lab_torch as lt
    from shared_tensor_tpu_torch.ops.codec_lab import Sign2, TopK
    from shared_tensor_tpu_torch.ops.packing import words_to_host, words_to_wire

    n = 1 << 16
    r = np.random.default_rng(14).standard_normal(n).astype(np.float32)
    frame, new_np = Sign2().encode(r.copy())
    scale, words, new_d = lt.sign2_quantize(torch.from_numpy(r).to(cuda_device), n)
    if float(scale) == frame.scale:
        assert words_to_wire(words_to_host(words), 2 * n) == frame.data.tobytes()
        assert _same_bits(new_d.cpu(), torch.from_numpy(new_np))
        vals = torch.from_numpy(r).to(cuda_device)
        out = lt.sign2_apply(vals, scale, words, n)
        assert _same_bits(out.cpu(), torch.from_numpy(r + Sign2().decode(frame, n)))
    else:
        assert max(float(scale), frame.scale) == 2 * min(float(scale), frame.scale)
    k = n // 32
    tf, tnew = TopK(k).encode(r.copy())
    idx, vals, rk = lt.topk_quantize(torch.from_numpy(r).to(cuda_device), k)
    assert set(idx.cpu().tolist()) == set(tf.data[:, 0].view(np.uint32).tolist())
    assert _same_bits(rk.cpu(), torch.from_numpy(tnew))
    back = lt.topk_apply(rk, idx, vals, n)
    assert _same_bits(back.cpu(), torch.from_numpy(r))


def _sign2_step_on_one_rank(mesh, steps):
    from shared_tensor_tpu_torch.ops import codec_np
    from shared_tensor_tpu_torch.ops.table import flatten, make_spec
    from shared_tensor_tpu_torch.parallel import add_updates, init_state
    from shared_tensor_tpu_torch.parallel.ici_lab import build_sign2_sync_step

    rng = np.random.default_rng(15)
    shapes = {"w": (300, 70), "b": (9,)}
    tpl = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    spec = make_spec(tpl)
    state = init_state(mesh, spec, tpl)
    add_updates(state, flatten({k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}, spec)
                .to(mesh.device))
    step = build_sign2_sync_step(mesh, spec)
    v0 = state.values.cpu().numpy().copy()
    bad = 0
    for _ in range(steps):
        r0 = state.residual.cpu().numpy().copy()
        state, scales = step(state)
        _, want = codec_np.quantize2_table_np(r0, spec, scales.cpu().numpy())
        bad += int((state.residual.cpu().numpy().view(np.uint32) != want.view(np.uint32)).sum())
    bad += int((state.values.cpu().numpy().view(np.uint32) != v0.view(np.uint32)).sum())
    return bad, str(state.values.device)


@pytest.mark.cuda
def test_sign2_pod_step_on_one_cuda_rank(cuda_device):
    """The codec lab's 2-bit pod step on a 1-rank mesh on the card: each
    step's residual equals the engine's C sign2 quantize at the step's
    scales, bit for bit, and with no other peer the replica is untouched."""
    from shared_tensor_tpu_torch.parallel import run_mesh

    ((bad, dev),) = run_mesh(_sign2_step_on_one_rank, 1, 1, 3, device="cuda", backend="gloo", timeout_s=300)
    assert dev.startswith("cuda") and bad == 0


def _train_bench_arms_on_one_rank(mesh, steps):
    """The train bench's compressed and exact arms on this rank for
    ``steps`` steps each (benchmarks/train_bench's model, batch and rate at
    the flagship width): the launches of A and B in each arm's steps, then
    A and B against their plain versions on the compressed arm's trained
    state (B applying the gathered frame, this peer's own, to the
    replica)."""
    from shared_tensor_tpu_torch.benchmarks import train_bench as TB
    from shared_tensor_tpu_torch.config import ScalePolicy
    from shared_tensor_tpu_torch.parallel import ici
    from shared_tensor_tpu_torch.train import PodTrainer

    setup = TB.Setup(batch=4, seq=64)
    params, loss, batch = TB.model(mesh, setup)
    launches, bad = {}, 0
    for name in ("compressed", "exact"):
        tr = PodTrainer(mesh, params, loss, **dict(TB.ARMS)[name])
        b = tr.shard_batch(batch)
        CC.reset_launches()
        for _ in range(steps):
            tr.step(b, setup.lr)
        torch.cuda.synchronize()
        launches[name] = {k: CC.LAUNCHES[k] for k in TB.KERNELS}
        if name != "compressed":
            continue
        ctx = ici._make_ctx(mesh, tr.spec, True)
        r0 = tr.state.residual.clone()
        s_row = ici._leaf_scales(ctx, r0.view(-1, 128), ScalePolicy.POW2_RMS)[ctx.row_leaf].contiguous()
        r_k, r_p = r0.clone(), r0.clone()
        w_k = CC.quantize_rows_kernel(s_row, ctx.rowcount, r_k)
        w_p = CC.quantize_rows_plain(s_row, ctx.rowcount, r_p)
        words_all, scales_all = ici._codec_send(ctx, ScalePolicy.POW2_RMS, CC.quantize_rows_plain, r0.clone()).wait()
        s_all = scales_all[:, ctx.row_leaf].contiguous()
        v_k, v_p = tr.state.values.clone(), tr.state.values.clone()
        CC.apply_rows_batch_kernel(s_all, ctx.rowcount, words_all, (v_k,))
        CC.apply_rows_batch_plain(s_all, ctx.rowcount, words_all, (v_p,))
        torch.cuda.synchronize()
        bad = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                  for x, y in ((w_k, w_p), (r_k, r_p), (v_k, v_p)))
        bad += int(not bool((s_all != 0).any()))  # a frame of zero scales would check nothing
    return launches, bad


@pytest.mark.cuda
def test_train_bench_compressed_arm_launches_the_kernels(cuda_device):
    """The train bench's one-rank compressed arm on the card: A and B launch
    once a step (3 each in 3 steps) and equal their plain versions bit for
    bit on the trained state; the exact arm launches neither."""
    from shared_tensor_tpu_torch.parallel import run_mesh

    ((launches, bad),) = run_mesh(_train_bench_arms_on_one_rank, 1, 1, 3, device="cuda", backend="gloo",
                                  timeout_s=300)
    assert launches["compressed"] == {"quantize_rows": 3, "apply_rows_batch": 3}
    assert launches["exact"] == {"quantize_rows": 0, "apply_rows_batch": 0}
    assert bad == 0


@pytest.mark.cuda
def test_e2e_parent_on_the_card_launches_the_kernels(cuda_device):
    """benchmarks/e2e_sync with its parent on the card's device tier and a
    host-tier child process at N = 1 Mi for 2 s: frames flow both ways, A
    and B launch, and both equal their plain versions bit for bit on the
    parent's state."""
    from shared_tensor_tpu_torch.benchmarks import e2e_sync

    out = e2e_sync.run(n=1 << 20, seconds=2.0, warmup=1.0, device=cuda_device)
    assert out["on_gpu"] and out["parent_tier"] == "device"
    assert out["frames_out_per_s"] > 0 and out["frames_in_per_s"] > 0
    assert all(out["launches"].values()), out["launches"]
    assert {k: v["mismatches"] for k, v in out["kernel_check"].items()} == {"quantize_rows": 0,
                                                                            "apply_rows_batch": 0}


@pytest.mark.cuda
def test_chaos_soak_python_arm_on_the_card(cuda_device):
    """benchmarks/chaos_soak's python arm as four device-tier peers on the
    card for 3 s of chaos: every gate of the arm holds, A and B launch
    under the faults and equal their plain versions on the master's state."""
    from shared_tensor_tpu_torch.benchmarks import chaos_soak

    out = chaos_soak.run(n=512, seconds=3.0, seed=6, arms=("python",), device=cuda_device)
    r = out["arms"]["python"]
    assert r["tier"] == "device:cuda"
    assert all(r["launches"].values()), r["launches"]
    assert all(v["mismatches"] == 0 for v in r["kernel_check"].values())
    assert r["wedged_threads"] == [] and r["obs"]["accounted"]
    assert out["pass"], r
