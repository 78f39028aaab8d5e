"""The port's CUDA kernels on a GPU (marked ``cuda``; each test skips
without a CUDA device). This file imports neither jax nor the JAX package,
so it runs on a torch-only machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: bit-exact against the plain PyTorch versions on the same inputs."""

import numpy as np
import pytest
import torch

from shared_tensor_tpu_torch.core import SharedTensor
from shared_tensor_tpu_torch.ops import codec_cuda as CC


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


@pytest.mark.cuda
@pytest.mark.parametrize("k,n_arr", [(1, 1), (2, 3), (8, 1)])
def test_apply_rows_batch_kernel_matches_plain(cuda_device, k, n_arr):
    rows = 4099
    rng = np.random.default_rng(k)
    _, rowcount, _ = _rows_case(6, rows)
    s = (2.0 ** rng.integers(-6, 2, (k, rows))).astype(np.float32)
    s[rng.random((k, rows)) < 0.2] = 0.0
    s[0] *= np.float32(1.37)
    words = rng.integers(0, 2**32, (k, rows * 4), dtype=np.uint64).astype(np.uint32)
    dev = cuda_device
    s_d = torch.from_numpy(s).to(dev)
    c_d = torch.from_numpy(rowcount).to(dev)
    w_d = torch.from_numpy(words.view(np.int32)).to(dev)
    base = [rng.normal(size=rows * 128).astype(np.float32) for _ in range(n_arr)]
    base[0][:4] = [3e38, -3e38, 1e-40, np.nan]
    ak = [torch.from_numpy(b).to(dev) for b in base]
    ap = [a.clone() for a in ak]
    CC.apply_rows_batch_kernel(s_d, c_d, w_d, ak)
    CC.apply_rows_batch_plain(s_d, c_d, w_d, ap)
    torch.cuda.synchronize()
    for x, y in zip(ak, ap):
        assert _same_bits(x, y)


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
