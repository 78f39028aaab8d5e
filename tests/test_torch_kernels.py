"""Port parity: the plain versions of kernels A and B
(shared_tensor_tpu_torch.ops.codec_cuda) vs the Pallas TPU kernels
codec_pallas.quantize_rows / apply_rows_batch, run by the Pallas
interpreter on the CPU, on the same numpy inputs; and the CUDA kernels vs
their plain versions on a GPU are in tests/test_torch_cuda.py.

Tolerance: bit-exact (words, residuals, arrays), K > 1 included: both sum
the K frame deltas in frame order from 0.0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shared_tensor_tpu.ops import codec_pallas
from shared_tensor_tpu_torch.ops import codec_cuda as CC


def _rows_case(seed, rows):
    """Per-row scales (powers of two and RMS-like, some 0), live counts with
    full, partial and empty rows, and garbage in the padding lanes."""
    rng = np.random.default_rng(seed)
    rowcount = rng.choice([0, 1, 31, 32, 33, 100, 127, 128, 128, 128], rows).astype(np.int32)
    resid = rng.normal(size=(rows, 128)).astype(np.float32)
    resid[rng.random((rows, 128)) < 0.05] = 0.0  # zeros count as negative
    s_row = (2.0 ** rng.integers(-8, 3, rows)).astype(np.float32)
    s_row[rng.random(rows) < 0.25] = 0.0
    s_row[: rows // 4] *= np.float32(1.37)  # not powers of two (RMS policy)
    return s_row, rowcount, resid.reshape(-1)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_plain_matches_pallas(seed):
    rows = 24
    s_row, rowcount, resid = _rows_case(seed, rows)
    jw, jr = codec_pallas.quantize_rows(jnp.asarray(s_row), jnp.asarray(rowcount), jnp.asarray(resid))
    r = torch.from_numpy(resid.copy())
    words = CC.quantize_rows(torch.from_numpy(s_row), torch.from_numpy(rowcount), r)
    assert words.dtype == torch.int32 and words.shape == (rows * 4,)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(_bits(r.numpy()), _bits(jr))


def _apply_case(seed, rows, k):
    rng = np.random.default_rng(seed)
    _, rowcount, _ = _rows_case(seed, rows)
    s = (2.0 ** rng.integers(-6, 2, (rows, k))).astype(np.float32)
    s[rng.random((rows, k)) < 0.2] = 0.0
    s[:, 0] *= np.float32(1.37)
    words2d = rng.integers(0, 2**32, (rows, 4 * k), dtype=np.uint64).astype(np.uint32)
    return s, rowcount, words2d


@pytest.mark.parametrize("k,n_arr", [(1, 1), (3, 3), (8, 2)])
def test_apply_rows_batch_plain_matches_pallas(k, n_arr):
    rows = 16
    s, rowcount, words2d = _apply_case(10 + k, rows, k)
    rng = np.random.default_rng(k)
    arrays = [rng.normal(size=rows * 128).astype(np.float32) for _ in range(n_arr)]
    arrays[0][:7] = [3e38, -3e38, 1e-40, -0.0, 0.0, 2.9e38, np.float32(1e-45)]
    want = codec_pallas.apply_rows_batch(
        jnp.asarray(s), jnp.asarray(rowcount), jnp.asarray(words2d),
        tuple(jnp.asarray(a) for a in arrays),
    )
    # the port takes its frames frame-major: s [K, rows], words [K, rows*4]
    s_t = torch.from_numpy(np.ascontiguousarray(s.T))
    w_t = words2d.reshape(rows, k, 4).transpose(1, 0, 2).reshape(k, rows * 4)
    w_t = torch.from_numpy(np.ascontiguousarray(w_t).view(np.int32))
    got = [torch.from_numpy(a.copy()) for a in arrays]
    out = CC.apply_rows_batch(s_t, torch.from_numpy(rowcount), w_t, got)
    assert all(o is g for o, g in zip(out, got))  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_wrappers_reject_bad_arguments():
    rows = 8
    s_row, rowcount, resid = _rows_case(3, rows)
    s_t, c_t, r_t = torch.from_numpy(s_row), torch.from_numpy(rowcount), torch.from_numpy(resid)
    with pytest.raises(TypeError):
        CC.quantize_rows(s_t.double(), c_t, r_t)
    with pytest.raises(ValueError):
        CC.quantize_rows(s_t[:-1], c_t, r_t)
    with pytest.raises(ValueError):
        CC.quantize_rows_kernel(s_t, c_t, r_t)  # CPU tensor: the kernel raises
    w = torch.zeros(1, rows * 4, dtype=torch.int32)
    a = torch.zeros(rows * 128)
    with pytest.raises(ValueError):  # aliased targets would get the delta twice
        CC.apply_rows_batch(s_t[None], c_t, w, (a, a))
    with pytest.raises(ValueError):
        CC.apply_rows_batch(s_t[None], c_t, w, (a, a[0:]))
    with pytest.raises(ValueError):
        CC.apply_rows_batch_kernel(s_t[None], c_t, w, (a,))


def test_plain_calls_do_not_count_as_launches():
    CC.reset_launches()
    rows = 8
    s_row, rowcount, resid = _rows_case(4, rows)
    CC.quantize_rows(torch.from_numpy(s_row), torch.from_numpy(rowcount), torch.from_numpy(resid))
    assert CC.LAUNCHES == {"quantize_rows": 0, "apply_rows_batch": 0}
