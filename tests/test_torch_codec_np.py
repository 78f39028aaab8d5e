"""The port's host codec (shared_tensor_tpu_torch.ops.codec_np): its build of
native/stcodec.c against the JAX package's (shared_tensor_tpu.ops.codec_np
on its native library), and against its own plain numpy versions.

Both bindings call the same C source, so scales, words, residuals and
replicas are equal bit for bit. The plain numpy versions are the JAX
package's numpy loops: they equal the JAX package's numpy tier bit for bit
(run with its library switched off), and the C loops given the same scales;
their own scales are within one octave of the C loops' (POW2_RMS, an exact
octave boundary) or within 1e-6 relative (RMS, ABS_MEAN).

Inputs, made from a seed with numpy: leaves with partial padding rows, an
all-zero leaf, a leaf of subnormals, magnitudes from 1e-3 to 800, the
padding lanes zero (the table invariant) or, for the apply's and
accumulate's passthrough, garbage in an update's padding."""

import ctypes

import numpy as np
import pytest
import torch

from shared_tensor_tpu.config import ScalePolicy as JScalePolicy
from shared_tensor_tpu.ops import codec_np as J
from shared_tensor_tpu.ops.table import make_spec as jax_make_spec
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec_np as P
from shared_tensor_tpu_torch.ops.table import make_spec

POLICIES = (ScalePolicy.POW2_RMS, ScalePolicy.RMS, ScalePolicy.ABS_MEAN)


def _jpolicy(p):
    return JScalePolicy(p.value)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.uniform(-1.0, 1.0, (30, 50)).astype(np.float32),
        "b": (rng.standard_normal(257) * 800).astype(np.float32),
        "c": np.zeros((4, 9), np.float32),  # an all-zero leaf: scale 0, idle
        "d": (rng.uniform(-1, 1, 100) * 1e-39).astype(np.float32),  # subnormals
        "e": rng.uniform(-1e-3, 1e-3, 1030).astype(np.float32),  # one partial row past a tile
    }


@pytest.fixture(scope="module")
def table():
    tree = _tree(0)
    spec, jspec = make_spec(tree), jax_make_spec(tree)
    assert J._native() is not None, "the JAX package's libstcodec did not load"
    flat = P.flatten_np(tree, spec)
    np.testing.assert_array_equal(flat, J.flatten_np(tree, jspec))
    assert np.count_nonzero(np.abs(flat[(flat != 0) & (np.abs(flat) < 1.2e-38)])) > 0  # subnormals present
    return tree, spec, jspec, flat


@pytest.fixture()
def jax_numpy_tier(monkeypatch):
    """The JAX package's codec_np on its numpy loops (library off)."""
    monkeypatch.setattr(J, "_LIB", None)
    monkeypatch.setattr(J, "_LIB_TRIED", True)


def _frames(flat, spec, k):
    r, out = flat.copy(), []
    for _ in range(k):
        s, w, r = P.quantize_table_np(r, spec)
        out.append((s, w))
    return np.stack([s for s, _ in out]), np.stack([w for _, w in out])


@pytest.mark.parametrize("per_leaf", [True, False], ids=["per_leaf", "global"])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.value)
def test_quantize_matches_jax_bit_for_bit(table, policy, per_leaf):
    _, spec, jspec, flat = table
    r = flat
    for _ in range(4):  # a few halvings: the residual's later states too
        mine = P.quantize_table_np(r, spec, policy, per_leaf)
        theirs = J.quantize_table_np(r, jspec, _jpolicy(policy), per_leaf)
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        r = mine[2]


@pytest.mark.parametrize("per_leaf", [True, False], ids=["per_leaf", "global"])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.value)
def test_quantize_matches_plain(table, policy, per_leaf):
    """The C loop against the plain numpy version: scales within the
    documented allowance; words and residual bit for bit at the C loop's
    scales; the all-zero leaf idle, padding lanes zero."""
    _, spec, _, flat = table
    s, w, r = P.quantize_table_np(flat, spec, policy, per_leaf)
    s_plain = P.compute_scales_plain(flat, spec, policy, per_leaf)
    if policy == ScalePolicy.POW2_RMS:
        ratio = np.where(s > 0, s_plain / np.where(s > 0, s, 1), 1)
        assert set(np.unique(ratio)) <= {0.5, 1.0, 2.0}, (s, s_plain)
    else:
        np.testing.assert_allclose(s_plain, s, rtol=1e-6)
    np.testing.assert_array_equal(s == 0, s_plain == 0)
    _, w_plain, r_plain = P.quantize_table_plain(flat, spec, policy, per_leaf, scales=s)
    np.testing.assert_array_equal(w, w_plain)
    np.testing.assert_array_equal(r, r_plain)
    live = P._live_mask(spec)
    assert not r[~live].any()
    if per_leaf:
        assert s[2] == 0  # leaf "c"


@pytest.mark.parametrize("per_leaf", [True, False], ids=["per_leaf", "global"])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.value)
def test_plain_matches_jax_numpy_tier(table, policy, per_leaf, jax_numpy_tier):
    _, spec, jspec, flat = table
    mine = P.quantize_table_plain(flat, spec, policy, per_leaf)
    theirs = J.quantize_table_np(flat, jspec, _jpolicy(policy), per_leaf)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_targets", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_apply_batch_matches_jax_and_plain(table, k, n_targets):
    tree, spec, jspec, flat = table
    scales, words = _frames(flat, spec, k)
    targets = tuple(P.flatten_np(_tree(10 + i), spec) for i in range(n_targets))
    mine = P.apply_table_batch_np(targets, scales, words, spec)
    theirs = J.apply_table_batch_np(targets, scales, words, jspec)
    plain = P.apply_table_batch_plain(targets, scales, words, spec)
    for a, b, c in zip(mine, theirs, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # in place, and through int32 words (the port's device bit patterns)
    inplace = [t.copy() for t in targets]
    P.apply_table_batch_np(inplace, scales, words.view(np.int32), spec, inplace=True)
    for a, b in zip(inplace, mine):
        np.testing.assert_array_equal(a, b)
    if k == 1:
        many = P.apply_table_many_np(targets, scales[0], words[0], spec)
        for a, b in zip(many, mine):
            np.testing.assert_array_equal(a, b)


def test_apply_plain_matches_jax_numpy_tier(table, jax_numpy_tier):
    _, spec, jspec, flat = table
    scales, words = _frames(flat, spec, 3)
    scales[1, :] = 0  # a zero-scale frame in the middle contributes nothing
    targets = tuple(P.flatten_np(_tree(20 + i), spec) for i in range(2))
    for a, b in zip(P.apply_table_batch_plain(targets, scales, words, spec),
                    J.apply_table_batch_np(targets, scales, words, jspec)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("update", ["random", "nonfinite", "padding_garbage"])
def test_accumulate_matches_jax_and_plain(table, update):
    _, spec, jspec, flat = table
    rng = np.random.default_rng(5)
    u = P.flatten_np(_tree(30), spec)
    live = P._live_mask(spec)
    if update == "nonfinite":
        u[:7] = [np.nan, np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, 1.0]
    elif update == "padding_garbage":
        u[~live] = rng.uniform(-5, 5, int((~live).sum())).astype(np.float32)
    targets = (flat.copy(), P.flatten_np(_tree(31), spec))
    mine = P.accumulate_table_np(targets, u, spec)
    theirs = J.accumulate_table_np(targets, u, jspec)
    plain = P.accumulate_table_plain(targets, u, spec)
    for a, b, c in zip(mine, theirs, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert np.isfinite(a).all() and not a[~live].any()
    inplace = [t.copy() for t in targets]
    P.accumulate_table_np(inplace, torch.from_numpy(u), spec, inplace=True)
    for a, b in zip(inplace, mine):
        np.testing.assert_array_equal(a, b)


def test_accumulate_plain_matches_jax_numpy_tier(table, jax_numpy_tier):
    _, spec, jspec, flat = table
    u = P.flatten_np(_tree(40), spec)
    u[3] = np.nan
    for a, b in zip(P.accumulate_table_plain((flat,), u, spec), J.accumulate_table_np((flat,), u, jspec)):
        np.testing.assert_array_equal(a, b)


def test_flatten_and_unflatten_match_jax(table):
    tree, spec, jspec, flat = table
    torch_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    np.testing.assert_array_equal(P.flatten_np(torch_tree, spec), flat)
    mine, theirs = P.unflatten_np(flat, spec), J.unflatten_np(flat, jspec)
    for k in tree:
        np.testing.assert_array_equal(mine[k], theirs[k])
        assert not np.shares_memory(mine[k], flat)
    with pytest.raises(ValueError):
        P.flatten_np({"a": tree["a"]}, spec)


def test_misaligned_or_readonly_arrays_fail_loudly(table):
    _, spec, _, flat = table
    scales = np.ones((1, spec.num_leaves), np.float32)
    words = np.zeros((1, spec.total // 32), np.uint32)
    raw = np.zeros(flat.nbytes + 4, np.uint8)
    misaligned = np.frombuffer(raw.data, np.float32, count=flat.size, offset=2)  # a 2-byte offset
    for inplace in (True, False):
        with pytest.raises(ctypes.ArgumentError, match="ALIGNED"):
            P.apply_table_batch_np((misaligned,), scales, words, spec, inplace=inplace)
    readonly = flat.copy()
    readonly.setflags(write=False)
    with pytest.raises(ValueError, match="writable"):
        P.apply_table_batch_np((readonly,), scales, words, spec, inplace=True)
    with pytest.raises(TypeError):
        P.apply_table_many_np((flat,), np.ones(spec.num_leaves, np.float32), np.zeros(spec.total // 32), spec)


def test_layout_is_cached_by_value(table):
    _, spec, _, _ = table
    again = make_spec(_tree(99))
    assert again == spec and P._layout(again) is P._layout(spec)
    offs, ns, padded = P._layout(spec)
    np.testing.assert_array_equal(offs, np.concatenate([[0], np.cumsum(spec.padded)[:-1]]))
    assert tuple(ns) == spec.ns and tuple(padded) == spec.padded
