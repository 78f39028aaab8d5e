"""Port parity: ResNet (shared_tensor_tpu_torch.models.resnet) vs
shared_tensor_tpu.models.resnet; and every case of tests/test_resnet.py on
the port (the 8-peer async-DP cases on a mesh of 8 gloo ranks).

Tolerances: one conv in f32 against XLA's ``"SAME"`` conv to f32 rounding
and the max pool bit-exact at every padding case, which pins XLA's split
(stride 2 on an even input pads (0, 1), the 7x7 stride-2 stem (2, 3)); one
conv as the model runs it (bf16 operands, f32 sum, bf16 result) within one
bf16 ulp of JAX's and equal on all but 0.1% of the elements (measured: 1 of
8192 at 7x7, where f32 sums in another order round to the other bf16
neighbour); the whole forward within 0.02 of logits of size ~2, measured 0.0045 on the
CPU: both sides round every conv's input and output to bf16, so an f32
difference upstream (batch-norm sums taken in another order) moves a value
across a bf16 rounding boundary now and then, 2^-8 relative, and that
propagates; the loss within a relative 1e-3 (measured 2.8e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_tensor_tpu.models import resnet as jr
from shared_tensor_tpu_torch.convert import table_from_numpy
from shared_tensor_tpu_torch.models import resnet as r
from tests import test_torch_pod_jobs as P

TINY = r.ResNetConfig(stages=(1, 1), width=8, classes=4)


def _params(cfg=TINY):
    return r.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def _data(seed=1, n=8, hw=8):
    x, y = P.resnet_data(seed, n, hw, TINY.classes, 1)
    return torch.from_numpy(x[0]), torch.from_numpy(y[0])


@pytest.fixture(scope="module")
def port():
    jobs = [(f"dp-{c}", "resnet_train", 8, 1, dict(cfg_kw=dict(stages=(1, 1), width=8, classes=4), steps=12,
                                                    lr=0.05, compressed=c)) for c in (True, False)]
    return P.run_on_mesh(jobs)


# -- parity ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw,k,stride", [(8, 3, 1), (8, 3, 2), (9, 3, 2), (32, 7, 2), (8, 1, 2)])
def test_conv_matches_jax(hw, k, stride):
    """In f32 the padded conv equals XLA's "SAME" conv to f32 rounding (a
    wrong split of the padding would move whole border rows); with JAX's
    bf16 rounding the results agree within one bf16 ulp, on all but a few
    elements exactly (an f32 sum in another order lands on the other side
    of a bf16 rounding boundary now and then)."""
    rng = np.random.default_rng(hw + k + stride)
    x = rng.normal(size=(2, hw, hw, 8)).astype(np.float32)
    w = rng.normal(size=(k, k, 8, 16)).astype(np.float32)
    xt, wt = torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1)
    f32 = torch.nn.functional.conv2d(r._pad_same(xt, k, stride), wt, stride=stride).permute(0, 2, 3, 1)
    want32 = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                          dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                          precision=jax.lax.Precision.HIGHEST)
    assert f32.shape == want32.shape
    np.testing.assert_allclose(f32.numpy(), np.asarray(want32), rtol=1e-5, atol=1e-4)
    want = np.asarray(jr._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = r._conv(xt, torch.from_numpy(w), stride).permute(0, 2, 3, 1).numpy()
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0**-7)
    assert np.mean(got != want) < 0.001


@pytest.mark.parametrize("hw", [16, 15])
def test_max_pool_matches_jax(hw):
    x = np.random.default_rng(hw).normal(size=(2, hw, hw, 4)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.max_pool2d(r._pad_same(t, 3, 2, value=-np.inf), 3, 2).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_same_padding_splits_like_xla():
    assert r.same_padding(32, 3, 2) == (0, 1)
    assert r.same_padding(32, 7, 2) == (2, 3)
    assert r.same_padding(32, 3, 1) == (1, 1)
    assert r.same_padding(32, 1, 2) == (0, 0)
    assert r.same_padding(33, 3, 2) == (1, 1)


def test_forward_and_loss_match_jax():
    """An even input with a stride-2 block, on JAX's own parameters (the
    residual branches switched on)."""
    cfg_j = jr.ResNetConfig(stages=(1, 1), width=8, classes=4)
    pj = jr.init_params(jax.random.key(0), cfg_j)
    rng = np.random.default_rng(1)
    for b in pj["blocks"]:
        b["scale2"] = jnp.asarray(rng.normal(size=b["scale2"].shape).astype(np.float32))
    pt = table_from_numpy(jax.tree.map(np.asarray, pj))
    x = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 6).astype(np.int32)
    want = np.asarray(jr.forward(pj, jnp.asarray(x), cfg_j))
    got = r.forward(pt, torch.from_numpy(x), TINY).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
    lj = float(jr.loss_fn(pj, (jnp.asarray(x), jnp.asarray(y)), cfg_j))
    lt = float(r.loss_fn(pt, (torch.from_numpy(x), torch.from_numpy(y)), TINY))
    assert lt == pytest.approx(lj, rel=1e-3)


# -- tests/test_resnet.py on the port --------------------------------------------------------


def test_forward_shape_and_finite():
    x, _ = _data()
    logits = r.forward(_params(), x, TINY)
    assert logits.shape == (8, TINY.classes)
    assert bool(torch.isfinite(logits).all())


def test_blocks_start_as_identity():
    params = _params()
    x, _ = _data()
    before = r.forward(params, x, TINY)
    params["blocks"][0]["conv2"] = params["blocks"][0]["conv2"] + 1.0
    after = r.forward(params, x, TINY)
    assert torch.allclose(before, after)


def test_imagenet_stem_downsamples():
    cfg = r.ResNetConfig(stages=(1,), width=8, classes=4, stem_kernel=7, stem_stride=2, stem_pool=True)
    logits = r.forward(_params(cfg), torch.zeros(2, 32, 32, 3), cfg)
    assert logits.shape == (2, 4)


@pytest.mark.parametrize("compressed", [True, False])
def test_async_dp_trains(port, compressed):
    """8-peer async-DP SGD (the config-4 shape): loss decreases under both
    the compressed-delta and the exact arm."""
    losses = P.result(port, f"dp-{compressed}")["losses"]
    assert losses[-1] < losses[0], losses
