"""Port parity: the char-RNN (shared_tensor_tpu_torch.models.char_rnn) vs
shared_tensor_tpu.models.char_rnn on the same parameters and tokens; and
every case of tests/test_char_rnn.py on the port.

Tolerances, measured on the CPU with JAX's own initial parameters (2 layers,
hidden 32): logits within 1e-7 (measured 7.5e-9: both round the matmul
operands to bf16 and sum the exact products in f32, in another order);
the loss within a relative 1e-6 (measured equal); each leaf's grad within
2e-5 of the leaf's largest |grad| (measured 7.2e-6, on the recurrent
weights, whose per-step cotangents both round to bf16, from f32 sums taken
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_tensor_tpu.models import char_rnn as jm
from shared_tensor_tpu_torch.convert import table_from_numpy
from shared_tensor_tpu_torch.models import char_rnn as m
from shared_tensor_tpu_torch.ops.table import tree_flatten, tree_unflatten

TINY = m.CharRNNConfig(vocab=64, embed=16, hidden=32, layers=2)
J_TINY = jm.CharRNNConfig(vocab=64, embed=16, hidden=32, layers=2)


def _params(seed=0):
    return m.init_params(torch.Generator().manual_seed(seed), TINY, device="cpu")


@pytest.fixture(scope="module")
def carried():
    """JAX's initial parameters, carried into the port, and a batch whose
    inputs hold out-of-vocabulary ids (clamped by both)."""
    pj = jm.init_params(jax.random.key(0), J_TINY)
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 70, (3, 12)).astype(np.int32)
    y = rng.integers(0, 64, (3, 12)).astype(np.int32)
    return pj, table_from_numpy(jax.tree.map(np.asarray, pj)), x, y


def test_forward_matches_jax(carried):
    pj, pt, x, _ = carried
    want = np.asarray(jm.forward(pj, jnp.asarray(x), J_TINY))
    got = m.forward(pt, torch.from_numpy(x), TINY).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_loss_matches_jax(carried):
    pj, pt, x, y = carried
    want = float(jm.loss_fn(pj, (jnp.asarray(x), jnp.asarray(y)), J_TINY))
    got = float(m.loss_fn(pt, (torch.from_numpy(x), torch.from_numpy(y)), TINY))
    assert got == pytest.approx(want, rel=1e-6)


def test_grads_match_jax(carried):
    pj, pt, x, y = carried
    gj = jax.grad(lambda p: jm.loss_fn(p, (jnp.asarray(x), jnp.asarray(y)), J_TINY))(pj)
    leaves = [t.clone().requires_grad_(True) for t in tree_flatten(pt)[0]]
    params = tree_unflatten(tree_flatten(pt)[1], leaves)
    m.loss_fn(params, (torch.from_numpy(x), torch.from_numpy(y)), TINY).backward()
    for want, leaf in zip(jax.tree.leaves(gj), leaves):
        want = np.asarray(want)
        np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_out_of_vocab_ids_clamp(carried):
    _, pt, _, _ = carried
    lo = m.forward(pt, torch.tensor([[-5, 100]]), TINY)
    ends = m.forward(pt, torch.tensor([[0, 63]]), TINY)
    torch.testing.assert_close(lo, ends, rtol=0, atol=0)


def test_init_params_needs_a_device_or_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_params(torch.Generator().manual_seed(0), TINY)


# -- tests/test_char_rnn.py on the port ---------------------------------------------------


def test_forward_shape_and_finite():
    params = _params()
    tokens = torch.randint(0, TINY.vocab, (3, 7), generator=torch.Generator().manual_seed(1))
    logits = m.forward(params, tokens, TINY)
    assert logits.shape == (3, 7, TINY.vocab)
    assert bool(torch.isfinite(logits).all())


def test_param_count_matches_pytree():
    assert sum(x.numel() for x in tree_flatten(_params())[0]) == TINY.param_count
    assert m.CharRNNConfig().param_count == 3_870_976


def test_initial_loss_near_uniform():
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, TINY.vocab, (4, 16), generator=gen)
    y = torch.randint(0, TINY.vocab, (4, 16), generator=gen)
    loss = m.loss_fn(_params(), (x, y), TINY)
    assert abs(float(loss) - np.log(TINY.vocab)) < 0.5


def test_sgd_learns_repeating_pattern():
    params = _params()
    text = bytes(range(8)) * 200
    x, y = m.make_batches(text, batch=8, seq=16, generator=torch.Generator().manual_seed(3), device="cpu")
    leaves, treedef = tree_flatten(params)
    leaves = [l.requires_grad_(True) for l in leaves]
    with torch.no_grad():
        loss0 = float(m.loss_fn(tree_unflatten(treedef, leaves), (x, y), TINY))
    for _ in range(100):
        grads = torch.autograd.grad(m.loss_fn(tree_unflatten(treedef, leaves), (x, y), TINY), leaves)
        with torch.no_grad():
            for l, g in zip(leaves, grads):
                l -= 0.5 * g
    with torch.no_grad():
        loss1 = float(m.loss_fn(tree_unflatten(treedef, leaves), (x, y), TINY))
    assert loss1 < loss0 * 0.5, (loss0, loss1)


def test_sample_shape_dtype_and_range():
    out = m.sample(_params(), torch.Generator().manual_seed(1), torch.tensor([1, 2, 3]), TINY, length=11)
    assert out.shape == (11,)
    assert out.dtype in (torch.int32, torch.int64)
    assert bool(((out >= 0) & (out < TINY.vocab)).all())


def test_make_batches_targets_shifted():
    text = bytes(range(256)) * 4
    x, y = m.make_batches(text, batch=4, seq=8, generator=torch.Generator().manual_seed(0), device="cpu")
    assert x.shape == (4, 8) and y.shape == (4, 8)
    assert bool(((y - x) % 256 == 1).all())


def test_make_batches_peer_axis():
    text = b"hello world " * 100
    x, y = m.make_batches(text, batch=2, seq=4, generator=torch.Generator().manual_seed(0), n_peer=3, device="cpu")
    assert x.shape == (3, 2, 4) and y.shape == (3, 2, 4)
