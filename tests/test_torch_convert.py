"""State carry-over: a JAX SharedTensor's snapshot continues in the port.

A JAX SharedTensor (device tier, XLA golden) runs a few frames; its
``snapshot_all()`` moves into a port SharedTensor through
``convert.shared_tensor_from_numpy``; both continue on the same link and
must send bit-equal frames and keep bit-equal state."""

import numpy as np
import pytest
import torch

from shared_tensor_tpu_torch import convert
from shared_tensor_tpu_torch.ops.table import make_spec, tree_flatten


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "layer": [rng.uniform(-1, 1, (9, 40)).astype(np.float32), rng.uniform(-3, 3, (5,)).astype(np.float32)],
        "emb": (rng.uniform(-1, 1, (300,)) * 0.01).astype(np.float32),
    }


def test_table_from_numpy_layout():
    tree = _tree(0)
    got = convert.table_from_numpy(tree)
    leaves, _ = tree_flatten(got)
    assert all(isinstance(l, torch.Tensor) and l.dtype == torch.float32 for l in leaves)
    np.testing.assert_array_equal(got["layer"][0].numpy(), tree["layer"][0])
    got["emb"].add_(1.0)
    assert tree["emb"].max() < 0.1  # a copy, not a view


def test_jax_state_carries_into_port(monkeypatch):
    monkeypatch.setenv("ST_HOST_CODEC", "xla")
    from shared_tensor_tpu.core import SharedTensor as JaxSharedTensor

    tree = _tree(1)
    jst = JaxSharedTensor(tree, seed_values=True)
    jst.new_link(4, seed=True)
    jst.new_link(5, seed=False)
    for _ in range(3):
        jst.make_frame(4)
    jst.add(_tree(2))
    values, links = jst.snapshot_all()
    pst = convert.shared_tensor_from_numpy(
        tree, np.asarray(values), {k: np.asarray(v) for k, v in links.items()}, device="cpu"
    )
    assert pst.link_ids == (4, 5)
    for _ in range(4):
        for link in (4, 5):
            jf, pf = jst.make_frame(link), pst.make_frame(link)
            np.testing.assert_array_equal(pf.scales, np.asarray(jf.scales))
            np.testing.assert_array_equal(pf.words, np.asarray(jf.words))
            jst.receive_frame(9, jf)
            pst.receive_frame(9, pf)
    jv, jl = jst.snapshot_all()
    pv, pl = pst.snapshot_all()
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    for k in jl:
        np.testing.assert_array_equal(pl[k].numpy(), np.asarray(jl[k]))


def test_layout_disagreement_raises():
    tree = _tree(3)
    spec = make_spec(tree)
    good = np.zeros(spec.total, np.float32)
    with pytest.raises(ValueError):
        convert.shared_tensor_from_numpy(tree, np.zeros(spec.total - 1024, np.float32), {}, device="cpu")
    bad = good.copy()
    bad[spec.ns[0]] = 1.0  # a padding lane of the first leaf
    with pytest.raises(ValueError):
        convert.shared_tensor_from_numpy(tree, bad, {}, device="cpu")
    with pytest.raises(ValueError):
        convert.shared_tensor_from_numpy(tree, good, {1: bad}, device="cpu")
    with pytest.raises(ValueError):
        convert.shared_tensor_from_numpy(tree, good.astype(np.float64), {}, device="cpu")
