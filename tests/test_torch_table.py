"""Port parity: the table codec (shared_tensor_tpu_torch.ops.table, plain
path on the CPU) vs shared_tensor_tpu.ops.table's XLA golden.

Tolerances: layout, words, residuals and replicas bit-exact given equal
scales; POW2_RMS scales equal or one octave apart; RMS / ABS_MEAN scales to
a relative 1e-6; K-frame batch sums to 1e-6 against the XLA sum (whose
order is XLA's own)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import codec_np as JNP
from shared_tensor_tpu.ops import table as JT
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import table as TT


def _nested(seed):
    """Nested dict/list tree with keys out of sorted order and partial rows."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "zeta": f(7, 9),
        "alpha": [f(130), {"y": f(3, 3), "b": f(1)}, (f(2, 200),)],
        "mid": {"k2": f(1030), "k1": np.float32(0.5)},
        "none": None,
    }


def _mixed(seed, mags=(1.0, 1000.0, 0.001)):
    rng = np.random.default_rng(seed)
    shapes = [(40, 70), (256,), (3, 5, 7)]
    return {f"leaf{i}": (rng.normal(size=s) * m).astype(np.float32) for i, (s, m) in enumerate(zip(shapes, mags))}


def test_layout_matches_jax():
    tree = _nested(0)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    assert str(ts.treedef) == str(js.treedef)
    assert (ts.shapes, ts.ns, ts.padded) == (js.shapes, js.ns, js.padded)
    assert ts.layout_digest() == js.layout_digest()
    np.testing.assert_array_equal(ts.row_leaf(), js.row_leaf())
    np.testing.assert_array_equal(ts.live_rowcount(), js.live_rowcount())
    flat = TT.flatten(tree, ts)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(JT.flatten(tree, js)))
    back = TT.unflatten(flat, ts)
    for a, b in zip(jax.tree.leaves(back, is_leaf=lambda x: isinstance(x, torch.Tensor)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b).reshape(np.shape(a)))
    assert TT.tree_unflatten(ts.treedef, TT.tree_flatten(tree)[0]).keys() == tree.keys()


@pytest.mark.parametrize(
    "tree", [np.zeros(3), (np.zeros(2),), [], {"a": [np.zeros(1), (np.zeros(1),), ()]}, {"x": None}],
)
def test_treedef_str_matches_jax(tree):
    assert str(TT.tree_flatten(tree)[1]) == str(jax.tree.structure(tree))


def _model_trees(model):
    """(JAX parameter shapes, port parameters) of a model's default size."""
    gen = torch.Generator().manual_seed(0)
    if model == "char_rnn":
        from shared_tensor_tpu.models import char_rnn as jm
        from shared_tensor_tpu_torch.models import char_rnn as tm

        return (jax.eval_shape(lambda: jm.init_params(jax.random.key(0), jm.CharRNNConfig())),
                tm.init_params(gen, tm.CharRNNConfig(), device="cpu"))
    from shared_tensor_tpu.models import resnet as jr
    from shared_tensor_tpu_torch.models import resnet as tr

    return (jax.eval_shape(lambda: jr.init_params(jax.random.key(0), jr.ResNetConfig())),
            tr.init_params(gen, tr.ResNetConfig(), device="cpu"))


@pytest.mark.parametrize("model", ["char_rnn", "resnet18"])
def test_model_layouts_match_jax(model):
    """The char-RNN and ResNet-18 trees (lists of dicts inside a dict): the
    same TreeDef string and layout digest as JAX's, so port and JAX peers
    can share one table."""
    j_tree, t_tree = _model_trees(model)
    js, ts = JT.make_spec(j_tree), TT.make_spec(t_tree)
    assert str(ts.treedef) == str(js.treedef)
    assert (ts.shapes, ts.ns, ts.padded) == (js.shapes, js.ns, js.padded)
    assert ts.layout_digest() == js.layout_digest()


def test_flatten_rejects_mismatch():
    tree = _mixed(0)
    spec = TT.make_spec(tree)
    bad = dict(tree, leaf0=np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        TT.flatten(bad, spec)
    with pytest.raises(ValueError):
        TT.flatten({"leaf0": tree["leaf0"]}, spec)


def _scales_ok(got, want, policy):
    got, want = np.asarray(got), np.asarray(want)
    if policy == ScalePolicy.POW2_RMS:
        ratio = np.where(want != 0, got / np.where(want != 0, want, 1), 1.0)
        assert np.all((got == want) | np.isin(ratio, (0.5, 2.0))), (got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("per_leaf", [True, False])
@pytest.mark.parametrize("policy", list(ScalePolicy))
def test_quantize_table_matches_jax(per_leaf, policy):
    tree = _mixed(1)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    r = np.asarray(JT.flatten(tree, js))
    jf, jr = JT.quantize_table(jnp.asarray(r), js, JPolicy(policy.value), per_leaf, impl="xla")
    tr = torch.from_numpy(r.copy())
    tf, tr2 = TT.quantize_table(tr, ts, policy, per_leaf)
    assert tr2 is tr  # in place
    _scales_ok(tf.scales.numpy(), jf.scales, policy)
    np.testing.assert_array_equal(tf.words.numpy().view(np.uint32), np.asarray(jf.words))
    if np.array_equal(tf.scales.numpy(), np.asarray(jf.scales)):
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    if not per_leaf:
        assert len(set(tf.scales.tolist())) == 1


def test_quantize_table_idle_leaf():
    tree = {"a": np.ones((100,), np.float32), "b": np.zeros((2000,), np.float32)}
    ts = TT.make_spec(tree)
    r = TT.flatten(tree, ts)
    f, r = TT.quantize_table(r, ts)
    assert float(f.scales[1]) == 0.0 and float(f.scales[0]) == 1.0
    assert float(r.abs().max()) == 0.0


def test_burst_equals_sequential():
    tree = _mixed(2)
    ts = TT.make_spec(tree)
    r1 = TT.flatten(tree, ts)
    r2 = r1.clone()
    stacked, r1 = TT.quantize_table_burst(r1, ts, 6)
    assert stacked.scales.shape == (6, 3) and stacked.words.shape == (6, ts.total // 32)
    for i in range(6):
        f, r2 = TT.quantize_table(r2, ts)
        np.testing.assert_array_equal(stacked.scales[i].numpy(), f.scales.numpy())
        np.testing.assert_array_equal(stacked.words[i].numpy(), f.words.numpy())
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())


def _jax_frames(tree, js, k):
    r = JT.flatten(tree, js)
    scales, words = [], []
    for _ in range(k):
        f, r = JT.quantize_table(r, js, impl="xla")
        scales.append(np.asarray(f.scales))
        words.append(np.asarray(f.words))
    return np.stack(scales), np.stack(words)


def test_apply_table_many_matches_jax():
    tree = _mixed(3)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    scales, words = _jax_frames(tree, js, 1)
    arrays = [np.asarray(JT.flatten(_mixed(10 + i), js)) for i in range(3)]
    wants = JT.apply_table_many(tuple(jnp.asarray(a) for a in arrays), JT.TableFrame(jnp.asarray(scales[0]), jnp.asarray(words[0])), js, impl="xla")
    frame = TT.TableFrame(torch.from_numpy(scales[0]), torch.from_numpy(words[0].view(np.int32)))
    gots = TT.apply_table_many([torch.from_numpy(a.copy()) for a in arrays], frame, ts)
    for g, w in zip(gots, wants):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [2, 5])
def test_apply_table_batch_matches_jax(k):
    tree = _mixed(4)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    scales, words = _jax_frames(tree, js, k)
    arrays = [np.asarray(JT.flatten(_mixed(20 + i), js)) for i in range(2)]
    wants = JT.apply_table_batch(tuple(jnp.asarray(a) for a in arrays), JT.TableFrame(jnp.asarray(scales), jnp.asarray(words)), js, impl="xla")
    frames = TT.TableFrame(torch.from_numpy(scales), torch.from_numpy(words.view(np.int32)))
    gots = TT.apply_table_batch([torch.from_numpy(a.copy()) for a in arrays], frames, ts)
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # and equal to applying the frames one by one, to f32 rounding of the
    # deltas: 1e-6 of the largest leaf's magnitude (1000)
    seq = [torch.from_numpy(a.copy()) for a in arrays]
    for i in range(k):
        TT.apply_table_many(seq, TT.TableFrame(frames.scales[i], frames.words[i]), ts)
    for g, s in zip(gots, seq):
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=0, atol=1e-3)


def _subnormal_tree(seed):
    """Leaves of +-U(1.4, 1.6) * 2^e (one at e = -126, the smallest normal
    octave), so each leaf's RMS lies well inside an octave and every tier
    picks the same POW2 scale; a tenth of the elements are zeros or the
    subnormals +-1e-40 and 1e-45."""
    rng = np.random.default_rng(seed)
    tiny = np.array([0.0, 1e-40, -1e-40, 1e-45, -1e-45], np.float32)
    tree = {}
    for i, (shape, e) in enumerate(zip([(40, 70), (256,), (3, 5, 7), (1000,)], [0, 10, -10, -126])):
        n = int(np.prod(shape))
        x = rng.uniform(1.4, 1.6, n) * rng.choice([-1.0, 1.0], n) * 2.0**e
        pick = rng.random(n) < 0.1
        x[pick] = rng.choice(tiny, int(pick.sum()))
        tree[f"leaf{i}"] = x.astype(np.float32).reshape(shape)
    return tree


@pytest.mark.parametrize("k", [1, 3])
def test_subnormals_match_the_jax_host_tier_bit_for_bit(k):
    """The JAX package's host tier (codec_np, which runs the C codec in
    native/ when it is built and numpy otherwise) keeps IEEE subnormals, as
    the port does: K sender steps and their K frames applied to targets
    that hold subnormals and zeros agree bit for bit (scales, words,
    residuals, targets). Only XLA's tier flushes
    (tests/test_torch_scalar_kernels.py)."""
    tree = _subnormal_tree(k)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    r_np = JNP.flatten_np(tree, js)
    r_t = TT.flatten(tree, ts)
    assert (np.abs(r_np[r_np != 0]) < 2.0**-126).any()  # subnormals in the input
    scales, words = [], []
    for _ in range(k):
        j_scales, j_words, r_np = JNP.quantize_table_np(r_np, js)
        frame, r_t = TT.quantize_table(r_t, ts, impl="plain")
        np.testing.assert_array_equal(_f32_bits(frame.scales.numpy()), _f32_bits(j_scales))
        np.testing.assert_array_equal(frame.words.numpy().view(np.uint32), j_words)
        np.testing.assert_array_equal(_f32_bits(r_t.numpy()), _f32_bits(r_np))
        scales.append(frame.scales.numpy())
        words.append(frame.words.numpy().view(np.uint32))
    assert (np.abs(r_np[r_np != 0]) < 2.0**-126).any()  # and in what the codec leaves
    assert float(scales[0][3]) == 2.0**-126
    targets = [JNP.flatten_np(_subnormal_tree(10 + i), js) for i in range(2)]
    wants = JNP.apply_table_batch_np(tuple(targets), np.stack(scales), np.stack(words), js)
    frames = TT.TableFrame(torch.from_numpy(np.stack(scales)), torch.from_numpy(np.stack(words).view(np.int32)))
    gots = TT.apply_table_batch([torch.from_numpy(t.copy()) for t in targets], frames, ts, impl="plain")
    for g, w in zip(gots, wants):
        np.testing.assert_array_equal(_f32_bits(g.numpy()), _f32_bits(w))
    sub = (gots[0].numpy() != 0) & (np.abs(gots[0].numpy()) < 2.0**-126)
    assert sub.any()  # subnormal sums survive


def _f32_bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_accumulate_table_sanitises_like_jax():
    tree = _mixed(5)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    u = np.asarray(JT.flatten(_mixed(6), js)).copy()
    u[:3] = [np.nan, np.inf, -np.inf]
    u[ts.ns[0] + 5] = 7.0  # a padding lane of leaf 0: masked
    arrays = [np.asarray(JT.flatten(tree, js)), np.full(ts.total, 3e38, np.float32)]
    wants = JT.accumulate_table(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(u), js)
    ta = [torch.from_numpy(a.copy()) for a in arrays]
    gots = TT.accumulate_table(ta, torch.from_numpy(u), ts)
    assert gots[0] is ta[0]
    for g, w in zip(gots, wants):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_impl_switch():
    tree = _mixed(7)
    ts = TT.make_spec(tree)
    r = TT.flatten(tree, ts)
    fa, ra = TT.quantize_table(r.clone(), ts, impl="auto")
    fp, rp = TT.quantize_table(r.clone(), ts, impl="plain")
    np.testing.assert_array_equal(fa.words.numpy(), fp.words.numpy())
    np.testing.assert_array_equal(ra.numpy(), rp.numpy())
    with pytest.raises(ValueError):
        TT.quantize_table(r.clone(), ts, impl="kernel")  # CPU tensor: no kernel
    with pytest.raises(ValueError):
        TT.quantize_table(r.clone(), ts, impl="xla")
