"""The per-leaf scale pass (shared_tensor_tpu_torch.ops.codec_cuda.leaf_scales,
``csrc/leaf_scale.cu``) through its plain twin on the CPU, against the JAX
package's per-leaf scales (``ops/table.compute_scales`` in XLA, and its host
tier's ``codec_np.compute_scales_np``), against the torch chain it replaces
(``ops/table.compute_scales`` of the port), and in the pod tier over gloo
(``parallel/ici._leaf_scales``) with blocks that start mid-tile. The kernel
against the twin, bit for bit, is in tests/test_torch_cuda.py.

The twin takes the port's rule for scales from partials (the host tier's):
max |r|, sum r^2 and sum |r| of each leaf's live lanes in double, no
normalising pass. JAX's XLA tier normalises each leaf by its max |r| and
sums in f32, and flushes subnormals on the CPU.

Tolerances: POW2_RMS scales equal, and equal to 2^floor(log2 RMS) from
the leaf's RMS in double, unless that RMS lies within EDGE_ULPS f32 ulps of
a power of two, where they may be one octave apart; RMS and ABS_MEAN to a
relative 1e-6; 0 exactly where JAX gives 0 (a zero leaf, a NaN or an inf in
the leaf), except a leaf of subnormals alone under RMS and ABS_MEAN, which
XLA flushes to 0 and the host tier, the chain and the twin keep (a pow2
floor of a subnormal RMS is 0 in every tier). The twin's partials and its
leaf sums bit for bit against their order written out."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_tensor_tpu.config import ScalePolicy as JPolicy
from shared_tensor_tpu.ops import codec_np as JNP
from shared_tensor_tpu.ops import table as JT
from shared_tensor_tpu_torch.config import ScalePolicy
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.ops import table as TT
from tests import test_torch_pod_jobs as P

POLICIES = list(ScalePolicy)
#: an RMS this close to a power of two may floor to either side of it
EDGE_ULPS = 4
#: the subnormal-only leaf's name (XLA on the CPU flushes it)
SUB = "l7_sub"


def _tree(seed, nonfinite=True):
    """Mixed leaves: gaussians of several magnitudes with 5% zeros and a
    tenth subnormals in the first, a zero leaf, one-row leaves (100
    elements, one element), a leaf of subnormals alone, and with
    ``nonfinite`` a leaf holding a NaN and one holding an inf."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(size=s).astype(np.float32)
    big = g(40, 70)
    big[rng.random(big.shape) < 0.05] = 0.0
    pick = rng.random(big.shape) < 0.1
    big[pick] = rng.choice(np.array([1e-40, -1e-40, 1e-45, -1e-45], np.float32), int(pick.sum()))
    tree = {"l0_big": big, "l1_milli": g(256) * np.float32(1e-3), "l2_zero": np.zeros(300, np.float32),
            "l3_row": g(100) * np.float32(10.0), "l4_one": np.float32(-3.0), "l5_wide": g(5000) * np.float32(1e3),
            "l6_tiny": g(3, 5, 7) * np.float32(2.0**-100),
            SUB: (rng.uniform(0.5, 1.0, 2000) * rng.choice([-1.0, 1.0], 2000) * 2.0**-130).astype(np.float32)}
    if nonfinite:
        nan, inf = g(50), g(70)
        nan[7], inf[3] = np.nan, -np.inf
        tree["l8_nan"], tree["l9_inf"] = nan, inf
    return tree


def _rms64(tree, spec, per_leaf):
    """Each leaf's RMS over its live elements in double (one over the table
    without ``per_leaf``), by leaf in the table's order."""
    leaves = [np.asarray(x, np.float64).reshape(-1) for x in TT.tree_flatten(tree)[0]]
    if not per_leaf:
        allv = np.concatenate(leaves)
        return np.full(len(leaves), np.sqrt(np.sum(allv * allv) / allv.size))
    return np.array([np.sqrt(np.sum(v * v) / v.size) for v in leaves])


def _near_pow2(x):
    if not np.isfinite(x) or x <= 0:
        return False
    m, _ = np.frexp(x)  # x = m * 2^e, 0.5 <= m < 1
    return min(2 * m - 1, 1 - m) < EDGE_ULPS * 2.0**-23


def _scales_ok(got, want, policy, rms):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got == 0, want == 0), (got, want)
    if policy != ScalePolicy.POW2_RMS:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        return
    for g, w, x in zip(got, want, rms):
        if g == w:
            continue
        assert _near_pow2(x) and w != 0 and g / w in (0.5, 2.0), (g, w, x)


def _twin(tree, policy, per_leaf):
    spec = TT.make_spec(tree)
    return TT._table_scales(TT.flatten(tree, spec), spec, policy, per_leaf).numpy()


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("per_leaf", [True, False])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_twin_matches_jax_compute_scales(policy, per_leaf, nonfinite):
    tree = _tree(1, nonfinite)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    got = _twin(tree, policy, per_leaf)
    want = np.asarray(JT._table_scales(jnp.asarray(JT.flatten(tree, js)), js, JPolicy(policy.value), per_leaf))
    rms = _rms64(tree, ts, per_leaf)
    names = sorted(tree)
    keep = [i for i, n in enumerate(names) if n != SUB]
    _scales_ok(got[keep], want[keep], policy, rms[keep])
    if per_leaf:
        sub = names.index(SUB)
        # XLA flushes the subnormal leaf; the twin keeps it (but a pow2 floor
        # of a subnormal RMS is 0 in every tier)
        assert want[sub] == 0 and (got[sub] == 0) == (policy == ScalePolicy.POW2_RMS)
        zero = [names.index(n) for n in ("l2_zero", "l8_nan", "l9_inf") if n in tree]
        assert not got[zero].any()
    elif nonfinite:
        assert not got.any()  # a NaN and an inf in the table: no scale
    else:
        assert len(set(got.tolist())) == 1 and got[0] > 0


@pytest.mark.parametrize("per_leaf", [True, False])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_twin_matches_the_jax_host_tier(policy, per_leaf):
    """The same rule as JAX's host tier (double sums, subnormals kept), the
    sums in another order: the subnormal leaf included."""
    tree = _tree(2)
    js, ts = JT.make_spec(tree), TT.make_spec(tree)
    got = _twin(tree, policy, per_leaf)
    want = JNP.compute_scales_np(JNP.flatten_np(tree, js), js, JPolicy(policy.value), per_leaf)
    _scales_ok(got, want, policy, _rms64(tree, ts, per_leaf))
    assert got[sorted(tree).index(SUB)] > 0 or not per_leaf or policy == ScalePolicy.POW2_RMS


@pytest.mark.parametrize("per_leaf", [True, False])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_twin_matches_the_torch_chain(policy, per_leaf):
    """The pass against the chain of torch launches it replaces on every
    path that launches kernel A (``table.compute_scales``, kept as the golden
    it is timed against)."""
    import dataclasses

    tree = _tree(3, nonfinite=False)
    ts = TT.make_spec(tree)
    r = TT.flatten(tree, ts)
    got = _twin(tree, policy, per_leaf)
    if per_leaf:
        want = TT.compute_scales(r, ts, policy).numpy()
    else:
        one = dataclasses.replace(ts, shapes=((ts.total_n,),), ns=(ts.total_n,), padded=(ts.total,))
        want = np.repeat(TT.compute_scales(r, one, policy).numpy(), ts.num_leaves)
    _scales_ok(got, want, policy, _rms64(tree, ts, per_leaf))


# -- the twin's own order ------------------------------------------------------------------


def _layout(seed, n_leaves, max_tiles, phase, empty_every=0):
    """A random block: leaves of 1..max_tiles tiles (some empty), its rows
    cut to start ``phase`` rows into the first tile, live counts with
    partial rows, values with zeros, subnormals, garbage in dead lanes."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(1, max_tiles + 1, n_leaves)
    if empty_every:
        tiles[::empty_every] = 0
    slots = np.concatenate([[0], np.cumsum(tiles)])
    rows = int(slots[-1]) * CC.TILE_ROWS - phase - int(rng.integers(0, CC.TILE_ROWS))
    rows = max(rows, 1)
    n_slots = CC.leaf_slot_count(rows, phase)
    leaf_slots = np.minimum(slots, n_slots)
    leaf_slots[-1] = n_slots
    rowcount = rng.choice([0, 1, 31, 32, 33, 100, 127, 128, 128, 128], rows).astype(np.int32)
    r = rng.normal(size=rows * 128).astype(np.float32) * (2.0 ** rng.integers(-20, 20, rows * 128)).astype(np.float32)
    r[rng.random(r.size) < 0.05] = 0.0
    r[:4] = [1e-40, -1e-45, 0.0, -0.0]
    dead = np.arange(128)[None, :] >= rowcount[:, None]
    r.reshape(rows, 128)[dead] = np.float32(np.nan)  # dead lanes count as 0
    ns = np.maximum(1, np.diff(leaf_slots) * 1024 - 17).astype(np.float64)
    return (torch.from_numpy(r), torch.from_numpy(rowcount), torch.from_numpy(leaf_slots.astype(np.int64)),
            torch.from_numpy(ns))


def _order_reference(r, rowcount, phase, slots):
    """The partials' order written out: for each slot, lane i adds the 4
    elements of unit i of each of the slot's rows in turn from 0.0, then the
    warp's halving tree."""
    rows = r.shape[0] // 128
    x = r.numpy().reshape(rows, 128).astype(np.float64)
    cnt = rowcount.numpy()
    out = np.zeros((3, slots))
    for t in range(slots):
        lanes = np.zeros((3, 32))
        for lane in range(32):
            am = ss = sa = 0.0
            for j in range(CC.TILE_ROWS):
                row = t * CC.TILE_ROWS - phase + j
                for c in range(4):
                    e = 4 * lane + c
                    v = x[row, e] if 0 <= row < rows and e < cnt[row] else 0.0
                    am = max(am, abs(v)) if v == v else am
                    ss = ss + v * v
                    sa = sa + abs(v)
            lanes[:, lane] = am, ss, sa
        out[0, t] = lanes[0].max()
        out[1:, t] = CC._halve(lanes[1:], 32)
    return out


@pytest.mark.parametrize("phase,n_leaves", [(0, 3), (3, 3), (7, 3), (5, 40), (2, 170)])
def test_partials_follow_the_kernels_order(phase, n_leaves):
    """The twin's partials against the order written out, with a table of
    fewer slots than the twin takes at once and one of more."""
    r, rowcount, _, _ = _layout(phase, n_leaves, 2, phase)
    rows = r.shape[0] // 128
    slots = CC.leaf_slot_count(rows, phase)
    assert (slots > CC.LEAF_NP_SLOTS) == (n_leaves == 170)
    want = _order_reference(r, rowcount, phase, slots)
    got = CC._leaf_partials_np(r.numpy(), rowcount.numpy(), phase, slots)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def _finish_reference(partials, bounds):
    """The finish kernel's leaf reduction written out: the slots cut into
    one range a warp (``finish_threads`` / 32 ranges of ``span`` slots, a
    multiple of 32); for each leaf, each range it touches gives a part:
    lane i takes the leaf's slots wb + 32 m + i in turn from 0.0, then the
    warp's halving tree; a leaf over several ranges is one warp's sum of
    its parts in range order (lane i takes parts i, i + 32, ... in turn)."""
    n_leaves, n = len(bounds) - 1, bounds[-1]
    span = -(-n // CC.finish_threads(n_leaves)) * 32
    out = np.zeros((3, n_leaves))

    def warp(cols):  # lane i: columns i, i + 32, ... in turn, then the tree
        lanes = np.zeros((3, 32))
        for j, col in enumerate(cols):
            lanes[0, j % 32] = max(lanes[0, j % 32], col[0])
            lanes[1:, j % 32] += col[1:]
        return np.concatenate([[lanes[0].max()], CC._halve(lanes[1:], 32)])

    for leaf in range(n_leaves):
        lo, hi = bounds[leaf], bounds[leaf + 1]
        if lo == hi:
            continue
        parts = []
        for w in range(lo // span, (hi - 1) // span + 1):
            lanes = np.zeros((3, 32))
            for m in range(span // 32):
                for i in range(32):
                    t = w * span + 32 * m + i
                    if lo <= t < hi:
                        lanes[0, i] = max(lanes[0, i], partials[0, t])
                        lanes[1:, i] += partials[1:, t]
            parts.append(np.concatenate([[lanes[0].max()], CC._halve(lanes[1:], 32)]))
        out[:, leaf] = parts[0] if len(parts) == 1 else warp(parts)
    return out


@pytest.mark.parametrize("case", ["one", "few", "many", "empty", "long", "thousands"])
@pytest.mark.parametrize("phase", [0, 4])
def test_leaf_sums_follow_the_finish_kernels_order(case, phase):
    """The twin's leaf sums (``_leaf_sums_np``, shared with the cascade's
    finish twin) against the finish kernel's order written out: one leaf
    (whose sum over the leaves is its own), few leaves (512 threads), many
    (1024), empty leaves (a pod block's), a leaf over many warp ranges, more
    leaves than a block's shared memory stages; and the twin's scales, by
    the pass and by its rule alone, agree for every policy."""
    n_leaves, max_tiles, empty = {"one": (1, 5, 0), "few": (5, 4, 0), "many": (40, 6, 0), "empty": (30, 3, 3),
                                  "long": (3, 900, 0), "thousands": (1100, 1, 5)}[case]
    r, rowcount, leaf_slots, ns = _layout(17, n_leaves, max_tiles, phase, empty)
    rows = r.shape[0] // 128
    slots = CC.leaf_slot_count(rows, phase)
    partials = CC._leaf_partials_np(r.numpy(), rowcount.numpy(), phase, slots)
    want = _finish_reference(partials, leaf_slots.tolist())
    got = CC._leaf_sums_np(partials, leaf_slots.tolist())
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    for policy in POLICIES:
        for per_leaf in (True, False):
            s, sums = CC.leaf_scales_plain(r, rowcount, leaf_slots, ns, policy, per_leaf, phase)
            np.testing.assert_array_equal(sums.numpy().view(np.uint64), want.view(np.uint64))
            np.testing.assert_array_equal(CC.leaf_rule(sums, ns, policy, per_leaf).numpy().view(np.uint32),
                                          s.numpy().view(np.uint32))


def test_the_pass_reads_only_live_lanes_and_counts_no_launch_on_the_cpu():
    tree = _tree(4, nonfinite=False)
    spec = TT.make_spec(tree)
    r = TT.flatten(tree, spec)
    want = TT._table_scales(r, spec, ScalePolicy.POW2_RMS, True)
    live = TT._consts(spec, "cpu")[2].view(-1)
    garbage = r.clone()
    garbage[~live] = float("nan")
    CC.reset_launches()
    got, amax = TT._table_scales(garbage, spec, ScalePolicy.POW2_RMS, True, with_amax=True)
    assert torch.equal(got, want) and not any(CC.launches().values())
    np.testing.assert_array_equal(amax.numpy(), TT.leaf_amax(r, spec).numpy())
    # quantize_table on the CPU takes the twin's scales
    frame, _ = TT.quantize_table(r.clone(), spec)
    assert torch.equal(frame.scales, want)


def test_argument_checks():
    r, rowcount, leaf_slots, ns = _layout(5, 4, 3, 2)
    with pytest.raises(ValueError, match="phase"):
        CC.leaf_scales(r, rowcount, leaf_slots, ns, ScalePolicy.POW2_RMS, True, 8)
    bad = leaf_slots.clone()
    bad[-1] += 1
    with pytest.raises(ValueError, match="leaf_slots"):
        CC.leaf_scales(r, rowcount, bad, ns, ScalePolicy.POW2_RMS, True, 2)  # past the pass's slots
    with pytest.raises(TypeError):
        CC.leaf_scales(r.double(), rowcount, leaf_slots, ns)
    with pytest.raises(TypeError):
        CC.leaf_scales(r, rowcount, leaf_slots, ns.float())
    with pytest.raises(ValueError):
        CC.leaf_scales(r, rowcount[:-1], leaf_slots, ns)
    with pytest.raises(ValueError, match="policy"):
        CC.leaf_scales(r, rowcount, leaf_slots, ns, "POW2")
    with pytest.raises(ValueError, match="CUDA"):
        CC.leaf_scales_kernel(r, rowcount, leaf_slots, ns, ScalePolicy.POW2_RMS, True, 2)
    with pytest.raises(ValueError, match="CUDA"):
        CC.leaf_rule_kernel(torch.zeros((3, 4), dtype=torch.float64), ns)
    with pytest.raises(ValueError):
        TT._table_scales(r, TT.make_spec({"x": np.zeros(r.numel(), np.float32)}), ScalePolicy.POW2_RMS, True,
                         impl="xla")


# -- the pod tier over gloo ------------------------------------------------------------------

#: leaves of 3, 1, 5, 1 and 1 tiles: 11 tiles, 88 rows, so blocks of 44, 22
#: and 11 rows, and shards past the first start mid-tile
POD_SHAPES = [(2500,), (100,), (4097,), (32, 32), (700,)]
POD_SHARDS = [2, 4, 8]


def _pod_residual(seed):
    rng = np.random.default_rng(seed)
    spec = TT.make_spec({f"l{i:02d}": np.zeros(s, np.float32) for i, s in enumerate(POD_SHAPES)})
    r = rng.normal(size=spec.total).astype(np.float32) * np.float32(3.0)
    live = TT._consts(spec, "cpu")[2].view(-1).numpy()
    r[~live] = np.float32(7.0)  # a pod residual's dead lanes may hold what add_updates left there
    r[spec.padded[0] : spec.padded[0] + spec.padded[1]] *= np.float32(1e-3)
    return spec, r


@pytest.fixture(scope="module")
def pod():
    _, r = _pod_residual(31)
    jobs = [(f"{pol.name}-{pl}-{k}", "leaf_scales_block", 1, k,
             dict(shapes=POD_SHAPES, residual=r, policy=pol.name, per_leaf=pl))
            for pol in POLICIES for pl in (True, False) for k in POD_SHARDS]
    return P.run_on_mesh(jobs)


@pytest.mark.parametrize("n_shard", POD_SHARDS)
@pytest.mark.parametrize("per_leaf", [True, False])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p.name)
def test_pod_blocks_reduce_to_the_tables_scales(pod, policy, per_leaf, n_shard):
    """``ici._leaf_scales`` over 2, 4 and 8 shards (gloo, one peer) on a
    table whose shard cuts fall mid-tile: every rank of the group gets the
    whole table's scales (the twin's on the unsplit table), the blocks'
    sums add up to the table's, and the tile grid follows each block's
    start."""
    spec, r = _pod_residual(31)
    want, want_sums = CC.leaf_scales_plain(torch.from_numpy(r), TT._consts(spec, "cpu")[1],
                                           TT._cascade_consts(spec, "cpu").leaf_slots,
                                           TT._cascade_consts(spec, "cpu").ns, policy, per_leaf)
    want = want.numpy() if per_leaf else want.numpy()[:1]
    got = [out[f"{policy.name}-{per_leaf}-{n_shard}"] for out in pod[:n_shard]]
    rows_local = spec.rows // n_shard
    assert [g["phase"] for g in got] == [k * rows_local % CC.TILE_ROWS for k in range(n_shard)]
    assert any(g["phase"] for g in got)  # a block starts mid-tile
    for g in got:
        np.testing.assert_array_equal(g["scales"].view(np.uint32), got[0]["scales"].view(np.uint32))
        assert g["leaf_slots"][-1] == CC.leaf_slot_count(rows_local, g["phase"])
    rms = _rms64({f"l{i:02d}": r[sum(spec.padded[:i]) : sum(spec.padded[:i]) + n].reshape(-1)
                  for i, n in enumerate(spec.ns)}, spec, per_leaf)
    _scales_ok(got[0]["scales"], want, policy, rms[: want.shape[0]])
    total = sum(g["sums"] for g in got)
    np.testing.assert_allclose(total[1:], want_sums.numpy()[1:], rtol=1e-12)
    np.testing.assert_array_equal(total[0] > 0, want_sums.numpy()[0] > 0)


# -- the twin's CPU cost ------------------------------------------------------------------------


def test_twin_cpu_time_on_a_4096_element_table(capsys):
    """The twin's and the torch chain's CPU time a call on a one-leaf
    4,096-element table, printed for the record (no clock is asserted)."""
    rng = np.random.default_rng(6)
    spec = TT.make_spec({"x": rng.normal(size=4096).astype(np.float32)})
    r = TT.flatten({"x": rng.normal(size=4096).astype(np.float32)}, spec)
    twin = lambda: TT._table_scales(r, spec, ScalePolicy.POW2_RMS, True)
    chain = lambda: TT.compute_scales(r, spec)
    times = {}
    for name, f in (("twin", twin), ("chain", chain)):
        for _ in range(20):
            f()
        t0 = time.perf_counter()
        for _ in range(200):
            f()
        times[name] = (time.perf_counter() - t0) / 200 * 1e3
    with capsys.disabled():
        print(f"\n[leaf scale twin] 4096 elements: twin {times['twin']:.4f} ms, torch chain {times['chain']:.4f} ms")
    assert torch.equal(twin(), chain())


def test_pod_scales_bench_needs_a_gpu(capsys):
    """``benchmarks.pod_scales`` (the pod step's scales stage from several
    trees in turns) runs on the card only: without one it says so and
    exits 2."""
    from shared_tensor_tpu_torch.benchmarks import pod_scales

    assert pod_scales.main(["--trees", "."]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
