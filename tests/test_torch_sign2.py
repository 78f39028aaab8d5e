"""sign2 (2-bit) frames and adaptive precision on the port's native engine,
against the JAX package (tests/test_sign2.py's cases).

- The port's C sign2 loops (ops/codec_np: stc_quantize2_ef_cascade,
  stc_apply_frames2, stc_apply_frame2) against its plain numpy twins and
  against JAX's quantize2_table_np / apply2_table_np, bit for bit given
  the same scales; the rollback apply within 4e-6 (test_sign2.py's), and
  the cascade equal to K one-frame passes at the same schedule.
- The codec lab's 2-bit pod step (parallel/ici_lab) against the C loops at
  the step's own scales: planes, residuals and applied values.
- A pinned-sign2 pair of port engines converges and counts frames2.
- A port engine with ST_SIGN2=0 keeps the pair at 1 bit.
- A port engine and a JAX engine negotiate sign2, both ways.
- The governor upshifts a byte-bound link and stays quiet on a frame-bound
  one.

Convergence tolerances are test_sign2.py's: 2e-5 between replicas, 1e-3
against the float64 sum of gaussian adds."""

import os
import time

import jax  # noqa: F401  (the JAX package needs its backend configured first)
import numpy as np
import pytest

from shared_tensor_tpu.comm.peer import create_or_fetch as jax_create_or_fetch
from shared_tensor_tpu.comm.transport import build_native
from shared_tensor_tpu.ops import codec_np as jnp_codec
from shared_tensor_tpu.ops.table import make_spec as jax_make_spec
from shared_tensor_tpu_torch import CodecConfig, Config, TransportConfig, create_or_fetch
from shared_tensor_tpu_torch.ops import codec_np
from shared_tensor_tpu_torch.ops.table import make_spec
from tests._ports import free_port

N = 1 << 14
TEMPLATES = {
    "flat": np.zeros(1 << 14, np.float32),
    "ragged": {"a": np.zeros(999, np.float32), "b": np.zeros((1 << 16) + 5, np.float32)},
}


def _residual(spec, rng):
    live = codec_np._live_mask(spec)
    r = np.zeros(spec.total, np.float32)
    r[live] = rng.normal(0, 1, int(live.sum())).astype(np.float32)
    return r, live


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_c_loops_match_plain_and_jax(name):
    spec, jspec = make_spec(TEMPLATES[name]), jax_make_spec(TEMPLATES[name])
    w = spec.total // 32
    rng = np.random.default_rng(11)
    r, live = _residual(spec, rng)
    scales, sw, mw, nr = codec_np.quantize2_table_plain(r, spec)
    js, jsw, jmw, jnr = jnp_codec.quantize2_table_np(r, jspec)
    for a, b in ((scales, js), (sw, jsw), (mw, jmw), (nr, jnr)):
        np.testing.assert_array_equal(a, b)
    words, r2 = codec_np.quantize2_table_np(r, spec, scales[None])
    np.testing.assert_array_equal(words[0, :w], sw)
    np.testing.assert_array_equal(words[0, w:], mw)
    np.testing.assert_array_equal(r2, nr)
    v = np.zeros(spec.total, np.float32)
    v[live] = rng.normal(0, 1, int(live.sum())).astype(np.float32)
    (got,) = codec_np.apply2_table_np((v,), scales[None], words, spec)
    (plain,) = codec_np.apply2_table_plain((v,), scales[None], words, spec)
    (want,) = jnp_codec.apply2_table_np((v,), scales.reshape(1, -1), words.reshape(1, -1), jspec)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    # the ledger's rollback: re-applying the frame to the residual restores it
    np.testing.assert_allclose(codec_np.apply2_frame_np(r2, scales, words[0], spec), r, atol=4e-6)


def test_cascade_is_k_passes_at_the_same_schedule():
    """K sign2 frames in one pass equal K one-frame passes at the same
    scales (the halving schedule the engine puts on the wire)."""
    spec = make_spec(np.zeros(1 << 15, np.float32))
    r, _ = _residual(spec, np.random.default_rng(5))
    s0 = codec_np.compute_scales_np(r, spec)
    k = 5
    sched = np.stack([s0 * np.float32(0.5**j) for j in range(k)])
    words, rc = codec_np.quantize2_table_np(r, spec, sched)
    rr = r
    for j in range(k):
        wj, rr = codec_np.quantize2_table_np(rr, spec, sched[j : j + 1])
        np.testing.assert_array_equal(wj[0], words[j])
    np.testing.assert_array_equal(rc, rr)
    # and K frames applied in one pass equal the plain sum-then-clip
    v = np.random.default_rng(6).normal(size=spec.total).astype(np.float32)
    np.testing.assert_array_equal(codec_np.apply2_table_np((v,), sched, words, spec)[0],
                                  codec_np.apply2_table_plain((v,), sched, words, spec)[0])


def test_sign2_c_loops_match_the_port_pod_lab_step():
    """The engine's sign2 loops against the codec lab's pod step
    (parallel/ici_lab.build_sign2_sync_step): one step on a 2-peer x
    2-shard mesh, then each peer's quantize and the cross-peer apply redone
    with the C loops at the step's scales. Planes, residuals and applied
    values byte-equal (the pod step's two planes and the C frame's
    [sign | magnitude] words share the LSB-first u32 layout)."""
    from tests import test_torch_pod_jobs as P

    n_peer, n = 2, 4096
    tpl = {"w": np.zeros(n, np.float32)}
    spec = make_spec(tpl)
    rng = np.random.default_rng(3)
    ups = np.stack([rng.normal(0, 1, spec.total) for _ in range(n_peer)]).astype(np.float32)
    got = P.result(P.run_on_mesh([("one", "sign2_planes", n_peer, 2, dict(tpl=tpl, ups=ups))], world=4), "one")
    (v_before, r_before), scales = got["before"], got["scales"][0]  # scales f32[n_peer, L]
    words = []
    for p in range(n_peer):
        w, r2 = codec_np.quantize2_table_np(r_before[p], spec, scales[p][None])
        np.testing.assert_array_equal(w[0], got["words"][p], err_msg=f"peer {p} planes")
        np.testing.assert_array_equal(r2.view(np.uint32), got["residual"][p].view(np.uint32), err_msg=f"peer {p}")
        words.append(w)
    for p in range(n_peer):
        q = 1 - p  # the one other peer
        (v,) = codec_np.apply2_table_np((v_before[p],), scales[q][None], words[q], spec)
        np.testing.assert_array_equal(v.view(np.uint32), got["values"][p].view(np.uint32), err_msg=f"peer {p}")


# -- engine peers --------------------------------------------------------------------


def _with_env(env, fn):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _engine(port, tpl, env=None, cfg=None):
    return _with_env(env or {}, lambda: create_or_fetch("127.0.0.1", port, tpl, cfg, host_tier=True))


def _drain(peers, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(all(p.st.residual_rms(l) == 0 for l in p.st.link_ids) and p.st.inflight_total() == 0 for p in peers):
            return True
        time.sleep(0.05)
    return False


def _read(p):
    out = p.read()
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)


def _link(p):
    return next(l for l in p.st.link_ids if l >= 0)


def test_sign2_pinned_pair_converges_and_counts_frames2():
    port = free_port()
    env = {"ST_SIGN2": "2"}
    m = _engine(port, np.zeros(N, np.float32), env)
    c = _engine(port, np.zeros(N, np.float32), env)
    try:
        assert m._engine is not None and c._engine is not None and m._sign2_mode == c._sign2_mode == 2
        rng = np.random.default_rng(0)
        total = np.zeros(N, np.float64)
        for _ in range(6):
            u = rng.normal(0, 1, N).astype(np.float32)
            total += u
            m.add(u)
        assert _drain([m, c]), "did not quiesce"
        np.testing.assert_allclose(_read(m), _read(c), atol=2e-5)
        np.testing.assert_allclose(_read(m), total, atol=1e-3)
        mm, cm = m.metrics(), c.metrics()
        assert mm["st_frames2_out_total"] > 0, "master sent no sign2 frames"
        assert cm["st_frames2_in_total"] > 0, "child applied no sign2 frames"
        assert mm[f'st_link_precision{{link="{_link(m)}"}}'] == 2
    finally:
        c.close()
        m.close()


def test_sign2_mixed_tree_interop_with_disabled_peer():
    port = free_port()
    m = _engine(port, np.zeros(N, np.float32), {"ST_SIGN2": "2"})
    c = _engine(port, np.zeros(N, np.float32), {"ST_SIGN2": "0"})
    try:
        assert c._sign2_mode == 0
        rng = np.random.default_rng(1)
        for _ in range(4):
            m.add(rng.normal(0, 1, N).astype(np.float32))
            c.add(rng.normal(0, 1, N).astype(np.float32))
        assert _drain([m, c]), "did not quiesce"
        np.testing.assert_allclose(_read(m), _read(c), atol=2e-5)
        assert m.metrics()["st_frames2_out_total"] == 0 and c.metrics()["st_frames2_out_total"] == 0, "sign2 leaked"
        assert m._engine.link_precision(_link(m)) == 1
    finally:
        c.close()
        m.close()


@pytest.mark.parametrize("orientation", ["torch_master", "jax_master"])
def test_port_and_jax_engines_negotiate_sign2(orientation):
    """A port engine and a JAX engine, both pinned to sign2, advertise it
    to each other in SYNC and WELCOME: 2-bit frames flow both ways and
    each end decodes the other's."""
    build_native()
    port = free_port()
    env = {"ST_SIGN2": "2"}

    def jax_peer(tpl):
        return _with_env(env, lambda: jax_create_or_fetch("127.0.0.1", port, tpl))

    tpl = np.zeros(N, np.float32)
    if orientation == "torch_master":
        t = _engine(port, tpl, env)
        j = jax_peer(tpl)
    else:
        j = jax_peer(tpl)
        t = _engine(port, tpl, env)
    try:
        assert j._engine is not None and t._engine is not None
        rng = np.random.default_rng(2)
        total = np.zeros(N, np.float64)
        for p in (t, j, t):
            u = rng.normal(0, 1, N).astype(np.float32)
            total += u
            p.add(u)
        assert _drain([t, j]), "did not quiesce"
        np.testing.assert_allclose(_read(t), _read(j), atol=2e-5)
        np.testing.assert_allclose(_read(t), total, atol=1e-3)
        tm, jc = t.metrics(), j._engine._counters()
        assert tm["st_frames2_out_total"] > 0 and tm["st_frames2_in_total"] > 0
        assert int(jc[20]) > 0 and int(jc[21]) > 0
        assert t._engine.link_precision(_link(t)) == 2
    finally:
        (j if orientation == "torch_master" else t).close()
        (t if orientation == "torch_master" else j).close()


GOVERNOR = CodecConfig(precision_interval_sec=0.02, precision_up_ratio=0.05, precision_down_ratio=0.0001)


def test_governor_upshifts_under_sustained_residual():
    """A byte-bound link (a token-bucket cap far below what the adds need)
    whose residual RMS will not decay upshifts to sign2: the upshift
    counter and the link's precision show it."""
    cfg = Config(transport=TransportConfig(bandwidth_cap_bytes_per_sec=1 << 15, ack_timeout_sec=2.0), codec=GOVERNOR)
    port = free_port()
    n = 4096  # ~64 1-bit frames/s under the cap: the adds below outrun the wire
    m = _engine(port, np.zeros(n, np.float32), cfg=cfg)
    c = _engine(port, np.zeros(n, np.float32), cfg=cfg)
    try:
        assert m._sign2_mode == 1
        rng = np.random.default_rng(2)
        deadline = time.time() + 20
        upshifted = False
        while time.time() < deadline and not upshifted:
            m.add(rng.normal(0, 1, n).astype(np.float32))
            time.sleep(0.005)
            upshifted = m.metrics()["st_precision_upshifts_total"] > 0
        assert upshifted, "governor never upshifted under sustained load"
        assert m._engine.link_precision(_link(m)) == 2
        assert _drain([m, c]), "did not quiesce after the load"
    finally:
        c.close()
        m.close()


def test_governor_stays_quiet_on_frame_bound_link():
    cfg = Config(codec=GOVERNOR)
    port = free_port()
    m = _engine(port, np.zeros(N, np.float32), cfg=cfg)
    c = _engine(port, np.zeros(N, np.float32), cfg=cfg)
    try:
        rng = np.random.default_rng(4)
        t_end = time.time() + 3.0
        while time.time() < t_end:
            m.add(rng.normal(0, 1, N).astype(np.float32))
            time.sleep(0.005)
        mm = m.metrics()
        assert mm["st_precision_upshifts_total"] == 0, "governor upshifted a frame-bound link"
        assert mm["st_frames2_out_total"] == 0, "sign2 frames leaked"
        assert m._engine.link_precision(_link(m)) == 1
        assert _drain([m, c]), "did not quiesce after the load"
    finally:
        c.close()
        m.close()
