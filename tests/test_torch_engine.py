"""The native link engine in the port's peer (shared_tensor_tpu_torch.comm.engine
over the port's own build of native/stengine.cpp): the cases of
tests/test_engine.py that this port covers, on port peers in one process
over loopback, plus the build's own contracts (one mapped copy of the
transport, no fallback when the engine does not build).

Tolerances are test_engine.py's: exact-draining workloads (uniform or
linspace deltas) compared with atol 1e-6 to 1e-3 as there. Every wait has
its own deadline."""

import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch
from shared_tensor_tpu_torch import _build
from shared_tensor_tpu_torch.comm.engine import EngineTensor, engine_eligible, load_engine
from shared_tensor_tpu_torch.ops.table import TableFrame
from tests._ports import free_port

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _built():
    load_engine()


def _mk(port, template, host_tier=True, **cfg):
    cfg.setdefault("transport", TransportConfig(peer_timeout_sec=10.0))
    return create_or_fetch("127.0.0.1", port, template, Config(**cfg), timeout=30.0,
                           device="cpu" if not host_tier else None, host_tier=host_tier)


def _w(peer) -> np.ndarray:
    return peer.read()["w"].numpy()


def _wait(cond, timeout=30.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.05)


def test_engine_active_by_default_on_host_tier():
    assert engine_eligible(Config(), host_tier=True)
    with _mk(free_port(), {"w": np.zeros(256, np.float32)}) as peer:
        assert isinstance(peer._engine, EngineTensor) and peer.st is peer._engine
        assert peer.st.host_tier
        # the engine sends on every link: no Python send thread races it
        # for a link that the handshake is handing over
        assert [t.name for t in peer._threads] == ["st-recv"] and peer.threads_alive()


def test_engine_off_with_native_engine_false():
    assert not engine_eligible(Config(native_engine=False), host_tier=True)
    with _mk(free_port(), {"w": np.zeros(256, np.float32)}, native_engine=False) as peer:
        assert peer._engine is None and peer.st.host_tier


@pytest.mark.parametrize(
    "cfg", [{}, {"sync_interval_sec": 0.01}], ids=["device_tier", "paced_host_tier"]
)
def test_engine_never_on_device_tier_or_paced(cfg):
    host = bool(cfg)  # the paced case is on the host tier: pacing is the Python tier's
    assert not engine_eligible(Config(**cfg), host_tier=host)
    with _mk(free_port(), {"w": np.zeros(256, np.float32)}, host_tier=host, **cfg) as peer:
        assert peer._engine is None and peer.st.host_tier == host


def _capture_engine_checkpoint(tmp_path):
    """A 2-node engine tree whose master has a nonzero link residual at
    save time: single-frame messages through a 2 KB/s token bucket pace
    the drain, and the residual of a linspace delta halves per frame."""
    from shared_tensor_tpu_torch.utils import checkpoint as ckpt

    port = free_port()
    a = _mk(port, {"w": np.zeros(512, np.float32)}, frame_burst=1,
            transport=TransportConfig(peer_timeout_sec=10.0, bandwidth_cap_bytes_per_sec=2000))
    b = _mk(port, {"w": np.zeros(512, np.float32)})
    try:
        assert a._engine is not None
        a.add({"w": np.linspace(0.1, 1.0, 512, dtype=np.float32)})
        time.sleep(0.2)
        path = str(tmp_path / "engine_peer.npz")
        ckpt.save_shared(a.st, path)
    finally:
        a.close()
        b.close()
    with np.load(path) as z:
        values = z["values"]
        links = {int(k.split("_", 1)[1]): z[k] for k in z.files if k.startswith("link_")}
    resid = links[min(links)]
    assert float(np.sqrt((resid * resid).mean())) > 1e-6, "resid drained"
    return path, values, links


def test_engine_checkpoint_restore_then_join(tmp_path):
    """load_shared's engine branch (the state lives in C), then a peer that
    joins after the restore receives the restored replica."""
    from shared_tensor_tpu_torch.utils import checkpoint as ckpt

    path, values, _ = _capture_engine_checkpoint(tmp_path)
    port = free_port()
    with _mk(port, {"w": np.zeros(512, np.float32)}) as a2:
        assert a2._engine is not None
        ckpt.load_shared(a2.st, path)
        np.testing.assert_array_equal(a2.st.snapshot_all()[0].numpy(), values)
        with _mk(port, {"w": np.zeros(512, np.float32)}) as b2:
            assert a2.drain(timeout=30.0, tol=1e-30)
            expect = values[:512]
            _wait(lambda: np.allclose(_w(b2), expect, atol=1e-5))
            np.testing.assert_allclose(_w(b2), expect, atol=1e-5)


def test_engine_checkpoint_restored_residual_streams(tmp_path):
    """Restoring onto a live link installs the saved residual in C and
    marks the link to stream: the joiner converges to exactly that mass."""
    from shared_tensor_tpu_torch.utils import checkpoint as ckpt

    path, values, links = _capture_engine_checkpoint(tmp_path)
    lid = min(links)
    port = free_port()
    with _mk(port, {"w": np.zeros(512, np.float32)}) as a2, _mk(port, {"w": np.zeros(512, np.float32)}) as b2:
        assert a2._engine is not None and lid in a2.st.link_ids
        ckpt.load_shared(a2.st, path)
        np.testing.assert_array_equal(a2.st.snapshot_all()[0].numpy(), values)
        assert a2.drain(timeout=30.0, tol=1e-30)
        expect = links[lid][:512]
        _wait(lambda: np.allclose(_w(b2), expect, atol=1e-5))
        np.testing.assert_allclose(_w(b2), expect, atol=1e-5)


def test_engine_checkpoint_file_matches_python_tier_format(tmp_path):
    """save_shared on an engine peer writes the Python tier's keys, and the
    file restores into a host-tier SharedTensor of the same layout."""
    from shared_tensor_tpu_torch.core import SharedTensor
    from shared_tensor_tpu_torch.utils import checkpoint as ckpt

    path, values, links = _capture_engine_checkpoint(tmp_path)
    st = SharedTensor({"w": np.zeros(512, np.float32)}, host_tier=True)
    for lid in links:
        st.new_link(lid, seed=False)
    ckpt.load_shared(st, path)
    v, got = st.snapshot_all()
    np.testing.assert_array_equal(v.numpy(), values)
    for lid, r in links.items():
        np.testing.assert_array_equal(got[lid].numpy(), r)


def test_engine_vs_python_tier_convergence_parity():
    """The same workload on the engine and on the Python host tier reaches
    the same fixed point (uniform deltas converge exactly)."""
    finals = {}
    for native in (True, False):
        port = free_port()
        with _mk(port, {"w": np.zeros(512, np.float32)}, native_engine=native) as a, _mk(
            port, {"w": np.zeros(512, np.float32)}, native_engine=native
        ) as b:
            assert (a._engine is not None) == native and a.st.host_tier
            a.add({"w": np.full(512, 0.75, np.float32)})
            b.add({"w": np.full(512, -0.25, np.float32)})
            _wait(lambda: np.allclose(_w(a), 0.5) and np.allclose(_w(b), 0.5))
            finals[native] = (_w(a).copy(), _w(b).copy())
    for native, (va, vb) in finals.items():
        np.testing.assert_allclose(va, 0.5, err_msg=f"native={native}")
        np.testing.assert_allclose(vb, 0.5, err_msg=f"native={native}")


def test_engine_drain_and_inflight_accounting():
    port = free_port()
    with _mk(port, {"w": np.zeros(1024, np.float32)}) as a, _mk(port, {"w": np.zeros(1024, np.float32)}) as b:
        assert a._engine is not None and len(a.st.link_ids) == 1, (a._engine, a.st.link_ids)
        a.add({"w": np.linspace(-1, 1, 1024, dtype=np.float32)})
        assert a.drain(timeout=30.0), "drain must complete once residuals hit 0"
        assert a.st.inflight_total() == 0
        np.testing.assert_allclose(_w(b), np.linspace(-1, 1, 1024, dtype=np.float32), atol=1e-6)


def test_counter_taxonomy_reconciles_across_layers():
    """A drained single-writer pair: every frame sent was applied, every
    message acknowledged, and the wire carried at least the data messages;
    an all-zero-scale frame applies as a no-op and counts nowhere."""
    port = free_port()
    with _mk(port, {"w": np.zeros(2048, np.float32)}) as a, _mk(port, {"w": np.zeros(2048, np.float32)}) as b:
        for k in range(5):
            a.add({"w": np.linspace(-1 - k, 1 + k, 2048, dtype=np.float32)})
            time.sleep(0.05)
        assert a.drain(timeout=30.0, tol=1e-30)
        _wait(lambda: b.metrics()["st_msgs_in_total"] == a.metrics()["st_msgs_out_total"], 5.0)
        ma, mb = a.metrics(), b.metrics()
        assert ma["st_frames_out_total"] == mb["st_frames_in_total"] > 0, (ma, mb)
        assert ma["st_inflight_msgs"] == 0
        assert ma["st_msgs_out_total"] == mb["st_msgs_in_total"], (ma, mb)
        wire_out = sum(v for k, v in ma.items() if k.startswith("st_link_wire_msgs_out_total{"))
        assert wire_out >= ma["st_msgs_out_total"]
        assert ma["st_tx_slot_acquires_total"] >= ma["st_msgs_out_total"]
        fin, vals = b.st.frames_in, _w(b).copy()
        zeroed = TableFrame(np.zeros(1, np.float32), np.arange(2048 // 32, dtype=np.uint32))
        b.st.receive_frames(b.node.links[0], [zeroed])
        assert b.st.frames_in == fin
        np.testing.assert_array_equal(_w(b), vals)


def test_engine_graceful_leave_loses_nothing():
    port = free_port()
    with _mk(port, {"w": np.zeros(256, np.float32)}) as a:
        b = _mk(port, {"w": np.zeros(256, np.float32)})
        b.add({"w": np.full(256, 2.5, np.float32)})
        assert b.drain(timeout=30.0)
        b.close()
        _wait(lambda: np.allclose(_w(a), 2.5), 20.0)
        np.testing.assert_allclose(_w(a), 2.5)


@pytest.mark.parametrize("native", [True, False], ids=["engine", "python"])
def test_engine_link_churn_loses_nothing(native):
    """The child's uplink is killed repeatedly while both sides add: with
    both processes alive nothing is lost (unacknowledged frames roll back
    into the live carry, the re-graft's diff handshake derives the rest)."""
    port = free_port()
    a = _mk(port, {"w": np.zeros(512, np.float32)}, native_engine=native)
    b = _mk(port, {"w": np.zeros(512, np.float32)}, native_engine=native)
    assert (b._engine is not None) == native
    total = np.zeros(512, np.float32)
    try:
        for k in range(4):
            da = np.linspace(-1 - k, 1 + k, 512, dtype=np.float32)
            db = np.linspace(0.5 + k, -0.5 - k, 512, dtype=np.float32)
            a.add({"w": da})
            b.add({"w": db})
            total += da + db
            time.sleep(0.3)
            links = b.node.links
            if links:
                b.node.drop_link(links[0])
            time.sleep(0.3)
        _wait(lambda: np.allclose(_w(a), total, atol=1e-4) and np.allclose(_w(b), total, atol=1e-4), 60.0)
        np.testing.assert_allclose(_w(a), total, atol=1e-4)
        np.testing.assert_allclose(_w(b), total, atol=1e-4)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("native", [True, False], ids=["engine", "python"])
def test_engine_midstream_leave_loses_nothing(native):
    """leave() of an interior node (a chain a <- b <- c) while a and c
    stream: seal, drain, close loses nothing, so the survivors hold the
    exact sum."""
    port = free_port()
    chain = dict(transport=TransportConfig(peer_timeout_sec=10.0, max_children=1), native_engine=native)
    a = _mk(port, {"w": np.zeros(1024, np.float32)}, **chain)
    b = _mk(port, {"w": np.zeros(1024, np.float32)}, **chain)
    c = _mk(port, {"w": np.zeros(1024, np.float32)}, **chain)
    try:
        assert len(b.node.links) == 2, b.node.links
        stop = threading.Event()
        lock = threading.Lock()
        acc: list = []

        def hammer(peer, seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                lo, hi = sorted(rng.uniform(-1, 1, size=2))
                d = np.linspace(lo, hi, 1024, dtype=np.float32)
                peer.add({"w": d})
                with lock:
                    acc.append(d.astype(np.float64))
                time.sleep(0.01)

        threads = [threading.Thread(target=hammer, args=(a, 1)), threading.Thread(target=hammer, args=(c, 2))]
        for t in threads:
            t.start()
        time.sleep(0.5)
        b.add({"w": np.full(1024, 0.5, np.float32)})
        assert b.leave(timeout=30.0)
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join()
        total = np.sum(acc, axis=0) + 0.5
        assert a.drain(timeout=60.0, tol=1e-30)
        assert c.drain(timeout=60.0, tol=1e-30)
        _wait(lambda: np.allclose(_w(a), total, atol=1e-3) and np.allclose(_w(c), total, atol=1e-3), 10.0)
        np.testing.assert_allclose(_w(a), total, atol=1e-3)
        np.testing.assert_allclose(_w(c), total, atol=1e-3)
    finally:
        for p in (a, b, c):
            p.close()


def test_engine_forwards_unknown_messages_without_disruption():
    """An unknown kind on an engine link goes to Python's control path
    (counted and dropped there) while the data keeps flowing both ways."""
    port = free_port()
    with _mk(port, {"w": np.zeros(256, np.float32)}) as a, _mk(port, {"w": np.zeros(256, np.float32)}) as b:
        link = b.node.links[0]
        for _ in range(3):
            b.node.send(link, bytes([99]) + b"garbage", timeout=1.0)
        b.add({"w": np.full(256, 1.25, np.float32)})
        _wait(lambda: np.allclose(_w(a), 1.25), 20.0)
        np.testing.assert_allclose(_w(a), 1.25)
        a.add({"w": np.full(256, -0.25, np.float32)})
        _wait(lambda: np.allclose(_w(b), 1.0), 20.0)
        np.testing.assert_allclose(_w(b), 1.0)
        _wait(lambda: a.metrics()["st_unknown_msgs_total"] == 3, 5.0)
        assert a.metrics()["st_unknown_msgs_total"] == 3
        assert a.threads_alive() and a._error is None


def test_engine_pause_holds_new_frames():
    """pause(): an add is held back until resume; then it arrives."""
    port = free_port()
    with _mk(port, {"w": np.zeros(256, np.float32)}) as a, _mk(port, {"w": np.zeros(256, np.float32)}) as b:
        a.pause()
        out0 = a.metrics()["st_frames_out_total"]
        a.add({"w": np.full(256, 0.5, np.float32)})
        time.sleep(0.3)
        assert a.metrics()["st_frames_out_total"] == out0 and not _w(b).any()
        a.pause(False)
        _wait(lambda: np.allclose(_w(b), 0.5), 20.0)
        np.testing.assert_allclose(_w(b), 0.5)


def test_one_transport_file_is_mapped():
    """The engine links the port's transport build by its hashed name, so
    the dynamic loader maps ONE port transport file, the one the ctypes
    binding loaded: the engine and the node handle share its globals."""
    code = (
        "import numpy as np\n"
        "from shared_tensor_tpu_torch import create_or_fetch, _build\n"
        f"p = create_or_fetch('127.0.0.1', {free_port()}, np.zeros(64, np.float32), host_tier=True)\n"
        "assert p._engine is not None\n"
        "maps = {l.split()[-1] for l in open('/proc/self/maps') if '.so' in l}\n"
        "transports = sorted(m for m in maps if 'libsttransport' in m)\n"
        "assert transports == [str(_build.transport_path())], transports\n"
        "assert str(_build.engine_path()) in maps and str(_build.codec_path()) in maps, maps\n"
        "p.close()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_failed_engine_build_raises_and_never_falls_back(tmp_path):
    """An engine that does not compile makes create_or_fetch(host_tier=True)
    raise with the compiler's message; only native_engine=False runs the
    Python host tier. The transport and codec builds are reused (copied)."""
    native = tmp_path / "native"
    native.mkdir()
    for name in (*_build.TRANSPORT_SOURCES, *_build.CODEC_SOURCES, *_build.ENGINE_SOURCES):
        shutil.copy(_build.NATIVE_DIR / name, native / name)
    with open(native / "stengine.cpp", "a") as f:
        f.write("\n#error deliberately broken engine\n")
    build = tmp_path / "build"
    build.mkdir()
    for lib in (_build.transport_path(), _build.codec_path()):
        shutil.copy(lib, build / lib.name)
    code = (
        "import pathlib, numpy as np\n"
        "import shared_tensor_tpu_torch._build as B\n"
        f"B.NATIVE_DIR, B.BUILD_DIR = pathlib.Path({str(native)!r}), pathlib.Path({str(build)!r})\n"
        "from shared_tensor_tpu_torch import Config, create_or_fetch\n"
        f"port = {free_port()}\n"
        "try:\n"
        "    create_or_fetch('127.0.0.1', port, np.zeros(64, np.float32), host_tier=True)\n"
        "except RuntimeError as e:\n"
        "    assert 'building the native engine failed' in str(e) and 'deliberately broken' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a broken engine build did not raise')\n"
        "p = create_or_fetch('127.0.0.1', port, np.zeros(64, np.float32), Config(native_engine=False), host_tier=True)\n"
        "assert p._engine is None and p.st.host_tier\n"
        "p.close()\n"
        "assert not list(B.BUILD_DIR.glob('libstengine*'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
