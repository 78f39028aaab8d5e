"""The port stands alone: importing shared_tensor_tpu_torch (every module of
it) loads no ``jax`` and nothing of ``shared_tensor_tpu``, and neither the
package nor chip_smoke.py names them in an import."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "shared_tensor_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "shared_tensor_tpu")


def test_import_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, shared_tensor_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('shared_tensor_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 8  # every module was imported


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"], ids=lambda p: p.name
)
def test_sources_name_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("module", ["shared_tensor_tpu_torch.ctl", "shared_tensor_tpu_torch.benchmarks.lifecycle",
                                    "shared_tensor_tpu_torch.benchmarks.shard_bench",
                                    "shared_tensor_tpu_torch.benchmarks.codec_lab",
                                    "shared_tensor_tpu_torch.benchmarks.fleet_health",
                                    "shared_tensor_tpu_torch.examples.example",
                                    "shared_tensor_tpu_torch.examples.serve_char_rnn",
                                    "shared_tensor_tpu_torch.benchmarks.train_bench",
                                    "shared_tensor_tpu_torch.benchmarks.mesh_timing",
                                    "shared_tensor_tpu_torch.benchmarks.profile_trace",
                                    "shared_tensor_tpu_torch.benchmarks.host_codec_bench",
                                    "shared_tensor_tpu_torch.benchmarks.cluster_chaos",
                                    "shared_tensor_tpu_torch.benchmarks.chaos_soak",
                                    "shared_tensor_tpu_torch.benchmarks.soak",
                                    "shared_tensor_tpu_torch.benchmarks.adaptive_ab",
                                    "shared_tensor_tpu_torch.benchmarks.e2e_sync",
                                    "shared_tensor_tpu_torch.benchmarks.e2e_artifact",
                                    "shared_tensor_tpu_torch.benchmarks.engine_sweep",
                                    "shared_tensor_tpu_torch.benchmarks.drain_tail"])
def test_cli_modules_load_no_jax(module):
    """The operator CLI, the benches and the examples, each run alone as
    ``python -m`` with ``--help``, load no jax and nothing of the JAX
    package."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage" in out.stdout


@pytest.mark.parametrize("module", ["map", "state", "engine_lane", "gather", "node", "__init__"])
def test_shard_modules_load_no_jax(module):
    """Each module of the sharded tensor, imported alone in a fresh
    interpreter, loads no jax and nothing of the JAX package (map.py is
    standard library only, in JAX too: the port keeps its own copy)."""
    name = "shared_tensor_tpu_torch.shard" + ("" if module == "__init__" else f".{module}")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["ops.codec_lab", "ops.codec_lab_torch", "parallel.ici_lab"])
def test_codec_lab_modules_load_no_jax(module):
    """Each module of the codec lab, imported alone in a fresh interpreter,
    loads no jax and nothing of the JAX package."""
    name = f"shared_tensor_tpu_torch.{module}"
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({name!r})\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_transport_builds_its_own_library_without_make(tmp_path):
    """The port's transport compiles its own copy of native/sttransport.cpp
    (csrc/native/) with g++ into its own build directory: no ``make``, no
    source read from and nothing written into native/, and no library
    loaded from native/. (The JAX package's own tests may run
    ``make`` in native/ at the same time, so the check is on the one
    compile command this process runs, not on native/'s contents.)"""
    from tests._ports import free_port

    code = (
        "import pathlib, subprocess, sys\n"
        "import shared_tensor_tpu_torch._build as B\n"
        f"B.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "calls, real = [], subprocess.run\n"
        "subprocess.run = lambda cmd, *a, **k: (calls.append(cmd), real(cmd, *a, **k))[1]\n"
        "from shared_tensor_tpu_torch.comm.transport import TransportNode\n"
        f"TransportNode('127.0.0.1', {free_port()}).close()\n"
        "assert len(calls) == 1 and pathlib.Path(calls[0][0]).name != 'make', calls\n"
        "out = pathlib.Path(calls[0][calls[0].index('-o') + 1])\n"
        "assert out.parent == B.BUILD_DIR, out\n"
        "assert [a for a in calls[0] if a.endswith('.cpp')] == [str(B.PORT_NATIVE_DIR / 'sttransport.cpp')]\n"
        "assert not [a for a in calls[0] if a.startswith(str(B.NATIVE_DIR))], calls[0]\n"
        "libs = {l.split()[-1] for l in open('/proc/self/maps') if '.so' in l}\n"
        "assert not [p for p in libs if p.startswith(str(B.NATIVE_DIR))], libs\n"
        "assert [p for p in libs if p.startswith(str(B.BUILD_DIR))], libs\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'shared_tensor_tpu')]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_every_native_build_reads_the_port_copies(tmp_path):
    """The codec, the engine (with the transport it links) and the C
    reference peer compile from the port's copies in csrc/native/ into the
    port's build directory: no compile reads a source of native/, and no
    library the process loads lies there."""
    code = (
        "import pathlib, subprocess, sys\n"
        "import shared_tensor_tpu_torch._build as B\n"
        f"B.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "calls, real = [], subprocess.run\n"
        "subprocess.run = lambda cmd, *a, **k: (calls.append(cmd), real(cmd, *a, **k))[1]\n"
        "from shared_tensor_tpu_torch.comm.engine import load_engine\n"
        "load_engine()\n"
        "B.build_harness()\n"
        "srcs = sorted(pathlib.Path(a).name for c in calls for a in c if a.endswith(('.c', '.cpp')))\n"
        "assert srcs == ['stc_harness.c', 'stcodec.c', 'stengine.cpp', 'sttransport.cpp'], srcs\n"
        "for c in calls:\n"
        "    assert pathlib.Path(c[0]).name != 'make', c\n"
        "    assert not [a for a in c if str(B.NATIVE_DIR) in a], c\n"
        "    assert all(pathlib.Path(a).parent == B.PORT_NATIVE_DIR for a in c if a.endswith(('.c', '.cpp'))), c\n"
        "    assert pathlib.Path(c[c.index('-o') + 1]).parent == B.BUILD_DIR, c\n"
        "libs = {l.split()[-1] for l in open('/proc/self/maps') if '.so' in l}\n"
        "assert not [p for p in libs if p.startswith(str(B.NATIVE_DIR))], libs\n"
        "mine = sorted(pathlib.Path(p).name.split('-')[0] for p in libs if p.startswith(str(B.BUILD_DIR)))\n"
        "assert mine == ['libstcodec', 'libstengine', 'libsttransport'], mine\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
