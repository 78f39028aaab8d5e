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


def test_transport_builds_its_own_library_without_make(tmp_path):
    """The port's transport compiles native/sttransport.cpp with g++ into its
    own build directory: no ``make``, nothing written into native/, and no
    library loaded from native/. (The JAX package's own tests may run
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
        "assert [a for a in calls[0] if a.startswith(str(B.NATIVE_DIR))] == [str(B.NATIVE_DIR / 'sttransport.cpp')]\n"
        "libs = {l.split()[-1] for l in open('/proc/self/maps') if '.so' in l}\n"
        "assert not [p for p in libs if p.startswith(str(B.NATIVE_DIR))], libs\n"
        "assert [p for p in libs if p.startswith(str(B.BUILD_DIR))], libs\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'shared_tensor_tpu')]\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
