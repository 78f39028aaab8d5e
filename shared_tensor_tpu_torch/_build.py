"""The port's own build of the native TCP transport.

The counterpart of ``shared_tensor_tpu/_build.py``, which runs ``make`` in
``native/`` and builds every native library in place. The port needs only
the transport and builds it itself: ``native/sttransport.cpp`` as it
stands, compiled with ``g++`` and the flags of ``native/Makefile``'s
``libsttransport.so`` rule into ``csrc/build/`` (beside the CUDA kernels),
named by a hash of the source, its two headers and the flags, so an edit
to any of them rebuilds it. It runs no ``make`` and writes nothing into
``native/``, and it never loads a library that it did not build: a
failed compile raises with the compiler's output.

Builds are serialised across processes by an ``fcntl`` lock in the build
directory, so peers that start together (or a test run with several
workers) compile once and never load a half-written file.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "csrc" / "build"
TRANSPORT_SOURCES = ("sttransport.cpp", "st_annotations.h", "st_cv.h")
#: native/Makefile: CXXFLAGS plus the libsttransport.so rule's -shared
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")


@contextlib.contextmanager
def build_lock():
    """Exclusive inter-process lock on the build directory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def transport_path() -> Path:
    """Where the transport library for the current sources lives."""
    h = hashlib.sha256()
    for name in TRANSPORT_SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsttransport-{h.hexdigest()[:16]}.so"


def build_transport() -> Path:
    """Compile the transport if the current sources are not built yet, and
    return the library's path. Raises ``RuntimeError`` if ``g++`` is
    missing or the compile fails."""
    out = transport_path()
    with build_lock():
        if out.exists():
            return out
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("g++ not found: the native transport cannot be built")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / "sttransport.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the native transport failed ({' '.join(cmd)}):\n{proc.stderr}"
            )
        os.replace(tmp, out)
    return out
