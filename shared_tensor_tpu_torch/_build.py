"""The port's own builds of the native libraries: the TCP transport, the
host codec loops and the link engine; and of the reference-protocol C
peer the compat tests and ``chip_smoke.py`` run beside the port.

The counterpart of ``shared_tensor_tpu/_build.py``, which runs ``make`` in
``native/`` and builds every native library in place. The port compiles
the sources of ``native/`` as they stand, with the flags of
``native/Makefile``'s rules, into ``csrc/build/`` (beside the CUDA
kernels):

- ``native/sttransport.cpp`` with ``g++`` (``$CXX``), the
  ``libsttransport.so`` rule;
- ``native/stcodec.c`` with ``gcc`` (``$CC``), the ``libstcodec.so`` rule;
- ``native/stengine.cpp`` with ``g++``, the ``libstengine.so`` rule, linked
  against the port's own transport and codec builds by their file names
  (``-l:<name>``) with ``-Wl,-rpath,$ORIGIN``. It is compiled to an object
  (the rule's flags and ``-c``) while the two libraries compile beside it,
  then linked: its compile is the longest of the three, and a first build
  (every run from a fresh checkout) would otherwise pay all three in turn;
- ``native/stc_harness.c``, a standalone C peer that speaks the reference
  wire format, with ``gcc``: the ``stc_harness`` rule (an executable).

Each library is named by a hash of its sources, its flags and the names
of the libraries it links, so an edit to any of them rebuilds it and the
ones that link it. The engine's ``DT_NEEDED`` entries are those hashed
names, which resolve to the very files ``comm/transport.py`` and
``ops/codec_np.py`` load with ctypes: the dynamic loader maps one copy of
each per process, so the engine shares the transport's globals (its
queues and rings) with the node handle it is given. The JAX package's
``native/*.so`` carry other names and stay separate objects.

It runs no ``make``, writes nothing into ``native/`` and never loads a
library that it did not build: a failed compile raises with the
compiler's output, and a missing compiler raises with its name. Each
output's build is serialised across processes by an ``fcntl`` lock of its
own in the build directory, so peers that start together (or a test run
with several workers) compile it once and never load a half-written file,
while different outputs compile in parallel.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "csrc" / "build"
HEADERS = ("st_annotations.h", "st_cv.h")
TRANSPORT_SOURCES = ("sttransport.cpp", *HEADERS)
CODEC_SOURCES = ("stcodec.c", *HEADERS)
ENGINE_SOURCES = ("stengine.cpp", *HEADERS)
#: native/Makefile: CXXFLAGS plus the libsttransport.so rule's -shared
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")
#: native/Makefile: the libstcodec.so rule
CC_FLAGS = ("-O3", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")
#: native/Makefile: CFLAGS of the stc_harness rule (its -lm -lpthread
#: follow the source)
HARNESS_FLAGS = ("-O2", "-Wall", "-Wextra")


@contextlib.contextmanager
def build_lock(name: str):
    """Exclusive inter-process lock on one output of the build directory."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".{name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _hashed(stem: str, sources, flags, links=(), suffix: str = ".so") -> Path:
    h = hashlib.sha256()
    for name in sources:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(flags).encode())
    for path in links:
        h.update(path.name.encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def transport_path() -> Path:
    """Where the transport library for the current sources lives."""
    return _hashed("libsttransport", TRANSPORT_SOURCES, CXX_FLAGS)


def codec_path() -> Path:
    """Where the codec library for the current sources lives."""
    return _hashed("libstcodec", CODEC_SOURCES, CC_FLAGS)


def engine_path() -> Path:
    """Where the engine library for the current sources (and the current
    transport and codec builds) lives."""
    return _hashed("libstengine", ENGINE_SOURCES, CXX_FLAGS, (transport_path(), codec_path()))


def _compile(out: Path, what: str, env_var: str, default: str, args) -> Path:
    """Run ``<compiler> *args(tmp)`` into ``out`` unless it exists, under
    ``out``'s own lock; returns ``out``."""
    with build_lock(out.name):
        if out.exists():
            return out
        cc = os.environ.get(env_var) or shutil.which(default)
        if not cc:
            raise RuntimeError(f"{default} not found: the native {what} cannot be built")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cc, *args(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building the native {what} failed ({' '.join(cmd)}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def build_transport() -> Path:
    """Compile the transport if the current sources are not built yet, and
    return the library's path. Raises ``RuntimeError`` if ``g++`` is
    missing or the compile fails."""
    src = str(NATIVE_DIR / "sttransport.cpp")
    return _compile(transport_path(), "transport", "CXX", "g++", lambda o: [*CXX_FLAGS, "-o", str(o), src])


def build_codec() -> Path:
    """Compile the host codec loops (``native/stcodec.c``) if need be and
    return the library's path. Raises ``RuntimeError`` if ``gcc`` is
    missing or the compile fails."""
    src = str(NATIVE_DIR / "stcodec.c")
    return _compile(codec_path(), "codec", "CC", "gcc", lambda o: [*CC_FLAGS, "-o", str(o), src])


def harness_path() -> Path:
    """Where the C reference peer for the current source lives."""
    return _hashed("stc_harness", ("stc_harness.c",), HARNESS_FLAGS, suffix="")


def build_harness() -> Path:
    """Compile the reference-protocol C peer (``native/stc_harness.c``:
    ``stc_harness <host> <port> <n> <seconds> <add> [children]``) if need
    be and return the executable's path. Raises ``RuntimeError`` if
    ``gcc`` is missing or the compile fails."""
    src = str(NATIVE_DIR / "stc_harness.c")
    return _compile(harness_path(), "reference peer", "CC", "gcc",
                    lambda o: [*HARNESS_FLAGS, "-o", str(o), src, "-lm", "-lpthread"])


def build_engine() -> Path:
    """Compile the link engine (``native/stengine.cpp``), and the transport
    and codec it links, if need be (the three compiles in parallel);
    returns the engine library's path. Raises ``RuntimeError`` if a
    compiler is missing or a compile fails."""
    out = engine_path()
    if out.exists():
        return out
    src = str(NATIVE_DIR / "stengine.cpp")
    obj_path = _hashed("stengine", ENGINE_SOURCES, CXX_FLAGS, suffix=".o")
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(build_transport), pool.submit(build_codec), pool.submit(
            _compile, obj_path, "engine", "CXX", "g++", lambda o: [*CXX_FLAGS, "-c", "-o", str(o), src])]
        transport, codec, obj = (j.result() for j in jobs)
    return _compile(
        out, "engine", "CXX", "g++",
        lambda o: [*CXX_FLAGS, "-o", str(o), str(obj), f"-L{BUILD_DIR}", f"-l:{transport.name}",
                   f"-l:{codec.name}", "-Wl,-rpath,$ORIGIN"],
    )
