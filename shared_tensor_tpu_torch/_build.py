"""The port's own builds of the native libraries: the TCP transport, the
host codec loops and the link engine; and of the reference-protocol C
peer the compat tests and ``chip_smoke.py`` run beside the port.

The counterpart of ``shared_tensor_tpu/_build.py``, which runs ``make`` in
``native/`` and builds every native library in place. The port compiles
its own copies of those sources, ``csrc/native/`` (``PORT_NATIVE_DIR``:
``sttransport.cpp``, ``stcodec.c``, ``stengine.cpp``, ``stc_harness.c``
and the two headers they include), with the flags of
``native/Makefile``'s rules, into ``csrc/build/`` (beside the CUDA
kernels). The transport's copy repairs the shared-memory lane's liveness
and a re-grafted node's redirect address (a second listener there, beside
the first); the engine's keeps a severed uplink's rolled-back messages
until the re-join's WELCOME, so that the prefix the parent applied is
retracted, and reports a detached link's applied count. Nothing is read
from ``native/``:

- ``sttransport.cpp`` with ``g++`` (``$CXX``), the ``libsttransport.so``
  rule;
- ``stcodec.c`` with ``gcc`` (``$CC``), the ``libstcodec.so`` rule;
- ``stengine.cpp`` with ``g++``, the ``libstengine.so`` rule, linked
  against the port's own transport and codec builds by their file names
  (``-l:<name>``) with ``-Wl,-rpath,$ORIGIN``. It is compiled to an object
  (the rule's flags and ``-c``) while the two libraries compile beside it,
  then linked: its compile is the longest of the three, and a first build
  (every run from a fresh checkout) would otherwise pay all three in turn;
- ``stc_harness.c``, a standalone C peer that speaks the reference wire
  format, with ``gcc``: the ``stc_harness`` rule (an executable).

Each library is named by a hash of its sources, its flags and the names
of the libraries it links, so an edit to any of them rebuilds it and the
ones that link it. The engine's ``DT_NEEDED`` entries are those hashed
names, which resolve to the very files ``comm/transport.py`` and
``ops/codec_np.py`` load with ctypes: the dynamic loader maps one copy of
each per process, so the engine shares the transport's globals (its
queues and rings) with the node handle it is given. The JAX package's
``native/*.so`` carry other names and stay separate objects.

Two sanitizer variants of the three libraries exist for
``tests/test_torch_sanitizers.py``, with the flags of the Makefile's
``sanitize`` and ``tsan`` rules appended to each rule's own: the
environment variable ``ST_TORCH_SANITIZER`` (``address``: ASan and UBSan;
``thread``: TSan), which nothing else reads, selects one for every build
of the process. The flags are part of each hash, so the variants live
beside the plain builds under names of their own; a variant loads only
into a process that preloads the matching runtime, and an unknown value
raises. The C reference peer is always the plain build.

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

#: the JAX package's native sources, which the port copies and never builds
NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
#: the port's own copies of the native sources, which it builds
PORT_NATIVE_DIR = Path(__file__).resolve().parent / "csrc" / "native"
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
#: native/Makefile: SAN_FLAGS and TSAN_FLAGS, by ST_TORCH_SANITIZER value
SANITIZER_FLAGS = {
    "address": ("-g", "-O1", "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
                "-fno-omit-frame-pointer"),
    "thread": ("-g", "-O1", "-fsanitize=thread", "-fno-omit-frame-pointer"),
}


def sanitizer() -> str:
    """The sanitizer variant this process builds and loads: ``""`` (the
    plain build), ``"address"`` or ``"thread"`` (``ST_TORCH_SANITIZER``)."""
    name = os.environ.get("ST_TORCH_SANITIZER", "")
    if name and name not in SANITIZER_FLAGS:
        raise ValueError(f"ST_TORCH_SANITIZER={name!r}: expected one of {sorted(SANITIZER_FLAGS)} or unset")
    return name


def _cxx_flags() -> tuple:
    return CXX_FLAGS + SANITIZER_FLAGS.get(sanitizer(), ())


def _cc_flags() -> tuple:
    return CC_FLAGS + SANITIZER_FLAGS.get(sanitizer(), ())


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
        h.update((PORT_NATIVE_DIR / name).read_bytes())
    h.update(" ".join(flags).encode())
    for path in links:
        h.update(path.name.encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def transport_path() -> Path:
    """Where the transport library for the current sources lives."""
    return _hashed("libsttransport", TRANSPORT_SOURCES, _cxx_flags())


def codec_path() -> Path:
    """Where the codec library for the current sources lives."""
    return _hashed("libstcodec", CODEC_SOURCES, _cc_flags())


def engine_path() -> Path:
    """Where the engine library for the current sources (and the current
    transport and codec builds) lives."""
    return _hashed("libstengine", ENGINE_SOURCES, _cxx_flags(), (transport_path(), codec_path()))


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
    """Compile the transport (the port's ``csrc/native/sttransport.cpp``)
    if the current sources are not built yet, and
    return the library's path. Raises ``RuntimeError`` if ``g++`` is
    missing or the compile fails."""
    src = str(PORT_NATIVE_DIR / "sttransport.cpp")
    return _compile(transport_path(), "transport", "CXX", "g++", lambda o: [*_cxx_flags(), "-o", str(o), src])


def build_codec() -> Path:
    """Compile the host codec loops (``csrc/native/stcodec.c``) if need be and
    return the library's path. Raises ``RuntimeError`` if ``gcc`` is
    missing or the compile fails."""
    src = str(PORT_NATIVE_DIR / "stcodec.c")
    return _compile(codec_path(), "codec", "CC", "gcc", lambda o: [*_cc_flags(), "-o", str(o), src])


def harness_path() -> Path:
    """Where the C reference peer for the current source lives."""
    return _hashed("stc_harness", ("stc_harness.c",), HARNESS_FLAGS, suffix="")


def build_harness() -> Path:
    """Compile the reference-protocol C peer (``csrc/native/stc_harness.c``:
    ``stc_harness <host> <port> <n> <seconds> <add> [children]``) if need
    be and return the executable's path. Raises ``RuntimeError`` if
    ``gcc`` is missing or the compile fails."""
    src = str(PORT_NATIVE_DIR / "stc_harness.c")
    return _compile(harness_path(), "reference peer", "CC", "gcc",
                    lambda o: [*HARNESS_FLAGS, "-o", str(o), src, "-lm", "-lpthread"])


def build_engine() -> Path:
    """Compile the link engine (``csrc/native/stengine.cpp``), and the transport
    and codec it links, if need be (the three compiles in parallel);
    returns the engine library's path. Raises ``RuntimeError`` if a
    compiler is missing or a compile fails."""
    out = engine_path()
    if out.exists():
        return out
    src = str(PORT_NATIVE_DIR / "stengine.cpp")
    flags = _cxx_flags()
    obj_path = _hashed("stengine", ENGINE_SOURCES, flags, suffix=".o")
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(build_transport), pool.submit(build_codec), pool.submit(
            _compile, obj_path, "engine", "CXX", "g++", lambda o: [*flags, "-c", "-o", str(o), src])]
        transport, codec, obj = (j.result() for j in jobs)
    return _compile(
        out, "engine", "CXX", "g++",
        lambda o: [*flags, "-o", str(o), str(obj), f"-L{BUILD_DIR}", f"-l:{transport.name}",
                   f"-l:{codec.name}", "-Wl,-rpath,$ORIGIN"],
    )
