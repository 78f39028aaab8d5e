"""ASan + UBSan and TSan over the port's own builds of the native trio.

The port binds its own copy of native/sttransport.cpp
(shared_tensor_tpu_torch/csrc/native/), native/stcodec.c and
native/stengine.cpp with ctypes through its own ``_SIGNATURES`` tables and
its own buffer lifetimes (numpy and torch memory handed to C, pooled send
slots, the engine's restore and snapshot arrays). tests/test_sanitizers.py
runs the JAX package's drive of the same C code under the sanitizers; this
file runs the port's: each arm builds the sanitizer variant of the three
libraries (``_build``, selected by ``ST_TORCH_SANITIZER``; hashed names in
csrc/build/, nothing in native/) and runs one port suite in a subprocess
that preloads the matching gcc runtime.

- ASan + UBSan (``address``): any AddressSanitizer report or UBSan
  ``runtime error:`` in the suite's processes fails the arm, and so does a
  red suite.
- TSan (``thread``): ``native/tsan.supp`` as it is; a report fails the arm
  when one of its stack frames lies in the port's builds (their hashed
  library names, or the native sources' lines, the transport's copy's
  among them, which only these -g builds carry). Accesses made in uninstrumented code (CPython, numpy, libtorch,
  libgomp, jaxlib and the JAX package's plain builds) are not tracked
  (``ignore_noninstrumented_modules``), and reports wholly inside such
  code are out of scope, as in the JAX package's arms. Torch's and
  OpenBLAS's thread pools
  are kept at one thread: a fork while such a pool is alive deadlocks
  inside libtsan (tests/test_sanitizers.py's module docstring).

Slow-marked, out of tier 1: ``pytest tests/test_torch_sanitizers.py -m slow``.
"""

import glob
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
NATIVE = REPO / "native"
SUITES = ("engine", "shm", "lifecycle", "shard_engine")
#: a TSan frame in the port's sanitizer builds
_OURS = re.compile(r"lib(?:sttransport|stcodec|stengine)-[0-9a-f]{16}\.so"
                   r"|native/(?:stengine\.cpp|sttransport\.cpp|stcodec\.c):")


def _runtime(name: str):
    """The gcc runtime ``name`` (the compiler that builds the variants), or
    None."""
    try:
        out = subprocess.run(["gcc", f"-print-file-name={name}"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return None
    p = pathlib.Path(out)
    return p if p.is_absolute() and p.exists() else None


def _build(sanitizer: str) -> list[str]:
    """Build the variant in a plain process (gcc needs no runtime) and
    return the three libraries' names; a failed build fails the arm."""
    code = ("from shared_tensor_tpu_torch import _build as b; b.build_engine(); "
            "print(b.transport_path().name, b.codec_path().name, b.engine_path().name)")
    proc = subprocess.run([sys.executable, "-c", code], env={**os.environ, "ST_TORCH_SANITIZER": sanitizer},
                          capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert proc.returncode == 0, f"the {sanitizer} build failed:\n{proc.stderr[-4000:]}"
    return proc.stdout.split()


def _env(sanitizer: str, logs: pathlib.Path) -> dict:
    env = {**os.environ, "ST_TORCH_SANITIZER": sanitizer, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    if sanitizer == "address":
        asan, ubsan = _runtime("libasan.so"), _runtime("libubsan.so")
        if asan is None or ubsan is None:
            pytest.skip("the gcc ASan/UBSan runtimes are not installed")
        env["LD_PRELOAD"] = f"{asan} {ubsan}"
        # reports of every process of the suite (its subprocesses inherit
        # this) go to files, and the first one ends its process
        env["ASAN_OPTIONS"] = f"detect_leaks=0,abort_on_error=1,log_path={logs / 'asan'}"
        env["UBSAN_OPTIONS"] = f"print_stacktrace=1,halt_on_error=1,log_path={logs / 'ubsan'}"
    else:
        tsan = _runtime("libtsan.so")
        if tsan is None:
            pytest.skip("the gcc TSan runtime is not installed")
        env["LD_PRELOAD"] = str(tsan)
        # every report in one run (the verdict is the scoped count below);
        # accesses that uninstrumented code makes through the runtime's
        # interceptors (torch's CPU kernels allocating and copying, CPython,
        # the JAX package's plain builds) are not tracked: they cannot race
        # in the port's builds' frames, and tracking them slowed the device
        # tier's plain-torch codec past the suites' deadlines
        env["TSAN_OPTIONS"] = (f"suppressions={NATIVE / 'tsan.supp'},halt_on_error=0,exitcode=0,"
                               f"ignore_noninstrumented_modules=1,log_path={logs / 'tsan'}")
    return env


def _tsan_reports(logs: pathlib.Path) -> list[str]:
    out = []
    for p in sorted(glob.glob(str(logs / "tsan*"))):
        text = pathlib.Path(p).read_text(errors="replace")
        for block in text.split("==================")[1:]:
            if "WARNING: ThreadSanitizer" not in block:
                continue
            # the access and lock stacks only: a "synchronized via sleep"
            # footnote may name a sleep in our code for two foreign accesses
            frames, skipping = [], False
            for line in block.splitlines():
                if "As if synchronized via sleep" in line:
                    skipping = True
                elif skipping and not line.strip():
                    skipping = False
                elif not skipping and line.lstrip().startswith("#"):
                    frames.append(line)
            if any(_OURS.search(f) for f in frames):
                out.append(f"==== {p}\n{block[:6000]}")
    return out


@pytest.mark.slow
@pytest.mark.parametrize("suite", SUITES)
@pytest.mark.parametrize("sanitizer", ["address", "thread"])
def test_port_suite_under_sanitizer(tmp_path, sanitizer, suite):
    names = _build(sanitizer)
    build_dir = REPO / "shared_tensor_tpu_torch" / "csrc" / "build"
    assert len(names) == 3 and all((build_dir / n).exists() for n in names)
    assert not any(n in os.listdir(NATIVE) for n in names)
    logs = tmp_path / "logs"
    logs.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", f"tests/test_torch_{suite}.py", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-m", "not slow"],
        env=_env(sanitizer, logs), capture_output=True, text=True, timeout=2400, cwd=str(REPO),
    )
    tail = f"stdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}"
    if sanitizer == "address":
        found = [pathlib.Path(p).read_text(errors="replace")[:6000] for p in sorted(glob.glob(str(logs / "*")))]
        assert not found, "\n".join(found)
        assert "AddressSanitizer" not in proc.stderr and "runtime error:" not in proc.stderr, tail
    else:
        reports = _tsan_reports(logs)
        assert not reports, f"{len(reports)} TSan report(s) in the port's builds:\n" + "\n".join(reports[:5])
    assert proc.returncode == 0, tail
