"""The port's two root examples, run as a user runs them, on the CPU
(``--device cpu``): examples/example.py as a master and a joiner (both exit
0, and each replica takes in the other's adds), and
examples/serve_char_rnn.py in one process at a tiny width with one trainer
(it exits 0 and serves at least one sample). Each runs as ``python -m``
runs it; the joiner's interpreter starts beside the master's and runs its
module once the test lets it, so that the seconds its interpreter takes
to import torch on a loaded host do not outlast the master's 8 steps."""

import re
import subprocess
import sys
import time
from pathlib import Path

from tests._ports import free_port

ROOT = Path(__file__).resolve().parent.parent


def _module(name, *args, gated=False, **kw):
    """``python -m shared_tensor_tpu_torch.examples.<name> args``. A gated
    one imports the package, then waits for a line on its stdin before it
    runs the module as ``-m`` does (``runpy``, as ``__main__``, the same
    argv)."""
    mod = f"shared_tensor_tpu_torch.examples.{name}"
    if gated:
        code = ("import runpy, sys, shared_tensor_tpu_torch; sys.stdin.readline(); "
                f"runpy.run_module({mod!r}, run_name='__main__', alter_sys=True)")
        return subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)
    return subprocess.Popen([sys.executable, "-m", mod, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def _replicas(out):
    """The replicas a run printed, as lists of floats."""
    return [[float(v) for v in row.split(",")] for row in re.findall(r"tensor\(\[([^\]]*)\]", out)]


def test_example_master_and_joiner():
    port = str(free_port())
    # the joiner's interpreter imports torch beside the master's: under
    # load that import alone took 7.2 s, past the master's last step
    joiner = _module("example", "127.0.0.1", port, "--steps", "3", "--device", "cpu", gated=True)
    master = _module("example", "127.0.0.1", port, "--steps", "8", "--device", "cpu")
    try:
        first = master.stdout.readline()  # the master is up and has added once
        assert _replicas(first) == [[1.0, 2.0, 3.0, 4.0]], first
        time.sleep(1.5)
        joiner.stdin.write("\n")  # the joiner's module runs now, and joins
        joiner.stdin.flush()
        j_out, j_err = joiner.communicate(timeout=120)
        m_out, m_err = master.communicate(timeout=120)
    finally:
        master.kill()
        joiner.kill()
    assert joiner.returncode == 0, j_err[-2000:]
    assert master.returncode == 0, m_err[-2000:]
    j_rows, m_rows = _replicas(j_out), _replicas(first + m_out)
    assert len(j_rows) == 3 and len(m_rows) == 8
    # the joiner takes in the master's state: its replica outgrows the
    # seed plus its own two adds before its last print
    assert j_rows[-1][0] > 3.0 and all(b - a == 1.0 for a, b in zip(j_rows[-1], j_rows[-1][1:])), j_rows
    # the master's replica takes in the joiner's adds too: it grows faster
    # than its own adds alone
    assert m_rows[-1][0] > 1.0 + 7, m_rows


def test_serve_char_rnn_serves_in_one_process():
    proc = _module("serve_char_rnn", "--device", "cpu", "--port", str(free_port()), "--trainers", "1",
                   "--hidden", "16", "--batch", "2", "--seq", "8", "--sample-len", "8", "--serve-seconds", "2",
                   "--serve-interval", "0.2")
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-2000:]
    served = re.search(r"\[serve\] served (\d+) samples, (\d+) refused", out)
    assert served and int(served.group(1)) >= 1, out[-2000:]
    assert "[trainer0] step    0" in out
