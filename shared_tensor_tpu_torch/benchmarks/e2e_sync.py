"""Two processes exchanging frames over loopback through the whole peer
stack, against the reference's end-to-end number.

    python -m shared_tensor_tpu_torch.benchmarks.e2e_sync

The counterpart of the root ``benchmarks/e2e_sync.py``, with its knobs and
JSON fields. The parent is a port peer on the device tier of the GPU
(``send_pipeline_depth`` ``ST_E2E_DEPTH`` = 8, ``device_frame_burst``
``ST_E2E_DEVICE_BURST`` = 0: K-frame device bursts), the master of one
``{"t": N}`` table; the child, in a subprocess that sees no GPU, is a port
peer on the host tier (the native engine). Both add a seeded normal delta
every ``ADD_PERIOD`` seconds, so the link never quiesces, and after
``ST_E2E_WARMUP`` seconds the parent counts the frames it sent and applied
and the bytes on its link over ``ST_E2E_SECONDS``. Equivalent bandwidth
counts the fp32 delta a frame applies (``N * 4`` bytes), as BASELINE.md
does; ``vs_baseline_out`` / ``vs_baseline_in`` hold each direction against
the reference's per-direction row at this ``N`` (:func:`baseline_equiv_bps`:
242 frames/s, 1.01 GB/s at 1 Mi, a CPU loopback probe of the reference's
C peer), ``vs_baseline`` their mean.

Arms: ``ST_E2E_PARENT_PLATFORM=cpu`` puts the parent on the host tier too
(no CUDA at all); ``ST_E2E_COMPAT=1`` runs both peers on the reference's
wire; ``ST_E2E_CHILD=c`` makes the child the reference C peer
(``native/stc_harness.c``, built by the port's ``_build.build_harness()``
into its own build directory), on the reference's wire. On a CUDA parent
the line also carries the launches of kernels A and B over the whole
exchange and both held against their plain versions on the parent's state
after it (``kernel_check``: 0 mismatches, or the exit status is 1).

Knobs: ``ST_E2E_N`` (1 Mi), ``ST_E2E_SECONDS`` (10), ``ST_E2E_WARMUP`` (3),
``ST_E2E_ADD_PERIOD`` (``max(0.2, N / 1 Mi * 0.05)``). Prints one JSON line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from . import REPO
from .lifecycle import _free_port

#: BASELINE.md's E2E rows: (n, equiv-fp32 bytes/s per link per direction)
#: of the reference's two-process loopback (78 k frames/s at 4 Ki, 242 at
#: 1 Mi, 7.8 at 16 Mi).
REF_ROWS = ((4096, 1.28e9), (1 << 20, 1.01e9), (16 << 20, 0.52e9))


def baseline_equiv_bps(n: int) -> float:
    """The reference's equiv-fp32 bytes/s per direction at ``n``:
    BASELINE.md's rows, log-interpolated between them and held flat past
    the ends."""
    if n <= REF_ROWS[0][0]:
        return REF_ROWS[0][1]
    if n >= REF_ROWS[-1][0]:
        return REF_ROWS[-1][1]
    for (n0, b0), (n1, b1) in zip(REF_ROWS, REF_ROWS[1:]):
        if n0 <= n <= n1:
            t = (math.log(n) - math.log(n0)) / (math.log(n1) - math.log(n0))
            return math.exp((1 - t) * math.log(b0) + t * math.log(b1))
    raise AssertionError(n)


#: The parent's timeline events that say its link was lost or re-made.
LINK_EVENTS = ("link_up", "link_down", "quarantine", "blackhole_teardown")


def add_period(n: int) -> float:
    """Seconds between adds on each side: an add is O(n) host work that
    must not crowd out the codec stream being measured."""
    return max(0.2, n / (1 << 20) * 0.05)


class ScaleTally:
    """The frames a Python-plane peer sends while attached, counted by the
    base-2 exponent of their largest (per-leaf, power-of-two) scale. It
    wraps the peer's ``finish_frame`` and ``finish_frame_burst``, which
    return the frames the wire carries."""

    def __init__(self, st):
        self.st, self.exps = st, []
        self._one, self._burst = st.finish_frame, st.finish_frame_burst
        st.finish_frame, st.finish_frame_burst = self._tally_one, self._tally_burst

    def _note(self, frame) -> None:
        self.exps.append(int(np.frexp(np.abs(np.asarray(frame.scales)).max())[1]) - 1)

    def _tally_one(self, frame):
        out = self._one(frame)
        if out is not None:
            self._note(out)
        return out

    def _tally_burst(self, frames):
        out = self._burst(frames)
        for f in out or ():
            self._note(f)
        return out

    def detach(self) -> dict:
        """Unwrap; returns {"frames", "max_scale_log2": {exponent: frames}}
        over the frames sent while attached."""
        del self.st.finish_frame, self.st.finish_frame_burst
        exps = list(self.exps)
        return {"frames": len(exps), "max_scale_log2": {str(e): exps.count(e) for e in sorted(set(exps))}}


def _mk_peer(port: int, n: int, wire_compat: bool, host_tier: bool, device=None, depth: int = 8,
             device_burst: int = 0):
    from .. import Config, TransportConfig, create_or_fetch

    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0, wire_compat=wire_compat),
                 send_pipeline_depth=depth, device_frame_burst=device_burst)
    return create_or_fetch("127.0.0.1", port, {"t": np.zeros((n,), np.float32)}, cfg, timeout=60.0,
                           device=device, host_tier=host_tier)


def child(port: int, n: int, wire_compat: bool, period: float, go_file: str = "") -> None:
    """The host-tier peer: once ``go_file`` exists (at once without one),
    join, then add until the parent kills it. Returns if the parent dies
    first."""
    parent = os.getppid()
    while go_file and not os.path.exists(go_file):
        if os.getppid() != parent:
            return
        time.sleep(0.02)
    peer = _mk_peer(port, n, wire_compat, host_tier=True)
    delta = {"t": np.random.default_rng(1).normal(size=n).astype(np.float32) * 1e-2}
    try:
        while True:
            peer.add(delta)  # residual mass stays alive: the link never idles
            time.sleep(period)
    except Exception:
        pass


class Child:
    """The exchange's child, started ahead of its parent on a port of its
    own. The host-tier child's process starts at once, in a process that
    sees no GPU (its imports take seconds), and joins once :meth:`go`
    writes its go file; the reference C peer, which cannot wait, starts at
    :meth:`go`."""

    def __init__(self, n: int, child_kind: str = "py", compat: bool = False, period=None, warmup: float = 3.0,
                 seconds: float = 10.0):
        import tempfile

        from .. import _build

        self.n, self.kind = n, child_kind
        self.wire_compat = child_kind == "c" or compat
        self.period = add_period(n) if period is None else period
        self.port = _free_port()
        self.err = tempfile.TemporaryFile()
        self.proc = None
        self._go = ""
        if child_kind == "c":
            self._cmd = [str(_build.build_harness()), "127.0.0.1", str(self.port), str(n),
                         str(warmup + seconds + 60), "1.0"]
            return
        # built here, the engine's compile would stall the child's join
        # (and a child killed mid-build would leave its build lock held)
        _build.build_engine()
        self._go = os.path.join(tempfile.gettempdir(), f"e2e-go-{os.getpid()}-{self.port}")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", ST_E2E_N=str(n), ST_E2E_ADD_PERIOD=str(self.period),
                   ST_E2E_COMPAT="1" if self.wire_compat else "0", ST_E2E_GO_FILE=self._go)
        self.proc = subprocess.Popen([sys.executable, "-m", "shared_tensor_tpu_torch.benchmarks.e2e_sync", "child",
                                      str(self.port)], env=env, cwd=REPO, stderr=self.err)

    def go(self) -> None:
        """The parent is listening: join it."""
        if self.proc is None:
            self.proc = subprocess.Popen(self._cmd, stdout=subprocess.DEVNULL, stderr=self.err)
        else:
            open(self._go, "w").close()

    def stop(self) -> str:
        """Stop the child; returns the tail of its stderr."""
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        if self._go and os.path.exists(self._go):
            os.unlink(self._go)
        self.err.seek(0)
        tail = self.err.read()[-2000:].decode(errors="replace")
        self.err.close()
        return tail


def run(n: int = 1 << 20, seconds: float = 10.0, warmup: float = 3.0, period=None, child_kind: str = "py",
        compat: bool = False, parent_host: bool = False, device=None, depth: int = 8, device_burst: int = 0,
        child: Child | None = None) -> dict:
    """One exchange (module docstring). ``parent_host`` puts the parent on
    the host tier, else on ``device``'s device tier (default: the GPU,
    which raises without one: the parent never carries on on the CPU). On
    a CUDA parent, A and B are held against their plain versions on its
    state after the window. ``child``: one started ahead (its kind, wire
    and add period then hold); else one is started here. Returns the row;
    the child is stopped."""
    from .. import obs
    from ..ops import codec_cuda as CC

    child = child or Child(n, child_kind, compat, period, warmup, seconds)
    period, wire_compat = child.period, child.wire_compat
    launches0 = dict(CC.LAUNCHES)
    counts = obs.hub().recorder.counts
    events0 = {k: counts.get(k, 0) for k in LINK_EVENTS}
    try:
        peer = _mk_peer(child.port, n, wire_compat, parent_host, device, depth, device_burst)
    except BaseException:
        child.stop()
        raise
    on_gpu = peer._engine is None and not peer.st.host_tier and peer.st.device.type == "cuda"
    try:
        child.go()
        proc = child.proc
        delta = {"t": np.random.default_rng(0).normal(size=n).astype(np.float32) * 1e-2}
        deadline = time.time() + 120
        while not peer.node.links and time.time() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(f"the child exited with {proc.returncode} before it joined")
            time.sleep(0.05)
        if not peer.node.links:
            raise RuntimeError("the child never joined")
        t_end = time.time() + warmup
        while time.time() < t_end:
            peer.add(delta)
            time.sleep(period)
        link = peer.node.links[0]
        s0 = peer.node.stats(link)
        f_out0, f_in0 = peer.st.frames_out, peer.st.frames_in
        tally = ScaleTally(peer.st) if peer._engine is None else None
        t0 = time.time()
        t_end = t0 + seconds
        while time.time() < t_end:
            peer.add(delta)
            time.sleep(period)
        dt = time.time() - t0
        scales = tally.detach() if tally is not None else None
        s1 = peer.node.stats(link)
        frames_out = (peer.st.frames_out - f_out0) / dt
        frames_in = (peer.st.frames_in - f_in0) / dt
        launches = {k: CC.LAUNCHES[k] - launches0[k] for k in ("quantize_rows", "apply_rows_batch")}
        child_rc = proc.poll()
        metrics = peer.metrics()
        master = None
        if on_gpu:
            from . import master_state

            master = master_state(peer, delta)
    finally:
        child_tail = child.stop()
        peer.close()
    equiv_out, equiv_in = frames_out * n * 4, frames_in * n * 4
    baseline = baseline_equiv_bps(n)
    out = {
        "metric": "e2e_host_sync",
        "wire": "compat" if wire_compat else "native",
        "n": n,
        "seconds": round(dt, 2),
        "backend": "cpu" if parent_host else peer.st.device.type,
        "on_tpu": False,  # the root bench's field: this parent is never on a TPU
        "on_gpu": on_gpu,
        "parent_tier": "engine" if peer._engine is not None else "host" if peer.st.host_tier else "device",
        "child": "stc_harness" if child.kind == "c" else "port-host-tier",
        "frames_out_per_s": round(frames_out, 1),
        "frames_in_per_s": round(frames_in, 1),
        "wire_out_GBps": round((s1.bytes_out - s0.bytes_out) / dt / 1e9, 4),
        "wire_in_GBps": round((s1.bytes_in - s0.bytes_in) / dt / 1e9, 4),
        "equiv_out_GBps": round(equiv_out / 1e9, 3),
        "equiv_in_GBps": round(equiv_in / 1e9, 3),
        "baseline_equiv_GBps": round(baseline / 1e9, 3),
        # the reference streams full duplex too: its row is per direction,
        # so each direction is held against it, never their sum
        "vs_baseline_out": round(equiv_out / baseline, 2),
        "vs_baseline_in": round(equiv_in / baseline, 2),
        "vs_baseline": round((equiv_out + equiv_in) / 2 / baseline, 2),
        # the link's health over the run: a child that died or a link torn
        # down and re-made would make the rates above mean something else
        "child_alive_at_end": child_rc is None,
        "link_events": {k: counts.get(k, 0) - events0[k] for k in LINK_EVENTS},
        "retransmits": int(metrics.get("st_retransmit_msgs_total", 0)),
        # the parent's sent frames over the window (a Python-plane parent)
        # by the exponent of their largest scale: an add's first frame
        # carries about 2^-7 here; a link that never quiesces streams on
        # at exponents far below it
        "frame_scales": scales,
    }
    if on_gpu:
        out["launches"] = launches
        if master is not None:
            if not master[1]:
                raise RuntimeError(f"no live link on the parent at the end of the window: {out}; the child's "
                                   f"stderr ends with {child_tail!r}")
            from . import kernel_check

            out["kernel_check"] = kernel_check(master, peer.st.spec)
    return out


def _env() -> dict:
    e = os.environ.get
    n = int(e("ST_E2E_N", str(1 << 20)))
    return {
        "n": n, "seconds": float(e("ST_E2E_SECONDS", "10")), "warmup": float(e("ST_E2E_WARMUP", "3")),
        "period": float(e("ST_E2E_ADD_PERIOD", str(add_period(n)))), "child_kind": e("ST_E2E_CHILD", "py"),
        "compat": e("ST_E2E_COMPAT", "0") == "1", "parent_host": e("ST_E2E_PARENT_PLATFORM", "") == "cpu",
        "depth": int(e("ST_E2E_DEPTH", "8")), "device_burst": int(e("ST_E2E_DEVICE_BURST", "0")),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["child"]:
        cfg = _env()
        child(int(argv[1]), cfg["n"], cfg["compat"], cfg["period"], os.environ.get("ST_E2E_GO_FILE", ""))
        return 0
    if argv[:1] in (["-h"], ["--help"]):
        print(f"usage: python -m shared_tensor_tpu_torch.benchmarks.e2e_sync\n\n{__doc__}")
        return 0
    out = run(**_env())
    print(json.dumps(out), flush=True)
    bad = {k: v["mismatches"] for k, v in out.get("kernel_check", {}).items() if v["mismatches"]}
    return 1 if bad or (out["on_gpu"] and not all(out["launches"].values())) else 0


if __name__ == "__main__":
    sys.exit(main())
