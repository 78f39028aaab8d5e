"""A multi-process churn soak of the native engine: evidence of the
delivery contract under link kills, leaves and rejoins, and crashes.

    python -m shared_tensor_tpu_torch.benchmarks.soak [--seconds S] [--crash] [--compat]

The counterpart of the root ``benchmarks/soak.py``, with its defaults,
knobs and JSON fields. A tree of five processes (a master in this process
and four joiners, each a port peer on the host tier's native engine, on
one ``{"w": N}`` table) streams for ``ST_SOAK_SECONDS``, counted from
when every joiner has joined: every peer adds linspace deltas on its own
cadence, and two chaos workers, every
``chaos_period`` seconds, alternately hard-drop their live uplink
(``node.drop_link``: a re-graft with the carried residual) and leave
gracefully (``leave``: seal, drain, close) to rejoin as a fresh peer. With
``ST_SOAK_CRASH=1`` the master also SIGKILLs a chaos worker every 20 s and
spawns a fresh one in its place; ``ST_SOAK_COMPAT=1`` runs the whole
profile on the reference's wire (no ACKs, so looser bounds).

The workers are spawned (``multiprocessing``'s "spawn"): nothing of this
process's state is forked into them, and they never make a CUDA context.
Each appends its adds and chaos events to a file of its own, which
survives a SIGKILL. The gates: a fresh verifier joining the quiesced tree
agrees with the master within ``0.01 + 2e-3 * max |state|``; the master's
state lies within the re-delivery noise bound of the exact sum of every
logged add, on each side (``2.0`` a link kill, ``5.0`` a crash; on the
reference wire ``4.0`` an event); every survivor's drain ok; every
graceful leave's verdict True (``leave_failures``: a leave whose drain
timed out owing mass); the population intact. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import glob
import json
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from .lifecycle import _free_port

PEERS = 4  # joiners; and the master
N = 8192
SECONDS = 300.0
#: Seconds between a chaos worker's events (a link kill, then a leave and
#: a rejoin, in turn).
CHAOS_PERIOD = 7.0
#: Seconds between the crash arm's SIGKILLs.
CRASH_PERIOD = 20.0


def _mk(port: int, n: int, compat: bool):
    from .. import Config, TransportConfig, create_or_fetch

    cfg = Config(transport=TransportConfig(peer_timeout_sec=30.0, wire_compat=True)) if compat else None
    return create_or_fetch("127.0.0.1", port, {"w": np.zeros(n, np.float32)}, cfg, timeout=60.0, host_tier=True)


def _worker(rank: int, port: int, n: int, compat: bool, chaos_period: float, stop_ev, exit_ev, out_q,
            ledger_dir: str, chaos: bool, ready) -> None:
    """One joiner: adds until ``stop_ev``, logging each add (and each chaos
    event) to its own append-only file, flushed a line at a time, so a
    SIGKILL loses at most the line being written; then drains, reports, and
    stays up until ``exit_ev`` so that its siblings finish through it.
    Releases ``ready`` once it has joined."""
    peer = _mk(port, n, compat)
    ready.release()
    rng = np.random.default_rng(rank)
    ledger = open(os.path.join(ledger_dir, f"ledger_{rank}.txt"), "a")
    kills = leaves = leave_failures = 0
    last_chaos = time.time()
    while not stop_ev.is_set():
        lo, hi = sorted(rng.uniform(-1, 1, size=2))
        peer.add({"w": np.linspace(lo, hi, n, dtype=np.float32)})
        ledger.write(f"A {float(lo)!r} {float(hi)!r}\n")
        ledger.flush()
        time.sleep(0.05 + 0.05 * rank / PEERS)
        if chaos and time.time() - last_chaos > chaos_period:
            last_chaos = time.time()
            if kills <= leaves:
                links = peer.node.links
                if links:
                    peer.node.drop_link(links[0])  # a hard uplink kill
                    kills += 1
                    ledger.write("K\n")
                    ledger.flush()
            else:
                # a graceful leave mid-stream: the sealed ingress re-routes
                # third-party mass in transit instead of losing it
                # its verdict: False means the drain timed out owing mass
                leave_failures += not peer.leave(timeout=30.0)
                leaves += 1
                ledger.write("L\n")
                ledger.flush()
                peer = _mk(port, n, compat)
    ok = peer.drain(timeout=90.0, tol=1e-30)
    ledger.close()
    out_q.put((rank, kills, leaves, ok, peer._engine is not None, peer.metrics()["st_frames_in_total"],
               leave_failures))
    exit_ev.wait(timeout=300)
    peer.close()


def run(seconds: float = SECONDS, n: int = N, crash: bool = False, compat: bool = False,
        chaos_period: float = CHAOS_PERIOD) -> dict:
    """The soak (module docstring). Returns the document; every process it
    started has ended by then."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    master = _mk(port, n, compat)
    stop_ev, exit_ev, out_q, ready = ctx.Event(), ctx.Event(), ctx.Queue(), ctx.Semaphore(0)
    ledger_dir = tempfile.mkdtemp(prefix="soak-ledgers-")
    procs = []
    verifier = None
    t_all = time.perf_counter()

    def spawn(rank: int, chaos: bool):
        p = ctx.Process(target=_worker, args=(rank, port, n, compat, chaos_period, stop_ev, exit_ev, out_q,
                                              ledger_dir, chaos, ready), daemon=True)
        p.start()
        return p

    try:
        for r in range(1, PEERS + 1):
            procs.append(spawn(r, r in (1, 3)))
            time.sleep(0.4)  # stagger the joins
        # the run's seconds start once every worker has joined: a worker's
        # start-up (a spawned interpreter, its imports, its join) takes
        # seconds on a loaded host, which would eat the chaos schedule
        for _ in range(PEERS):
            if not ready.acquire(timeout=120.0):
                raise RuntimeError("a soak worker did not join within 120 s")
        chaos_idx = [0, 2]  # procs of the chaos workers
        crashes = 0
        next_rank = PEERS + 1
        master_contrib = np.zeros(n, np.float64)
        rng = np.random.default_rng(0)
        t_end = time.time() + seconds
        last_crash = time.time()
        while time.time() < t_end:
            lo, hi = sorted(rng.uniform(-1, 1, size=2))
            d = np.linspace(lo, hi, n, dtype=np.float32)
            master.add({"w": d})
            master_contrib += d
            if crash and time.time() - last_crash > CRASH_PERIOD:
                last_crash = time.time()
                # SIGKILL a chaos worker (no drain, no seal) and replace it
                idx = chaos_idx[crashes % len(chaos_idx)]
                victim = procs[idx]
                if victim.is_alive():
                    victim.kill()
                    victim.join(timeout=10)
                    crashes += 1
                    procs[idx] = spawn(next_rank, True)
                    next_rank += 1
            time.sleep(0.05)
        stop_ev.set()
        live = [p for p in procs if p.is_alive()]
        # an unexpected worker death fails the soak instead of shrinking it
        population_ok = len(live) == PEERS
        results = [out_q.get(timeout=180) for _ in range(len(live))]
        # replay every worker's ledger (a SIGKILLed worker's last line may be torn)
        worker_contrib = np.zeros(n, np.float64)
        kills = leaves = 0
        for path in sorted(glob.glob(os.path.join(ledger_dir, "ledger_*.txt"))):
            with open(path) as f:
                for line in f:
                    if not line.endswith("\n"):
                        continue
                    if line.startswith("A "):
                        try:
                            _, lo, hi = line.split()
                            worker_contrib += np.linspace(float(lo), float(hi), n, dtype=np.float32).astype(np.float64)
                        except ValueError:
                            continue
                    elif line[0] == "K":
                        kills += 1
                    elif line[0] == "L":
                        leaves += 1
        settle_end = time.time() + 30
        prev = None
        while time.time() < settle_end:
            cur = master.read()["w"].numpy().copy()
            if prev is not None and np.array_equal(cur, prev):
                break
            prev = cur
            time.sleep(1.0)
        time.sleep(1.0)
        mv = master.read()["w"].numpy().astype(np.float64)
        signed = mv - (master_contrib + worker_contrib)
        neg_dev = float(-signed.min()) if signed.min() < 0 else 0.0
        pos_dev = float(signed.max()) if signed.max() > 0 else 0.0
        drains_ok = sum(1 for r in results if r[3])
        leave_failures = sum(r[6] for r in results)
        # agreement: a fresh verifier joins the quiesced tree and reaches
        # the master's state (state transfer and flood agree)
        verifier = _mk(port, n, compat)
        agreement_dev = float("inf")
        v_end = time.time() + 30
        while time.time() < v_end:
            vv = verifier.read()["w"].numpy().astype(np.float64)
            agreement_dev = float(np.abs(vv - master.read()["w"].numpy().astype(np.float64)).max())
            if agreement_dev < 1e-4:
                break
            time.sleep(0.5)
        exit_ev.set()
        # a hard link kill may re-deliver one link's window in flight
        # (~O(1) a element for these unit-range deltas); a crash also loses
        # the victim's adds not yet flooded onward. On the reference wire
        # (no ACKs) every event loses or doubles its TCP-buffered window.
        if compat:
            noise_bound = 4.0 * max(kills + leaves, 1) + 5.0 * crashes
        else:
            noise_bound = 2.0 * max(kills, 1) + 5.0 * crashes
        bar = 0.01 + 2e-3 * float(np.abs(mv).max())
        out = {
            "bench": "engine_churn_soak",
            "wire": "compat" if compat else "native",
            "n": n,
            "seconds": seconds,
            "peers": PEERS + 1,
            "hard_link_kills": kills,
            "process_crashes_sigkill": crashes,
            "graceful_leave_rejoin_cycles": leaves,
            "leave_failures": leave_failures,
            "final_drains_ok": f"{drains_ok}/{len(results)}",
            "population_ok": population_ok,
            "workers_on_engine": all(r[4] for r in results),
            "agreement_dev_master_vs_fresh_joiner": agreement_dev,
            "agreement_bar": round(bar, 4),
            "state_magnitude_max": round(float(np.abs(mv).max()), 2),
            "sum_dev_neg": neg_dev,
            "sum_dev_pos": pos_dev,
            "redelivery_noise_bound": noise_bound,
            "master_frames_in": master.metrics()["st_frames_in_total"],
            "pass": bool(agreement_dev < bar and neg_dev < noise_bound and pos_dev < noise_bound
                         and drains_ok == len(results) and population_ok and leave_failures == 0),
        }
    finally:
        stop_ev.set()
        exit_ev.set()
        if verifier is not None:
            verifier.close()
        master.close()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(ledger_dir, ignore_errors=True)
    out["wall_sec"] = time.perf_counter() - t_all
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=float(os.environ.get("ST_SOAK_SECONDS", str(SECONDS))))
    ap.add_argument("--crash", action="store_true", default=os.environ.get("ST_SOAK_CRASH", "0") == "1",
                    help="the SIGKILL arm")
    ap.add_argument("--compat", action="store_true", default=os.environ.get("ST_SOAK_COMPAT", "0") == "1",
                    help="the reference wire")
    args = ap.parse_args(argv)
    out = run(args.seconds, int(os.environ.get("ST_SOAK_N", str(N))), args.crash, args.compat)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
