"""The cluster lifecycle's kill-restore arm: a snapshot under chaos, the
whole tree killed, restarted from its shards and held against an
uninterrupted run; its ``--shm`` variant; and its sharded arm.

    python -m shared_tensor_tpu_torch.benchmarks.lifecycle [--shm] [--dir D] [--out FILE]
    python -m shared_tensor_tpu_torch.benchmarks.lifecycle --sharded [--dir D] [--out FILE]

The counterpart of the ``--kill-restore``, ``--shm`` and ``--sharded``
arms of the root ``benchmarks/cluster_chaos.py``, with its constants
(``cluster_chaos.py`` in this package dispatches its own flags of those
names here): a tree of ``NODES`` native-engine peers (``host_tier=True``)
on one ``N``-element table, the last node's uplink under 25% drop chaos
(``faults.to_env`` around its creation, so the engine injects it). The
steps:

1. ``ADDS`` seeded adds, alternating between the root and the chaotic
   node, 15 ms apart; mid-soak, with updates still in flight under the
   drops, the root takes a consistent-cut snapshot (``snapshot_cluster``,
   budget ``SNAP_BUDGET_S``).
2. Every node closes: the kill.
3. The tree restarts on a new port, each node from its shard
   (``LifecycleConfig.restore_path``), node 1 with v1 wire emission (the
   version-skew arm: old and new framings interoperate mid-upgrade); it
   must re-converge to the snapshot's total within ``RESTORE_BUDGET_S``.
4. ``max(4, ADDS // 2)`` more adds under the same chaos; every replica
   converges and drains.
5. An uninterrupted tree takes both schedules; its root's replica and the
   restored root's agree within 1e-3.

Gates: the snapshot succeeded within its budget, the restored tree
re-converged within its budget with two wire versions live, the chaos
fired and was repaired (retransmits > 0), both arms converged, the arms
agree, and the run's timeline replays through the protocol model
(``tools/protospec``, :func:`~shared_tensor_tpu_torch.benchmarks.conformance`)
with no violation and at least one routed event. ``--shm`` adds the
lane's gates: every writer link's data plane on the shared-memory rings
(``st_shm_active`` 2) at both ends before the kill and again after the
restart's fresh negotiation, lane traffic in both, and the root's digest
exact over ``STABLE_COUNTERS`` at the quiesce after the restore. The
sharded arm ends on the same conformance gate. Prints one JSON document on
its last line (and writes it to ``--out``); exits 1 when a gate fails.
``chip_smoke.py`` phase 16 calls :func:`run_kill_restore`.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np

#: The JAX arm's constants (benchmarks/cluster_chaos.py).
NODES = 7
N = 2048
ADDS = 40
SEED = 9
RESTORE_BUDGET_S = 45.0
SNAP_BUDGET_S = 30.0
#: Seconds for a snapshot's RESUME to reach every node after the root returns.
RELEASE_S = 5.0
#: Both arms' final replicas agree within this (drop chaos and go-back-N
#: converge exactly: the bound is float accumulation slack).
ARMS_BOUND = 1e-3
#: The sharded arm's table and the model's size over one node's allowance
#: (the JAX arm's ``ST_SHARD_N`` and ``ST_SHARD_FACTOR`` defaults).
SHARD_N = 16384
SHARD_FACTOR = 2
#: The events a chaos arm's recorder keeps: the whole run, so that the
#: conformance gate replays every barrier and link event (the default
#: postmortem window would roll early ones out and fake an imbalance).
CAPTURE_EVENTS = 500_000
#: The counters the root's in-band digest must equal the sum of the
#: nodes' registries over, at a quiesced instant (the root bench's).
STABLE_COUNTERS = (
    "st_frames_out_total", "st_frames_in_total", "st_updates_total",
    "st_msgs_out_total", "st_msgs_in_total",
    "st_retransmit_msgs_total", "st_dedup_discards_total",
    "st_traced_msgs_in_total",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def released(peers, budget: float) -> bool:
    """Every peer resumed from a barrier's pause within ``budget`` seconds."""
    deadline = time.monotonic() + budget
    while any(p._paused for p in peers):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def capture(hub) -> None:
    """Start a chaos arm's timeline: drain what the ring holds, clear the
    recorder and widen it to ``CAPTURE_EVENTS``."""
    hub.poll_native()
    hub.recorder.clear()
    hub.recorder.set_capacity(CAPTURE_EVENTS)


def quiesced_digest(peers, n_writers: int, n_extra: int = 0) -> tuple[bool, dict]:
    """Bottom-up digest beats (four rounds, so every level's totals reach
    the root whatever the tree's shape), then the root's cluster counters
    against the sum of the nodes' registries over ``STABLE_COUNTERS``.
    Exact when every writer is in the root's view (subscribers, up to
    ``n_extra``, may be) and every counter is equal. Returns (exact,
    {"nodes_seen", "counters": {name: {"cluster", "sum_of_registries"}}})."""
    for _ in range(4):
        for p in peers:
            if p._uplink is not None:
                p.push_digest()
        time.sleep(0.4)
    cluster = peers[0].metrics(cluster=True)
    snaps = [p.metrics() for p in peers]
    digest = {"nodes_seen": len(cluster["nodes"]), "counters": {}}
    exact = n_writers <= len(cluster["nodes"]) <= n_writers + n_extra
    for name in STABLE_COUNTERS:
        want = sum(s.get(name, 0) for s in snaps)
        got = cluster["counters"].get(name, 0)
        digest["counters"][name] = {"cluster": got, "sum_of_registries": want}
        exact = exact and got == want
    return bool(exact), digest


def _shm_tally(peers) -> tuple[int, int]:
    """(link ends on the rings, lane messages out) across the tree: a link
    counts once for each end whose data plane is on the rings (state 2)."""
    live = msgs = 0
    for p in peers:
        m = p.metrics()
        live += sum(1 for k, v in m.items() if k.startswith("st_shm_active") and v == 2)
        msgs += int(m.get("st_shm_msgs_out_total", 0))
    return live, msgs


def run_kill_restore(snapdir: str, nodes: int = NODES, n: int = N, adds: int = ADDS, seed: int = SEED,
                     shm: bool = False) -> dict:
    """The arm (module docstring); the shards go to ``snapdir``; ``shm``
    adds the lane's gates. Returns the report, its verdict under
    ``pass``."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, obs
    from shared_tensor_tpu_torch.benchmarks import conformance, gate_passes
    from shared_tensor_tpu_torch.comm import faults
    from shared_tensor_tpu_torch.config import FaultConfig, LifecycleConfig, ObsConfig

    chaos_idx = nodes - 1
    skew_idx = 1  # restarted with v1 emission
    zeros = np.zeros((n,), np.float32)
    env = faults.to_env(FaultConfig(enabled=True, seed=seed, drop_pct=0.25, only_link=1))
    rng = np.random.default_rng(seed)
    # one add schedule for both arms, before the snapshot and after the restore
    p1 = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for _ in range(adds)]
    p2 = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for _ in range(max(4, adds // 2))]
    total1 = np.sum(p1, axis=0, dtype=np.float64)
    total_all = total1 + np.sum(p2, axis=0, dtype=np.float64)

    def cfg(i: int, restore: str = "", skew: bool = False) -> Config:
        return Config(
            lifecycle=LifecycleConfig(node_name=f"n{i}", restore_path=restore),
            transport=TransportConfig(peer_timeout_sec=20.0, ack_timeout_sec=0.4),
            obs=ObsConfig(digest_interval_sec=0.2, trace_wire=not skew),
        )

    def build(port: int, restore_dir: str = "", skew: bool = False) -> list:
        peers = []
        try:
            for i in range(nodes):
                if i == chaos_idx:
                    os.environ["ST_FAULT_PLAN"] = env["ST_FAULT_PLAN"]
                try:
                    restore = os.path.join(restore_dir, f"shard_n{i}.npz") if restore_dir else ""
                    peers.append(create_or_fetch("127.0.0.1", port, zeros, cfg(i, restore, skew and i == skew_idx),
                                                 timeout=60.0, host_tier=True))
                finally:
                    os.environ.pop("ST_FAULT_PLAN", None)
        except BaseException:
            for p in peers:
                p.close()
            raise
        return peers

    def soak(peers, deltas) -> None:
        for i, d in enumerate(deltas):
            peers[0 if i % 2 else chaos_idx].add(d)
            time.sleep(0.015)

    def converge(peers, total, budget: float) -> bool:
        deadline = time.time() + budget
        while time.time() < deadline:
            if all(np.allclose(p.read().numpy(), total, atol=1e-3) for p in peers):
                return True
            time.sleep(0.05)
        return False

    def close(peers) -> None:
        for p in reversed(peers):  # leaves first: nobody re-grafts in the kill
            p.close()

    out: dict = {
        "bench": "lifecycle_kill_restore", "nodes": nodes, "n": n,
        "adds": {"phase1": len(p1), "phase2": len(p2)}, "seed": seed,
        "chaos": {"drop_pct": 0.25, "node_index": chaos_idx}, "skew_node": skew_idx,
        "budgets": {"restore_sec": RESTORE_BUDGET_S, "snapshot_sec": SNAP_BUDGET_S},
    }
    hub = obs.hub()
    capture(hub)
    t_all = time.perf_counter()
    # the kill-restore arm: a snapshot mid-soak, then the whole tree killed
    peers = build(_free_port())
    try:
        out["engine_tier"] = all(p._engine is not None for p in peers)
        soak(peers, p1)
        if shm:
            live, msgs = _shm_tally(peers)
            out["shm"] = {"pre_kill_lanes_live": live, "pre_kill_msgs": msgs}
        t0 = time.monotonic()
        res = peers[0].snapshot_cluster(snapdir, timeout=SNAP_BUDGET_S)
        out["snapshot"] = {"ok": res["ok"], "nodes": res["nodes"], "duration_sec": time.monotonic() - t0,
                           "barrier_sec": res["duration_sec"]}
        # the root returns once it sent RESUME; the kill waits for the
        # release to reach every node (a node killed while paused would end
        # the run paused, which the lifecycle spec forbids)
        out["snapshot"]["released"] = released(peers, RELEASE_S)
    finally:
        close(peers)
    t0 = time.monotonic()
    peers = build(_free_port(), restore_dir=snapdir, skew=True)
    try:
        restored = converge(peers, total1, RESTORE_BUDGET_S)
        out["restore"] = {"reconverged_pre_kill_mass": restored, "duration_sec": time.monotonic() - t0,
                          "wire_versions": sorted({p._wire_version for p in peers})}
        soak(peers, p2)
        t1 = time.monotonic()
        kr_converged = converge(peers, total_all, 120.0)
        out["restore"]["post_restore_converge_sec"] = time.monotonic() - t1
        kr_final = peers[0].read().numpy().astype(np.float64)
        drained = all(p.drain(timeout=30.0, tol=1e-30) for p in peers)
        snaps = [p.metrics() for p in peers]
        out["restored_arm"] = {
            "converged": kr_converged, "drained": drained,
            "retransmits": sum(int(s.get("st_retransmit_msgs_total", 0)) for s in snaps),
            "restore_total": sum(int(s.get("st_restore_total", 0)) for s in snaps),
        }
        if shm:
            # the restarted tree negotiated its lanes afresh, and the root's
            # digest must be exact at this quiesce: the lane lies below the
            # wire's sequence numbers, so no counter may drift because of it
            live, msgs = _shm_tally(peers)
            exact, digest = quiesced_digest(peers, nodes)
            out["shm"].update(restored_lanes_live=live, restored_msgs=msgs, digest_exact_at_quiesce=exact,
                              digest_counters=digest["counters"])
    finally:
        close(peers)
    # the uninterrupted arm: the same schedule, no kill
    peers = build(_free_port())
    try:
        soak(peers, p1)
        soak(peers, p2)
        t1 = time.monotonic()
        out["uninterrupted_arm"] = {"converged": converge(peers, total_all, 120.0),
                                    "converge_sec": time.monotonic() - t1}
        un_final = peers[0].read().numpy().astype(np.float64)
    finally:
        close(peers)
    conf = conformance(hub)
    out["conformance"] = conf
    dev = float(np.max(np.abs(kr_final - un_final)))
    out["arms_max_deviation"] = dev
    out["bound"] = ARMS_BOUND
    out["seconds"] = time.perf_counter() - t_all
    out["pass"] = bool(
        gate_passes(conf)
        and out["snapshot"]["ok"]
        and out["snapshot"]["duration_sec"] <= SNAP_BUDGET_S
        and out["snapshot"]["released"]
        and out["restore"]["reconverged_pre_kill_mass"]
        and out["restore"]["duration_sec"] <= RESTORE_BUDGET_S
        and len(out["restore"]["wire_versions"]) == 2  # the skew was real
        and out["restored_arm"]["converged"]
        and out["restored_arm"]["drained"]
        and out["restored_arm"]["retransmits"] >= 1  # the chaos fired and was repaired
        and out["uninterrupted_arm"]["converged"]
        and dev <= ARMS_BOUND
    )
    if shm:
        # every writer link's data plane on the rings at both ends, before
        # the kill and again after the restart; lane traffic in both
        want = 2 * (nodes - 1)
        s_ = out["shm"]
        s_["want_lanes"] = want
        out["pass"] = bool(
            out["pass"] and s_["pre_kill_lanes_live"] >= want and s_["restored_lanes_live"] >= want
            and s_["pre_kill_msgs"] >= 1 and s_["restored_msgs"] >= 1 and s_["digest_exact_at_quiesce"]
        )
        out["bench"] = "lifecycle_kill_restore_shm"
    return out


def run_sharded(snapdir: str, nodes: int = NODES, n: int = SHARD_N, adds: int = ADDS, seed: int = SEED) -> dict:
    """The sharded arm (module docstring); the shard-state files go to
    ``snapdir``. Returns the report, its verdict under ``pass``."""
    from shared_tensor_tpu_torch import obs
    from shared_tensor_tpu_torch.benchmarks import conformance
    from shared_tensor_tpu_torch.comm import faults
    from shared_tensor_tpu_torch.config import Config, FaultConfig, LifecycleConfig, ShardConfig, TransportConfig
    from shared_tensor_tpu_torch.ops.table import make_spec
    from shared_tensor_tpu_torch.shard import ShardGather, create_or_fetch_sharded
    from shared_tensor_tpu_torch.utils import checkpoint as ckpt

    tmpl = {"t": np.zeros(n, np.float32)}
    spec = make_spec(tmpl)
    full_bytes = spec.total * 4  # a full replica's floor
    bound = full_bytes // SHARD_FACTOR  # one node's allowance, checked at every sample
    chaos_idx = nodes - 1
    env = faults.to_env(FaultConfig(enabled=True, seed=seed, drop_pct=0.25, only_link=1))

    def cfg(i: int, restore: str = "") -> Config:
        return Config(
            shard=ShardConfig(n_shards=nodes, shard_index=i, restore_dir=restore),
            lifecycle=LifecycleConfig(node_name=f"s{i}"),
            transport=TransportConfig(peer_timeout_sec=20.0, ack_timeout_sec=0.4),
        )

    def build(port: int, restore_dir: str = "") -> list:
        handles = []
        try:
            for i in range(nodes):
                if i == chaos_idx:
                    os.environ["ST_FAULT_PLAN"] = env["ST_FAULT_PLAN"]
                try:
                    handles.append(create_or_fetch_sharded("127.0.0.1", port, tmpl, cfg(i, restore_dir),
                                                           timeout=60.0))
                finally:
                    os.environ.pop("ST_FAULT_PLAN", None)
        except BaseException:
            for h in handles:
                h.close()
            raise
        return handles

    # sparse adds (windows of about one shard): no writer needs the whole
    # table resident, which is the point of the sharded tensor
    rng = np.random.default_rng(seed)
    win = max(64, n // nodes)

    def mk_deltas(count: int) -> list:
        out = []
        for _ in range(count):
            lo = int(rng.integers(0, n - win))
            d = np.zeros(n, np.float32)
            d[lo:lo + win] = rng.uniform(-0.5, 0.5, win).astype(np.float32)
            out.append(d)
        return out

    p1 = mk_deltas(adds)
    p2 = mk_deltas(max(4, adds // 2))
    total1 = np.sum(p1, axis=0, dtype=np.float64)
    total_all = total1 + np.sum(p2, axis=0, dtype=np.float64)
    alloc = {"violations": 0, "peak": 0, "samples": 0, "stalls": 0}
    slice_bytes = (spec.total // nodes + 32) * 4  # one shard slice: the admission unit

    def soak(handles, deltas) -> None:
        for i, d in enumerate(deltas):
            h = handles[0 if i % 2 else chaos_idx]
            # a writer adds only while its resident bytes leave room for two
            # outbox slices (a window can straddle a shard boundary): the
            # backpressure a training step's sync point gives
            deadline = time.time() + 30.0
            while h.node.alloc_bytes() > bound - 2 * slice_bytes and time.time() < deadline:
                alloc["stalls"] += 1
                time.sleep(0.005)
            h.add({"t": d})
            for hh in handles:
                b = hh.node.alloc_bytes()
                alloc["samples"] += 1
                alloc["peak"] = max(alloc["peak"], b)
                alloc["violations"] += int(b > bound)
            time.sleep(0.015)

    def gathered(handles, total, budget: float, atol: float = 1e-3) -> tuple[bool, float]:
        deadline = time.time() + budget
        while time.time() < deadline:
            if all(h.node.drained() for h in handles):
                with ShardGather(handles[0].node, tmpl) as g:
                    got = np.asarray(g.read_tree(max_staleness=60.0)["t"])
                if np.allclose(got, total, atol=atol):
                    return True, float(np.max(np.abs(got - total)))
            time.sleep(0.25)
        with ShardGather(handles[0].node, tmpl) as g:
            got = np.asarray(g.read_tree(max_staleness=60.0)["t"])
        return False, float(np.max(np.abs(got - total)))

    out: dict = {
        "bench": "lifecycle_sharded", "nodes": nodes, "n_shards": nodes, "n": n,
        "adds": {"phase1": len(p1), "phase2": len(p2)}, "seed": seed,
        "chaos": {"drop_pct": 0.25, "only_link": 1, "node_index": chaos_idx},
        "memory_model": {"full_replica_bytes_per_node": full_bytes, "per_node_alloc_bound": bound,
                         "model_over_node_factor": SHARD_FACTOR},
        "budgets": {"restore_sec": RESTORE_BUDGET_S},
    }
    hub = obs.hub()
    capture(hub)
    t_all = time.perf_counter()
    handles = build(_free_port())
    try:
        out["sharded"] = all(h.sharded for h in handles)
        out["engine_lane"] = all(h.node._lane is not None for h in handles)
        t0 = time.monotonic()
        soak(handles, p1)
        ok1, dev1 = gathered(handles, total1, 120.0)
        out["pre_kill"] = {"converged": ok1, "max_dev": dev1, "seconds": time.monotonic() - t0}
        # steady state: outboxes drained and freed; the gather's legs tear
        # down asynchronously at each owner, so let them settle
        settle = time.time() + 5.0
        while time.time() < settle:
            steady = max(h.node.alloc_bytes() for h in handles)
            if steady <= full_bytes * 2.0 / nodes:
                break
            time.sleep(0.05)
        out["memory_model"]["steady_state_max_bytes"] = steady
        out["memory_model"]["steady_over_full_ratio"] = steady / full_bytes
        out["ownership_pre_kill"] = {str(i): h.node.owned_shards() for i, h in enumerate(handles)}
        t0 = time.monotonic()
        entries = [e for e in (h.node.save_shards(snapdir) for h in handles) if e is not None]
        ckpt.write_manifest(snapdir, "lifecycle-sharded", entries)
        out["snapshot"] = {"nodes": len(entries), "coverage_problems": ckpt.verify_shard_coverage(snapdir, nodes),
                           "duration_sec": time.monotonic() - t0}
    finally:
        for h in handles:
            h.close()  # the whole-cluster kill
    t0 = time.monotonic()
    handles = build(_free_port(), restore_dir=snapdir)
    try:
        ok_r, dev_r = gathered(handles, total1, RESTORE_BUDGET_S)
        out["restore"] = {"reconverged_pre_kill_mass": ok_r, "max_dev": dev_r, "duration_sec": time.monotonic() - t0}
        t0 = time.monotonic()
        soak(handles, p2)
        ok2, dev2 = gathered(handles, total_all, 120.0)
        out["restored_arm"] = {"converged": ok2, "max_dev": dev2, "seconds": time.monotonic() - t0}
        out["ownership_restored"] = {str(i): h.node.owned_shards() for i, h in enumerate(handles)}
        snaps = [h.node.metrics() for h in handles]
        out["fwd"] = {k: int(sum(s.get(k, 0) for s in snaps)) for k in (
            "st_shard_fwd_msgs_out_total", "st_shard_fwd_msgs_in_total", "st_shard_fwd_relayed_total",
            "st_shard_fwd_dedup_total", "st_shard_park_drops_total")}
        hub.poll_native()
        out["injected"] = {"fault_drop": hub.recorder.counts.get("fault_drop", 0)}
        out["alloc"] = dict(alloc)
    finally:
        for h in handles:
            h.close()
    conf = conformance(hub)
    out["conformance"] = conf
    out["seconds"] = time.perf_counter() - t_all
    out["pass"] = bool(
        conf["pass"]
        and out["sharded"]
        and out["pre_kill"]["converged"]
        and out["snapshot"]["coverage_problems"] == []
        and out["snapshot"]["nodes"] == nodes
        and out["restore"]["reconverged_pre_kill_mass"]
        and out["restore"]["duration_sec"] <= RESTORE_BUDGET_S
        and out["restored_arm"]["converged"]
        and out["ownership_restored"] == out["ownership_pre_kill"]  # every node re-owned its shards
        and out["injected"]["fault_drop"] >= 1  # the chaos fired on the FWD plane
        and out["fwd"]["st_shard_fwd_msgs_out_total"] >= 1
        and out["fwd"]["st_shard_park_drops_total"] == 0  # no silent loss
        and alloc["violations"] == 0
        and out["memory_model"]["steady_over_full_ratio"] <= 2.0 / nodes
    )
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="", help="the snapshot's directory (default: a new temporary one)")
    ap.add_argument("--out", default="", help="also write the JSON document here")
    ap.add_argument("--sharded", action="store_true", help="run the sharded arm instead")
    ap.add_argument("--shm", action="store_true", help="add the shared-memory lane's gates to kill-restore")
    args = ap.parse_args(argv)
    snapdir = args.dir or tempfile.mkdtemp(prefix="lifecycle-")
    out = run_sharded(snapdir) if args.sharded else run_kill_restore(snapdir, shm=args.shm)
    doc = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    if args.sharded:
        print(f"lifecycle --sharded: steady/full {out['memory_model']['steady_over_full_ratio']:.3f} (bound "
              f"{2.0 / NODES:.3f}), alloc violations {out['alloc']['violations']}/{out['alloc']['samples']}, drops "
              f"{out['injected']['fault_drop']}, restore {out['restore']['duration_sec']:.2f} s -> "
              f"{'PASS' if out['pass'] else 'FAIL'}", file=sys.stderr)
        print(doc)
        return out
    conf = out["conformance"]
    print(f"lifecycle kill-restore: snapshot {out['snapshot']['duration_sec']:.2f} s, restore "
          f"{out['restore']['duration_sec']:.2f} s, arms max dev {out['arms_max_deviation']:.2e}, conformance "
          f"{conf['routed_events']} routed/{len(conf['violations'])} violations -> "
          f"{'PASS' if out['pass'] else 'FAIL'}", file=sys.stderr)
    print(doc)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
