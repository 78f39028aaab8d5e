"""A seven-node cluster under drop chaos, held to the observability plane's
gates and to the protocol model.

    python -m shared_tensor_tpu_torch.benchmarks.cluster_chaos OUT [--subscribers K] [--stripes K]
    python -m shared_tensor_tpu_torch.benchmarks.cluster_chaos OUT --kill-restore | --shm | --sharded

The counterpart of the root ``benchmarks/cluster_chaos.py``'s ``main()``,
with its defaults, knobs and JSON fields: a binary tree of ``NODES``
native-engine peers (``host_tier=True``) on one ``N``-element table, the
deep leaf (the last node) under a seeded 25% drop schedule on its uplink
(``faults.to_env`` around its creation, so its engine injects it). The root
and the chaotic leaf take ``ADDS`` uniform adds in turn, 15 ms apart; then
every replica must reach the exact total (1e-4) and drain. The gates:

- trace-path contiguity: at least 99% of the delivered update generations
  rebuild a contiguous hop path from the ``trace_apply`` records, over at
  least ``ADDS // 2`` paths;
- digest exactness: after bottom-up digest beats at the quiesced instant,
  the root's cluster counters equal the sum of the nodes' registries over
  ``lifecycle.STABLE_COUNTERS``;
- the chaos fired (``fault_drop`` >= 1) and was repaired (``retransmit``
  >= 1, exact convergence, every drain ok);
- conformance: the run's timeline replays through ``tools/protospec`` with
  no violation and at least one routed event
  (:func:`shared_tensor_tpu_torch.benchmarks.conformance`).

``--subscribers K`` (``ST_CLUSTER_SUBSCRIBERS``) grafts K read-only serving
leaves directly below the chaotic node, whose drop schedule then covers
every link of it (``only_link=0``): reads either verify ``SUB_BOUND`` or
raise, every subscriber reaches the total at the quiesce, and the writer
tree still converges and drains. ``--stripes K`` (``ST_CLUSTER_STRIPES``)
stripes every link over K sockets and severs the chaotic uplink's last
stripe after ``SEVER_AFTER`` frames (``only_stripe``,
``sever_after_frames``): the link must degrade to its surviving stripes or
take go-back-N's teardown into a re-graft, never wedge.
``--kill-restore``, ``--shm`` and ``--sharded`` (``ST_CLUSTER_KILL_RESTORE``,
``ST_CLUSTER_SHM``, ``ST_CLUSTER_SHARDED``) run
:func:`~shared_tensor_tpu_torch.benchmarks.lifecycle.run_kill_restore` (with
``shm=True`` for ``--shm``) and ``run_sharded``. ``ST_CLUSTER_TRACE_OUT``
writes the run's Chrome trace (``obs/trace_export``),
``ST_CLUSTER_TIMELINE_OUT`` its raw timeline (``ObsHub.export_timeline``).

Knobs: ``ST_CLUSTER_NODES`` (7), ``ST_CLUSTER_N`` (2048),
``ST_CLUSTER_ADDS`` (40), ``ST_CLUSTER_SEED`` (9). Prints the JSON document
and writes it to OUT, which has no default: the root bench's defaults
(``CHAOS_r09.json`` and the like) name the JAX package's committed
artifacts. Exits 1 when a gate fails. The peers run on the CPU: this bench
runs no CUDA kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .lifecycle import _free_port, capture, quiesced_digest

#: Frames the chaotic node's targeted stripe carries before its sever fires.
SEVER_AFTER = 4
#: The staleness bound (seconds) a subscriber's read must verify, or raise.
SUB_BOUND = float(os.environ.get("ST_CLUSTER_SUB_BOUND", "0.75"))
#: Seconds for the writers' convergence, and then the subscribers'.
CONVERGE_S = 120.0
SUB_CONVERGE_S = 90.0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def run(nodes: int = 7, n: int = 2048, adds: int = 40, seed: int = 9, subs: int = 0, stripes: int = 1) -> dict:
    """The base arm, with ``subs`` subscribers or ``stripes`` stripes a
    link (module docstring). Returns the report, its verdict under
    ``pass``."""
    from shared_tensor_tpu_torch import Config, TransportConfig, create_or_fetch, obs, serve
    from shared_tensor_tpu_torch.benchmarks import conformance, gate_passes
    from shared_tensor_tpu_torch.comm import faults
    from shared_tensor_tpu_torch.config import FaultConfig, ObsConfig
    from shared_tensor_tpu_torch.obs import trace_export
    from shared_tensor_tpu_torch.serve import StalenessError

    hub = obs.hub()
    capture(hub)
    cfg = Config(
        transport=TransportConfig(peer_timeout_sec=20.0, ack_timeout_sec=0.4, stripe_count=max(1, min(8, stripes))),
        obs=ObsConfig(digest_interval_sec=0.2),
    )
    zeros = np.zeros((n,), np.float32)
    chaos_idx = nodes - 1  # the deep leaf, which also adds
    # with subscribers the chaotic node's schedule covers all its links, so
    # the unledgered subscriber links face the drops too; the striped arm
    # also severs one stripe socket of its uplink mid-stream
    env = faults.to_env(FaultConfig(
        enabled=True, seed=seed, drop_pct=0.25, only_link=0 if subs > 0 else 1,
        only_stripe=stripes - 1 if stripes > 1 else -1, sever_after_frames=SEVER_AFTER if stripes > 1 else 0,
    ))
    t_all = time.perf_counter()
    port = _free_port()
    peers, subscribers = [], []

    def close_all() -> None:
        for s in subscribers:
            s.close()
        for p in reversed(peers):
            p.close()

    try:
        for i in range(nodes):
            if i == chaos_idx:
                os.environ["ST_FAULT_PLAN"] = env["ST_FAULT_PLAN"]
            try:
                peers.append(create_or_fetch("127.0.0.1", port, zeros, cfg, timeout=60.0, host_tier=True))
            finally:
                os.environ.pop("ST_FAULT_PLAN", None)
        chaos_port = peers[chaos_idx].node.listen_port
        for _ in range(subs):
            subscribers.append(serve.subscribe("127.0.0.1", chaos_port, zeros, cfg, timeout=60.0))
    except BaseException:
        close_all()
        raise

    out: dict = {
        "bench": "cluster_chaos", "nodes": nodes, "n": n, "adds": adds, "seed": seed,
        "engine_tier": all(p._engine is not None for p in peers),
        "chaos": {"drop_pct": 0.25, "only_link": 1, "node_index": chaos_idx},
    }
    if subs > 0:
        out["chaos"]["only_link"] = 0
        out["subscribers"] = {"count": subs, "max_staleness_sec": SUB_BOUND}
    if stripes > 1:
        out["chaos"]["severed_stripe"] = stripes - 1
        out["chaos"]["sever_after_frames"] = SEVER_AFTER
        out["stripes"] = {"count": stripes}
    try:
        reads_ok = reads_refused = 0  # mid-chaos tallies
        q_ok = q_refused = 0  # at the quiesce
        total = np.zeros(n, np.float64)
        rng = np.random.default_rng(0)
        t0 = time.monotonic()
        for i in range(adds):
            d = rng.uniform(-0.5, 0.5, n).astype(np.float32)
            peers[0 if i % 2 else chaos_idx].add(d)
            total += d
            # the serving contract mid-chaos: a read verifies its bound or raises
            for s in subscribers:
                try:
                    s.read(max_staleness=SUB_BOUND)
                    reads_ok += 1
                except StalenessError:
                    reads_refused += 1
            time.sleep(0.015)
        out["adds_sec"] = time.monotonic() - t0

        t0 = time.monotonic()
        deadline = time.time() + CONVERGE_S
        converged = [False] * nodes
        while time.time() < deadline and not all(converged):
            for i, p in enumerate(peers):
                if not converged[i]:
                    converged[i] = bool(np.allclose(p.read().numpy(), total, atol=1e-4))
            time.sleep(0.05)
        out["converge_sec"] = time.monotonic() - t0
        drained = all(p.drain(timeout=30.0, tol=1e-30) for p in peers)

        # once the writers quiesce, every subscriber's verified read reaches
        # the total (resyncs repair what the drops swallowed)
        sub_converged = [False] * len(subscribers)
        sub_deadline = time.time() + SUB_CONVERGE_S
        while time.time() < sub_deadline and not all(sub_converged):
            for i, s in enumerate(subscribers):
                if not sub_converged[i]:
                    try:
                        v = np.asarray(s.read(max_staleness=SUB_BOUND))
                        sub_converged[i] = bool(np.allclose(v, total, atol=1e-3))
                        q_ok += 1
                    except StalenessError:
                        q_refused += 1
            time.sleep(0.05)

        hub.poll_native()
        timeline = hub.recorder.timeline()
        stats = trace_export.path_stats(trace_export.trace_paths(timeline))
        counts = hub.recorder.counts
        # subscribers' digests ride the same control plane on their own
        # beat: their presence in the root's view is allowed, not required
        digest_exact, digest = quiesced_digest(peers, nodes, len(subscribers))
        snaps = [p.metrics() for p in peers]
        staleness = [v for s in snaps for k, v in s.items() if k.startswith("st_staleness_seconds")
                     and isinstance(v, (int, float))]
        if stripes > 1:
            # the sever killed one socket of the chaotic uplink: the link
            # degraded to the survivors, or reassembly wedged on a swallowed
            # stripe seq and go-back-N tore it down into a re-graft; a wedged
            # link fails convergence before this
            per_link = []
            for i, p in enumerate(peers):
                for link in list(p.node.links or ()):
                    ss = p.node.stripe_stats(link)
                    if ss is not None and ss["stripes"] > 1:
                        per_link.append({"node": i, "link": link, **ss})
            degraded = [s for s in per_link if s["deaths"] >= 1 and s["live"] == s["stripes"] - s["deaths"]]
            teardowns = counts.get("blackhole_teardown", 0)
            out["stripes"].update(
                links_striped=len(per_link), deaths=sum(s["deaths"] for s in per_link),
                reroutes=sum(s["reroutes"] for s in per_link), degraded_links=len(degraded),
                stripe_down_events=counts.get("stripe_down", 0), gbn_teardowns=teardowns,
                outcome=("degraded-to-survivors" if degraded else "gbn-teardown-regraft" if teardowns >= 1
                         else "none-observed"),
            )
        if subscribers:
            sm = [s.metrics() for s in subscribers]
            out["subscribers"].update(
                converged_all=all(sub_converged), reads_ok_mid_chaos=reads_ok, reads_refused_mid_chaos=reads_refused,
                reads_ok_at_quiesce=q_ok, reads_refused_at_quiesce=q_refused,
                resyncs=sum(int(m["st_sub_resyncs_total"]) for m in sm),
                gap_discards=sum(int(m["st_sub_gap_discards_total"]) for m in sm),
                stale_reads_raised=sum(int(m["st_read_stale_total"]) for m in sm),
            )
        out.update(
            converged_all=all(converged), drained_all=drained,
            injected={"fault_drop": counts.get("fault_drop", 0), "retransmit": counts.get("retransmit", 0)},
            trace_paths=stats, trace_events=counts.get("trace_apply", 0),
            native_ring_dropped=int(next(iter(snaps), {}).get("st_obs_events_dropped_total", 0)),
            staleness_seconds={"max": max(staleness, default=0.0), "observed_links": len(staleness)},
            digest=digest, digest_exact=digest_exact,
        )
        trace_out = os.environ.get("ST_CLUSTER_TRACE_OUT", "")
        if trace_out:
            trace_export.export_file(trace_out, timeline)
            out["trace_export"] = trace_out
        conf = conformance(hub)
        out["conformance"] = conf
        out["pass"] = bool(
            gate_passes(conf)
            and all(converged)
            and drained
            and out["injected"]["fault_drop"] >= 1
            and out["injected"]["retransmit"] >= 1
            and stats["paths"] >= adds // 2
            and stats["contiguous_frac"] >= 0.99
            and digest_exact
            # the subscriber arm: every verified read reached the total, and
            # at least one read verified somewhere in the run
            and (not subscribers or (all(sub_converged) and reads_ok + q_ok >= 1))
            # the striped arm: the sever fired and resolved cleanly
            and (stripes <= 1 or out["stripes"]["outcome"] != "none-observed")
        )
    finally:
        close_all()
    out["seconds"] = time.perf_counter() - t_all
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", help="where to write the JSON document")
    ap.add_argument("--subscribers", type=int, default=_env_int("ST_CLUSTER_SUBSCRIBERS", 0))
    ap.add_argument("--stripes", type=int, default=_env_int("ST_CLUSTER_STRIPES", 1))
    ap.add_argument("--kill-restore", action="store_true",
                    default=os.environ.get("ST_CLUSTER_KILL_RESTORE", "0") == "1")
    ap.add_argument("--shm", action="store_true", default=os.environ.get("ST_CLUSTER_SHM", "0") == "1",
                    help="the kill-restore arm with the shared-memory lane's gates")
    ap.add_argument("--sharded", action="store_true", default=os.environ.get("ST_CLUSTER_SHARDED", "0") == "1")
    args = ap.parse_args(argv)
    from . import lifecycle

    nodes = _env_int("ST_CLUSTER_NODES", lifecycle.NODES)
    adds = _env_int("ST_CLUSTER_ADDS", lifecycle.ADDS)
    seed = _env_int("ST_CLUSTER_SEED", lifecycle.SEED)
    if args.sharded:
        out = lifecycle.run_sharded(tempfile.mkdtemp(prefix="chaos-sharded-"), nodes,
                                    _env_int("ST_SHARD_N", lifecycle.SHARD_N), adds, seed)
    elif args.kill_restore or args.shm:
        out = lifecycle.run_kill_restore(tempfile.mkdtemp(prefix="chaos-kill-restore-"), nodes,
                                         _env_int("ST_CLUSTER_N", lifecycle.N), adds, seed, shm=args.shm)
    else:
        out = run(nodes, _env_int("ST_CLUSTER_N", lifecycle.N), adds, seed, args.subscribers, args.stripes)
    doc = json.dumps(out, indent=2)
    print(doc)
    with open(args.out, "w") as f:
        f.write(doc + "\n")
    conf = out["conformance"]
    print(f"cluster_chaos ({out['bench']}): conformance {conf['events']} events, {conf['routed_events']} routed, "
          f"{len(conf['violations'])} violations, {out['seconds']:.2f} s -> {'PASS' if out['pass'] else 'FAIL'}",
          file=sys.stderr)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
