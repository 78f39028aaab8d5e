"""``python -m shared_tensor_tpu_torch.obs.top``: a live view of the cluster digest.

The counterpart of ``shared_tensor_tpu/obs/top.py``, rendering the same
text. Point the tree ROOT at a file
(``ObsConfig.cluster_json_path="/tmp/st_cluster.json"``) and this tool
tails it: whole-tree totals, throughput rates (counters differenced
between refreshes) and the per-node breakdown, one row per node
(staleness, residual norm, frames, retransmits). Standard library only and
read-only: it never touches the peers.

The viewer keeps a bounded :class:`~.timeseries.TimeSeriesStore` across
refreshes for its sparklines; with ``--health`` (the root's
``ObsConfig.health_json_path``) it adds the SLO burn-rate row, the
per-shard heat table and a per-node heat column. A truncated digest says
how many node breakdowns were dropped.

Usage:
    python -m shared_tensor_tpu_torch.obs.top --file /tmp/st_cluster.json
    python -m shared_tensor_tpu_torch.obs.top --file ... --health /tmp/st_health.json
    python -m shared_tensor_tpu_torch.obs.top --file ... --once   # one frame
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

_SPARK_CHARS = "▁▂▃▄▅▆▇█"
_SHARD_LABEL_RE = re.compile(r'\{shard="(\d+)"\}$')


def _fmt(v, width=10) -> str:
    if isinstance(v, float):
        if v != 0 and (abs(v) < 1e-3 or abs(v) >= 1e6):
            return f"{v:>{width}.2e}"
        return f"{v:>{width}.3f}"
    return f"{v:>{width}}"


def _spark(vals, width: int = 16) -> str:
    """Unicode sparkline over the last ``width`` values (min..max scaled;
    a flat series renders as all-low so spikes stay visually loud)."""
    vals = [float(v) for v in vals][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_CHARS[0] * len(vals)
    return "".join(
        _SPARK_CHARS[
            min(len(_SPARK_CHARS) - 1, int((v - lo) / span * len(_SPARK_CHARS)))
        ]
        for v in vals
    )


def _deltas(vals) -> list[float]:
    """Positive first-differences of a counter series (reset -> 0 step)."""
    out = []
    for a, b in zip(vals, vals[1:]):
        out.append(max(0.0, float(b) - float(a)))
    return out


def _node_heat(m: dict, health: dict) -> float:
    """A node's heat: max health score over the shards it reports apply
    telemetry for (the applier of a shard's FWDs is its owner)."""
    shards = (health.get("heat") or {}).get("shards") or {}
    best = 0.0
    for k in m:
        sm = _SHARD_LABEL_RE.search(k)
        if sm is not None and k.startswith("st_shard_heat_applies{"):
            best = max(best, float(shards.get(sm.group(1), {}).get("score", 0.0)))
    return best


def _node_val(m: dict, base: str) -> float:
    """A node's value for a base metric name, max over labeled variants
    (per-link gauges render as ``name{link="N"}``)."""
    best = 0.0
    for k, v in m.items():
        if k == base or k.startswith(base + "{"):
            best = max(best, float(v))
    return best


def render(
    doc: dict,
    prev: dict | None,
    dt: float,
    health: dict | None = None,
    store=None,
) -> str:
    nodes = doc.get("nodes", {})
    counters = doc.get("counters", {})
    pc = (prev or {}).get("counters", {})
    truncated = int(doc.get("truncated", 0))

    def rate(name: str) -> float:
        if dt <= 0:
            return 0.0
        return max(0.0, (counters.get(name, 0) - pc.get(name, 0)) / dt)

    # truncation honesty: a bounded digest drops whole NODE
    # breakdowns oldest-first but keeps exact totals — say both, loudly,
    # instead of letting a partial node table read as the whole fleet.
    if truncated:
        trunc_note = (
            f"{truncated} node breakdown(s) TRUNCATED — totals exact, "
            f"per-node rows partial"
        )
    else:
        trunc_note = "breakdown complete"
    lines = [
        f"shared-tensor cluster digest — {len(nodes)} node(s), {trunc_note}",
        (
            f"  frames in {counters.get('st_frames_in_total', 0):.0f}"
            f" ({rate('st_frames_in_total'):.0f}/s)"
            f"   msgs in {counters.get('st_msgs_in_total', 0):.0f}"
            f" ({rate('st_msgs_in_total'):.0f}/s)"
            f"   retx {counters.get('st_retransmit_msgs_total', 0):.0f}"
            f"   dedup {counters.get('st_dedup_discards_total', 0):.0f}"
        ),
    ]
    if store is not None and len(store):
        spark_rows = []
        fr = _deltas(store.values(("cluster", "st_frames_in_total")))
        if fr:
            spark_rows.append(f"frames/beat {_spark(fr)}")
        st = store.values(("gmax", "st_staleness_seconds"))
        if st:
            spark_rows.append(f"worst stale {_spark(st)}")
        if spark_rows:
            lines.append("  " + "   ".join(spark_rows))
    gmax = doc.get("gmax", {})
    stale = gmax.get("st_staleness_seconds")
    resid = gmax.get("st_residual_norm")
    if stale or resid:
        parts = []
        if stale:
            parts.append(
                f"worst staleness {stale[0]:.4f}s @ node {int(stale[1])}"
            )
        if resid:
            parts.append(
                f"worst residual L2 {resid[0]:.4g} @ node {int(resid[1])}"
            )
        lines.append("  " + "   ".join(parts))
    # fleet health: SLO burn-rate row + per-shard heat table, fed by
    # the root's health.json (absent: no health rows)
    if health:
        slo = health.get("slo") or {}
        worst = (health.get("staleness") or {}).get("worst")
        alert = int(slo.get("alert", 0))
        badge = {0: "ok", 1: "TICKET", 2: "PAGE"}.get(alert, str(alert))
        parts = [f"slo [{badge}]"]
        if worst:
            unc = worst.get("unc_sec")
            parts.append(
                f"worst corrected {worst['corrected_sec']:.4f}s"
                + (f" ±{unc:.4f}s" if unc is not None else " (uncorrected)")
                + f" @ node {worst.get('node', '?')}"
            )
        for name, w in sorted((slo.get("windows") or {}).items()):
            flame = "*" if w.get("firing") else ""
            parts.append(
                f"{name}{flame} {w.get('burn_long', 0.0):.1f}x/"
                f"{w.get('burn_short', 0.0):.1f}x"
            )
        lines.append("  " + "   ".join(parts))
        heat = health.get("heat") or {}
        shards = heat.get("shards") or {}
        if shards:
            hot = int(heat.get("hot_shard", -1))
            cells = []
            for k in sorted(shards, key=int):
                s = shards[k]
                mark = "!" if int(k) == hot else ""
                cells.append(
                    f"s{k}{mark}={s.get('score', 0.0):.2f}"
                    f"({s.get('apply_rate', 0.0):.0f}/s)"
                )
            tail = f"   HOT shard {hot}" if hot >= 0 else ""
            lines.append("  heat: " + " ".join(cells) + tail)
    # lifecycle rows: only rendered while something is happening —
    # a snapshot barrier in progress (per-node paused/acked state), a
    # drain underway, or a version skew worth knowing about mid-upgrade
    lc_rows = []
    versions = set()
    for nid in sorted(nodes, key=int):
        m = nodes[nid].get("m", {})
        v = int(_node_val(m, "st_wire_version"))
        if v:
            versions.add(v)
        state = []
        if _node_val(m, "st_snapshot_in_progress") > 0:
            state.append(
                f"snapshotting (acks {int(_node_val(m, 'st_snapshot_shards_acked'))})"
            )
        elif _node_val(m, "st_lifecycle_paused") > 0:
            state.append("paused (barrier)")
        if _node_val(m, "st_drain_in_progress") > 0:
            state.append("draining")
        if state:
            lc_rows.append(f"  node {nid}: " + ", ".join(state))
    if lc_rows:
        lines.append("  lifecycle:")
        lines.extend(lc_rows)
    if len(versions) > 1:
        lines.append(
            f"  lifecycle: MIXED wire versions {sorted(versions)} "
            f"(rolling upgrade in progress?)"
        )
    lines.append("")
    # the shard column renders only when any node reports shard
    # telemetry; a full-replica tree leaves it out
    sharded = any(
        _node_val(nodes[nid].get("m", {}), "st_shard_owned_words") > 0
        or _node_val(nodes[nid].get("m", {}), "st_shard_routes") > 0
        for nid in nodes
    )
    hdr = (
        f"{'node':>6} {'stale_s':>10} {'resid_L2':>10} {'hops':>5} "
        f"{'frames_out':>11} {'frames_in':>10} {'updates':>8} "
        f"{'retx':>6} {'inflight':>9}"
    )
    if sharded:
        hdr += f" {'owned_w':>9} {'fwd_in':>8} {'fwd_out':>8}"
    heatcol = bool(health and (health.get("heat") or {}).get("shards"))
    if heatcol:
        hdr += f" {'heat':>6}"
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for nid in sorted(nodes, key=int):
        m = nodes[nid].get("m", {})
        row = (
            f"{nid:>6} "
            f"{_fmt(_node_val(m, 'st_staleness_seconds'))} "
            f"{_fmt(_node_val(m, 'st_residual_norm'))} "
            f"{int(_node_val(m, 'st_update_hops_last')):>5} "
            f"{_fmt(m.get('st_frames_out_total', 0), 11)} "
            f"{_fmt(m.get('st_frames_in_total', 0))} "
            f"{_fmt(m.get('st_updates_total', 0), 8)} "
            f"{_fmt(m.get('st_retransmit_msgs_total', 0), 6)} "
            f"{_fmt(_node_val(m, 'st_inflight_msgs'), 9)}"
        )
        if sharded:
            row += (
                f" {int(_node_val(m, 'st_shard_owned_words')):>9}"
                f" {int(m.get('st_shard_fwd_msgs_in_total', 0)):>8}"
                f" {int(m.get('st_shard_fwd_msgs_out_total', 0)):>8}"
            )
        if heatcol:
            row += f" {_node_heat(m, health):>6.2f}"
        lines.append(row)
    if truncated:
        lines.append(
            f"({truncated} more node(s) in totals but not shown: "
            f"breakdown truncated at the digest bound)"
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="live terminal view of the cluster metrics digest"
    )
    ap.add_argument(
        "--file", required=True,
        help="digest JSON the tree root writes (ObsConfig.cluster_json_path)",
    )
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument(
        "--once", action="store_true", help="render one frame and exit"
    )
    ap.add_argument(
        "--health", default="",
        help="root health.json (ObsConfig.health_json_path) for the SLO "
        "row, heat table and per-node heat column",
    )
    args = ap.parse_args(argv)
    from .timeseries import TimeSeriesStore

    store = TimeSeriesStore()
    prev, prev_t, last_t = None, 0.0, -1
    while True:
        try:
            with open(args.file) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            if args.once:
                print(f"cannot read digest {args.file}: {e}", file=sys.stderr)
                return 1
            time.sleep(args.interval)
            continue
        health = None
        if args.health:
            try:
                with open(args.health) as f:
                    health = json.load(f)
            except (OSError, ValueError):
                health = None  # stale/missing health is not fatal to top
        now = time.monotonic()
        # the viewer keeps its own series (sparklines): ingest each NEW
        # digest once, keyed by its freshest node stamp (the digest has
        # no top-level stamp of its own)
        t_ns = max(
            (int(n.get("t_ns", 0)) for n in doc.get("nodes", {}).values()),
            default=time.monotonic_ns(),
        )
        if t_ns != last_t:
            store.ingest(doc, t_ns)
            last_t = t_ns
        frame = render(
            doc, prev, now - prev_t if prev is not None else 0.0,
            health=health, store=store,
        )
        if args.once:
            print(frame)
            return 0
        # ANSI clear + home keeps it flicker-light without curses
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        prev, prev_t = doc, now
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
