"""In-band cluster metrics aggregation: the bounded metrics digest.

The counterpart of ``shared_tensor_tpu/obs/aggregate.py``; the documents
are the same, so JAX and port digests merge in one tree. Peers piggyback
the digest up the tree on their existing links (``wire.DIGEST`` control
messages, one per ``ObsConfig.digest_interval_sec``): each node folds its
own registry snapshot together with its children's latest digests and
forwards the merge, so the root's ``peer.metrics(cluster=True)`` serves a
live whole-tree view.

Merge semantics (a bounded summary, not a log):

- **counters** merge by SUM, with per-link labels stripped first (link ids
  are node-local; the per-node breakdown keeps the labeled values);
- **histograms** merge by BUCKET-ADD (the same fixed bounds everywhere, so
  cumulative bucket counts, sums and counts add losslessly);
- **gauges** merge by LABELED MAX/MIN: each extremum carries the node id
  that owns it.

Every digest also carries a bounded per-node breakdown (``nodes``): each
node's gauges plus a whitelisted counter subset, stamped with the node's
snapshot time. At most :data:`MAX_NODES` breakdown entries and
``wire.DIGEST_MAX_BYTES`` encoded bytes: past either, the OLDEST nodes'
breakdowns are dropped (the merged totals keep every node's contribution;
``truncated`` counts the dropped breakdowns).

Names this module does not know (a port-only counter reaching a JAX root,
or the other way round) are classified by suffix: ``_total`` is a counter,
anything else a gauge. Every port-only name follows that rule.

Subtree disjointness makes the sums exact: a node merges only its own
snapshot plus digests from CHILD links, and the tree has no cycles, so
every registry contributes exactly once to the root's totals.
"""

from __future__ import annotations

import json
from typing import Optional

from . import schema as _schema

#: Digest document version (the JSON carries it as "v").
DIGEST_VERSION = 1

#: Per-node breakdown entries kept before truncation (merged totals are
#: never truncated — only the per-node detail).
MAX_NODES = 256

#: Counters included in each node's per-node breakdown (the whole-tree
#: totals cover every counter; the breakdown is the operator's "which node
#: is the outlier" view and stays small by listing only the load-bearing
#: ones).
NODE_COUNTERS = (
    "st_frames_out_total",
    "st_frames_in_total",
    "st_updates_total",
    "st_msgs_out_total",
    "st_msgs_in_total",
    "st_retransmit_msgs_total",
    "st_dedup_discards_total",
    "st_traced_msgs_in_total",
    # obs.top's shard columns read these off the per-node breakdown
    "st_shard_fwd_msgs_in_total",
    "st_shard_fwd_msgs_out_total",
)


def base_name(name: str) -> str:
    """Strip a rendered ``{label=...}`` suffix: the schema keys per-link
    series as ``st_link_..._total{link="3"}``."""
    return name.split("{", 1)[0]


def empty() -> dict:
    return {
        "v": DIGEST_VERSION,
        "nodes": {},
        "counters": {},
        "hists": {},
        "gmax": {},
        "gmin": {},
        # PROCESS-scoped counters (schema.PROCESS_GLOBAL), keyed by pid:
        # every peer in a process reports the same ring/module-global
        # value, so merging by pid-keyed assignment (not sum) dedups
        # within a process while still summing across processes.
        "proc": {},
        "truncated": 0,
    }


def _kind(name: str, value) -> str:
    if isinstance(value, dict):
        return "histogram" if "buckets" in value else "skip"
    k = _schema.SCHEMA.get(base_name(name))
    if k is not None:
        return k[0]
    # unknown name (forward compat): counters are self-describing by suffix
    return "counter" if base_name(name).endswith("_total") else "gauge"


def _merge_hist(dst: dict, name: str, snap: dict) -> None:
    h = dst.setdefault(name, {"sum": 0.0, "count": 0, "buckets": {}})
    h["sum"] += float(snap.get("sum", 0.0))
    h["count"] += int(snap.get("count", 0))
    hb = h["buckets"]
    for bound, cum in snap.get("buckets", {}).items():
        key = str(float(bound))  # JSON round trips turn float keys to str
        hb[key] = hb.get(key, 0) + int(cum)


def from_snapshot(node_id: int, snap: dict, t_ns: int) -> dict:
    """One node's registry snapshot -> a single-node digest document."""
    import os

    doc = empty()
    mine: dict = {}
    pid = str(os.getpid())
    for name, v in snap.items():
        kind = _kind(name, v)
        if kind == "histogram":
            _merge_hist(doc["hists"], base_name(name), v)
            continue
        if kind == "skip" or not isinstance(v, (int, float)):
            continue
        if kind == "counter":
            b = base_name(name)
            if b in _schema.PROCESS_GLOBAL:
                doc["proc"].setdefault(pid, {})[b] = v
                continue
            doc["counters"][b] = doc["counters"].get(b, 0) + v
            if b in NODE_COUNTERS and "{" not in name:
                mine[name] = v
            continue
        # gauge: per-node breakdown keeps the labeled value; the cluster
        # extrema aggregate on the base name, tagged with the owner
        mine[name] = v
        b = base_name(name)
        cur = doc["gmax"].get(b)
        if cur is None or v > cur[0]:
            doc["gmax"][b] = [v, node_id]
        cur = doc["gmin"].get(b)
        if cur is None or v < cur[0]:
            doc["gmin"][b] = [v, node_id]
    doc["nodes"][str(int(node_id))] = {"t_ns": int(t_ns), "m": mine}
    return doc


def merge(into: dict, other: Optional[dict]) -> dict:
    """Fold ``other`` (a child subtree's digest) into ``into`` in place and
    return it. Node breakdowns are keyed by process-unique node id, so a
    re-sent child digest REPLACES at the caller (peers keep only each
    child's latest) — this merge itself assumes disjoint inputs."""
    if not other:
        return into
    for name, v in other.get("counters", {}).items():
        into["counters"][name] = into["counters"].get(name, 0) + v
    for name, h in other.get("hists", {}).items():
        _merge_hist(into["hists"], name, h)
    for name, pair in other.get("gmax", {}).items():
        cur = into["gmax"].get(name)
        if cur is None or pair[0] > cur[0]:
            into["gmax"][name] = list(pair)
    for name, pair in other.get("gmin", {}).items():
        cur = into["gmin"].get(name)
        if cur is None or pair[0] < cur[0]:
            into["gmin"][name] = list(pair)
    into["nodes"].update(other.get("nodes", {}))
    for pid, vals in other.get("proc", {}).items():
        # pid-keyed assignment: same-process peers overwrite with the same
        # (or fresher) value instead of double-counting
        into["proc"].setdefault(pid, {}).update(vals)
    into["truncated"] += int(other.get("truncated", 0))
    return into


def process_global_totals(doc: dict) -> dict:
    """The cluster-wide PROCESS_GLOBAL counter totals: summed across the
    distinct processes the digest has seen (each counted once)."""
    out: dict = {}
    for vals in doc.get("proc", {}).values():
        for name, v in vals.items():
            out[name] = out.get(name, 0) + v
    return out


def bounded(doc: dict) -> dict:
    """Enforce the digest bounds before encoding: at most MAX_NODES
    per-node breakdowns and wire.DIGEST_MAX_BYTES encoded bytes. Oldest
    breakdowns (stalest t_ns) drop first; merged totals are untouched and
    ``truncated`` counts what the per-node view lost. Over-budget
    shrinking estimates each drop's size from the entry's own encoding
    (additive to within framing commas) and re-measures once per batch —
    never one full-document re-encode per evicted node."""
    from ..comm import wire as _wire

    nodes = doc["nodes"]
    by_age = sorted(nodes, key=lambda k: nodes[k].get("t_ns", 0))
    drop = len(by_age) - MAX_NODES
    for k in by_age[:max(0, drop)]:
        del nodes[k]
        doc["truncated"] += 1
    by_age = by_age[max(0, drop):]
    cap = _wire.DIGEST_MAX_BYTES
    while by_age:
        size = len(json.dumps(doc, separators=(",", ":")).encode())
        if size <= cap:
            break
        over = size - cap
        freed = 0
        while by_age and freed < over:
            k = by_age.pop(0)
            entry = nodes.pop(k)
            doc["truncated"] += 1
            # this entry's encoded footprint: key + entry + framing slack
            freed += len(
                json.dumps({k: entry}, separators=(",", ":")).encode()
            )
    return doc


def cluster_nodes(doc: dict) -> int:
    return len(doc.get("nodes", {}))


def _num(v) -> str:
    """Full-precision sample rendering: %g's 6 significant digits would
    round any counter past ~1e6 (a soak's frame totals within minutes),
    silently breaking the cluster view's ``totals == sum of registries``
    exactness for scrapers. Integers render as integers; floats via repr
    (shortest round-trip)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(doc: dict) -> str:
    """Render a cluster digest as Prometheus text exposition: merged
    counters/histograms as plain series, per-node GAUGES with a ``node``
    label, extrema as ``_max``/``_min`` series labeled with the owning
    node. Per-node COUNTER breakdowns stay in the JSON digest / obs.top
    only — emitting them as labeled twins of the merged series would make
    ``sum()`` double-count and interleave metric families (strict
    OpenMetrics parsers reject that); per-node gauges group by family so
    the exposition stays contiguous."""
    lines: list[str] = []
    for name in sorted(doc.get("counters", {})):
        lines.append(f"# TYPE {name} counter")
        lines.append(f'{name} {_num(doc["counters"][name])}')
    for name, v in sorted(process_global_totals(doc).items()):
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {_num(v)}")
    for name in sorted(doc.get("hists", {})):
        h = doc["hists"][name]
        lines.append(f"# TYPE {name} histogram")
        for bound in sorted(h["buckets"], key=float):
            lines.append(
                f'{name}_bucket{{le="{float(bound):g}"}} {h["buckets"][bound]}'
            )
        lines.append(f'{name}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f'{name}_sum {_num(h["sum"])}')
        lines.append(f'{name}_count {h["count"]}')
    for kind, suffix in (("gmax", "_max"), ("gmin", "_min")):
        for name in sorted(doc.get(kind, {})):
            v, node = doc[kind][name]
            lines.append(
                f'{name}{suffix}{{node="{int(node)}"}} {_num(v)}'
            )
    # per-node gauges, pivoted name-major so each family is one
    # contiguous block of {node=...}-labeled samples
    families: dict[str, list[str]] = {}
    for node in sorted(doc.get("nodes", {}), key=int):
        for name, v in doc["nodes"][node].get("m", {}).items():
            base = base_name(name)
            if _kind(name, v) != "gauge":
                continue
            if "{" in name:  # fold the node label into the existing set
                head, rest = name.split("{", 1)
                families.setdefault(base, []).append(
                    f'{head}{{node="{int(node)}",{rest} {_num(v)}'
                )
            else:
                families.setdefault(base, []).append(
                    f'{name}{{node="{int(node)}"}} {_num(v)}'
                )
    for base in sorted(families):
        lines.extend(families[base])
    return "\n".join(lines) + "\n"
