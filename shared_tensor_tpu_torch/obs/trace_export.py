"""Causal-path reconstruction and the Chrome/Perfetto trace export.

The counterpart of ``shared_tensor_tpu/obs/trace_export.py``. The v2 wire
trace context gives every applied DATA/BURST message a ``trace_apply``
event: ``(node, link)`` say who applied it, ``arg`` carries the update
generation (the origin's monotonic ns at ``add()``) and ``extra`` packs
``origin_node << 8 | hop``. This module turns a flight-recorder timeline
into:

- :func:`trace_paths`: ``{(origin, gen): [hop records]}``, the causal
  path of each update generation across the tree, and :func:`contiguous`,
  which checks a path has no hop gaps (a generation whose mass coalesced
  into a newer one stops, hops 1..k, but never skips a hop: a gap means
  lost telemetry);
- :func:`chrome_trace`: a Chrome ``trace_event`` JSON document: every event
  an instant on its node's track, and each multi-hop generation a flow
  (``s``/``t`` arrows) across node tracks.

Timestamps: each node's CLOCK_MONOTONIC in the format's microseconds.
Nodes of one process share a timebase; across hosts (or under the
simulated skew) they do not: pass ``offsets_ns`` (node obs id -> its
estimated offset from the root, ``st_clock_offset_seconds`` * 1e9) and
every event is moved onto the ROOT's clock. ``pid`` is the node obs id,
with metadata records naming it; ``tid`` separates the native ("c") and
Python ("py") tiers.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

from . import events as ev


def unpack_trace(event: ev.Event) -> Optional[tuple[int, int, int]]:
    """(origin, gen, hop) of a trace_apply event, else None."""
    if event.name != "trace_apply":
        return None
    return (event.extra >> 8) & 0xFFFFFF, event.arg, event.extra & 0xFF


def trace_paths(
    events: Iterable[ev.Event],
) -> dict[tuple[int, int], list[dict]]:
    """Group trace_apply events by update generation. Each value is the
    generation's hop list sorted by hop then time:
    ``{"hop": h, "node": applier, "link": l, "t_ns": t, "tier": tier}``.
    Retransmissions of the same message are deduplicated upstream by the
    wire's go-back-N acceptance (a discarded duplicate never emits
    trace_apply), so one (generation, node) pair appears at most once per
    delivery."""
    out: dict[tuple[int, int], list[dict]] = {}
    for e in events:
        tr = unpack_trace(e)
        if tr is None:
            continue
        origin, gen, hop = tr
        out.setdefault((origin, gen), []).append(
            {
                "hop": hop,
                "node": e.node,
                "link": e.link,
                "t_ns": e.t_ns,
                "tier": e.tier,
            }
        )
    for path in out.values():
        path.sort(key=lambda r: (r["hop"], r["t_ns"]))
    return out


def contiguous(path: list[dict]) -> bool:
    """True when the path's hop set is exactly 1..max (no gaps). A short
    path (coalesced into a newer generation mid-tree) is contiguous; a
    HOLE means a hop's telemetry was lost."""
    hops = sorted({r["hop"] for r in path})
    return bool(hops) and hops[0] == 1 and hops == list(range(1, hops[-1] + 1))


def path_stats(paths: dict) -> dict:
    """Aggregate verdict over reconstructed paths (``contiguous_frac``
    is the share of paths without a gap)."""
    total = len(paths)
    ok = sum(1 for p in paths.values() if contiguous(p))
    max_hops = max((p[-1]["hop"] for p in paths.values() if p), default=0)
    return {
        "paths": total,
        "contiguous": ok,
        "contiguous_frac": (ok / total) if total else 1.0,
        "max_hops": max_hops,
    }


_TIER_TID = {"c": 1, "py": 2}


def chrome_trace(
    events: Iterable[ev.Event],
    flows: bool = True,
    offsets_ns: Optional[dict] = None,
) -> dict:
    """Chrome ``trace_event`` JSON document from a merged timeline.

    ``offsets_ns`` maps node obs id -> that node's clock offset from the
    root in ns (``off = C_node - C_root``, the clock plane's sign
    convention); each event's ``ts`` becomes ``t_ns - off`` so every
    track shares the root's timebase. Unlisted nodes keep raw stamps.
    """
    offs = offsets_ns or {}

    def _ts(node: int, t_ns: int) -> float:
        return (t_ns - int(offs.get(node, 0))) / 1000.0

    events = sorted(events, key=lambda e: e.t_ns)
    out: list[dict] = []
    nodes = sorted({e.node for e in events})
    for n in nodes:
        out.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": n,
                "args": {"name": f"node-{n}" if n else "process"},
            }
        )
        for tier, tid in _TIER_TID.items():
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": n,
                    "tid": tid,
                    "args": {"name": f"{tier}-tier"},
                }
            )
    for e in events:
        args: dict = {"link": e.link, "arg": e.arg}
        tr = unpack_trace(e)
        if tr is not None:
            args.update(origin=tr[0], gen=tr[1], hop=tr[2])
        if e.detail:
            args["detail"] = e.detail
        out.append(
            {
                "name": e.name,
                "cat": "st",
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": _ts(e.node, e.t_ns),
                "pid": e.node,
                "tid": _TIER_TID.get(e.tier, 3),
                "args": args,
            }
        )
    if flows:
        # one flow per multi-hop generation: arrows from each hop's track
        # to the next — the cross-node causal chain made visual
        for flow_id, ((origin, gen), path) in enumerate(
            sorted(trace_paths(events).items()), start=1
        ):
            if len(path) < 2:
                continue
            for i, rec in enumerate(path):
                out.append(
                    {
                        "name": f"update-{origin}-{gen}",
                        "cat": "st_trace",
                        "ph": "s" if i == 0 else "t",
                        "id": flow_id,
                        "ts": _ts(rec["node"], rec["t_ns"]),
                        "pid": rec["node"],
                        "tid": _TIER_TID.get(rec["tier"], 3),
                        "args": {"hop": rec["hop"], "origin": origin},
                    }
                )
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_file(
    path: str,
    events: Iterable[ev.Event],
    flows: bool = True,
    offsets_ns: Optional[dict] = None,
) -> str:
    doc = chrome_trace(events, flows=flows, offsets_ns=offsets_ns)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path
