"""The fleet health analyzer over the digest time series.

The counterpart of ``shared_tensor_tpu/obs/health.py``: fed the same
digests it writes the same document. It sits at the tree ROOT (a master
with ``ObsConfig.health_json_path`` set), is fed one cluster digest per
digest beat, and turns the series into three signals:

- **Per-shard heat.** Each shard's score combines its FWD apply rate
  (owner-side work), the fleet-wide outbox backlog destined to it
  (writer-side pressure), and the owner's allocation share::

      heat_k = 0.6 * rate_k/max_rate + 0.3 * outbox_k/max_outbox
             + 0.1 * alloc_k/max_alloc

  Rates come from the reset-tolerant store (``timeseries.TimeSeriesStore``)
  over a short trailing window, each node's series at its digests' own
  sample times (a re-merged digest adds no point; JAX's store samples
  every node at the beat). The hot shard is named only when its rate
  beats the mean of the others by ``skew_ratio`` (default 3x). The
  port's sharded nodes (``shard/node.py``) report ``st_shard_heat_*``
  in their digests, as a JAX sharded subtree's do; a tree of full-replica
  peers alone leaves the heat table empty.

- **Cross-host staleness.** Raw ``st_staleness_seconds`` compares the
  applier's CLOCK_MONOTONIC to the origin's. Each node exports its
  estimated offset to the root (``st_clock_offset_seconds`` ±
  ``st_clock_uncertainty_seconds``) and the origin node of each link's
  freshest update (``st_staleness_origin{link=}``), so the analyzer
  widens every value to offset-corrected with an error bound::

      corrected = raw - off_applier + off_origin
      unc       = unc_applier + unc_origin

  Nodes without clock estimates keep their raw value with ``unc = null``.

- **Staleness SLO with multi-window burn-rate alerts.** Per beat the SLI
  is "worst corrected staleness <= objective". The burn rate over a
  window is ``bad_fraction / error_budget``; a severity fires when BOTH
  its long and short windows exceed the threshold (``slo_alert_fire``)
  and clears when the short window recovers (``slo_alert_clear``).
  Defaults: page = 14.4x over (60 s, 5 s), ticket = 6x over (300 s,
  30 s), budget 1%.

Everything lands in a machine-readable ``health.json`` (written to a
temporary file and moved over with ``os.replace``), plus ``metrics()``
gauges that ride the root's registry. ``partial`` mirrors the digest's
``truncated`` count: totals are exact, but per-node detail may be
missing nodes.
"""

from __future__ import annotations

import json
import os
import re
from collections import deque

from .timeseries import TimeSeriesStore
from . import schema as _schema

HEALTH_VERSION = 1

#: Trailing window for heat rates: long enough to smooth beat jitter,
#: short enough that a hot shard is named within ~3 digest beats.
HEAT_WINDOW_SEC = 10.0

#: Default multi-window burn-rate severities: (name, long_s, short_s,
#: threshold). Thresholds follow the SRE-workbook sizing for a 1% budget.
DEFAULT_WINDOWS = (
    ("page", 60.0, 5.0, 14.4),
    ("ticket", 300.0, 30.0, 6.0),
)

_SHARD_RE = re.compile(r'\{shard="(\d+)"\}$')
_LINK_RE = re.compile(r'\{link="(\d+)"\}')


class HealthAnalyzer:
    """Digest-beat health analytics at the root; see module docstring.

    Thread-safety: ``beat`` runs on the root's housekeeping thread (the
    same one that publishes digests); ``metrics``/``doc`` read a single
    attribute holding an immutable-by-convention dict, so collector
    threads see either the previous or the new beat, never a torn one.
    """

    def __init__(
        self,
        path: str = "",
        history: int = 256,
        objective_sec: float = 1.0,
        budget: float = 0.01,
        windows=DEFAULT_WINDOWS,
        skew_ratio: float = 3.0,
        heat_window_sec: float = HEAT_WINDOW_SEC,
        emit=None,
    ) -> None:
        self.path = path
        self.store = TimeSeriesStore(max_points=history)
        self.objective_sec = float(objective_sec)
        self.budget = max(1e-9, float(budget))
        self.windows = tuple(
            (str(n), float(l), float(s), float(t)) for n, l, s, t in windows
        )
        self.skew_ratio = max(1.0, float(skew_ratio))
        self.heat_window_sec = float(heat_window_sec)
        self._emit = emit
        longest = max((w[1] for w in self.windows), default=60.0)
        # SLI ring sized by time, not beats: prune past the longest window
        self._sli: deque = deque()
        self._sli_horizon_ns = int(longest * 1e9) + int(1e9)
        self._firing: dict = {}      # severity name -> bool
        self._hot_named = -1         # last hot shard announced via event
        self.bad_beats = 0
        self._doc: dict = {}

    # -- per-beat pipeline ----------------------------------------------

    def beat(self, doc: dict, t_ns: int) -> dict:
        """Ingest one cluster digest and recompute the health document."""
        t_ns = int(t_ns)
        self.store.ingest(doc, t_ns)
        clock = self._clock_table(doc)
        stale = self._staleness(doc, clock)
        slo = self._slo(stale, t_ns)
        heat = self._heat(doc)
        out = {
            "v": HEALTH_VERSION,
            "t_ns": t_ns,
            "beats": self.store.beats,
            "nodes": len(doc.get("nodes", {})),
            "truncated": int(doc.get("truncated", 0)),
            "partial": int(doc.get("truncated", 0)) > 0,
            "store": {"series": len(self.store), "evicted": self.store.evicted},
            "clock": clock,
            "staleness": stale,
            "slo": slo,
            "heat": heat,
            "trends": {
                "frames_in_per_sec": self.store.cluster_rate(
                    "st_frames_in_total", self.heat_window_sec
                ),
                "updates_per_sec": self.store.cluster_rate(
                    "st_updates_total", self.heat_window_sec
                ),
            },
        }
        self._doc = out
        if self.path:
            self._write(out)
        return out

    def doc(self) -> dict:
        return self._doc

    def metrics(self) -> dict:
        """Analyzer gauges folded into the root's registry collector so
        they ride the normal export (and the next digest)."""
        d = self._doc
        if not d:
            return {}
        out = {
            "st_heat_score": max(
                (s["score"] for s in d["heat"]["shards"].values()), default=0.0
            ),
            "st_heat_hot_shard": float(d["heat"]["hot_shard"]),
            "st_slo_alert": float(d["slo"]["alert"]),
            "st_slo_bad_beats_total": self.bad_beats,
        }
        for name, w in d["slo"]["windows"].items():
            out[_schema.label_key("st_slo_burn_rate", "window", name)] = w[
                "burn_long"
            ]
        return out

    # -- clock -----------------------------------------------------------

    @staticmethod
    def _clock_table(doc: dict) -> dict:
        """node id (str) -> {"off_sec","unc_sec"} for nodes that export
        clock estimates; absent nodes have no usable offset."""
        table = {}
        for nid, entry in doc.get("nodes", {}).items():
            m = entry.get("m", {})
            off = m.get("st_clock_offset_seconds")
            if off is None:
                continue
            table[str(int(nid))] = {
                "off_sec": float(off),
                "unc_sec": float(m.get("st_clock_uncertainty_seconds", 0.0)),
            }
        return table

    # -- staleness --------------------------------------------------------

    def _staleness(self, doc: dict, clock: dict) -> dict:
        nodes_out = {}
        worst = None
        for nid, entry in doc.get("nodes", {}).items():
            m = entry.get("m", {})
            applier = clock.get(str(int(nid)))
            for name, raw in m.items():
                if not (
                    name == "st_staleness_seconds"
                    or name.startswith("st_staleness_seconds{")
                ):
                    continue
                raw = float(raw)
                lm = _LINK_RE.search(name)
                origin = None
                if lm is not None:
                    ov = m.get(
                        _schema.label_key(
                            "st_staleness_origin", "link", lm.group(1)
                        )
                    )
                    if ov is not None:
                        origin = int(ov)
                oc = clock.get(str(origin)) if origin is not None else None
                if applier is not None and oc is not None:
                    corrected = raw - applier["off_sec"] + oc["off_sec"]
                    unc = applier["unc_sec"] + oc["unc_sec"]
                else:
                    corrected, unc = raw, None
                corrected = max(0.0, corrected)
                rec = {
                    "raw_sec": raw,
                    "corrected_sec": corrected,
                    "unc_sec": unc,
                    "origin": origin,
                }
                prev = nodes_out.get(str(int(nid)))
                if prev is None or corrected > prev["corrected_sec"]:
                    nodes_out[str(int(nid))] = rec
                if worst is None or corrected > worst["corrected_sec"]:
                    worst = dict(rec, node=int(nid))
        return {
            "objective_sec": self.objective_sec,
            "worst": worst,
            "nodes": nodes_out,
        }

    # -- SLO --------------------------------------------------------------

    def _burn(self, window_sec: float, now_ns: int) -> float:
        since = now_ns - int(window_sec * 1e9)
        total = bad = 0
        for t, b in self._sli:
            if t >= since:
                total += 1
                bad += b
        if total == 0:
            return 0.0
        return (bad / total) / self.budget

    def _slo(self, stale: dict, t_ns: int) -> dict:
        worst = stale.get("worst")
        bad = 1 if worst and worst["corrected_sec"] > self.objective_sec else 0
        self.bad_beats += bad
        self._sli.append((t_ns, bad))
        horizon = t_ns - self._sli_horizon_ns
        while self._sli and self._sli[0][0] < horizon:
            self._sli.popleft()
        windows_out = {}
        alert = 0
        for i, (name, long_s, short_s, thr) in enumerate(self.windows):
            burn_long = self._burn(long_s, t_ns)
            burn_short = self._burn(short_s, t_ns)
            was = self._firing.get(name, False)
            if not was and burn_long >= thr and burn_short >= thr:
                self._firing[name] = True
                self._event(
                    "slo_alert_fire",
                    arg=i,
                    detail=f"{name}: burn {burn_long:.1f}x/{burn_short:.1f}x"
                    f" over {long_s:g}s/{short_s:g}s (thr {thr:g}x)",
                )
            elif was and burn_short < thr:
                self._firing[name] = False
                self._event(
                    "slo_alert_clear",
                    arg=i,
                    detail=f"{name}: short-window burn {burn_short:.1f}x"
                    f" back under {thr:g}x",
                )
            if self._firing.get(name, False):
                alert = max(alert, 2 if name == "page" else 1)
            windows_out[name] = {
                "long_sec": long_s,
                "short_sec": short_s,
                "threshold": thr,
                "burn_long": burn_long,
                "burn_short": burn_short,
                "firing": self._firing.get(name, False),
            }
        return {"budget": self.budget, "alert": alert, "windows": windows_out}

    # -- heat --------------------------------------------------------------

    def _heat(self, doc: dict) -> dict:
        rates: dict = {}       # shard -> summed apply rate
        outbox: dict = {}      # shard -> summed outbox backlog bytes
        alloc: dict = {}       # shard -> owner alloc bytes (max-rate node)
        owner_rate: dict = {}
        for nid, entry in doc.get("nodes", {}).items():
            m = entry.get("m", {})
            node_alloc = float(m.get("st_shard_alloc_bytes", 0.0))
            for name, v in m.items():
                sm = _SHARD_RE.search(name)
                if sm is None:
                    continue
                shard = int(sm.group(1))
                if name.startswith("st_shard_heat_applies{"):
                    r = self.store.node_rate(
                        int(nid), name, self.heat_window_sec
                    )
                    rates[shard] = rates.get(shard, 0.0) + r
                    # the node applying this shard's FWDs is its owner:
                    # its allocation share feeds the headroom term
                    if r >= owner_rate.get(shard, 0.0):
                        owner_rate[shard] = r
                        alloc[shard] = node_alloc
                elif name.startswith("st_shard_heat_outbox_bytes{"):
                    outbox[shard] = outbox.get(shard, 0.0) + float(v)
        shards = sorted(set(rates) | set(outbox))
        max_rate = max(rates.values(), default=0.0)
        max_out = max(outbox.values(), default=0.0)
        max_alloc = max(alloc.values(), default=0.0)
        out_shards = {}
        for k in shards:
            rn = rates.get(k, 0.0) / max_rate if max_rate > 0 else 0.0
            on = outbox.get(k, 0.0) / max_out if max_out > 0 else 0.0
            an = alloc.get(k, 0.0) / max_alloc if max_alloc > 0 else 0.0
            out_shards[str(k)] = {
                "apply_rate": rates.get(k, 0.0),
                "outbox_bytes": outbox.get(k, 0.0),
                "alloc_frac": an,
                "score": 0.6 * rn + 0.3 * on + 0.1 * an,
            }
        hot, ratio = -1, 0.0
        if len(shards) >= 2 and max_rate > 0:
            top = max(shards, key=lambda k: rates.get(k, 0.0))
            others = [rates.get(k, 0.0) for k in shards if k != top]
            mean_rest = sum(others) / len(others) if others else 0.0
            ratio = (
                rates.get(top, 0.0) / mean_rest if mean_rest > 0 else float("inf")
            )
            if ratio >= self.skew_ratio:
                hot = top
        if hot >= 0 and hot != self._hot_named:
            self._event(
                "hot_shard",
                arg=hot,
                detail=f"shard {hot} rate {rates.get(hot, 0.0):.1f}/s, "
                f"{'inf' if ratio == float('inf') else f'{ratio:.1f}'}x the rest",
            )
        self._hot_named = hot
        return {
            "window_sec": self.heat_window_sec,
            "shards": out_shards,
            "hot_shard": hot,
            "skew_ratio": ratio if ratio != float("inf") else -1.0,
        }

    # -- plumbing ----------------------------------------------------------

    def _event(self, name: str, arg: int = 0, detail: str = "") -> None:
        if self._emit is not None:
            try:
                self._emit(name, arg, detail)
            except Exception:
                pass  # health events must never take down the beat

    def _write(self, out: dict) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(out, f, separators=(",", ":"))
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
