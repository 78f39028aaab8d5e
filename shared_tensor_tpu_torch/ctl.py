"""``python -m shared_tensor_tpu_torch.ctl``: the cluster's operator CLI.

The counterpart of ``shared_tensor_tpu/ctl.py``, with its commands and its
files, so it drives a tree with a port root or a JAX root alike. It works
over the two file channels the tree's ROOT serves: the live cluster digest
(``ObsConfig.cluster_json_path``, the file ``obs.top`` tails) for the
read-only views, and the lifecycle command directory
(``LifecycleConfig.ctl_dir``) for operations. Like ``obs.top`` it never
opens a socket into the cluster: it runs wherever the files are shared.

Commands::

    python -m shared_tensor_tpu_torch.ctl --file CLUSTER_JSON status
    python -m shared_tensor_tpu_torch.ctl --file CLUSTER_JSON versions
    python -m shared_tensor_tpu_torch.ctl --ctl-dir CTL_DIR snapshot --dir D
    python -m shared_tensor_tpu_torch.ctl --ctl-dir CTL_DIR restore  --dir D
    python -m shared_tensor_tpu_torch.ctl --ctl-dir CTL_DIR drain NODE
    python -m shared_tensor_tpu_torch.ctl verify --dir D        # offline audit
    python -m shared_tensor_tpu_torch.ctl health --health-file HEALTH_JSON

``status`` and ``versions`` read the digest; ``snapshot``, ``restore`` and
``drain`` write ``<ctl_dir>/cmd.json`` (atomically) and poll
``<ctl_dir>/result.json`` for the root's verdict; ``verify`` audits a
snapshot directory against its manifest (every shard there, every sha256
equal) with no cluster at all. The default paths lie in the temporary
directory (``TMPDIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import uuid

from .obs import top as _top


def _read_digest(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(f"cannot read cluster digest {path}: {e}")


def cmd_status(args) -> int:
    print(_top.render(_read_digest(args.file), None, 0.0))
    return 0


def cmd_versions(args) -> int:
    """The wire version of each node: the rolling upgrade's view. A steady
    cluster shows one version; two mid-upgrade are expected (every decoder
    takes both framings); a node the digest has not seen yet shows as '?'."""
    nodes = _read_digest(args.file).get("nodes", {})
    versions: dict[int, list[str]] = {}
    for nid in sorted(nodes, key=int):
        v = int(_top._node_val(nodes[nid].get("m", {}), "st_wire_version"))
        versions.setdefault(v, []).append(str(nodes[nid].get("name") or nid))
    for v in sorted(versions):
        label = f"v{v}" if v else "?"
        print(f"wire {label}: {len(versions[v])} node(s) — {', '.join(versions[v])}")
    if len([v for v in versions if v]) > 1:
        print("MIXED versions: rolling upgrade in progress (interop is version-gated — see MIGRATION.md's runbook)")
    return 0


def _send_cmd(ctl_dir: str, cmd: dict, timeout: float) -> dict:
    from .utils.checkpoint import atomic_write_json

    cmd = dict(cmd, req_id=uuid.uuid4().hex)
    atomic_write_json(os.path.join(ctl_dir, "cmd.json"), cmd)
    res_path = os.path.join(ctl_dir, "result.json")
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(res_path) as f:
                res = json.load(f)
            if res.get("req_id") == cmd["req_id"]:
                return res
        except (OSError, ValueError):
            pass
        time.sleep(0.25)
    raise SystemExit(
        f"no result from the root within {timeout}s — is a root peer polling LifecycleConfig.ctl_dir={ctl_dir}?"
    )


def _print_result(res: dict) -> int:
    print(json.dumps(res, indent=2))
    return 0 if res.get("ok") else 1


def cmd_snapshot(args) -> int:
    return _print_result(_send_cmd(args.ctl_dir, {"op": "snapshot", "dir": os.path.abspath(args.dir)}, args.timeout))


def cmd_restore(args) -> int:
    return _print_result(_send_cmd(args.ctl_dir, {"op": "restore", "dir": os.path.abspath(args.dir)}, args.timeout))


def cmd_drain(args) -> int:
    return _print_result(_send_cmd(args.ctl_dir, {"op": "drain", "target": args.node}, args.timeout))


def cmd_health(args) -> int:
    """The fleet's health verdict from the root's health.json: exit 0 when
    no SLO alert fires, 1 while one does (its severity printed), 2 when the
    file is unreadable, so a readiness or paging probe can call it."""
    try:
        with open(args.health_file) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot read health file {args.health_file}: {e}", file=sys.stderr)
        return 2
    slo = doc.get("slo") or {}
    alert = int(slo.get("alert", 0))
    badge = {0: "ok", 1: "TICKET", 2: "PAGE"}.get(alert, str(alert))
    partial = " (PARTIAL: digest breakdowns truncated)" if doc.get("partial") else ""
    print(f"health [{badge}] — beat {doc.get('beats', 0)}, {doc.get('nodes', 0)} node(s){partial}")
    worst = (doc.get("staleness") or {}).get("worst")
    if worst:
        unc = worst.get("unc_sec")
        bound = f" ±{unc:.4f}s" if unc is not None else " (uncorrected)"
        print(f"  staleness worst {worst['corrected_sec']:.4f}s{bound} @ node {worst.get('node', '?')} "
              f"(objective {(doc.get('staleness') or {}).get('objective_sec', 0):g}s)")
    for name, w in sorted((slo.get("windows") or {}).items()):
        state = "FIRING" if w.get("firing") else "ok"
        print(f"  slo/{name}: {state} — burn {w.get('burn_long', 0.0):.1f}x long / {w.get('burn_short', 0.0):.1f}x "
              f"short (threshold {w.get('threshold', 0.0):g}x)")
    heat = doc.get("heat") or {}
    hot = int(heat.get("hot_shard", -1))
    shards = heat.get("shards") or {}
    if shards:
        hottest = max(shards.items(), key=lambda kv: kv[1].get("score", 0.0))
        print(f"  heat: {len(shards)} shard(s), top s{hottest[0]} score {hottest[1].get('score', 0.0):.2f}"
              + (f" — HOT shard {hot} (zipf skew)" if hot >= 0 else ""))
    return 1 if alert else 0


def cmd_verify(args) -> int:
    from .utils import checkpoint as ckpt

    problems = ckpt.verify_manifest(args.dir)
    if problems:
        for p in problems:
            print(f"FAIL: {p}")
        return 1
    doc = ckpt.load_manifest(args.dir)
    print(f"OK: snapshot {doc.get('snap_id')} — {len(doc.get('nodes', []))} shard(s), digests match")
    return 0


def main(argv=None) -> int:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(prog="python -m shared_tensor_tpu_torch.ctl",
                                 description="the cluster lifecycle's operator CLI")
    ap.add_argument("--file", default=os.path.join(tmp, "st_cluster.json"),
                    help="cluster digest JSON the root writes (ObsConfig.cluster_json_path)")
    ap.add_argument("--ctl-dir", default=os.path.join(tmp, "st_ctl"),
                    help="lifecycle command directory the root polls (LifecycleConfig.ctl_dir)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds to wait for the root's verdict on an operation")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status", help="render the live cluster digest once")
    sub.add_parser("versions", help="per-node wire-version audit")
    p = sub.add_parser("snapshot", help="consistent-cut snapshot of the tree")
    p.add_argument("--dir", required=True, help="snapshot output directory")
    p = sub.add_parser("restore", help="in-place restore of a live tree")
    p.add_argument("--dir", required=True, help="snapshot directory")
    p = sub.add_parser("drain", help="gracefully drain one node out")
    p.add_argument("node", help="target node name (LifecycleConfig.node_name)")
    p = sub.add_parser("verify", help="offline snapshot-manifest audit")
    p.add_argument("--dir", required=True, help="snapshot directory")
    p = sub.add_parser("health", help="fleet health verdict from the root's health.json")
    p.add_argument("--health-file", default=os.path.join(tmp, "st_health.json"),
                   help="health JSON the root writes (ObsConfig.health_json_path)")
    args = ap.parse_args(argv)
    return {
        "status": cmd_status,
        "versions": cmd_versions,
        "snapshot": cmd_snapshot,
        "restore": cmd_restore,
        "drain": cmd_drain,
        "verify": cmd_verify,
        "health": cmd_health,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
