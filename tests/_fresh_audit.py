"""Runs each test of some test files first in a fresh interpreter, and
records its outcome and the transport nodes each package made in its
process: the way to see an in-process fault that earlier tests in the same
process would hide (two packages' node ids colliding, say).

    python tests/_fresh_audit.py run --tree DIR --out FILE.jsonl [-j 6] FILE...
    python tests/_fresh_audit.py compare PARENT.jsonl CHANGE.jsonl

``run`` collects the files' tests in the checkout DIR (``-m 'not slow'``)
and runs each alone, ``-j`` at a time, with this module loaded as a pytest
plugin (a copy of it under a temporary directory, so a checkout without it
works too). Each line of the output is one test: its id, outcome, the
``(package, obs_id)`` of every ``TransportNode`` made in its process, and
whether a JAX id equals a port id. ``compare`` prints the tests that made
nodes of both packages, the runs holding a shared id, and every test whose
outcome differs between the two files.
"""

import argparse
import concurrent.futures
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

_MADE: list = []
_OUTCOME: dict = {}


# -- the plugin side (loaded into each test's interpreter) ------------------


def pytest_collection_finish(session):
    import shared_tensor_tpu.comm.transport as jax_transport
    import shared_tensor_tpu_torch.comm.transport as port_transport

    for tag, cls in (("jax", jax_transport.TransportNode), ("port", port_transport.TransportNode)):
        def init(self, *a, _orig=cls.__init__, _tag=tag, **k):
            _orig(self, *a, **k)
            _MADE.append((_tag, int(self.obs_id)))

        cls.__init__ = init


def pytest_runtest_logreport(report):
    if report.failed or report.when == "call" or (report.when == "setup" and report.skipped):
        if _OUTCOME.get(report.nodeid) != "failed":
            _OUTCOME[report.nodeid] = report.outcome


def pytest_sessionfinish(session, exitstatus):
    with open(os.environ["FRESH_AUDIT_OUT"], "w") as f:
        json.dump({"made": _MADE, "outcome": _OUTCOME}, f)


# -- the runner side ----------------------------------------------------------


def _pytest(tree: pathlib.Path, args: list, env: dict, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:randomly", "-p", "no:cacheprovider",
                           "-m", "not slow", *args], cwd=tree, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _run_one(tree: pathlib.Path, plugin_dir: str, nodeid: str, timeout: float) -> dict:
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as tmp:
        out_path = tmp.name
    env = dict(os.environ, JAX_PLATFORMS="cpu", FRESH_AUDIT_OUT=out_path,
               PYTHONPATH=os.pathsep.join(filter(None, [plugin_dir, os.environ.get("PYTHONPATH")])))
    try:
        rc = _pytest(tree, ["-p", "_fresh_audit", nodeid], env, timeout).returncode
        with open(out_path) as f:
            doc = json.load(f)
    except (subprocess.TimeoutExpired, OSError, ValueError) as e:
        rc, doc = None, {"made": [], "outcome": {}, "error": repr(e)}
    finally:
        if os.path.exists(out_path):
            os.remove(out_path)
    jax_ids = {i for t, i in doc["made"] if t == "jax"}
    port_ids = {i for t, i in doc["made"] if t == "port"}
    return {"test": nodeid, "rc": rc, "outcome": doc["outcome"].get(nodeid, "no result"), "made": doc["made"],
            "shared_id": bool(jax_ids & port_ids)}


def run(tree: pathlib.Path, files: list, out: str, jobs: int, timeout: float) -> None:
    listing = _pytest(tree, ["--collect-only", "-o", "addopts=", *files], dict(os.environ, JAX_PLATFORMS="cpu"), 600)
    ids = [ln for ln in listing.stdout.splitlines() if "::" in ln]
    with tempfile.TemporaryDirectory() as plugin_dir:
        shutil.copy(__file__, os.path.join(plugin_dir, "_fresh_audit.py"))
        with concurrent.futures.ThreadPoolExecutor(jobs) as pool, open(out, "w") as f:
            for row in pool.map(lambda nid: _run_one(tree, plugin_dir, nid, timeout), ids):
                f.write(json.dumps(row) + "\n")
                f.flush()
    print(f"{len(ids)} tests run first in a fresh interpreter; results in {out}")


def compare(parent: str, change: str) -> None:
    rows = [{r["test"]: r for r in map(json.loads, open(p))} for p in (parent, change)]

    def mixed(r):
        return {t for t, _ in r["made"]} == {"jax", "port"}

    both = sorted(set(rows[0]) & set(rows[1]))
    mix = [t for t in both if mixed(rows[0][t]) or mixed(rows[1][t])]
    print(f"{len(both)} tests in both runs; {len(mix)} made nodes of both packages in one process")
    for name, r in zip(("parent", "change"), rows):
        print(f"{name}: {sum(r[t]['shared_id'] for t in both)} runs held a JAX id equal to a port id")
    for t in both:
        a, b = rows[0][t]["outcome"], rows[1][t]["outcome"]
        if a != b:
            print(f"changed: {t}: {a} -> {b}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--tree", type=pathlib.Path, default=pathlib.Path.cwd())
    r.add_argument("--out", required=True)
    r.add_argument("-j", "--jobs", type=int, default=6)
    r.add_argument("--timeout", type=float, default=400.0)
    r.add_argument("files", nargs="+")
    c = sub.add_parser("compare")
    c.add_argument("parent")
    c.add_argument("change")
    a = ap.parse_args()
    if a.cmd == "run":
        run(a.tree.resolve(), a.files, a.out, a.jobs, a.timeout)
    else:
        compare(a.parent, a.change)


if __name__ == "__main__":
    main()
