"""Phase 8c's receive_frames alone and phase 8b's peer tree, from two
checkouts in turns (parent, change, change, parent), each run in a fresh
process on the GPU.

    python tools/receive_ab.py PARENT_DIR [CHANGE_DIR]

CHANGE_DIR defaults to this checkout. Each run builds its tree's kernels
and calls its own ``chip_smoke.fetch_ab`` (the receive half: host ms of
``receive_frames`` for one burst, of which staging and host-to-device
copy) and ``chip_smoke.peer_tree`` (four peers on the ResNet-18 table:
seconds of the four adds, last add to agreement, frames, H2D ms per frame
received by each peer, and each link's frames). Prints one line per run
and a JSON list of every run last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CODE = r"""
import json, sys
sys.path.insert(0, {tree!r})
import torch
import chip_smoke as C
from shared_tensor_tpu_torch.comm import wire
from shared_tensor_tpu_torch.ops import codec_cuda as CC
from shared_tensor_tpu_torch.ops.table import make_spec
CC.build()
t = C.resnet18_template()
dev = torch.device("cuda")
rx = C.fetch_ab(t, dev, min(16, wire.burst_frames_cap(make_spec(t))))["receive"]
tree = C.peer_tree(t, dev, 0)
peers = tree["per_peer"]
print("RESULT " + json.dumps(dict(
    rx, adds_s=tree["adds_s"], agree_s=tree["last_add_to_converged_s"], frames_out=tree["frames_out"],
    h2d_ms_per_frame=[1e3 * p["delta"]["st_h2d_seconds_total"] / max(1, p["delta"]["st_frames_in_total"])
                      for p in peers],
    link_frames_out=[{{k: v.get("st_link_frames_out_total", 0) for k, v in p["links"].items()}} for p in peers],
)))
"""


def main() -> None:
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(sys.argv[1]), "change": os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else here)}
    runs = []
    for name in ("parent", "change", "change", "parent"):
        p = subprocess.run([sys.executable, "-c", CODE.format(tree=trees[name])], capture_output=True, text=True,
                           cwd=trees[name], timeout=600)
        lines = [l for l in p.stdout.splitlines() if l.startswith("RESULT ")]
        print(name, p.returncode, lines[-1][7:] if lines else p.stderr[-2000:], flush=True)
        if p.returncode != 0 or not lines:
            sys.exit(f"the {name} run failed")
        runs.append({"tree": name, **json.loads(lines[-1][7:])})
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
