"""The device tier's cascade burst on the card: kernel A-cascade's time at
several depths, and the whole K-frame burst graph's replay.

    python -m shared_tensor_tpu_torch.benchmarks.burst_graph [--kcs 1,11,16,32] [--k 16] [--out FILE]

On BASELINE config 2's table (the default ``CharRNNConfig``'s 9 leaves,
3,870,976 elements), on a 1 Mi flat table and on config 4's (ResNet-18's
56 leaves, 11,172,170 elements), with ``chip_smoke.py``
phase 22a's residual (gaussian times 1e-2, every 997th element times 50,
padding 0, from a seeded ``torch.Generator``):

- A-cascade at each depth of ``--kcs`` from the ladder top of the
  residual's own measurement: ms a launch from a CUDA graph of 50 launches
  over buffer sets holding four times the L2, beside its bytes bound and
  ``copy_ms`` (a device copy of the same bytes);
- the measurement A-cascade's rounds stand on: ms of one finish kernel
  where the tree has it, and of the torch chain it replaces
  (``table.compute_scales`` and ``table.cascade_ladder``) from a graph; and
  of a spent round's two launches (the burst stopped: each returns at
  once);
- one K-frame ``core._BurstGraph`` (cascade 32, the peer's default): ms of
  ``graph.replay()`` alone between CUDA events (the residual restored
  before each replay, outside the events), and the node types of a
  capture of the same burst.

Prints the card's name and power limit, one JSON line a table and, with
``--out``, writes them there too. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import itertools
import json
import subprocess
import sys

import numpy as np
import torch

#: cuGraphNodeGetType's CUgraphNodeType values
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty", 6: "wait_event",
              7: "event_record"}
RATE = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA's data sheet)


def config2_template() -> dict:
    """BASELINE config 2's table: the default CharRNNConfig's parameter
    shapes as zero float32 arrays."""
    from ..models import char_rnn as m
    from ..ops.table import tree_flatten, tree_unflatten

    params = m.init_params(torch.Generator().manual_seed(0), m.CharRNNConfig(), device="cpu")
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [np.zeros(tuple(x.shape), np.float32) for x in leaves])


def resnet18_template() -> dict:
    """BASELINE config 4's table: the default ResNetConfig's (ResNet-18)
    parameter shapes as zero float32 arrays."""
    from ..models import resnet as m
    from ..ops.table import tree_flatten, tree_unflatten

    params = m.init_params(torch.Generator().manual_seed(0), m.ResNetConfig(), device="cpu")
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [np.zeros(tuple(x.shape), np.float32) for x in leaves])


def residual(spec, device, seed: int) -> torch.Tensor:
    """Phase 22a's residual: gaussian 1e-2, every 997th element x50, padding 0."""
    from ..ops import table as T

    live = T._consts(spec, str(torch.device(device)))[2]
    gen = torch.Generator(device=device).manual_seed(seed)
    r = torch.randn(spec.total, generator=gen, device=device) * 1e-2
    r[::997] *= 50.0
    return torch.where(live.view(-1), r, torch.zeros_like(r))


def round_trip(spec, r0, kc, quantize, finish, policy, per_leaf=True, j0=0, k=None, cap=32) -> list:
    """A cascade burst's launches by hand, with the given A-cascade and
    finish functions (kernels or plain twins): the measuring launch on a
    copy of ``r0``, the first finish, one A-cascade pass at depth ``kc``
    from ``j0`` of ``k`` (default ``j0 + kc``) frames, and the next finish.
    After each launch, the residual and every ``table.CascadeBuffers``
    field, on the host."""
    from ..ops import table as T

    dev = r0.device
    row_leaf, rowcount, *_ = T._consts(spec, str(dev))
    c = T._cascade_consts(spec, str(dev))
    k = j0 + kc if k is None else k
    b = T.cascade_buffers(spec, k, dev)
    for x in (b.state, b.ladder, b.leaf_sums):  # what the measuring launch leaves unwritten
        x.zero_()
    resid = r0.clone()
    out = []

    def snap():
        out.append([x.cpu() for x in (resid, *b)])

    quantize(b.ladder[2], row_leaf, rowcount, b.state, resid, b.words, b.scales, b.partials, begin=True)
    snap()
    finish(b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder, b.leaf_sums, k, cap, policy, per_leaf, True)
    snap()
    b.state.copy_(torch.tensor([j0, kc, 0], dtype=torch.int32))
    quantize(b.ladder[2], row_leaf, rowcount, b.state, resid, b.words, b.scales, b.partials)
    snap()
    finish(b.partials, c.leaf_slots, c.ns, b.scales, b.state, b.ladder, b.leaf_sums, k, cap, policy, per_leaf, False)
    snap()
    return out


def _handle(obj) -> int:
    if isinstance(obj, int):
        return obj
    get = ctypes.pythonapi.PyCapsule_GetPointer
    get.restype, get.argtypes = ctypes.c_void_p, [ctypes.py_object, ctypes.c_char_p]
    return get(obj, None)


def graph_node_types(fn) -> dict:
    """Node counts by type of a CUDA graph that captures ``fn()`` (after one
    eager call), read with the driver's ``cuGraphGetNodes`` from a graph
    kept by ``CUDAGraph(keep_graph=True)``."""
    fn()
    torch.cuda.synchronize()
    from ..utils.timing import no_collection

    g = torch.cuda.CUDAGraph(keep_graph=True)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with no_collection(), torch.cuda.graph(g, stream=s, capture_error_mode="thread_local"):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    cu = ctypes.CDLL("libcuda.so.1")
    h = ctypes.c_void_p(_handle(g.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(h, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    out: dict = {}
    for node in nodes:
        t = ctypes.c_int()
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        name = NODE_TYPES.get(t.value, str(t.value))
        out[name] = out.get(name, 0) + 1
    return out


def _graph_ms(fn, iters: int = 50) -> float:
    from ..utils.timing import graph_ms

    return graph_ms(fn, iters)


def cascade_times(spec, device, kcs, seed: int, rate: float = RATE) -> dict:
    """A-cascade at each depth of ``kcs`` (module docstring)."""
    from ..config import ScalePolicy
    from ..ops import codec_cuda as CC
    from ..ops import table as T
    from ..utils.timing import copy_ms, l2_sets

    row_leaf, rowcount, *_ = T._consts(spec, str(torch.device(device)))
    r0 = residual(spec, device, seed)
    s, amax = T._table_scales(r0, spec, ScalePolicy.POW2_RMS, True, with_amax=True)
    rows, n_leaves = spec.rows, spec.num_leaves
    fused = "partials" in inspect.signature(CC.quantize_rows_cascade_kernel).parameters
    slots = CC.partial_slots(rows) if fused else 0

    def buffers(kc):
        out = [r0.clone(), torch.zeros((kc, rows * 4), dtype=torch.int32, device=device),
               torch.zeros((kc, n_leaves), dtype=torch.float32, device=device)]
        if fused:
            out.append(torch.empty((3, slots), dtype=torch.float64, device=device))
        return out

    out = {}
    for kc in kcs:
        top = T.cascade_ladder(s, amax, kc)[0] if kc > 1 else s
        state = torch.tensor([0, kc], dtype=torch.int32, device=device)
        # residual read and written, kc bit planes, the row constants and
        # the ladder top read, kc scale rows (and the fused pass's partials)
        nbytes = spec.total * 8 + kc * spec.total / 8 + rows * 12 + n_leaves * 4 * (1 + kc)
        nbytes += slots * 24
        sets = [buffers(kc) for _ in range(l2_sets(nbytes, device))]
        turn = itertools.cycle(sets)
        launch = lambda: CC.quantize_rows_cascade_kernel(top, row_leaf, rowcount, state, *next(turn))  # noqa: E731
        ms = _graph_ms(launch)
        out[kc] = {"ms": ms, "bytes": nbytes, "bound_ms": nbytes / rate * 1e3, "pct_of_bound": 100 * nbytes / rate
                   * 1e3 / ms, "copy_ms": copy_ms(nbytes, device, _graph_ms, sets=len(sets)), "sets": len(sets)}
        del sets, turn
    return out


def measure_times(spec, device, seed: int, k: int, cascade: int) -> dict:
    """The per-round measurement: the finish kernel (where the tree has it)
    and the torch chain it replaces, each from a graph of 50 calls."""
    from ..config import ScalePolicy
    from ..ops import codec_cuda as CC
    from ..ops import table as T

    r0 = residual(spec, device, seed)
    cap = torch.tensor(min(k, cascade), device=device)
    out = {"torch_chain_ms": _graph_ms(lambda: T.cascade_ladder(
        *T.compute_scales(r0, spec, ScalePolicy.POW2_RMS, with_amax=True), cap))}
    if hasattr(CC, "cascade_round_kernel"):
        c = T._cascade_consts(spec, str(torch.device(device)))
        bufs = T.cascade_buffers(spec, k, device)
        row_leaf, rowcount, *_ = T._consts(spec, str(torch.device(device)))
        CC.quantize_rows_cascade_kernel(bufs.ladder[2], row_leaf, rowcount, bufs.state, r0.clone(), bufs.words,
                                        bufs.scales, bufs.partials, begin=True)
        out["finish_ms"] = _graph_ms(lambda: CC.cascade_round_kernel(
            bufs.partials, c.leaf_slots, c.ns, bufs.scales, bufs.state, bufs.ladder, bufs.leaf_sums, k, cascade,
            ScalePolicy.POW2_RMS, True, True))
        # a spent round: the burst stopped, both launches return at once
        bufs.state.copy_(torch.tensor([k, 0, 1], dtype=torch.int32))
        r = r0.clone()
        out["spent_pass_ms"] = _graph_ms(lambda: CC.quantize_rows_cascade_kernel(
            bufs.ladder[2], row_leaf, rowcount, bufs.state, r, bufs.words, bufs.scales, bufs.partials))
        out["spent_finish_ms"] = _graph_ms(lambda: CC.cascade_round_kernel(
            bufs.partials, c.leaf_slots, c.ns, bufs.scales, bufs.state, bufs.ladder, bufs.leaf_sums, k, cascade,
            ScalePolicy.POW2_RMS, True, False))
    return out


def burst_replay(spec, device, seed: int, k: int, cascade: int, reps: int = 20) -> dict:
    """One K-frame ``core._BurstGraph``: ms of its replay alone (module
    docstring), the frames it yields, and its capture's node types."""
    from ..config import CodecConfig
    from ..core import _BurstGraph
    from ..ops.table import quantize_table_cascade

    r0 = residual(spec, device, seed)
    resid = r0.clone()
    g = _BurstGraph(resid, spec, k, cascade, CodecConfig(), torch.cuda.Stream())
    times = []
    frames = 0
    for i in range(reps + 2):
        resid.copy_(r0)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.graph.replay()
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
        frames = int(g.out.scales.ne(0).any(dim=1).sum())
    tmp = r0.clone()
    nodes = graph_node_types(lambda: quantize_table_cascade(tmp, spec, k, cascade))
    return {"replay_ms": float(np.median(times)), "replay_ms_min": float(min(times)),
            "replay_ms_max": float(max(times)), "reps": reps, "frames": frames, "nodes": nodes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kcs", default="1,11,16,32")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--cascade", type=int, default=32)
    ap.add_argument("--seed", type=int, default=22)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("burst_graph: needs a CUDA device", file=sys.stderr)
        return 2
    from ..ops import codec_cuda as CC
    from ..ops.table import make_spec

    CC.build()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    kcs = [int(x) for x in args.kcs.split(",")]
    rows = []
    for name, tmpl in (("config2", config2_template()), ("1Mi", {"t": np.zeros(1 << 20, np.float32)}),
                       ("resnet18", resnet18_template())):
        spec = make_spec(tmpl)
        row = {"bench": "burst_graph", "table": name, "rows": spec.rows, "leaves": spec.num_leaves, "k": args.k,
               "cascade": args.cascade, "card": smi, "torch": torch.__version__,
               "a_cascade": cascade_times(spec, dev, kcs, args.seed),
               "measure": measure_times(spec, dev, args.seed, args.k, args.cascade),
               "burst": burst_replay(spec, dev, args.seed, args.k, args.cascade)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
