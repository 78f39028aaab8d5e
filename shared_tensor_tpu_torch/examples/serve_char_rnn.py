"""char-RNN serving demo: a read-only subscriber replica serves text
generation while trainer peers stream weight updates through the tree.

    python -m shared_tensor_tpu_torch.examples.serve_char_rnn [corpus.txt] [--device cpu]

The counterpart of the root ``examples/serve_char_rnn.py``, the read-path
twin of ``train_char_rnn.py``'s peer mode:

- N trainer peers (writers) join the tree at the rendezvous and run
  async SGD, each adding its own gradient steps;
- one SUBSCRIBER joins as a read-only leaf (it never adds), and a
  ``serve.ServingHandle`` hot-swaps verified snapshots into the sampling
  loop;
- every swap verifies its staleness bound against the origin stamps and
  FRESH drain marks: a violation raises ``StalenessError`` instead of
  serving stale weights.

One process by default (trainers on background threads, the subscriber
serving from the main thread); ``--peer`` / ``--serve`` split it across
processes:

  # terminals 1..n: trainers (writers)
  python -m shared_tensor_tpu_torch.examples.serve_char_rnn --peer 127.0.0.1:50000
  # terminal n+1: the serving replica
  python -m shared_tensor_tpu_torch.examples.serve_char_rnn --serve 127.0.0.1:50000

Peers and the handle's tensors live on the GPU unless ``--device cpu``
asks for the CPU (without a GPU they raise). Exits non-zero when nothing
was served.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import threading
import time

import torch

from .. import serve
from ..models import char_rnn as m
from ..ops.table import tree_flatten, tree_unflatten


def run_trainer(host, port, cfg, text, args, stop=None, tag="trainer", ready=None):
    from .. import create_or_fetch

    params = m.init_params(torch.Generator().manual_seed(0), cfg, device=args.device)
    with create_or_fetch(host, port, params, device=args.device) as st:
        if ready is not None:
            ready.set()  # the tree exists: joiners and subscribers may start
        data = m.encode_corpus(text, device=st.st.device)
        for i in range(args.steps):
            if stop is not None and stop.is_set():
                break
            leaves, treedef = tree_flatten(st.read())
            leaves = [x.requires_grad_(True) for x in leaves]
            batch = m.make_batches(data, args.batch, args.seq, torch.Generator().manual_seed(i))
            loss = m.loss_fn(tree_unflatten(treedef, leaves), batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
            st.add(tree_unflatten(treedef, [-args.lr * g for g in grads]))
            if i % 20 == 0:
                print(f"[{tag}] step {i:4d} loss {float(loss.detach()):.3f}", flush=True)
        st.drain(timeout=30.0, tol=1e-30)


def run_server(host, port, cfg, text, args, stop=None):
    """The serving loop: subscribe read-only, hot-swap verified weights,
    sample. Every ``refresh`` is a verified bounded-staleness read: stale
    weights could only be served loudly, as an exception."""
    template = m.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sub = serve.subscribe(host, port, template, timeout=60.0)
    handle = sub.serving_handle(max_staleness=args.max_staleness, device=args.device)
    served = refused = 0
    prompt = torch.frombuffer(bytearray(text[:8]), dtype=torch.uint8).long()
    try:
        deadline = time.monotonic() + args.serve_seconds
        while time.monotonic() < deadline:
            if stop is not None and stop.is_set() and served:
                break
            try:
                handle.refresh()
            except serve.StalenessError as e:
                refused += 1
                print(f"[serve] REFUSED: {e}", flush=True)
                time.sleep(0.25)
                continue
            params = handle.params()
            gen = torch.Generator(device=params["embed"].device).manual_seed(served)
            out = m.sample(params, gen, prompt, cfg, length=args.sample_len, temperature=0.8)
            txt = (text[:8] + bytes(int(t) % 256 for t in out.tolist())).decode(errors="replace")
            served += 1
            print(f"[serve] v{handle.version} staleness {handle.staleness:.3f}s (bound "
                  f"{args.max_staleness}s): {txt[:72]!r}", flush=True)
            time.sleep(args.serve_interval)
    finally:
        mtr = sub.metrics()
        print(f"[serve] served {served} samples, {refused} refused; reads ok/stale = "
              f"{mtr['st_read_total']:.0f}/{mtr['st_read_stale_total']:.0f}, "
              f"resyncs {mtr['st_sub_resyncs_total']:.0f}", flush=True)
        sub.close()
    if served == 0:
        sys.exit("[serve] nothing served: were the trainers up?")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("corpus", nargs="?", help="text file (default: pangram)")
    ap.add_argument("--peer", help="host:port: run ONE trainer process")
    ap.add_argument("--serve", help="host:port: run ONE serving process")
    ap.add_argument("--port", type=int, default=50310)
    ap.add_argument("--trainers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--max-staleness", type=float, default=1.0)
    ap.add_argument("--serve-seconds", type=float, default=30.0)
    ap.add_argument("--serve-interval", type=float, default=0.5)
    ap.add_argument("--sample-len", type=int, default=64)
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the GPU)")
    args = ap.parse_args()

    text = pathlib.Path(args.corpus).read_bytes() if args.corpus else b"The quick brown fox jumps over the lazy dog. " * 500
    cfg = m.CharRNNConfig(hidden=args.hidden, layers=args.layers)

    if args.peer:
        host, port = args.peer.rsplit(":", 1)
        run_trainer(host, int(port), cfg, text, args)
        return
    if args.serve:
        host, port = args.serve.rsplit(":", 1)
        run_server(host, int(port), cfg, text, args)
        return

    # one process: trainers on threads, serving on the main thread
    host, port = "127.0.0.1", args.port
    stop = threading.Event()
    master_up = threading.Event()
    # the trainers train for the WHOLE serving window (stop ends them);
    # --steps bounds only the split-process mode
    t_args = argparse.Namespace(**{**vars(args), "steps": 10**9})
    trainers = [
        threading.Thread(
            target=run_trainer,
            args=(host, port, cfg, text, t_args, stop, f"trainer{i}"),
            kwargs={"ready": master_up if i == 0 else None},
            daemon=True,
        )
        for i in range(args.trainers)
    ]
    trainers[0].start()
    if not master_up.wait(120.0):  # the model's init happens before the join
        sys.exit("trainer 0 never claimed the rendezvous")
    for t in trainers[1:]:
        t.start()
    try:
        run_server(host, port, cfg, text, args, stop)
    finally:
        stop.set()
        for t in trainers:
            t.join(timeout=60.0)


if __name__ == "__main__":
    main()
