"""char-rnn async-DP training demo (BASELINE config 2: "char-rnn param sync,
4 peers, approximate-delta compression on"), on PyTorch.

    python -m shared_tensor_tpu_torch.examples.train_char_rnn [corpus.txt] [--peers 4] [--overlap]

Two modes:

- pod (default): ``--peers`` ranks on this host (``parallel.run_mesh``), one
  per peer, each on the GPU ``cuda:{rank % device count}``; compressed sync
  through kernels A and B and one all-gather per step. Ranks that share a
  card talk over gloo, since NCCL refuses two ranks on one device; the
  backend in use is printed. ``--device cpu`` runs on the CPU with gloo.
- peer: ``--peer host:port``: this process is one worker of the TCP tree
  (``create_or_fetch``); run it in several terminals, the first becomes the
  master. Each step reads the table, takes the grads and adds the update.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

from ..models import char_rnn as m

#: The built-in corpus when no file is given.
PANGRAM = b"The quick brown fox jumps over the lazy dog. " * 2000


def pod_backend(device: str | None, peers: int) -> str:
    """NCCL when every rank has a GPU of its own, gloo otherwise."""
    if device == "cpu" or torch.cuda.device_count() < peers:
        return "gloo"
    return "nccl"


def _pod_rank(mesh, text: bytes, cfg: m.CharRNNConfig, args: dict):
    from ..train import PodTrainer

    talk = mesh.peer == 0
    params = m.init_params(torch.Generator().manual_seed(0), cfg, device=mesh.device)
    tr = PodTrainer(mesh, params, lambda p, b: m.loss_fn(p, b, cfg), overlap=args["overlap"])
    data = m.encode_corpus(text, device=mesh.device)
    if talk:
        print(f"{cfg.param_count} params, {mesh.n_peer} peers, device={mesh.device}, backend={mesh.backend}", flush=True)
    t0 = time.perf_counter()
    for i in range(args["steps"]):
        batch = m.make_batches(data, args["batch"], args["seq"], torch.Generator().manual_seed(i), n_peer=mesh.n_peer)
        losses, _ = tr.step(tr.shard_batch(batch), lr=args["lr"])
        if i % 20 == 0 or i == args["steps"] - 1:
            spread = tr.replica_spread()
            if talk:
                toks = (i + 1) * mesh.n_peer * args["batch"] * args["seq"]
                print(f"step {i:4d} loss {float(losses.mean()):.3f} spread {spread:.2e} "
                      f"tok/s {toks / (time.perf_counter() - t0):.0f}", flush=True)
    params = tr.read(0)
    if talk:
        prompt = torch.frombuffer(bytearray(text[:16]), dtype=torch.uint8).long()
        gen = torch.Generator(device=mesh.device).manual_seed(1)
        out = m.sample(params, gen, prompt, cfg, length=200, temperature=0.8)
        print("--- sample ---")
        print((text[:16] + bytes(int(t) % 256 for t in out.tolist())).decode(errors="replace"), flush=True)


def train_pod(text: bytes, cfg: m.CharRNNConfig, args) -> None:
    from ..parallel import run_mesh

    backend = pod_backend(args.device, args.peers)
    run_mesh(_pod_rank, args.peers, 1, text, cfg, vars(args), device=args.device, backend=backend,
             timeout_s=args.timeout)


def train_peer(text: bytes, cfg: m.CharRNNConfig, args) -> None:
    from .. import create_or_fetch
    from ..ops.table import tree_flatten, tree_unflatten

    host, port = args.peer.rsplit(":", 1)
    params = m.init_params(torch.Generator().manual_seed(0), cfg, device=args.device)
    with create_or_fetch(host, int(port), params, device=args.device) as st:
        dev = st.st.device
        data = m.encode_corpus(text, device=dev)
        t0 = time.perf_counter()
        for i in range(args.steps):
            leaves, treedef = tree_flatten(st.read())
            leaves = [x.requires_grad_(True) for x in leaves]
            batch = m.make_batches(data, args.batch, args.seq, torch.Generator().manual_seed(i))
            loss = m.loss_fn(tree_unflatten(treedef, leaves), batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
            st.add(tree_unflatten(treedef, [-args.lr * g for g in grads]))
            if i % 20 == 0:
                print(f"step {i:4d} loss {float(loss.detach()):.3f} frames out {st.st.frames_out} in {st.st.frames_in}",
                      flush=True)
        print(f"done in {time.perf_counter() - t0:.1f}s; frames out {st.st.frames_out} in {st.st.frames_in}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("corpus", nargs="?", help="text file (default: built-in pangram)")
    ap.add_argument("--peers", type=int, default=4)
    ap.add_argument("--peer", help="host:port: join/seed the TCP tree instead of a pod mesh")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--overlap", action="store_true", help="run the sync collective under the backward pass")
    ap.add_argument("--device", default=None, help="'cpu' for the CPU (default: the GPU)")
    ap.add_argument("--timeout", type=float, default=3600.0, help="pod mode: seconds before the ranks are killed")
    args = ap.parse_args()

    text = pathlib.Path(args.corpus).read_bytes() if args.corpus else PANGRAM
    if len(text) < args.seq + 2:
        sys.exit("corpus too small for --seq")
    cfg = m.CharRNNConfig(hidden=args.hidden, layers=args.layers)
    if args.peer:
        train_peer(text, cfg, args)
    else:
        train_pod(text, cfg, args)


if __name__ == "__main__":
    main()
