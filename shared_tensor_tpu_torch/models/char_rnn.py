"""char-rnn: the flagship workload model (BASELINE config 2), in PyTorch.

The counterpart of ``shared_tensor_tpu/models/char_rnn.py``: a multi-layer
LSTM over byte-level tokens, written as plain functions on an explicit
parameter pytree (a dict holding a list of dicts). The pytree IS the table
the pod tier syncs, so its structure, leaf order and shapes are the JAX
package's and its layout digest equals JAX's: a mixed JAX/PyTorch tree can
train one model.

Numerics follow the JAX model. Its matmuls round both operands to bf16 and
return f32 (``preferred_element_type``); a PyTorch bf16 matmul would return
bf16, a different number. So :func:`_mm` rounds the operands to bf16 and
multiplies them as f32: bf16 values are exact in f32 (and in TF32), the
products are exact and the sum stays in f32. The backward pass rounds each
cotangent at the same casts as JAX's. Gate math, the cell state and the
parameters stay f32. The recurrence is a Python loop over time steps (JAX's
``lax.scan``); the input projection of every step is one matmul hoisted out
of it, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..core import resolve_device


@dataclasses.dataclass(frozen=True)
class CharRNNConfig:
    """Defaults are the flagship size: 2-layer LSTM, 512 hidden units,
    byte vocabulary; 3,870,976 parameters."""

    vocab: int = 256
    embed: int = 256
    hidden: int = 512
    layers: int = 2

    @property
    def param_count(self) -> int:
        n = self.vocab * self.embed
        d = self.embed
        for _ in range(self.layers):
            n += (d + self.hidden + 1) * 4 * self.hidden
            d = self.hidden
        n += (self.hidden + 1) * self.vocab
        return n


def init_params(generator: torch.Generator, cfg: CharRNNConfig, device=None) -> dict:
    """Parameter pytree, drawn from ``generator`` (a CPU generator: the
    same seed gives the same parameters on every device). Scaled-normal
    init; the forget-gate bias starts at 1. Gate order along the 4H axis:
    [input, forget, cell (g), output]. ``device=None`` is the GPU."""
    dev = resolve_device(device)
    normal = lambda *shape: torch.randn(shape, generator=generator, dtype=torch.float32)
    params: dict[str, Any] = {"embed": normal(cfg.vocab, cfg.embed) * 0.08}
    lstm = []
    d = cfg.embed
    for _ in range(cfg.layers):
        b = torch.zeros(4 * cfg.hidden)
        b[cfg.hidden : 2 * cfg.hidden] = 1.0
        lstm.append({
            "wx": normal(d, 4 * cfg.hidden) * (1.0 / math.sqrt(d)),
            "wh": normal(cfg.hidden, 4 * cfg.hidden) * (1.0 / math.sqrt(cfg.hidden)),
            "b": b,
        })
        d = cfg.hidden
    params["lstm"] = lstm
    params["proj"] = {
        "w": normal(cfg.hidden, cfg.vocab) * (1.0 / math.sqrt(cfg.hidden)),
        "b": torch.zeros(cfg.vocab),
    }
    return _to(params, dev)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, as f32 (differentiable: the cotangent is
    rounded the same way on the way back, as JAX's convert is)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> f32 matmul: the operands rounded to bf16, the product
    taken in f32 (exact products, f32 sum)."""
    return _bf16(a) @ _bf16(w)


def _cell(layer: dict, h: torch.Tensor, c: torch.Tensor, gx_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell update given the input half of the gate pre-activation
    ``gx_t`` = x @ wx + b (shared by training and sampling)."""
    gates = gx_t + _mm(h, layer["wh"])
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _lstm_layer(layer: dict, xs: torch.Tensor, hidden: int) -> torch.Tensor:
    """One LSTM layer over xs: f32[T, B, D] -> f32[T, B, H]. The input half
    of every step's gates is one matmul; the loop carries (h, c)."""
    t, b_sz, d = xs.shape
    gx = _mm(xs.reshape(t * b_sz, d), layer["wx"]).reshape(t, b_sz, 4 * hidden)
    gx = gx + layer["b"]
    h = c = torch.zeros(b_sz, hidden, dtype=torch.float32, device=xs.device)
    hs = []
    for step in range(t):
        h, c = _cell(layer, h, c, gx[step])
        hs.append(h)
    return torch.stack(hs)


def forward(params: Any, tokens: torch.Tensor, cfg: CharRNNConfig) -> torch.Tensor:
    """Logits for next-token prediction: int[B, T] -> f32[B, T, vocab].
    Out-of-vocabulary ids clamp to the table's ends, as JAX's
    ``take(mode="clip")`` does (a NaN embedding would poison the table)."""
    emb = params["embed"]
    x = emb[tokens.long().clamp(0, emb.shape[0] - 1)]  # [B, T, E]
    xs = x.transpose(0, 1)  # [T, B, E]
    for layer in params["lstm"]:
        xs = _lstm_layer(layer, xs, cfg.hidden)
    logits = _mm(xs.reshape(-1, cfg.hidden), params["proj"]["w"]) + params["proj"]["b"]
    t, b_sz = xs.shape[0], xs.shape[1]
    return logits.reshape(t, b_sz, cfg.vocab).transpose(0, 1)


def loss_fn(params: Any, batch: tuple[torch.Tensor, torch.Tensor], cfg: CharRNNConfig) -> torch.Tensor:
    """Mean next-char cross-entropy; ``batch`` = (inputs, targets), both
    int[B, T]."""
    inputs, targets = batch
    logp = torch.log_softmax(forward(params, inputs, cfg).float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


@torch.no_grad()
def sample(
    params: Any,
    generator: torch.Generator,
    prompt: torch.Tensor,
    cfg: CharRNNConfig,
    length: int = 256,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Autoregressive sampling: int[P] prompt -> int64[length] continuation,
    one token at a time with (h, c) per layer carried, drawn with
    ``generator`` (which must live on the parameters' device)."""
    dev = params["embed"].device
    hs = [torch.zeros(1, cfg.hidden, device=dev) for _ in range(cfg.layers)]
    cs = [torch.zeros(1, cfg.hidden, device=dev) for _ in range(cfg.layers)]

    def step_token(tok: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tok.clamp(0, cfg.vocab - 1)].reshape(1, -1)
        for li, layer in enumerate(params["lstm"]):
            gx = _mm(x, layer["wx"]) + layer["b"]
            hs[li], cs[li] = _cell(layer, hs[li], cs[li], gx)
            x = hs[li]
        return (_mm(x, params["proj"]["w"]) + params["proj"]["b"])[0]

    logits = None
    for tok in prompt.long().to(dev):
        logits = step_token(tok)
    out = torch.empty(length, dtype=torch.int64, device=dev)
    for i in range(length):
        probs = torch.softmax(logits / temperature, dim=-1)
        out[i] = torch.multinomial(probs, 1, generator=generator)[0]
        logits = step_token(out[i])
    return out


def encode_corpus(text: bytes, vocab: Optional[int] = None, device=None) -> torch.Tensor:
    """Byte text -> int64 token ids on ``device`` (``None`` is the GPU),
    once: pass the result to :func:`make_batches` in the training loop.
    ``vocab`` folds bytes into a smaller id space."""
    data = torch.from_numpy(np.frombuffer(text, dtype=np.uint8).astype(np.int64)).to(resolve_device(device))
    if vocab is not None:
        data = data % vocab
    return data


def make_batches(
    text: bytes | torch.Tensor,
    batch: int,
    seq: int,
    generator: torch.Generator,
    n_peer: Optional[int] = None,
    vocab: Optional[int] = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Random (inputs, targets) windows of a byte corpus, the starts drawn
    from ``generator`` (a CPU generator). With ``n_peer``, [n_peer, batch,
    seq], a slice per pod peer. ``text`` is raw bytes (converted here, onto
    ``device``; ``None`` is the GPU) or the ids of :func:`encode_corpus`
    (the batches land on their device)."""
    if len(text) < seq + 2:
        raise ValueError(f"corpus has {len(text)} tokens; need at least seq+2 = {seq + 2}")
    data = encode_corpus(text, device=device) if isinstance(text, bytes) else text
    if vocab is not None:
        data = data % vocab
    count = (n_peer or 1) * batch
    starts = torch.randint(0, data.shape[0] - seq - 1, (count,), generator=generator)
    idx = (starts[:, None] + torch.arange(seq)[None, :]).to(data.device)
    x, y = data[idx], data[idx + 1]
    if n_peer is not None:
        x, y = x.reshape(n_peer, batch, seq), y.reshape(n_peer, batch, seq)
    return x, y
