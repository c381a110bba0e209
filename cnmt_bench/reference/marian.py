"""Plain float32 reference of the Marian encoder-decoder, independent of
the program under test (it imports nothing of it).

A post-norm Transformer as the configuration file describes it:
sinusoidal positions added to embeddings scaled by sqrt(d_model),
multi-head attention with the padding keys masked, a ReLU feed-forward
layer, LayerNorm after each residual, separate source and target
embeddings and a biased output projection.  Attention is materialised
(scores, softmax, weighted sum); every product is an ordinary
``torch.matmul``, so TF32 decides the precision (the caller switches it
off, or on for the control).

The parameter names and layouts (``nn.Linear``'s (out, in) weights) are
the ones the harness loads into the program with ``load_state_dict``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def param_spec(w: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, law) of every parameter, for the widths ``w``."""
    d, f = w["d_model"], w["d_ff"]
    spec = []

    def linear(p, d_in, d_out):
        spec.append((p + "weight", (d_out, d_in), "glorot"))
        spec.append((p + "bias", (d_out,), "bias"))

    def attn(p):
        for x in "qkvo":
            linear(f"{p}{x}.", d, d)

    def norm(p):
        spec.append((p + "weight", (d,), "ln_weight"))
        spec.append((p + "bias", (d,), "ln_bias"))

    def ffn(p):
        linear(p + "inp.", d, f)
        linear(p + "out.", f, d)

    for i in range(w["enc_layers"]):
        attn(f"enc.{i}.attn.")
        norm(f"enc.{i}.ln1.")
        ffn(f"enc.{i}.ffn.")
        norm(f"enc.{i}.ln2.")
    for i in range(w["dec_layers"]):
        attn(f"dec.{i}.self_attn.")
        norm(f"dec.{i}.ln1.")
        attn(f"dec.{i}.cross.")
        norm(f"dec.{i}.ln2.")
        ffn(f"dec.{i}.ffn.")
        norm(f"dec.{i}.ln3.")
    spec.append(("src_embed.weight", (w["vocab_src"], d), "embed"))
    spec.append(("tgt_embed.weight", (w["vocab_tgt"], d), "embed"))
    linear("out.", d, w["vocab_tgt"])
    return spec


def positions(count: int, d: int, device) -> torch.Tensor:
    """(count, d) sinusoidal table: sin on even, cos on odd columns of
    pos / 10000^(2i/d)."""
    pos = torch.arange(count, device=device, dtype=torch.float32)[:, None]
    two_i = torch.arange(0, d, 2, device=device, dtype=torch.float32)[None]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), two_i / d)
    table = torch.empty((count, d), device=device)
    table[:, 0::2] = torch.sin(angle)
    table[:, 1::2] = torch.cos(angle)
    return table


def _linear(p: Dict, name: str, x):
    return x @ p[name + "weight"].T + p[name + "bias"]


def _norm(p: Dict, name: str, x, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[name + "weight"], p[name + "bias"],
                        eps)


def _attention(p: Dict, name: str, q_in, kv_in, keep, heads: int):
    """keep (B|1, 1, Sq|1, Sk) bool: the keys each query may see."""
    b, sq, d = q_in.shape
    dh = d // heads

    def split(x):
        return x.view(b, x.shape[1], heads, dh).transpose(1, 2)

    q = split(_linear(p, name + "q.", q_in))
    k = split(_linear(p, name + "k.", kv_in))
    v = split(_linear(p, name + "v.", kv_in))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    scores = scores.masked_fill(~keep, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    return _linear(p, name + "o.", out.transpose(1, 2).reshape(b, sq, d))


def _ffn(p: Dict, name: str, x):
    return _linear(p, name + "out.", torch.relu(_linear(p, name + "inp.", x)))


def logits(p: Dict, w: Dict, src, src_lens, tgt_in) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocab_tgt) of target inputs ``tgt_in``
    (B, T) (BOS, then the tokens before each position) over sources
    ``src`` (B, N) whose first ``src_lens`` tokens are real."""
    d, h, eps = w["d_model"], w["heads"], w["ln_eps"]
    b, n = src.shape
    t = tgt_in.shape[1]
    table = positions(max(n, t), d, src.device)
    scale = math.sqrt(d)
    src_keep = (torch.arange(n, device=src.device)[None]
                < src_lens[:, None])[:, None, None, :]
    x = p["src_embed.weight"][src] * scale + table[:n]
    for i in range(w["enc_layers"]):
        x = _norm(p, f"enc.{i}.ln1.",
                  x + _attention(p, f"enc.{i}.attn.", x, x, src_keep, h), eps)
        x = _norm(p, f"enc.{i}.ln2.", x + _ffn(p, f"enc.{i}.ffn.", x), eps)
    memory = x
    causal = torch.ones((t, t), dtype=torch.bool,
                        device=src.device).tril()[None, None]
    y = p["tgt_embed.weight"][tgt_in] * scale + table[:t]
    for i in range(w["dec_layers"]):
        y = _norm(p, f"dec.{i}.ln1.",
                  y + _attention(p, f"dec.{i}.self_attn.", y, y, causal, h),
                  eps)
        y = _norm(p, f"dec.{i}.ln2.",
                  y + _attention(p, f"dec.{i}.cross.", y, memory, src_keep, h),
                  eps)
        y = _norm(p, f"dec.{i}.ln3.", y + _ffn(p, f"dec.{i}.ffn.", y), eps)
    return _linear(p, "out.", y)


def request_flops(w: Dict, n: int, m: int) -> float:
    """Useful FLOPs of one greedy translation of ``n`` source tokens into
    ``m`` output tokens (2 per multiply-add; attention 4 x keys x d a
    query; the conventions of ``models/costs.py``).  Decoding token t
    (1-based) attends to t cached positions."""
    d, f, v = w["d_model"], w["d_ff"], w["vocab_tgt"]
    enc = w["enc_layers"] * (8 * n * d * d + 4 * n * n * d + 4 * n * d * f)
    cross_kv = w["dec_layers"] * 4 * n * d * d
    per_token = w["dec_layers"] * (12 * d * d + 4 * n * d + 4 * d * f) \
        + 2 * d * v
    self_attn = w["dec_layers"] * 4 * d * (m * (m + 1) / 2)
    return float(enc + cross_kv + m * per_token + self_attn)
