"""Plain float32 reference of the BiLSTM seq2seq, independent of the
program under test (it imports nothing of it).

The OpenNMT-style recipe the configuration file describes: per encoder
layer a forward and a backward LSTM over each source's own tokens, their
outputs concatenated and projected back to ``hidden`` through tanh; a
decoder of stacked LSTM cells whose layer l starts from the mean of
encoder layer l's two final states; Luong dot attention over the encoder
outputs; tanh of a projection of [h, context]; a biased output layer.
The LSTM cell has gates (i, f, g, o) and a fixed +1 on the forget gate.

The backward direction reverses each source's real prefix and runs it
forward, so no padding step ever touches a state.  Every product is an
ordinary ``torch.matmul``: TF32 decides the precision.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def param_spec(w: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, law) of every parameter, for the widths ``w``."""
    e, h = w["embed"], w["hidden"]
    spec = []

    def cell(p, d_in):
        spec.append((p + "wx", (d_in, 4 * h), "glorot"))
        spec.append((p + "wh", (h, 4 * h), "glorot"))
        spec.append((p + "b", (4 * h,), "bias"))

    def linear(p, d_in, d_out):
        spec.append((p + "weight", (d_out, d_in), "glorot"))
        spec.append((p + "bias", (d_out,), "bias"))

    widths = [e] + [h] * (w["layers"] - 1)
    for i, d_in in enumerate(widths):
        cell(f"enc.{i}.fwd.", d_in)
        cell(f"enc.{i}.bwd.", d_in)
        linear(f"enc.{i}.proj.", 2 * h, h)
    for i, d_in in enumerate(widths):
        cell(f"dec.{i}.", d_in)
    spec.append(("src_embed.weight", (w["vocab_src"], e), "embed"))
    spec.append(("tgt_embed.weight", (w["vocab_tgt"], e), "embed"))
    linear("attn_combine.", 2 * h, h)
    linear("out.", h, w["vocab_tgt"])
    return spec


def _cell(p: Dict, name: str, h, c, xw):
    gates = xw + h @ p[name + "wh"] + p[name + "b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _run(p: Dict, name: str, x, lens, hidden: int):
    """The cell over each row's first ``lens`` steps of x (B, N, d): the
    state stops at a row's last real step; outputs past it are 0."""
    b, n, _ = x.shape
    xw = x @ p[name + "wx"]
    h = x.new_zeros((b, hidden))
    c = x.new_zeros((b, hidden))
    outs = x.new_zeros((b, n, hidden))
    for t in range(n):
        live = (t < lens)[:, None]
        h2, c2 = _cell(p, name, h, c, xw[:, t])
        h = torch.where(live, h2, h)
        c = torch.where(live, c2, c)
        outs[:, t] = torch.where(live, h2, 0.0)
    return h, c, outs


def _reverse_prefix(x, lens):
    """Each row's first ``lens`` entries along axis 1 in reverse order,
    the rest left in place (its own inverse)."""
    n = x.shape[1]
    t = torch.arange(n, device=x.device)[None]
    idx = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def logits(p: Dict, w: Dict, src, src_lens, tgt_in) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocab_tgt) of target inputs ``tgt_in``
    (B, T) (BOS, then the tokens before each position) over sources
    ``src`` (B, N) whose first ``src_lens`` tokens are real."""
    hid = w["hidden"]
    x = p["src_embed.weight"][src]
    starts = []
    for i in range(w["layers"]):
        hf, cf, of = _run(p, f"enc.{i}.fwd.", x, src_lens, hid)
        hb, cb, ob = _run(p, f"enc.{i}.bwd.", _reverse_prefix(x, src_lens),
                          src_lens, hid)
        ob = _reverse_prefix(ob, src_lens)
        proj = torch.cat([of, ob], dim=-1) @ p[f"enc.{i}.proj.weight"].T \
            + p[f"enc.{i}.proj.bias"]
        x = torch.tanh(proj)
        starts.append([0.5 * (hf + hb), 0.5 * (cf + cb)])
    memory = x
    keep = torch.arange(memory.shape[1], device=src.device)[None] \
        < src_lens[:, None]
    out = []
    for t in range(tgt_in.shape[1]):
        y = p["tgt_embed.weight"][tgt_in[:, t]]
        for i, state in enumerate(starts):
            state[0], state[1] = _cell(p, f"dec.{i}.", state[0], state[1],
                                       y @ p[f"dec.{i}.wx"])
            y = state[0]
        scores = (memory @ y[:, :, None])[:, :, 0]
        scores = scores.masked_fill(~keep, float("-inf"))
        ctx = (torch.softmax(scores, dim=-1)[:, None] @ memory)[:, 0]
        y = torch.tanh(torch.cat([y, ctx], dim=-1)
                       @ p["attn_combine.weight"].T + p["attn_combine.bias"])
        out.append(y @ p["out.weight"].T + p["out.bias"])
    return torch.stack(out, dim=1)


def request_flops(w: Dict, n: int, m: int) -> float:
    """Useful FLOPs of one greedy translation of ``n`` source tokens into
    ``m`` output tokens (2 per multiply-add; the gates' and the
    attention's element-wise work not counted, as ``models/costs.py``
    leaves it out)."""
    e, h, v = w["embed"], w["hidden"], w["vocab_tgt"]
    widths = [e] + [h] * (w["layers"] - 1)
    enc = sum(2 * (2 * n * d * 4 * h + 2 * n * h * 4 * h) + 2 * n * 2 * h * h
              for d in widths)
    per_token = sum(2 * d * 4 * h + 2 * h * 4 * h for d in widths) \
        + 4 * n * h + 2 * 2 * h * h + 2 * h * v
    return float(enc + m * per_token)
