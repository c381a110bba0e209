"""Mixture-of-Experts FFN: top-k routing with a sort-based dropping
dispatch.

Port of ``repro/models/layers/moe.py``, its semantics exactly:

* routing: a softmax router in float32 (``router.w`` (D, E) is kept in
  float32), exact top-k (``torch.topk``; the callers' inputs carry no
  exact ties, where ``lax.top_k`` would put the lower index first), and
  the ``norm_topk`` renormalisation of the kept gates;
* groups: the whole batch is ONE group for single-token decode (S == 1),
  one group per batch row otherwise;
* dispatch: per group, ``capacity = max(1, int(tg * top_k *
  capacity_factor / E + 0.999))``; the flattened expert ids are sorted
  with a **stable** sort, each assignment's rank within its expert
  decides ``keep = rank < capacity``, and the kept tokens are packed into
  a fixed (E, capacity, D) buffer at slot ``expert * capacity +
  clip(rank)``.  A dropped assignment (an expert's later tokens in the
  stable order) adds zeros, so each slot receives at most one nonzero
  value and the scatter is exact in any order;
* experts: one SwiGLU per expert over the whole (G, E, C, D) buffer, as
  batched products (the reference's einsums run outside any Pallas
  kernel, so these are plain tensor ops): every expert's weights are read
  at every call, whatever the number of tokens;
* combine: each assignment's expert output gathered back to (T, k, D),
  weighted by ``w * keep`` and summed over k in a fixed order.  Not an
  ``index_add_``: on the card that adds with atomics, so the k
  contributions of a token would be summed in a varying order and the
  same inputs would not give the same bits;
* the switch-style load-balance loss on each token's first choice, and
  the shared experts (one SwiGLU of width ``d_ff_expert *
  num_shared_experts``) added to the routed output.

Capacity dropping couples the rows of a group: with qwen3-moe-30b-a3b's
128 experts, top-8 and factor 1.25 a decode batch of 8 has capacity 1,
so two rows whose top-8 share an expert lose one assignment, the later
one.  A row's output then depends on the other rows of its batch
(padding rows and a slot table's free slots included).  That is the
reference's behaviour; it is kept.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers.basic import SwiGLU, normal_param
from repro_torch.sharding import ctx as shard_ctx


class _Weight(nn.Module):
    """A bare ``w`` leaf (the reference's ``{"w": ...}``)."""

    def __init__(self, shape, std: float, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        self.w = normal_param(shape, std, device=device, generator=generator,
                              dtype=dtype)


class MoE(nn.Module):
    """Leaves ``router.w`` (D, E), ``experts_gate.w`` / ``experts_up.w``
    (E, D, F), ``experts_down.w`` (E, F, D) and, with shared experts,
    ``shared`` (a SwiGLU of width F * num_shared_experts)."""

    def __init__(self, cfg: ModelConfig, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        mo: MoEConfig = cfg.moe
        d, f, e = cfg.d_model, mo.d_ff_expert, mo.num_experts
        kw = dict(device=device, generator=generator, dtype=dtype)
        # the router's math is float32 at any dtype
        self.router = _Weight((d, e), d ** -0.5, device=device,
                              generator=generator)
        self.experts_gate = _Weight((e, d, f), d ** -0.5, **kw)
        self.experts_up = _Weight((e, d, f), d ** -0.5, **kw)
        self.experts_down = _Weight((e, f, d), f ** -0.5, **kw)
        if mo.num_shared_experts:
            self.shared = SwiGLU(d, f * mo.num_shared_experts, **kw)


def route(p: MoE, mo: MoEConfig, tokens):
    """tokens (..., D) -> (top_w (..., k) f32, top_i (..., k) int64,
    probs (..., E) f32)."""
    logits = tokens.float() @ p.router.w
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, mo.top_k, dim=-1)
    if mo.norm_topk:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_i, probs


def capacity(mo: MoEConfig, tg: int) -> int:
    """Slots per expert for a group of ``tg`` tokens."""
    return max(1, int(tg * mo.top_k * mo.capacity_factor / mo.num_experts
                      + 0.999))


def build_dispatch(p: MoE, mo: MoEConfig, groups, cap: int):
    """groups (G, T, D) -> (buf (G, E, C, D), metadata for the combine).

    The metadata is in the assignments' own order (token-major, then the
    k choices): ``slot`` (G, T*k) into the group's flattened (E*C)
    buffer, ``keep`` (G, T*k) in the tokens' dtype, ``w`` (G, T*k) the
    gates, and the router's ``probs`` / ``top_i``."""
    g, t, d = groups.shape
    k, e = mo.top_k, mo.num_experts
    top_w, top_i, probs = route(p, mo, groups)
    flat_e = top_i.reshape(g, t * k)
    es, order = torch.sort(flat_e, dim=-1, stable=True)
    # rank within the expert: position in the sorted list minus the
    # expert's first position there
    first = torch.searchsorted(es, es)
    rank_sorted = torch.arange(t * k, device=groups.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = (rank < cap).to(groups.dtype)
    slot = flat_e * cap + torch.clamp(rank, 0, cap - 1)
    tok_of = torch.arange(t * k, device=groups.device) // k
    src = groups[:, tok_of] * keep[..., None]                 # (G, T*k, D)
    base = (torch.arange(g, device=groups.device) * (e * cap))[:, None]
    buf = groups.new_zeros((g * e * cap, d)).index_add_(
        0, (slot + base).reshape(-1), src.reshape(-1, d))
    meta = {"slot": slot, "keep": keep, "w": top_w.reshape(g, t * k),
            "probs": probs, "top_i": top_i}
    return buf.view(g, e, cap, d), meta


def experts(p: MoE, bufs):
    """The E expert SwiGLUs over the packed buffer (G, E, C, D): batched
    products over the expert axis, every expert's weights read once."""
    g, e, c, d = bufs.shape
    x = bufs.transpose(0, 1).reshape(e, g * c, d)
    dt = bufs.dtype
    gg = torch.bmm(x, p.experts_gate.w.to(dt))
    uu = torch.bmm(x, p.experts_up.w.to(dt))
    out = torch.bmm(F.silu(gg) * uu, p.experts_down.w.to(dt))
    return out.view(e, g, c, d).transpose(0, 1)


def combine(out, meta: Dict, k: int):
    """out (G, E, C, D) + metadata -> y (G, T, D): each assignment's
    output gathered to (G, T, k, D), weighted by ``w * keep`` and summed
    over k (a fixed-order reduction, no atomics)."""
    g, e, c, d = out.shape
    flat = out.reshape(g, e * c, d)
    idx = meta["slot"][..., None].expand(-1, -1, d)
    contrib = torch.gather(flat, 1, idx) * (
        meta["w"].to(out.dtype) * meta["keep"])[..., None]
    return contrib.view(g, -1, k, d).sum(dim=2)


def load_balance_loss(probs, top_i, num_experts: int):
    """Switch-transformer aux loss E * sum_e f_e * P_e (float32 scalar),
    f_e the share of tokens whose first choice is e, P_e the mean router
    probability.  Under a batch split over ranks (a
    :class:`~repro_torch.sharding.ctx.BatchShard` installed), both means
    are taken over the whole batch before their product."""
    assign = F.one_hot(top_i[:, 0], num_experts).float()
    f = shard_ctx.batch_mean(assign.mean(0))
    p = shard_ctx.batch_mean(probs.mean(0))
    return num_experts * torch.sum(f * p)


def _dispatch(p: MoE, mo: MoEConfig, x):
    """x (B,S,D) dispatched in its groups: the whole batch one group for
    single-token decode (S == 1), one group per row otherwise."""
    b, s, d = x.shape
    groups = x.reshape(1, b, d) if s == 1 else x
    return build_dispatch(p, mo, groups, capacity(mo, groups.shape[1]))


def moe_ffn(p: MoE, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """x (B,S,D) -> (y (B,S,D), aux_loss float32 scalar)."""
    mo = cfg.moe
    bufs, meta = _dispatch(p, mo, x)
    y = combine(experts(p, bufs), meta, mo.top_k).reshape(x.shape)
    aux = load_balance_loss(meta["probs"].reshape(-1, mo.num_experts),
                            meta["top_i"].reshape(-1, mo.top_k),
                            mo.num_experts)
    if mo.num_shared_experts:
        y = y + p.shared(x)
    return y, aux


def dropped_share(p: MoE, cfg: ModelConfig, x) -> float:
    """The share of x's (B,S,D) routed assignments that capacity drops,
    under ``moe_ffn``'s grouping (a diagnostic; one host sync)."""
    _, meta = _dispatch(p, cfg.moe, x)
    return float(1.0 - meta["keep"].float().mean())
