"""Attention mixers of the big-LM stack: grouped-query attention and
DeepSeek's multi-head latent attention (MLA), each full-sequence and
one-token decode against a preallocated cache.

Port of the GQA and MLA parts of ``repro/models/layers/attention.py``.
GQA, qk-norm included: with ``cfg.qk_norm`` (qwen3) q and k take an RMS norm over the
head dim (``q_norm.g`` / ``k_norm.g``, the reference's names) before
RoPE.  Prefill runs :func:`repro_torch.kernels.ops.flash_attention` with
the causal mask at offset 0; the reference's ``blocked_sdpa`` aligns the
queries to the last S keys, which is the same mask when S == T, as in
prefill.  Training (``attn_full(..., kernels=False)``) runs the
reference's jnp attention instead, materialized scores and softmax in
torch ops that autograd differentiates: the arithmetic of the kernel's
plain version,
:func:`~repro_torch.kernels.flash_attention.flash_attention_plain`, which
it calls (the reference's query blocks only bound its memory).
Decode writes K/V in place at slot ``pos`` (slot == position) and runs
:func:`repro_torch.kernels.ops.flash_decode` over ``lengths = pos + 1``,
the reference's mask ``idx <= pos``.  A position at or past the cache's
capacity writes nothing and attends to every slot, as the reference's
one-hot write and mask do (a free slot of a continuous slot table keeps
stepping past ``max_len``).

MLA (:class:`MLA`, :func:`mla_full`, :func:`mla_decode`) has no kernel,
in the reference or here: its q/k head dim (``nope + rope``, 192 at
deepseek-v3's width) differs from its v head dim (128), which the
attention kernels do not take, so it runs in plain torch ops.  Prefill
expands the latent into per-head keys and values and takes a causal
softmax over materialized scores; decode is the absorbed form (queries
through ``k_up``, scores against the cached latent, the weighted latent
expanded through ``v_up``).  The cache is the compressed latent ``(c_kv,
k_pe)``; a decode write at ``pos >= S_max`` is dropped, as GQA's.

Sliding windows (the ring cache) and cross-attention are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.models.layers.basic import (
    Linear,
    RMSNorm,
    apply_rope,
    head_rmsnorm,
    rmsnorm,
)

NEG_INF = -0.7 * torch.finfo(torch.float32).max   # the reference's mask value


def check_supported(cfg: ModelConfig, cross: bool = False) -> None:
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding-window attention (the ring cache) is not ported yet")
    if cross:
        raise NotImplementedError("cross-attention is not ported yet")


class GQA(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        check_supported(cfg)
        d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        mk = lambda a, b: Linear(a, b, device=device, generator=generator)
        self.q, self.k = mk(d, h * dh), mk(d, hkv * dh)
        self.v, self.o = mk(d, hkv * dh), mk(h * dh, d)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, device=device)
            self.k_norm = RMSNorm(dh, device=device)


def _qkv(p: GQA, cfg: ModelConfig, x, positions):
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = p.q(x).view(b, s, h, dh)
    k = p.k(x).view(b, s, hkv, dh)
    v = p.v(x).view(b, s, hkv, dh)
    if cfg.qk_norm:
        q = head_rmsnorm(p.q_norm.g, q, cfg.norm_eps)
        k = head_rmsnorm(p.k_norm.g, k, cfg.norm_eps)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attn_full(p: GQA, cfg: ModelConfig, x, *, window: Optional[int] = None,
              kernels: bool = True):
    """Causal self-attention over a full sequence: through the kernel
    (prefill) or, with ``kernels=False``, the differentiable training
    path.  Returns (y (B,S,D), (k, v)) with k/v (B,S,Hkv,Dh), k after
    RoPE."""
    if window is not None:
        raise NotImplementedError("sliding-window attention is not ported")
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _qkv(p, cfg, x, positions)
    attend = ops.flash_attention if kernels else flash_attention_plain
    y = attend(q, k, v, causal=True)
    return p.o(y.reshape(b, s, -1)), (k, v)


def _write_slot(cache, new, pos) -> None:
    """Write ``new`` (B, ...) into ``cache`` (B, S_max, ...) at slot
    ``pos`` (B,), dropping the write of a row with ``pos >= S_max``: the
    index is clamped to the last slot and that slot written back as it
    was, so only the B written rows are read."""
    b, s_max = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    idx = pos.long().clamp(max=s_max - 1)
    fits = (pos < s_max).view((b,) + (1,) * (new.dim() - 1))
    cache[rows, idx] = torch.where(fits, new, cache[rows, idx])


def attn_decode(p: GQA, cfg: ModelConfig, x, cache_k, cache_v, pos):
    """One token per sequence against the cache.  x (B,1,D); cache_k/v
    (B,S_max,Hkv,Dh), written in place at slot ``pos`` (B,), the absolute
    position that also drives RoPE.  A row with ``pos >= S_max`` leaves
    its cache as it was (the reference's one-hot write is all zeros
    there): its write index is clamped to the last slot and that slot
    written back unchanged, so only the B written rows are read."""
    b = x.shape[0]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    _write_slot(cache_k, k[:, 0], pos)
    _write_slot(cache_v, v[:, 0], pos)
    y = ops.flash_decode(q[:, 0], cache_k, cache_v,
                         (pos + 1).to(torch.int32))
    return p.o(y.reshape(b, 1, -1))


# ==================================================================== MLA
class MLA(nn.Module):
    """Leaves ``q_down``, ``q_norm``, ``q_up``, ``kv_down``, ``kv_norm``,
    ``k_up``, ``v_up`` and ``o``, the reference's names and shapes."""

    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        m: MLAConfig = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        mk = lambda a, b: Linear(a, b, device=device, generator=generator)
        self.q_down = mk(d, m.q_lora_rank)
        self.q_norm = RMSNorm(m.q_lora_rank, device=device)
        self.q_up = mk(m.q_lora_rank,
                       h * (m.qk_nope_head_dim + m.qk_rope_head_dim))
        self.kv_down = mk(d, m.kv_lora_rank + m.qk_rope_head_dim)
        self.kv_norm = RMSNorm(m.kv_lora_rank, device=device)
        self.k_up = mk(m.kv_lora_rank, h * m.qk_nope_head_dim)
        self.v_up = mk(m.kv_lora_rank, h * m.v_head_dim)
        self.o = mk(h * m.v_head_dim, d)


def _mla_q(p: MLA, cfg: ModelConfig, x, positions):
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    cq = rmsnorm(p.q_norm.g, p.q_down(x), cfg.norm_eps)
    q = p.q_up(cq).view(b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _mla_latent(p: MLA, cfg: ModelConfig, x, positions):
    """The compressed KV latent: c_kv (B,S,rank) and the rotated shared
    k_pe (B,S,rope)."""
    m = cfg.mla
    c_kv, k_pe = p.kv_down(x).split([m.kv_lora_rank, m.qk_rope_head_dim],
                                    dim=-1)
    c_kv = rmsnorm(p.kv_norm.g, c_kv, cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_pe[:, :, 0, :]


def mla_full(p: MLA, cfg: ModelConfig, x):
    """Full-sequence MLA (train / prefill), the expanded form.  Returns
    (y (B,S,D), (c_kv (B,S,rank), k_pe (B,S,rope))).

    Keys are ``[k_nope ; k_pe]`` with the one rotated ``k_pe`` shared by
    every head, values ``v_up(c_kv)``; the causal softmax runs over
    materialized (B,H,S,S) scores in float32 at q/k dim ``nope + rope``
    and v dim ``v_head_dim``."""
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q_nope, q_pe = _mla_q(p, cfg, x, positions)
    c_kv, k_pe = _mla_latent(p, cfg, x, positions)
    k_nope = p.k_up(c_kv).view(b, s, h, m.qk_nope_head_dim)
    v = p.v_up(c_kv).view(b, s, h, m.v_head_dim)
    q_eff = torch.cat([q_nope, q_pe], dim=-1)
    k_eff = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = torch.einsum("bshd,bthd->bhst", q_eff, k_eff).float() * scale
    pos = torch.arange(s, device=x.device)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    y = torch.einsum("bhst,bthd->bshd", w, v).reshape(b, s, -1)
    return p.o(y), (c_kv, k_pe)


def mla_decode(p: MLA, cfg: ModelConfig, x, cache_ckv, cache_kpe, pos):
    """One token per sequence, the absorbed form.  x (B,1,D); cache_ckv
    (B,S_max,rank) and cache_kpe (B,S_max,rope) written in place at slot
    ``pos`` (B,) (dropped at ``pos >= S_max``, where every slot is
    attended, as the reference's one-hot write and mask ``idx <= pos``
    give).  Returns y (B,1,D)."""
    m, h = cfg.mla, cfg.num_heads
    b, s_max = x.shape[0], cache_ckv.shape[1]
    positions = pos[:, None]
    q_nope, q_pe = _mla_q(p, cfg, x, positions)              # (B,1,H,.)
    c_kv, k_pe = _mla_latent(p, cfg, x, positions)
    _write_slot(cache_ckv, c_kv[:, 0], pos)
    _write_slot(cache_kpe, k_pe[:, 0], pos)
    w_kup = p.k_up.w.view(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_kup.to(x.dtype))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bhr,btr->bht", q_c, cache_ckv)
              + torch.einsum("bhd,btd->bht", q_pe[:, 0], cache_kpe)) * scale
    valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]
    scores = scores.float().masked_fill(~valid[:, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    lat = torch.einsum("bht,btr->bhr", w, cache_ckv)
    w_vup = p.v_up.w.view(m.kv_lora_rank, h, m.v_head_dim)
    y = torch.einsum("bhr,rhd->bhd", lat, w_vup.to(x.dtype))
    return p.o(y.reshape(b, 1, -1))
