"""Grouped-query attention for the big-LM stack: full-sequence and
one-token decode against a preallocated KV cache.

Port of the GQA part of ``repro/models/layers/attention.py``, qk-norm
included: with ``cfg.qk_norm`` (qwen3) q and k take an RMS norm over the
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

Sliding windows (the ring cache), MLA and cross-attention are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import (
    Linear,
    RMSNorm,
    apply_rope,
    head_rmsnorm,
)


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


def attn_decode(p: GQA, cfg: ModelConfig, x, cache_k, cache_v, pos):
    """One token per sequence against the cache.  x (B,1,D); cache_k/v
    (B,S_max,Hkv,Dh), written in place at slot ``pos`` (B,), the absolute
    position that also drives RoPE.  A row with ``pos >= S_max`` leaves
    its cache as it was (the reference's one-hot write is all zeros
    there): its write index is clamped to the last slot and that slot
    written back unchanged, so only the B written rows are read."""
    b, s_max = x.shape[0], cache_k.shape[1]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    rows = torch.arange(b, device=x.device)
    idx = pos.long().clamp(max=s_max - 1)
    fits = (pos < s_max)[:, None, None]
    cache_k[rows, idx] = torch.where(fits, k[:, 0], cache_k[rows, idx])
    cache_v[rows, idx] = torch.where(fits, v[:, 0], cache_v[rows, idx])
    y = ops.flash_decode(q[:, 0], cache_k, cache_v,
                         (pos + 1).to(torch.int32))
    return p.o(y.reshape(b, 1, -1))
