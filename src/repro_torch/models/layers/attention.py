"""Attention mixers of the big-LM stack: grouped-query attention (with a
sliding window, a ring cache and cross-attention) and DeepSeek's
multi-head latent attention (MLA), each full-sequence and one-token
decode against a preallocated cache.

Port of the GQA and MLA parts of ``repro/models/layers/attention.py``.
GQA, qk-norm included: with ``cfg.qk_norm`` (qwen3) q and k take an RMS
norm over the head dim (``q_norm.g`` / ``k_norm.g``, the reference's
names) before RoPE.  Prefill runs
:func:`repro_torch.kernels.ops.flash_attention` with the causal mask at
offset 0; the reference's ``blocked_sdpa`` aligns the queries to the last
S keys, which is the same mask when S == T, as in prefill.  Training
(``attn_full(..., kernels=False)``, ``cross_attn(..., kernels=False)``)
and every MLA full-sequence call run :func:`blocked_sdpa`, the
reference's memory-bounded attention in torch ops that autograd
differentiates: a loop over blocks of ``DEFAULT_Q_BLOCK`` queries, each
block's (B, H, q_block, T) scores the only ones alive, the block
checkpointed so that the backward recomputes them.  No (B, H, S, T)
tensor is made or saved.  GQA calls it on float32 copies of q, k and v
(the kernel's arithmetic: scores, softmax and P.V in float32, one
rounding at the end), MLA in the model's dtype, as the reference does.
Decode writes K/V in place at slot ``pos`` (slot == position) and runs
:func:`repro_torch.kernels.ops.flash_decode` over ``lengths = pos + 1``,
the reference's mask ``idx <= pos``.  A position at or past the cache's
capacity writes nothing and attends to every slot, as the reference's
one-hot write and mask do (a free slot of a continuous slot table keeps
stepping past ``max_len``).

Sliding windows (the long-decode variants) go through the same two
kernels, which take a ``window`` bound: prefill masks keys at or below
``q_pos - window``, a linear cache the slots below ``pos + 1 - window``.
A ring cache (``ring=True``, capacity == window) holds the last
``S_max`` tokens: the write slot is ``pos % S_max`` (never dropped) and
``flash_decode`` reads ``lengths = min(pos + 1, S_max)``, which is the
reference's ring mask ``idx <= pos or pos >= S_max``.

Sequence-sharded decode (:func:`attn_decode_seq_sharded`, the sharded
runtime's path for a linear cache split over ranks): each rank runs
``flash_decode`` on its own slots with the softmax state out, and the
ranks merge their states with two collectives.

Cross-attention (whisper's decoder): ``xq``/``xk``/``xv``/``xo`` project
the decoder's queries and the encoder's keys and values, with no RoPE
and no qk-norm.  The reference masks frames with any ``(B, T)`` mask;
the kernels take key-prefix lengths, so :func:`mask_lengths` turns a
prefix mask into lengths and raises ``ValueError`` on any other mask.
Prefill runs ``flash_attention(causal=False, lengths=)`` (S tokens
against T frames), decode ``flash_decode(lengths=)``.  A row with no
valid frame averages over all T frames in both, as the reference's
finite mask value gives.

MLA (:class:`MLA`, :func:`mla_full`, :func:`mla_decode`) has no kernel,
in the reference or here: its q/k head dim (``nope + rope``, 192 at
deepseek-v3's width) differs from its v head dim (128), which the
attention kernels do not take, so it runs in plain torch ops.  Prefill
and training expand the latent into per-head keys and values and run
:func:`blocked_sdpa` over them; decode is the absorbed form (queries
through ``k_up``, scores against the cached latent, the weighted latent
expanded through ``v_up``).  The cache is the compressed latent
``(c_kv, k_pe)``; a decode write at ``pos >= S_max`` is dropped, as
GQA's.

"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import MLAConfig, ModelConfig
from repro_torch.models.layers.basic import (
    Linear,
    RMSNorm,
    apply_rope,
    head_rmsnorm,
    rmsnorm,
)

NEG_INF = -0.7 * torch.finfo(torch.float32).max   # the reference's mask value
DEFAULT_Q_BLOCK = 512     # queries per block of blocked_sdpa (the reference's)


class GQA(nn.Module):
    """Leaves ``q``, ``k``, ``v``, ``o`` (and ``q_norm``/``k_norm`` with
    qk-norm); with ``cross`` also the cross-attention leaves ``xq``,
    ``xk``, ``xv``, ``xo``: the reference's ``gqa_params(cross=)``."""

    def __init__(self, cfg: ModelConfig, *, cross: bool = False, device,
                 generator, dtype=torch.float32):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        mk = lambda a, b: Linear(a, b, device=device, generator=generator,
                                 dtype=dtype)
        self.q, self.k = mk(d, h * dh), mk(d, hkv * dh)
        self.v, self.o = mk(d, hkv * dh), mk(h * dh, d)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(dh, device=device)
            self.k_norm = RMSNorm(dh, device=device)
        if cross:
            self.xq, self.xk = mk(d, h * dh), mk(d, hkv * dh)
            self.xv, self.xo = mk(d, hkv * dh), mk(h * dh, d)


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


def _sdpa_block(q, k, v, q_pos0: int, scale, causal: bool, window,
                valid):
    """One block of :func:`blocked_sdpa`: the queries ``q`` (B,l,H,Dh) at
    positions ``q_pos0 + i`` against every key, the reference body's
    arithmetic (scores in q's dtype times the scale in that dtype, then
    float32; the masks; a float32 softmax; the weights back in q's dtype;
    P.V).  Returns (B,l,H,Dv)."""
    b, l, h, dh = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    qg = q.reshape(b, l, hkv, h // hkv, dh)
    scores = (torch.einsum("blgrd,btgd->bgrlt", qg, k) * scale).float()
    mask = valid                                  # (B,1,1,1,T) or None
    if causal:
        k_pos = torch.arange(t, device=q.device)
        q_pos = q_pos0 + torch.arange(l, device=q.device)[:, None]
        keep = k_pos <= q_pos                     # (l,T)
        if window:
            keep = keep & (k_pos > q_pos - window)
        mask = keep if mask is None else mask & keep
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgrlt,btgd->blgrd", w, v).reshape(b, l, h, dv)


def blocked_sdpa(q, k, v, *, causal: bool = True,
                 window: Optional[int] = None, lengths=None,
                 q_block: Optional[int] = None,
                 scale: Optional[float] = None):
    """Memory-bounded attention, the reference's ``blocked_sdpa``: a loop
    over blocks of ``q_block`` queries (None: ``DEFAULT_Q_BLOCK``, read
    at call time; the last block may be short), so that only one block's
    (B, H, q_block, T) scores live at a time.  Under autograd each block
    is checkpointed (non-reentrant, no RNG state: nothing here draws
    random numbers), so the backward recomputes its scores and nothing
    of that size is saved; without grad the blocks run directly.

    q (B,S,H,Dh); k (B,T,Hkv,Dh); v (B,T,Hkv,Dv), Dv may differ from Dh
    (MLA).  The queries sit at the last S of the T key positions (offset
    ``T - S``), as in the reference.  Masks: ``causal`` (key position <=
    query position), a sliding ``window`` (causal only; None or 0: none;
    keys at or below ``q_pos - window`` masked) and ``lengths`` (B,),
    the valid key prefix of each row (the port's form of the reference's
    ``kv_mask``, ROADMAP C.0).  A row with no valid key averages over
    every key, as the reference's finite mask value gives.  ``scale``
    (default ``Dh ** -0.5``) is rounded to q's dtype, as the reference
    rounds it.  Returns (B,S,H,Dv) in q's dtype."""
    if window and not causal:
        raise ValueError("a sliding window bounds causal attention only")
    s, dh, t = q.shape[1], q.shape[3], k.shape[1]
    scale = torch.tensor(scale if scale is not None else dh ** -0.5,
                         dtype=q.dtype)
    valid = None
    if lengths is not None:
        valid = (torch.arange(t, device=q.device)[None, :]
                 < lengths.to(q.device)[:, None])[:, None, None, None, :]
    l = min(q_block or DEFAULT_Q_BLOCK, s)
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    outs = []
    for i0 in range(0, s, l):
        args = (q[:, i0:i0 + l], k, v, i0 + t - s, scale, causal, window,
                valid)
        outs.append(torch.utils.checkpoint.checkpoint(
            _sdpa_block, *args, use_reentrant=False,
            preserve_rng_state=False) if remat else _sdpa_block(*args))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attn_full(p: GQA, cfg: ModelConfig, x, *, window: Optional[int] = None,
              causal: bool = True, kernels: bool = True):
    """Self-attention over a full sequence at positions 0..S-1 (RoPE on
    q and k): causal, with an optional sliding ``window``, or
    bidirectional (``causal=False``, the encoder), through the kernel
    (prefill) or, with ``kernels=False``, the differentiable training
    path: :func:`blocked_sdpa` on float32 copies of q, k and v, its
    output cast back to q's dtype.  Returns (y (B,S,D), (k, v)) with k/v
    (B,S,Hkv,Dh), k after RoPE."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _qkv(p, cfg, x, positions)
    if kernels:
        y = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        y = blocked_sdpa(q.float(), k.float(), v.float(), causal=causal,
                         window=window).to(q.dtype)
    return p.o(y.reshape(b, s, -1)), (k, v)


def mask_lengths(mask, *, check: bool = True):
    """The key-prefix lengths (B,) int32 of a (B, T) frame mask (nonzero =
    valid).  The kernels take prefix lengths only, so with ``check`` a
    mask that is not a prefix (a valid frame after an invalid one) raises
    ``ValueError`` (one read of the device)."""
    valid = mask > 0
    lengths = valid.sum(-1, dtype=torch.int32)
    if check:
        prefix = (torch.arange(mask.shape[-1], device=mask.device)[None, :]
                  < lengths[:, None])
        if not torch.equal(valid, prefix):
            raise ValueError(
                "the attention kernels take key-prefix lengths: a frame "
                "mask must be ones then zeros in every row")
    return lengths


def encode_cross_kv(p: GQA, cfg: ModelConfig, enc_out):
    """The cross-attention keys and values (B,T,Hkv,Dh) of the encoder's
    output (no RoPE)."""
    b, t, _ = enc_out.shape
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    return p.xk(enc_out).view(b, t, hkv, dh), p.xv(enc_out).view(b, t, hkv,
                                                                 dh)


def cross_attn(p: GQA, cfg: ModelConfig, x, enc_k, enc_v, enc_lengths, *,
               kernels: bool = True):
    """Decoder -> encoder attention over a full sequence: x (B,S,D) against
    enc_k/v (B,T,Hkv,Dh), frames ``< enc_lengths`` (B,) valid, not
    causal, through the kernel or, with ``kernels=False``, the training
    path: :func:`blocked_sdpa` on float32 copies, as :func:`attn_full`'s.
    Returns (B,S,D)."""
    b, s, _ = x.shape
    q = p.xq(x).view(b, s, cfg.num_heads, cfg.head_dim)
    if kernels:
        y = ops.flash_attention(q, enc_k, enc_v, enc_lengths, causal=False)
    else:
        y = blocked_sdpa(q.float(), enc_k.float(), enc_v.float(),
                         causal=False, lengths=enc_lengths).to(q.dtype)
    return p.xo(y.reshape(b, s, -1))


def cross_decode(p: GQA, cfg: ModelConfig, x, enc_k, enc_v, enc_lengths):
    """Cross-attention of one token per sequence: x (B,1,D) against the
    state's enc_k/v (B,T,Hkv,Dh).  Returns (B,1,D)."""
    b = x.shape[0]
    q = p.xq(x).view(b, cfg.num_heads, cfg.head_dim)
    y = ops.flash_decode(q, enc_k, enc_v, enc_lengths)
    return p.xo(y.reshape(b, 1, -1))


def _write_slot(cache, new, pos) -> None:
    """Write ``new`` (B, ...) into ``cache`` (B, S_max, ...) at slot
    ``pos`` (B,), dropping the write of a row with ``pos`` outside [0,
    S_max): the index is clamped into the cache and that slot written
    back as it was, so only the B written rows are read."""
    b, s_max = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    idx = pos.long().clamp(0, s_max - 1)
    fits = ((pos >= 0) & (pos < s_max)).view((b,) + (1,) * (new.dim() - 1))
    cache[rows, idx] = torch.where(fits, new, cache[rows, idx])


def attn_decode(p: GQA, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                window: Optional[int] = None, ring: bool = False):
    """One token per sequence against the cache.  x (B,1,D); cache_k/v
    (B,S_max,Hkv,Dh), written in place; ``pos`` (B,) is the absolute
    position that also drives RoPE.  Two cache disciplines, as the
    reference's:

    * linear (``ring=False``): slot == position, ``lengths = pos + 1``
      and an optional sliding ``window`` (slots at or below ``pos -
      window`` masked).  A row with ``pos >= S_max`` leaves its cache as
      it was (the reference's one-hot write is all zeros there): its
      write index is clamped to the last slot and that slot written back
      unchanged, so only the B written rows are read;
    * ring (``ring=True``): the cache holds the last ``S_max`` tokens, the
      write slot is ``pos % S_max`` and ``lengths = min(pos + 1,
      S_max)``: every slot is valid once ``pos >= S_max``."""
    b, s_max = x.shape[0], cache_k.shape[1]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    if ring:
        rows = torch.arange(b, device=x.device)
        slot = pos.long() % s_max
        cache_k[rows, slot] = k[:, 0]
        cache_v[rows, slot] = v[:, 0]
        lengths = torch.clamp(pos + 1, max=s_max).to(torch.int32)
        window = None
    else:
        _write_slot(cache_k, k[:, 0], pos)
        _write_slot(cache_v, v[:, 0], pos)
        lengths = (pos + 1).to(torch.int32)
    y = ops.flash_decode(q[:, 0], cache_k, cache_v, lengths, window=window)
    return p.o(y.reshape(b, 1, -1))


def attn_decode_seq_sharded(p: GQA, cfg: ModelConfig, x, cache_k, cache_v,
                            pos, *, group, window: Optional[int] = None):
    """:func:`attn_decode` over a linear cache split along its sequence
    axis over the ranks of ``group``: this rank holds slots ``[base, base
    + s_loc)``, ``base = rank * s_loc``, as cache_k/v (B,s_loc,Hkv,Dh).

    Each rank writes the new K/V only where ``pos`` falls in its range
    (``_write_slot`` at ``pos - base``), runs ``flash_decode`` on its own
    slots with local lengths ``max(pos + 1 - base, 0)`` and the softmax
    state out, and the ranks merge: ``all_reduce`` MAX of m, then one SUM
    of (o l w, l w), ``w = exp(m - max m)``; the output is ``sum o l w /
    max(sum l w, 1e-30)`` (:func:`~repro_torch.kernels.decode_attention.
    merge_decode_stats` is the same merge as a plain function).  Every
    rank ends with the same output.  A rank whose slots all lie past
    ``pos`` has local length 0, averages over its slots and carries m =
    -1e30, so its weight is 0: slot 0 is always valid.  The local lengths
    are not cut at ``s_loc``: the kernel reads at most its slots anyway,
    and a ``window`` (slots below ``lengths - window`` masked) stays
    right only on the uncut length.  The reference's shard_map body
    (``attn_decode_seq_sharded``) attends with jnp ops and no window.
    In bf16 each rank's output arrives rounded to bf16 and the merge,
    in float32, is rounded once more: on a group of one rank that is the
    kernel's output exactly, across ranks one more rounding than the
    unsharded kernel's."""
    b, s_loc = x.shape[0], cache_k.shape[1]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    local = pos - dist.get_rank(group) * s_loc
    _write_slot(cache_k, k[:, 0], local)
    _write_slot(cache_v, v[:, 0], local)
    lengths = (local + 1).clamp(min=0).to(torch.int32)
    y, m, l = ops.flash_decode(q[:, 0], cache_k, cache_v, lengths,
                               window=window, return_stats=True)
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    lw = l * torch.exp(m - m_g)
    merged = torch.cat([(y.float() * lw[..., None]).reshape(b, -1), lw], 1)
    dist.all_reduce(merged, op=dist.ReduceOp.SUM, group=group)
    n = y[0].numel()
    acc, l_g = merged[:, :n].reshape(y.shape), merged[:, n:]
    y = (acc / l_g.clamp_min(1e-30)[..., None]).to(y.dtype)
    return p.o(y.reshape(b, 1, -1))


# ==================================================================== MLA
class MLA(nn.Module):
    """Leaves ``q_down``, ``q_norm``, ``q_up``, ``kv_down``, ``kv_norm``,
    ``k_up``, ``v_up`` and ``o``, the reference's names and shapes."""

    def __init__(self, cfg: ModelConfig, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        m: MLAConfig = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        mk = lambda a, b: Linear(a, b, device=device, generator=generator,
                                 dtype=dtype)
        self.q_down = mk(d, m.q_lora_rank)
        self.q_norm = RMSNorm(m.q_lora_rank, device=device)
        self.q_up = mk(m.q_lora_rank,
                       h * (m.qk_nope_head_dim + m.qk_rope_head_dim))
        self.kv_down = mk(d, m.kv_lora_rank + m.qk_rope_head_dim)
        self.kv_norm = RMSNorm(m.kv_lora_rank, device=device)
        self.k_up = mk(m.kv_lora_rank, h * m.qk_nope_head_dim)
        self.v_up = mk(m.kv_lora_rank, h * m.v_head_dim)
        self.o = mk(h * m.v_head_dim, d)


def _scale(m: MLAConfig, dtype):
    """MLA's softmax scale in the working dtype: the reference multiplies
    the scores in that dtype (rounded there at bf16) before the float32
    softmax."""
    return torch.tensor((m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5,
                        dtype=dtype)


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
    every head, values ``v_up(c_kv)``; :func:`blocked_sdpa` runs the
    causal softmax in the model's dtype (float32 inside) at q/k dim
    ``nope + rope`` and v dim ``v_head_dim``, one block of queries at a
    time, as the reference's."""
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
    y = blocked_sdpa(q_eff, k_eff, v, causal=True,
                     scale=(m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5)
    return p.o(y.reshape(b, s, -1)), (c_kv, k_pe)


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
    scores = (torch.einsum("bhr,btr->bht", q_c, cache_ckv)
              + torch.einsum("bhd,btd->bht", q_pe[:, 0], cache_kpe)) \
        * _scale(m, x.dtype)
    valid = torch.arange(s_max, device=x.device)[None, :] <= pos[:, None]
    scores = scores.float().masked_fill(~valid[:, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    lat = torch.einsum("bht,btr->bhr", w, cache_ckv)
    w_vup = p.v_up.w.view(m.kv_lora_rank, h, m.v_head_dim)
    y = torch.einsum("bhr,rhd->bhd", lat, w_vup.to(x.dtype))
    return p.o(y.reshape(b, 1, -1))
