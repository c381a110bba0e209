"""Plain PyTorch oracles for the attention kernels: O(S^2) materialized
softmax attention, the simplest correct implementations, used as the
ground truth in kernel tests.

These follow the reference oracles' own conventions, which differ from
the kernels' in two corners (see :mod:`repro_torch.kernels.flash_attention`
for the kernel semantics): the causal mask aligns the queries to the LAST
``s`` of the ``t`` keys, and masked scores are ``-inf``, so a row with no
valid key is NaN.  The two agree wherever S == T and every row has a
valid key.
"""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, lengths=None):
    """Materialized softmax attention with GQA head grouping.

    q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D).  f32 softmax.
    ``lengths`` (B,) optionally restricts each sequence to its valid key
    prefix (>= 1 valid key per row required, as in the kernels).
    """
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, s, hkv, rep, d).float()
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) * scale
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        # queries are the LAST s positions of the t-long key sequence
        offset = t - s
        mask &= j <= (i + offset)
        if window is not None:
            mask &= j > (i + offset - window)
    mask = mask[None].expand(b, s, t)
    if lengths is not None:
        mask = mask & (j[None] < lengths.to(q.device)[:, None, None])
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths, *, scale=None):
    """Single-token decode oracle.

    q (B,H,D); k/v_cache (B,T,Hkv,D); lengths (B,) = #valid cache slots.
    """
    b, h, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, rep, d).float()
    scores = torch.einsum("bgrd,btgd->bgrt", qg, k_cache.float()) * scale
    mask = (torch.arange(t, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", w, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
