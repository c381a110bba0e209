"""Plain PyTorch oracles for every kernel: O(S^2) materialized softmax
attention and one-step-at-a-time recurrences, the simplest correct
implementations, used as the ground truth in kernel tests.

The attention oracles follow the reference's conventions, which differ from
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


# ----------------------------------------------------------------- rwkv6 --
def rwkv6_ref(r, k, v, log_w, u, s0=None):
    """Step-by-step WKV6 recurrence (the definitionally-correct form).

    r/k/v (B,S,H,P), log_w (B,S,H,P) (<= 0), u (H,P), s0 (B,H,P,P).
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (y (B,S,H,P) in r's dtype, S_final (B,H,P,P) float32).
    """
    b, s, h, p = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    uf = u.float()
    state = (torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float().clone())
    ys = []
    for t in range(s):
        kv = torch.einsum("bhp,bhq->bhpq", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhp,bhpq->bhq", rf[:, t],
                               state + uf[None, :, :, None] * kv))
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


# ------------------------------------------------------------ mamba2 ssd --
def ssd_ref(x, dt, a_log, b_in, c_in, s0=None):
    """Step-by-step SSD recurrence.

    x (B,S,H,P), dt (B,S,H) (post-softplus), a_log (H,) with A=-exp(a_log),
    b/c (B,S,H,N), s0 (B,H,P,N).
    H_t = exp(dt_t*A) H_{t-1} + dt_t * x_t (x) B_t ;  y_t = H_t . C_t
    Returns (y (B,S,H,P) in x's dtype, H_final (B,H,P,N) float32).
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    a = -torch.exp(a_log.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b_in.float(), c_in.float()
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if s0 is None else s0.float().clone())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)                     # (B,H)
        state = state * decay[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state
