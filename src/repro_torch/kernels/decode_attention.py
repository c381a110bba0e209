"""Flash decode: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/decode_attention.py`` (the Pallas TPU kernel
``flash_decode``).  The kernel itself is ``csrc/decode_attention.cu``
(split-KV: the cache is cut into :func:`decode_splits` ranges, one block
each, and the splits' partial softmax states are combined in a fixed
order); its header says what bounds it on the H100 and what it leaves
for later.  :func:`combine_splits_plain` is the plain twin of its
combine pass.

Semantics, shared by the kernel and :func:`flash_decode_plain`: one query
token per sequence, q (B,H,D), against caches (B,S,Hkv,D) over the valid
prefix ``slot < lengths[b]``; softmax in float32; the output is
``acc / max(l, 1e-30)`` in q's dtype (float32 or bfloat16).  Masked
scores are -1e30, so a row with no valid slot (length <= 0) averages
over every slot, as the TPU kernel does; callers clamp lengths to >= 1.
``window`` (None or 0 means none) also masks the slots below ``lengths -
window``: with ``lengths = pos + 1`` the reference LM's linear-cache
window ``idx > pos - window``, which the TPU kernel does not take (the
reference computes windowed decode in jnp; the port's LM runs it here).

The caches may be strided views: the Marian decoder passes its folded
(B,T,H*D) buffers as ``view(B,T,H,D)``, and the kernel reads them through
their strides, with no per-step transpose or copy.

``return_stats=True`` also returns each (b, h) row's softmax state in
float32: the score maximum ``m`` and the normaliser ``l = sum exp(s -
m)`` over the slots the softmax ran over (a row with no valid slot: m =
-1e30 and l its slot count).  Outputs over disjoint slices of one cache
merge into the whole cache's output with :func:`merge_decode_stats`,
which is what the sequence-sharded decode computes with collectives
(``models/layers/attention.attn_decode_seq_sharded``; the reference's
``pmax`` / ``psum`` merge).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    _DTYPES,
    HEAD_DIMS,
    SMS,
    _check_operands,
    _lengths_i32,
    _window,
)

NEG_INF = -1e30
MIN_SPLIT_SLOTS = 32   # a split reads at least this many slots
SPLIT_WAVES = 2        # aim: this many blocks per SM over B * Hkv * splits


@functools.lru_cache(maxsize=256)
def decode_splits(b: int, hkv: int, s: int) -> tuple:
    """Split plan ``(n_split, chunk)`` of a cache of capacity ``s`` slots:
    split i covers slots ``[i * chunk, min((i + 1) * chunk, s))``.

    Depends on ``b * hkv`` and ``s`` only, never on the lengths, which live
    on the device (reading them would sync the host every step and break
    CUDA-graph capture).  About ``SPLIT_WAVES`` blocks per SM, with chunks
    of at least ``MIN_SPLIT_SLOTS`` slots in whole groups of 16.
    """
    want = max(1, SPLIT_WAVES * SMS // (b * hkv))
    n = min(want, max(1, s // MIN_SPLIT_SLOTS))
    chunk = -(-s // n)
    chunk = -(-chunk // 16) * 16
    return -(-s // chunk), chunk


def combine_splits_plain(m, l, acc):
    """Plain twin of the kernel's combine pass: the splits' partial softmax
    states ``m``, ``l`` (..., n_split) and ``acc`` (..., n_split, D), all
    float32, merged into the output (..., D).  An empty split (``l == 0``)
    carries no weight; a split of masked slots only carries m = -1e30 and
    its slot count, so a length <= 0 still averages over every slot."""
    live = l > 0
    mx = torch.where(live, m, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
    total = (l * w).sum(-1)
    acc = torch.where(live[..., None], acc, torch.zeros_like(acc))
    return (acc * w[..., None]).sum(-2) / total.clamp_min(1e-30)[..., None]


def merge_decode_stats(outs, ms, ls):
    """The output over a whole cache from ``flash_decode(return_stats=
    True)`` over disjoint slices of it: ``outs`` (B,H,D), ``ms`` and
    ``ls`` (B,H) float32, one each per slice.  ``m_g = max m``, ``w =
    exp(m - m_g)``, ``l_g = sum l w``, ``o = sum o l w / max(l_g,
    1e-30)`` in float32, in outs' dtype.  A slice whose rows have no
    valid slot (m = -1e30) weighs 0 beside a live slice."""
    m = torch.stack(list(ms))
    lw = torch.stack(list(ls)) * torch.exp(m - m.amax(0))
    acc = (torch.stack(list(outs)).float() * lw[..., None]).sum(0)
    return (acc / lw.sum(0).clamp_min(1e-30)[..., None]).to(outs[0].dtype)


def flash_decode_plain(q, k_cache, v_cache, lengths, *, scale=None,
                       window: int | None = None,
                       return_stats: bool = False):
    """Plain PyTorch version of the kernel (materialized scores); with
    ``return_stats`` also (m, l) (B,H) float32."""
    window = _window(window, True)
    b, h, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, rep, d).float()
    scores = torch.einsum("bgrd,btgd->bgrt", qg, k_cache.float()) * scale
    lens = lengths.to(q.device)[:, None]
    slot = torch.arange(t, device=q.device)[None, :]
    valid = slot < lens
    if window:
        valid = valid & (slot >= lens - window)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", w, v_cache.float())
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_stats:
        return out
    m = scores.amax(-1)
    l = torch.exp(scores - m[..., None]).sum(-1)
    return out, m.reshape(b, h), l.reshape(b, h)


def flash_decode_cuda(q, k_cache, v_cache, lengths, *, scale=None,
                      window: int | None = None,
                      return_stats: bool = False):
    """Launch ``csrc/decode_attention.cu`` on PyTorch's current stream;
    with ``return_stats`` also (m, l) (B,H) float32.

    Takes CUDA tensors only and raises on anything the kernel does not
    take; builds the kernel library at first use.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_cuda needs CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    _check_operands({"q": q, "k_cache": k_cache, "v_cache": v_cache},
                    q.dtype, q.device)
    b, h, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match "
                         f"q {tuple(q.shape)}")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled; have {HEAD_DIMS}")
    window = _window(window, True)
    lens = _lengths_i32(lengths, b, q.device)
    scale = scale if scale is not None else d ** -0.5
    n_split, chunk = decode_splits(b, hkv, s)
    # one allocation: the output first, then (with splits) the partial
    # accumulators (B*H*n_split*D) and (m, l) pairs, then (with stats) m
    # and l, all float32
    n_out = b * h * d * q.element_size() // 4
    n_part = b * h * n_split * d if n_split > 1 else 0
    n_ml = 2 * b * h * n_split if n_split > 1 else 0
    n_st = 2 * b * h if return_stats else 0
    buf = torch.empty(n_out + n_part + n_ml + n_st, dtype=torch.float32,
                      device=q.device)
    out = buf[:n_out].view(q.dtype).view(b, h, d)
    base = buf.data_ptr()
    parts = ((base + 4 * n_out, base + 4 * (n_out + n_part)) if n_split > 1
             else (None, None))
    stats = buf[n_out + n_part + n_ml:].view(2, b, h) if return_stats \
        else None
    stat_ptrs = ((stats[0].data_ptr(), stats[1].data_ptr()) if return_stats
                 else (None, None))
    lib = _build.load_library()
    rc = lib.repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens.data_ptr(), out.data_ptr(), *parts, *stat_ptrs, b, s, h, hkv, d,
        n_split,
        chunk, *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2], ctypes.c_float(scale), window, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    return (out, stats[0], stats[1]) if return_stats else out
