"""Flash decode: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/decode_attention.py`` (the Pallas TPU kernel
``flash_decode``).  The kernel itself is ``csrc/decode_attention.cu``;
its header says what bounds it on the H100 and what its simple design
leaves for later.

Semantics, shared by the kernel and :func:`flash_decode_plain`: one query
token per sequence, q (B,H,D), against caches (B,S,Hkv,D) over the valid
prefix ``slot < lengths[b]``; softmax in float32; the output is
``acc / max(l, 1e-30)`` in q's dtype (float32 or bfloat16).  Masked
scores are -1e30, so a row with length <= 0 averages over every slot, as
the TPU kernel does; callers clamp lengths to >= 1.

The caches may be strided views: the Marian decoder passes its folded
(B,T,H*D) buffers as ``view(B,T,H,D)``, and the kernel reads them through
their strides, with no per-step transpose or copy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    _DTYPES,
    _check_operands,
    _lengths_i32,
)

NEG_INF = -1e30


def flash_decode_plain(q, k_cache, v_cache, lengths, *, scale=None):
    """Plain PyTorch version of the kernel (materialized scores)."""
    b, h, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, rep, d).float()
    scores = torch.einsum("bgrd,btgd->bgrt", qg, k_cache.float()) * scale
    valid = (torch.arange(t, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", w, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def flash_decode_cuda(q, k_cache, v_cache, lengths, *, scale=None):
    """Launch ``csrc/decode_attention.cu`` on PyTorch's current stream.

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
    lens = _lengths_i32(lengths, b, q.device)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    rc = lib.repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, s, h, hkv, d,
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2], ctypes.c_float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    return out
