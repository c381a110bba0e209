"""Norms, RoPE, embeddings, projections and the SwiGLU FFN of the big-LM
stack.

Port of ``repro/models/layers/basic.py``.  Parameters keep the
reference's layout and names so the converter copies them as they are:
a projection's weight ``w`` is stored (d_in, d_out) and applied as
``x @ w`` (no ``nn.Linear`` transpose); a norm's scale is ``g``; the
embedding table is ``w`` (vocab, d).  Weights are drawn in place from an
explicit ``torch.Generator`` with the reference's laws (N(0, 1/d_in) for
projections, N(0, 1/d) for the embedding), in float32, and each is cast
to its ``dtype`` as soon as it is drawn (the reference's ``(normal(key,
shape, float32) * scale).astype(dtype)``): a model at ``param_dtype``
holds the bits of the float32 model from the same seed, cast tensor by
tensor.  Norm scales and every other constant leaf stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _param(tensor: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(tensor, requires_grad=False)


def const_param(value: float, shape, device,
                dtype=torch.float32) -> nn.Parameter:
    return _param(torch.full(shape, value, dtype=dtype, device=device))


def normal_param(shape, std: float, *, device, generator,
                 dtype=torch.float32) -> nn.Parameter:
    """N(0, std^2) drawn in float32, then cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=generator)
    return _param(w.to(dtype))


# ------------------------------------------------------------------ norms --
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device):
        super().__init__()
        self.g = const_param(1.0, (d,), device)

    def forward(self, x, eps: float = 1e-5):
        return rmsnorm(self.g, x, eps)


def rmsnorm(g, x, eps: float = 1e-5):
    """RMS norm with its statistics in float32 whatever x's dtype."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * g).to(x.dtype)


def head_rmsnorm(g, x, eps: float = 1e-5):
    """qk-norm (qwen3): the RMS norm over the last (head) dim of q or k
    (..., H, Dh) with a scale ``g`` (Dh,), its statistics in float32."""
    return rmsnorm(g, x, eps)


# ------------------------------------------------------------------- rope --
def apply_rope(x, positions, theta: float):
    """x (..., S, H, Dh), positions (..., S) -> rotated x (same dtype).

    The reference's full-width form: frequency and sign tables over all
    Dh lanes (lanes i and i + Dh/2 share a frequency, the sign flips at
    the half) and a roll by Dh/2, not the textbook rotate-half built from
    slices; the tables take the reference's float32 values, so the two
    agree to rounding.
    """
    dh = x.shape[-1]
    idx = torch.arange(dh, dtype=torch.float32, device=x.device)
    freqs_full = 1.0 / (theta ** ((idx % (dh // 2)) * 2.0 / dh))
    sign_full = torch.where(idx < dh // 2, -1.0, 1.0)
    angles = positions[..., None].float() * freqs_full        # (...,S,Dh)
    cos_full = torch.cos(angles)[..., None, :]                 # (...,S,1,Dh)
    sin_full = torch.sin(angles)[..., None, :] * sign_full
    xf = x.float()
    out = xf * cos_full + torch.roll(xf, dh // 2, dims=-1) * sin_full
    return out.to(x.dtype)


# ------------------------------------------------------------ projections --
class Linear(nn.Module):
    """``x @ w`` with ``w`` (d_in, d_out), drawn N(0, scale^2), scale
    d_in^-0.5 by default."""

    def __init__(self, d_in: int, d_out: int, *, device, generator,
                 scale: float | None = None, dtype=torch.float32):
        super().__init__()
        scale = scale if scale is not None else d_in ** -0.5
        self.w = normal_param((d_in, d_out), scale, device=device,
                              generator=generator, dtype=dtype)

    def forward(self, x):
        return linear(self.w, x)


def linear(w, x):
    return x @ w.to(x.dtype)


class Embedding(nn.Module):
    """Token table ``w`` (vocab, d), drawn N(0, 1/d)."""

    def __init__(self, vocab: int, d: int, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        self.w = normal_param((vocab, d), d ** -0.5, device=device,
                              generator=generator, dtype=dtype)

    def forward(self, tokens):
        return self.w[tokens.long()]


# ------------------------------------------------------------------- ffn --
class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        mk = lambda a, b: Linear(a, b, device=device, generator=generator,
                                 dtype=dtype)
        self.gate, self.up = mk(d_model, d_ff), mk(d_model, d_ff)
        self.down = mk(d_ff, d_model)

    def forward(self, x):
        return swiglu(self, x)


def swiglu(p, x):
    return p.down(F.silu(p.gate(x)) * p.up(x))
