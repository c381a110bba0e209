"""Mamba2 (SSD — state-space duality) mixer.

Port of ``repro/models/layers/mamba2.py``.  Recurrence per head h with
state H (P, N):

    H_t = a_t * H_{t-1} + dt_t * x_t (x) B_t        a_t = exp(dt_t * A_h)
    y_t = H_t @ C_t + D_h * x_t

Prefill (:func:`mamba2_full`) is the reference's kernel route: the SSD
scan goes through :func:`repro_torch.kernels.ops.ssd_scan` (the CUDA
kernel on the card, its plain version on the CPU), fed strided head views
of the conv output and, with one B/C group, B and C expanded over the
heads rather than repeated.  Training (``mamba2_full(...,
kernels=False)``) is the reference's ``impl="xla"`` chunked scan in torch
ops that autograd differentiates; its arithmetic is the kernel's plain
version's, :func:`~repro_torch.kernels.ssd_scan.ssd_scan_plain`, which it
calls as the reference's ``"xla"`` mixer, not as a fallback from the
kernel (with the decay's prefix sums in float64, as everywhere in the
port).  Decode (:func:`mamba2_decode`) is the O(1) state update in plain
torch ops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import (
    Linear,
    RMSNorm,
    _param,
    const_param,
    normal_param,
    rmsnorm,
)


def pick_chunk(seq: int, chunk: int) -> int:
    """Largest divisor of ``seq`` that is <= ``chunk`` (1 for a prime
    ``seq`` above ``chunk``)."""
    l = min(chunk, seq)
    while seq % l:
        l -= 1
    return max(l, 1)


class MambaState(NamedTuple):
    ssm: torch.Tensor     # (B, nh, P, N)
    conv: torch.Tensor    # (B, conv_width-1, conv_channels) pre-activation


class Mamba2Mixer(nn.Module):
    """The mixer's parameters, named as in the reference's pytree."""

    def __init__(self, cfg: ModelConfig, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        d_in = s.expand * d
        nh = d_in // s.head_dim
        conv_ch = d_in + 2 * s.n_groups * s.state_dim
        # in_proj emits [z, x, B, C, dt]
        self.in_proj = Linear(d, 2 * d_in + 2 * s.n_groups * s.state_dim + nh,
                              device=device, generator=generator, dtype=dtype)
        # the conv's weight and bias are matrices to the reference's dtype
        # rule; a_log, d_skip, dt_bias and the norm stay float32
        self.conv_w = normal_param((s.conv_width, conv_ch),
                                   s.conv_width ** -0.5, device=device,
                                   generator=generator, dtype=dtype)
        self.conv_b = const_param(0.0, (conv_ch,), device, dtype)
        self.a_log = _param(torch.log(torch.linspace(1.0, 16.0, nh,
                                                     device=device)))
        self.d_skip = const_param(1.0, (nh,), device)
        self.dt_bias = const_param(0.0, (nh,), device)
        self.norm_g = RMSNorm(d_in, device=device)
        self.out_proj = Linear(d_in, d, device=device, generator=generator,
                               dtype=dtype)


def _split_proj(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.state_dim
    return torch.split(zxbcdt, [d_in, d_in + 2 * gn, d_in // s.head_dim],
                       dim=-1)


def _causal_conv_full(p: Mamba2Mixer, xbc):
    """Depthwise causal conv over (B,S,C) with window W; silu activation.
    The W taps are summed in float32 and rounded to xbc's dtype once, as
    the decode step's einsum sums them (in bf16, rounding each product
    and partial sum cost the smoke zamba2's first layer 1.8% of its
    gradient's norm)."""
    w = p.conv_w.to(xbc.dtype).float()                 # (W, C)
    width = w.shape[0]
    pads = F.pad(xbc, (0, 0, width - 1, 0)).float()
    out = pads[:, 0:xbc.shape[1], :] * w[0]
    for k in range(1, width):
        out = out + pads[:, k:k + xbc.shape[1], :] * w[k]
    return F.silu(out.to(xbc.dtype) + p.conv_b.to(xbc.dtype))


def _heads(cfg: ModelConfig, x_in, b_in, c_in):
    """(B,S,·) -> x (B,S,nh,P) and B/C (B,S,nh,N), as views where the
    layout allows: one B/C group is expanded over the heads (stride 0)."""
    s = cfg.ssm
    b_, seq = x_in.shape[0], x_in.shape[1]
    nh = (s.expand * cfg.d_model) // s.head_dim
    x = x_in.reshape(b_, seq, nh, s.head_dim)
    bb = b_in.reshape(b_, seq, s.n_groups, s.state_dim)
    cc = c_in.reshape(b_, seq, s.n_groups, s.state_dim)
    rep = nh // s.n_groups
    if s.n_groups == 1:
        return (x, bb.expand(b_, seq, nh, s.state_dim),
                cc.expand(b_, seq, nh, s.state_dim))
    return (x, torch.repeat_interleave(bb, rep, dim=2),
            torch.repeat_interleave(cc, rep, dim=2))


def _gate_out(p: Mamba2Mixer, cfg, y, z):
    """Gated RMSNorm (norm(y * silu(z))) and the output projection."""
    return p.out_proj(rmsnorm(p.norm_g.g, y * F.silu(z), cfg.norm_eps))


def mamba2_full(p: Mamba2Mixer, cfg: ModelConfig, x, *, kernels: bool = True
                ) -> Tuple[torch.Tensor, MambaState]:
    """Chunked SSD over a full sequence, through the kernel or, with
    ``kernels=False``, the differentiable chunked scan.  Returns
    (y (B,S,D), final state).  Needs at least conv_width - 1 tokens: the
    decode's conv buffer is the last W-1 pre-activation inputs."""
    s = cfg.ssm
    b, seq, _ = x.shape
    if seq < s.conv_width - 1:
        raise ValueError(
            f"mamba2 prefill needs at least conv_width - 1 = "
            f"{s.conv_width - 1} tokens (its conv state is the last "
            f"{s.conv_width - 1} inputs), got {seq}")
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.state_dim
    z, xbc, dt_raw = _split_proj(cfg, p.in_proj(x))
    xbc = _causal_conv_full(p, xbc)
    x_in, b_in, c_in = torch.split(xbc, [d_in, gn, gn], dim=-1)
    xh, bh, ch = _heads(cfg, x_in, b_in, c_in)       # (B,S,nh,P),(B,S,nh,N)
    dt = F.softplus(dt_raw.float() + p.dt_bias)       # (B,S,nh)
    ssd = ops.ssd_scan if kernels else ssd_scan_plain
    y, h_final = ssd(xh.float(), dt, p.a_log, bh.float(), ch.float(),
                     chunk=pick_chunk(seq, s.chunk))
    y = y.to(xh.dtype) + xh * p.d_skip[None, None, :, None].to(xh.dtype)
    y = _gate_out(p, cfg, y.reshape(b, seq, d_in), z)
    # rolling conv buffer = the last W-1 pre-activation conv inputs,
    # recomputed from the last W-1 tokens as the reference does
    tail = _split_proj(cfg, p.in_proj(x[:, -(s.conv_width - 1):, :]))[1]
    return y, MambaState(ssm=h_final.to(xh.dtype), conv=tail)


def mamba2_decode(p: Mamba2Mixer, cfg: ModelConfig, x, state: MambaState
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token state update.  x (B,1,D)."""
    s = cfg.ssm
    b = x.shape[0]
    d_in = s.expand * cfg.d_model
    gn = s.n_groups * s.state_dim
    z, xbc_new, dt_raw = _split_proj(cfg, p.in_proj(x))        # (B,1,·)
    window = torch.cat([state.conv, xbc_new], dim=1)           # (B,W,C)
    conv_out = (torch.einsum("bwc,wc->bc", window, p.conv_w.to(x.dtype))
                + p.conv_b.to(x.dtype))
    xbc = F.silu(conv_out)[:, None, :]
    x_in, b_in, c_in = torch.split(xbc, [d_in, gn, gn], dim=-1)
    xh, bh, ch = (t[:, 0] for t in _heads(cfg, x_in, b_in, c_in))
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)          # (B,nh)
    decay = torch.exp(dt * -torch.exp(p.a_log))
    h = state.ssm * decay[:, :, None, None].to(state.ssm.dtype)
    h = h + torch.einsum("bh,bhp,bhs->bhps", dt.to(xh.dtype), xh, bh)
    y = torch.einsum("bhps,bhs->bhp", h, ch)
    y = y + xh * p.d_skip[None, :, None].to(xh.dtype)
    y = _gate_out(p, cfg, y.reshape(b, 1, d_in), z)
    return y, MambaState(ssm=h, conv=window[:, 1:, :])


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaState:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.state_dim
    return MambaState(
        ssm=torch.zeros((batch, nh, s.head_dim, s.state_dim), dtype=dtype,
                        device=device),
        conv=torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                         device=device))
