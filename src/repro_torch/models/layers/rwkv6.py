"""RWKV6 ("Finch") mixers: time-mix with data-dependent decay + channel-mix.

Port of ``repro/models/layers/rwkv6.py``.  Per head (P = head_dim) the
time-mix recurrence over a state S (P_k x P_v):

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with the data-dependent per-channel decay w_t = exp(-exp(w0 + lora(x))),
its log clamped to |log w| <= ``LOG_DECAY_CLAMP`` per step so that the
chunked kernel's e^{-cum} stays finite in float32 over 32 steps.

Prefill (:func:`rwkv6_full`) is the reference's kernel route: the WKV
recurrence goes through :func:`repro_torch.kernels.ops.rwkv6_wkv` (the
CUDA kernel on the card, its plain version on the CPU).  Training
(``rwkv6_full(..., kernels=False)``) is the reference's ``impl="xla"``
chunked scan in torch ops that autograd differentiates; its arithmetic
is the kernel's plain version's, :func:`~repro_torch.kernels.rwkv6_wkv.
rwkv6_wkv_plain`, which it calls as the reference's ``"xla"`` mixer, not
as a fallback from the kernel.  Decode
(:func:`rwkv6_decode`) is the O(1) one-token recurrence in plain torch
ops; the reference has no kernel for it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers.basic import Linear, const_param
from repro_torch.models.layers.mamba2 import pick_chunk

LOG_DECAY_CLAMP = 2.5   # per-step |log w| bound; exp(2.5*chunk) stays in f32
WKV_CHUNK = 32          # the most steps the clamp keeps finite


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, P, P) time-mix state
    shift_tm: torch.Tensor  # (B, D) previous time-mix input
    shift_cm: torch.Tensor  # (B, D) previous channel-mix input


class TimeMix(nn.Module):
    """The time-mix parameters, named as in the reference's pytree."""

    def __init__(self, cfg: ModelConfig, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        rc, d = cfg.rwkv, cfg.d_model
        h = d // rc.head_dim
        mk = lambda a, b: Linear(a, b, device=device, generator=generator,
                                 dtype=dtype)
        # the token-shift coefficients, decays, bonus and group norm stay
        # float32 at any dtype (the reference's rule)
        self.mix = nn.ParameterDict(
            {n: const_param(0.5, (d,), device) for n in ("r", "k", "v", "g",
                                                         "w")})
        self.r, self.k, self.v, self.g = (mk(d, d) for _ in range(4))
        self.w_down = mk(d, rc.decay_lora)
        self.w_up = mk(rc.decay_lora, d)
        self.w0 = const_param(-1.0, (d,), device)
        self.u = const_param(0.0, (h, rc.head_dim), device)   # bonus
        self.ln_g = const_param(1.0, (d,), device)            # group norm
        self.ln_b = const_param(0.0, (d,), device)
        self.o = mk(d, d)


class ChannelMix(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        mk = lambda a, b: Linear(a, b, device=device, generator=generator,
                                 dtype=dtype)
        self.mix = nn.ParameterDict(
            {n: const_param(0.5, (d,), device) for n in ("r", "k")})
        self.rk = mk(d, d)
        self.kk = mk(d, int(3.5 * d))
        self.vv = mk(int(3.5 * d), d)


def _token_shift(x, prev):
    """shifted[t] = x[t-1]; shifted[0] = prev (carried across calls)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(mix_coef, x, x_prev):
    return x + (x_prev - x) * mix_coef.to(x.dtype)


def _streams(p: TimeMix, x, shift_prev):
    """Project the five time-mix streams.  x (B,S,D)."""
    xs = _token_shift(x, shift_prev)
    r = p.r(_mix(p.mix["r"], x, xs))
    k = p.k(_mix(p.mix["k"], x, xs))
    v = p.v(_mix(p.mix["v"], x, xs))
    g = p.g(_mix(p.mix["g"], x, xs))
    wx = _mix(p.mix["w"], x, xs)
    w_log = p.w0 + p.w_up(torch.tanh(p.w_down(wx))).float()
    log_w = -torch.clamp(torch.exp(w_log), 1e-4, LOG_DECAY_CLAMP)  # <= 0
    return r, k, v, g, log_w


def _group_norm(p: TimeMix, y, eps):
    """Per-head LayerNorm over P (RWKV's ln_x), then flatten."""
    b, s, h, pp = y.shape
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    return yn.reshape(b, s, h * pp) * p.ln_g + p.ln_b


def _out(p: TimeMix, cfg, y, g, dtype):
    y = _group_norm(p, y, cfg.norm_eps)
    return p.o((y * F.silu(g.float())).to(dtype))


def rwkv6_full(p: TimeMix, cfg: ModelConfig, x, state: RWKVState, *,
               kernels: bool = True) -> Tuple[torch.Tensor, RWKVState]:
    """Chunked WKV over a full sequence, through the kernel or, with
    ``kernels=False``, the differentiable chunked scan.  Returns
    (y (B,S,D), final state)."""
    b, seq, d = x.shape
    pdim = cfg.rwkv.head_dim
    hnum = d // pdim
    r, k, v, g, log_w = _streams(p, x, state.shift_tm)
    heads = lambda t: t.float().view(b, seq, hnum, pdim)
    wkv = ops.rwkv6_wkv if kernels else rwkv6_wkv_plain
    y, s_final = wkv(heads(r), heads(k), heads(v), heads(log_w), p.u,
                     state.wkv.float(), chunk=pick_chunk(seq, WKV_CHUNK))
    y = _out(p, cfg, y, g, x.dtype)
    return y, RWKVState(wkv=s_final.to(state.wkv.dtype),
                        shift_tm=x[:, -1, :], shift_cm=state.shift_cm)


def rwkv6_decode(p: TimeMix, cfg: ModelConfig, x, state: RWKVState
                 ) -> Tuple[torch.Tensor, RWKVState]:
    """One-token recurrence.  x (B,1,D)."""
    b, _, d = x.shape
    pdim = cfg.rwkv.head_dim
    hnum = d // pdim
    r, k, v, g, log_w = _streams(p, x, state.shift_tm)
    rh, kh, vh = (t.float().view(b, hnum, pdim) for t in (r, k, v))
    w = torch.exp(log_w.view(b, hnum, pdim))
    s_prev = state.wkv.float()
    kv = torch.einsum("bhp,bhq->bhpq", kh, vh)
    y = torch.einsum("bhp,bhpq->bhq", rh,
                     s_prev + p.u[None, :, :, None] * kv)
    s_new = s_prev * w[..., None] + kv
    y = _out(p, cfg, y.view(b, 1, hnum, pdim), g, x.dtype)
    return y, RWKVState(wkv=s_new.to(state.wkv.dtype), shift_tm=x[:, -1, :],
                        shift_cm=state.shift_cm)


def _channel_mix(p: ChannelMix, x, xs):
    r = torch.sigmoid(p.rk(_mix(p.mix["r"], x, xs)))
    k = p.kk(_mix(p.mix["k"], x, xs))
    return r * p.vv(torch.square(F.relu(k)))


def channel_mix_full(p: ChannelMix, cfg: ModelConfig, x, state: RWKVState
                     ) -> Tuple[torch.Tensor, RWKVState]:
    y = _channel_mix(p, x, _token_shift(x, state.shift_cm))
    return y, state._replace(shift_cm=x[:, -1, :])


def channel_mix_decode(p: ChannelMix, cfg: ModelConfig, x, state: RWKVState
                       ) -> Tuple[torch.Tensor, RWKVState]:
    y = _channel_mix(p, x, state.shift_cm[:, None, :])
    return y, state._replace(shift_cm=x[:, -1, :])


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None) -> RWKVState:
    rc, d = cfg.rwkv, cfg.d_model
    h = d // rc.head_dim
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return RWKVState(wkv=z(batch, h, rc.head_dim, rc.head_dim),
                     shift_tm=z(batch, d), shift_cm=z(batch, d))

