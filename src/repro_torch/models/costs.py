"""Analytic FLOPs and memory bytes per (architecture x input shape).

Port of ``repro/models/costs.py``: plain Python arithmetic over a
:class:`~repro_torch.models.config.ModelConfig`, function for function,
so both packages give the same numbers for the same configuration.  It
prices a configuration without building it (the full-width models do not
fit one card), and gives the bounds of a step: a step's FLOPs over the
card's peak rate and its bytes over the memory rate.

Conventions
-----------
* FLOPs: 2*M*N*K per matmul; attention scores+AV = 4*T*Tk*H*Dh (causal
  self-attention halves Tk on average).
* Train = 3x forward (bwd is 2x) + 1x forward recompute (remat) +
  ~25 flops/param optimizer.
* Bytes: parameter traffic + decode state traffic + O(tokens*D) activation
  traffic with a fusion-optimistic constant; decode is parameter/cache
  dominated, which is the regime that matters for the memory term.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.latency_model import ActivationCostModel
from repro_torch.models.config import LayerGroup, ModelConfig


def _attn_flops(cfg: ModelConfig, t: int, tk: float, *, cross: bool = False,
                causal: bool = True) -> float:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * t * d * (h * dh + 2 * hkv * dh) + 2 * t * h * dh * d
    eff_tk = tk / 2 if (causal and not cross and t > 1) else tk
    attn = 4 * t * eff_tk * h * dh
    return proj + attn


def _mla_flops(cfg: ModelConfig, t: int, tk: float, *, decode: bool) -> float:
    m, h, d = cfg.mla, cfg.num_heads, cfg.d_model
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    f = 2 * t * d * m.q_lora_rank + 2 * t * m.q_lora_rank * h * (dn + dr)
    f += 2 * t * d * (r + dr)                      # kv_down
    f += 2 * t * h * dv * d                        # o proj
    if decode:
        # absorbed: q/ouput absorb through k_up/v_up + latent-space attn
        f += 2 * t * h * dn * r + 2 * t * h * r * dv
        f += 4 * t * tk * h * (r + dr)
    else:
        f += 2 * t * r * h * (dn + dv)             # k_up + v_up expand
        eff = tk / 2 if t > 1 else tk
        f += 4 * t * eff * h * (dn + dr + dv) / (dn + dr + dv) * (dn + dr)
        f += 4 * t * eff * h * dv
    return f


def _mamba_flops(cfg: ModelConfig, t: int) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    gn = s.n_groups * s.state_dim
    f = 2 * t * d * (2 * di + 2 * gn + nh) + 2 * t * di * d
    f += 2 * t * s.conv_width * (di + 2 * gn)      # depthwise conv
    if t == 1:
        f += 5 * nh * s.head_dim * s.state_dim     # state update
        return f
    L = min(s.chunk, t)
    # intra: CB^T (L*L*N) + @x (L*L*P); inter/state: 2 * L*P*N per chunk
    per_chunk = (2 * L * L * s.state_dim * nh + 2 * L * L * s.head_dim * nh
                 + 4 * L * s.head_dim * s.state_dim * nh)
    f += (t // L) * per_chunk
    return f


def _rwkv_flops(cfg: ModelConfig, t: int) -> float:
    r = cfg.rwkv
    d = cfg.d_model
    h, p = d // r.head_dim, r.head_dim
    f = 2 * t * d * d * 5 + 4 * t * d * r.decay_lora       # r,k,v,g,o + lora
    if t == 1:
        f += 5 * h * p * p                                  # state update
    else:
        L = min(32, t)
        per_chunk = (4 * L * L * p * h          # A scores + @v
                     + 6 * L * p * p * h)       # state inc + inter
        f += (t // L) * per_chunk
    # channel mix: rk (d*d) + kk (d*3.5d) + vv (3.5d*d)
    f += 2 * t * (d * d + 2 * d * int(3.5 * d))
    return f


def _ffn_flops(cfg: ModelConfig, g: LayerGroup, t: int) -> float:
    if g.ffn == "dense":
        return 6 * t * cfg.d_model * cfg.d_ff
    if g.ffn == "moe":
        mo = cfg.moe
        routed = 6 * t * mo.top_k * mo.capacity_factor * cfg.d_model \
            * mo.d_ff_expert
        shared = 6 * t * cfg.d_model * mo.num_shared_experts * mo.d_ff_expert
        router = 2 * t * cfg.d_model * mo.num_experts
        return routed + shared + router
    if g.ffn == "rwkv_cm":
        return 0.0  # folded into _rwkv_flops
    return 0.0


def forward_flops(cfg: ModelConfig, *, tokens: int, context: float,
                  decode: bool, batch: int = 1) -> float:
    """Whole-model forward FLOPs for `tokens` query tokens against
    `context` keys (context==tokens for train/prefill self-attention).
    ``batch`` only matters for enc-dec models (encoder runs once/sequence).
    """
    total = 2 * tokens * cfg.d_model * cfg.vocab_size     # lm head
    for g in cfg.layer_plan:
        if g.mixer in ("attn", "shared_attn"):
            tk = min(context, cfg.sliding_window) if cfg.sliding_window \
                else context
            per = _attn_flops(cfg, tokens, tk)
            if g.cross_attn:
                per += _attn_flops(cfg, tokens, cfg.encoder.max_frames,
                                   cross=True)
        elif g.mixer == "mla":
            per = _mla_flops(cfg, tokens, context, decode=decode)
        elif g.mixer == "mamba2":
            per = _mamba_flops(cfg, tokens)
        elif g.mixer == "rwkv6":
            per = _rwkv_flops(cfg, tokens)
        per += _ffn_flops(cfg, g, tokens)
        total += per * g.count
    if cfg.is_encoder_decoder and not decode:
        # encoder runs once per sequence over max_frames (bidirectional)
        te = batch * cfg.encoder.max_frames
        per_enc = (_attn_flops(cfg, te, cfg.encoder.max_frames, causal=False)
                   + 6 * te * cfg.d_model * cfg.d_ff)
        total += per_enc * cfg.encoder.num_layers
    if cfg.mtp_depth:
        g = cfg.layer_plan[-1]
        total += (_mla_flops(cfg, tokens, context, decode=False)
                  if g.mixer == "mla" else _attn_flops(cfg, tokens, context))
        total += _ffn_flops(cfg, g, tokens)
        total += 2 * tokens * (2 * cfg.d_model) * cfg.d_model
        total += 2 * tokens * cfg.d_model * cfg.vocab_size
    return float(total)


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    """Decode-state bytes appended per generated token (all layers)."""
    total = 0.0
    for g in cfg.layer_plan:
        if g.mixer in ("attn", "shared_attn"):
            total += 2 * cfg.num_kv_heads * cfg.head_dim * g.count
        elif g.mixer == "mla":
            total += (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) \
                * g.count
        # mamba/rwkv states are O(1), not per-token
    return total * dtype_bytes


def recurrent_state_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    total = 0.0
    for g in cfg.layer_plan:
        if g.mixer == "mamba2":
            s = cfg.ssm
            nh = s.expand * cfg.d_model // s.head_dim
            total += nh * s.head_dim * s.state_dim * g.count
        elif g.mixer == "rwkv6":
            r = cfg.rwkv
            h = cfg.d_model // r.head_dim
            total += (h * r.head_dim * r.head_dim + 2 * cfg.d_model) * g.count
    return total * dtype_bytes


def activation_cost_model(cfg: ModelConfig,
                          dtype_bytes: int = 2) -> ActivationCostModel:
    """Encoder-state wire size for a big-model config (bf16 default)."""
    return ActivationCostModel(d_model=cfg.d_model, dtype_bytes=dtype_bytes)


def nmt_activation_cost(model, dtype_bytes: int = 4) -> ActivationCostModel:
    """Encoder-state wire size for an NMT model (fp32 default on CPU).

    Works for any of the three seed NMT models: transformer configs
    expose ``d_model``, the RNN configs expose ``hidden``.  For the GRU
    the shipped state is a single fixed-size context vector, so
    ``n x hidden`` is a conservative upper bound rather than exact —
    fine for scheduling (it only makes the GRU's split plans look
    slightly worse than they are).
    """
    cfg = model.cfg if hasattr(model, "cfg") else model
    d = getattr(cfg, "d_model", None) or cfg.hidden
    return ActivationCostModel(d_model=int(d), dtype_bytes=dtype_bytes)


@dataclasses.dataclass(frozen=True)
class StepCost:
    flops: float           # per step
    hbm_bytes: float       # per step
    kind: str


def step_cost(cfg: ModelConfig, *, kind: str, batch: int, seq: int,
              moments_bytes: int = 8, param_bytes: int = 2) -> StepCost:
    """Analytic per-step cost of a train, prefill or decode step at
    ``batch`` x ``seq`` (the whole step, on however many devices)."""
    pc = cfg.param_counts()
    p_total = pc["total"]
    if kind == "train":
        tokens = batch * seq
        fwd = forward_flops(cfg, tokens=tokens, context=seq, decode=False, batch=batch)
        flops = 4 * fwd + 25 * p_total            # fwd+bwd(2x)+remat + opt
        act_rw = 16 * tokens * cfg.d_model * cfg.num_layers * param_bytes
        # params: fwd read + recompute read + grad write + opt read/write
        param_traffic = p_total * (3 * param_bytes + 2 * param_bytes
                                   + 2 * moments_bytes + moments_bytes // 2)
        bytes_ = param_traffic + act_rw
    elif kind == "prefill":
        tokens = batch * seq
        flops = forward_flops(cfg, tokens=tokens, context=seq, decode=False, batch=batch)
        kv_write = tokens * kv_bytes_per_token(cfg)
        act_rw = 8 * tokens * cfg.d_model * cfg.num_layers * param_bytes
        bytes_ = p_total * param_bytes + act_rw + kv_write
    elif kind == "decode":
        tokens = batch
        flops = forward_flops(cfg, tokens=tokens, context=seq, decode=True)
        ctx_eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        cache_read = batch * ctx_eff * kv_bytes_per_token(cfg)
        state_rw = 2 * batch * recurrent_state_bytes(cfg)
        bytes_ = p_total * param_bytes + cache_read + state_rw \
            + 8 * tokens * cfg.d_model * cfg.num_layers * param_bytes
    else:
        raise ValueError(kind)
    return StepCost(flops=float(flops), hbm_bytes=float(bytes_), kind=kind)
