"""Unified model configuration for the big-LM stack.

Port of ``repro/models/config.py``: the same frozen dataclasses, field
for field, so a configuration built by either package describes the same
model.  A model is a stack of (mixer, ffn) layer groups described by
``layer_plan``; heterogeneous patterns (hybrid SSM + shared attention)
become several groups.

Mixer kinds : "attn", "mla", "mamba2", "rwkv6", "shared_attn".
FFN kinds   : "dense" (SwiGLU), "moe" (top-k routed + shared experts),
              "rwkv_cm" (RWKV channel mix), "none".

The port's :class:`repro_torch.models.model.LM` builds every group kind,
cross-attention behind an ``EncoderConfig``'s encoder included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64       # N
    head_dim: int = 64        # P
    expand: int = 2           # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128          # SSD chunk length
    n_groups: int = 1         # B/C groups


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64      # rank of the data-dependent decay MLP
    token_shift: bool = True


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    mixer: str                # attn | mla | mamba2 | rwkv6 | shared_attn
    ffn: str                  # dense | moe | rwkv_cm | none
    count: int
    cross_attn: bool = False  # decoder group attends to encoder output


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    num_layers: int
    max_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab_size: int
    layer_plan: Tuple[LayerGroup, ...]
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None
    d_ff: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    mtp_depth: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    supports_long_decode: bool = False
    is_encoder_decoder: bool = False
    citation: str = ""

    @property
    def num_layers(self) -> int:
        return sum(g.count for g in self.layer_plan)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (the reference's
        tensor-parallel padding; pad columns are masked in the logits)."""
        return ((self.vocab_size + 127) // 128) * 128

    def validate(self) -> "ModelConfig":
        assert self.d_model > 0 and self.vocab_size > 0
        uses_attn = any(g.mixer in ("attn", "mla", "shared_attn")
                        for g in self.layer_plan)
        if uses_attn and self.mla is None:
            assert self.num_heads > 0 and self.head_dim > 0
            assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if any(g.ffn == "moe" for g in self.layer_plan):
            assert self.moe is not None
        if any(g.mixer == "mamba2" for g in self.layer_plan):
            assert self.ssm is not None
            d_inner = self.ssm.expand * self.d_model
            assert d_inner % self.ssm.head_dim == 0
        if any(g.mixer == "rwkv6" for g in self.layer_plan):
            assert self.rwkv is not None
            assert self.d_model % self.rwkv.head_dim == 0
        if self.is_encoder_decoder:
            assert self.encoder is not None
        return self

    # -- parameter counting (for the cost model's roofline) -----------------
    def param_counts(self) -> dict:
        """Returns {"total": n, "active": n_active} parameter counts."""
        d = self.d_model
        total = d * self.vocab_size  # input embed
        if not self.tie_embeddings:
            total += d * self.vocab_size  # lm head
        active = total
        shared_attn_counted = False
        for g in self.layer_plan:
            mixer = ffn = 0
            if g.mixer in ("attn", "shared_attn") and self.mla is None:
                q = d * self.num_heads * self.head_dim
                kv = 2 * d * self.num_kv_heads * self.head_dim
                o = self.num_heads * self.head_dim * d
                mixer = q + kv + o
                if g.cross_attn:
                    mixer *= 2
            elif g.mixer == "mla":
                m = self.mla
                mixer = (d * m.q_lora_rank
                         + m.q_lora_rank * self.num_heads
                         * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                         + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                         + m.kv_lora_rank * self.num_heads
                         * (m.qk_nope_head_dim + m.v_head_dim)
                         + self.num_heads * m.v_head_dim * d)
            elif g.mixer == "mamba2":
                s = self.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                mixer = (d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh)
                         + d_in * d)
            elif g.mixer == "rwkv6":
                r = self.rwkv
                mixer = 4 * d * d + d * d  # r,k,v,g + output
                mixer += 2 * d * r.decay_lora  # decay LoRA
            if g.ffn == "dense":
                ffn = 3 * d * self.d_ff
            elif g.ffn == "moe":
                mo = self.moe
                per_exp = 3 * d * mo.d_ff_expert
                ffn = mo.num_experts * per_exp + d * mo.num_experts  # + router
                ffn += mo.num_shared_experts * per_exp
                ffn_active = (mo.top_k + mo.num_shared_experts) * per_exp \
                    + d * mo.num_experts
            elif g.ffn == "rwkv_cm":
                ffn = int(3.5 * d * d)
            if g.mixer == "shared_attn":
                # weights stored once, applied g.count times
                if not shared_attn_counted:
                    total += mixer + ffn
                    shared_attn_counted = True
                active += (mixer + ffn) * g.count
                continue
            total += (mixer + ffn) * g.count
            active += (mixer + (ffn_active if g.ffn == "moe" else ffn)) * g.count
        if self.encoder is not None:
            enc_attn = 4 * d * self.num_heads * self.head_dim
            enc = self.encoder.num_layers * (enc_attn + 3 * d * self.d_ff)
            total += enc
            active += enc
        return {"total": int(total), "active": int(active)}
