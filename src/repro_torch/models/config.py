"""Unified model configuration for the big-LM stack.

Port of ``repro/models/config.py``: the same frozen dataclasses, field
for field, so a configuration built by either package describes the same
model.  A model is a stack of (mixer, ffn) layer groups described by
``layer_plan``; heterogeneous patterns (hybrid SSM + shared attention)
become several groups.

Mixer kinds : "attn", "mla", "mamba2", "rwkv6", "shared_attn".
FFN kinds   : "dense" (SwiGLU), "moe", "rwkv_cm" (RWKV channel mix),
              "none".

The port's :class:`repro_torch.models.model.LM` builds the rwkv6, mamba2,
shared-attention and GQA groups; ``MoEConfig``, ``MLAConfig`` and
``EncoderConfig`` are carried as plain data so every configuration
loads, and the LM raises ``NotImplementedError`` on them.
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
