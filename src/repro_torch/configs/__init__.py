"""Architecture registry of the big-LM stack, with the smoke reductions.

Port of ``repro/configs/__init__.py``.  ``get_config(name)`` returns the
assigned configuration; ``get_config(name, shape="long_500k")`` swaps in
the documented long-decode variant where one exists (qwen3-8b and
zamba2-1.2b: a 4096-token sliding window over a ring KV cache).
``smoke_config(name)`` is the reduced same-family variant the CPU tests
use, by the reference's exact rules (<=2 layers per group kind, d_model
256, vocab 512, narrower heads and states, a sliding window capped at
8, an encoder of 2 layers over 16 frames).

All ten assigned names: the two recurrent families (``rwkv6-3b``,
``zamba2-1.2b``), whisper-large-v3 (encoder-decoder), the dense GQA
decoders (``qwen3-8b``, ``qwen3-32b``, ``deepseek-67b``,
``chameleon-34b``), the MoE decoders (``qwen3-moe-30b-a3b``,
``moonshot-v1-16b-a3b``) and ``deepseek-v3-671b`` (MLA, MoE, MTP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import (
    chameleon_34b,
    deepseek_67b,
    deepseek_v3_671b,
    moonshot_v1_16b_a3b,
    qwen3_8b,
    qwen3_32b,
    qwen3_moe_30b_a3b,
    rwkv6_3b,
    whisper_large_v3,
    zamba2_1p2b,
)
from repro_torch.models.config import EncoderConfig, MLAConfig, ModelConfig

_MODULES = {
    "rwkv6-3b": rwkv6_3b,
    "whisper-large-v3": whisper_large_v3,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "zamba2-1.2b": zamba2_1p2b,
    "qwen3-32b": qwen3_32b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "deepseek-67b": deepseek_67b,
    "qwen3-8b": qwen3_8b,
    "chameleon-34b": chameleon_34b,
}

# every architecture the reference registry assigns, in its order
ARCH_NAMES = tuple(_MODULES)

# The four assigned input shapes: name -> (seq_len, global_batch, kind)
INPUT_SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; have {ARCH_NAMES}")
    return _MODULES[name]


def get_config(name: str, shape: Optional[str] = None) -> ModelConfig:
    """The assigned configuration, or with ``shape="long_500k"`` its
    sliding-window long-decode variant where the architecture has one."""
    mod = _module(name)
    cfg = mod.CONFIG
    if shape == "long_500k" and hasattr(mod, "long_decode_variant"):
        cfg = mod.long_decode_variant()
    return cfg.validate()


def shape_supported(name: str, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is runnable; returns (ok, reason-if-not):
    long_500k needs a configuration that supports long decode (a
    recurrent state, or a sliding-window variant)."""
    cfg = _module(name).CONFIG
    if shape == "long_500k" and not cfg.supports_long_decode:
        return False, ("full-attention KV cache is O(context): skipped per "
                       "DESIGN.md §long_500k")
    return True, ""


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant: <=2 layers per group kind, d_model
    256, vocab 512, <=4 experts — the reference's reduction rules, rule
    for rule."""
    cfg = _module(name).CONFIG
    plan = []
    seen_kinds = set()
    for g in cfg.layer_plan:
        key = (g.mixer, g.ffn)
        if key in seen_kinds:
            continue
        seen_kinds.add(key)
        plan.append(dataclasses.replace(g, count=min(g.count, 2)))
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=256,
        vocab_size=512,
        layer_plan=tuple(plan),
        d_ff=max(1, min(cfg.d_ff, 512)) if cfg.d_ff else 0,
        sliding_window=cfg.sliding_window and min(cfg.sliding_window, 8),
    )
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=max(1, 4 * cfg.num_kv_heads
                                                // cfg.num_heads),
                  head_dim=64)
    if cfg.moe:
        # capacity_factor = E/k -> capacity >= group size: drop-free, so
        # decode and teacher-forced paths agree exactly (the full configs
        # keep the assigned 1.25 dropping behaviour)
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=128,
            capacity_factor=2.0)
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=32, qk_rope_head_dim=16,
                              v_head_dim=32)
        kw.update(num_heads=4, num_kv_heads=4, head_dim=32)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32,
                                        chunk=8)
    if cfg.rwkv:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=32,
                                         decay_lora=16)
    if cfg.encoder:
        kw["encoder"] = EncoderConfig(num_layers=2, max_frames=16)
    return dataclasses.replace(cfg, **kw).validate()
