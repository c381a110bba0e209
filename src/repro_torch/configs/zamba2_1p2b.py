"""zamba2-1.2b — Mamba2 backbone + ONE shared attention block applied at
intervals [arXiv:2411.15242].

38 layer slots: (5 x mamba2, 1 x shared attn+MLP) x 6 + 2 trailing
mamba2 = 32 mamba2 layers + 6 calls of the single shared transformer
block (weights stored once).  d_model=2048, ssm_state=64, attention 32
heads (kv=32, head_dim 64), shared-MLP d_ff=8192, vocab 32000.  Port of
``repro/configs/zamba2_1p2b.py``.

The mamba2 state is O(1); for the 500k decode shape the shared attention
runs with a 4096-token sliding window (the ring cache) — see
``long_decode_variant``.
"""

import dataclasses

from repro_torch.models.config import LayerGroup, ModelConfig, SSMConfig

_PLAN = []
for _ in range(6):
    _PLAN.append(LayerGroup(mixer="mamba2", ffn="none", count=5))
    _PLAN.append(LayerGroup(mixer="shared_attn", ffn="dense", count=1))
_PLAN.append(LayerGroup(mixer="mamba2", ffn="none", count=2))

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    d_model=2048,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    layer_plan=tuple(_PLAN),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk=128),
    supports_long_decode=True,
    citation="arXiv:2411.15242 (Zamba2)",
)


def long_decode_variant() -> ModelConfig:
    """500k decode: the shared attention gets a 4096-token sliding window."""
    return dataclasses.replace(CONFIG, sliding_window=4096,
                               name=CONFIG.name + "-swa")
