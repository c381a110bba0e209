"""qwen3-moe-30b-a3b — Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32 heads GQA kv=4 (head_dim 128), 128 experts top-8
(expert d_ff=768, no shared expert), qk-norm, vocab 151936.
Port of ``repro/configs/qwen3_moe_30b_a3b.py``.
"""

from repro_torch.models.config import LayerGroup, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    d_model=2048,
    vocab_size=151936,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    qk_norm=True,
    layer_plan=(LayerGroup(mixer="attn", ffn="moe", count=48),),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768,
                  num_shared_experts=0),
    supports_long_decode=False,
    citation="hf:Qwen/Qwen3-30B-A3B",
)
