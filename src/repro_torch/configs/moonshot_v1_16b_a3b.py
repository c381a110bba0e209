"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (DeepSeek-style MoE)
[hf:moonshotai/Moonlight-16B-A3B].

48L, d_model=2048, 16 heads (kv=16 per assignment), expert d_ff=1408,
64 experts top-6 + 2 shared experts, first layer dense (d_ff 8*1408),
vocab 163840.  Port of ``repro/configs/moonshot_v1_16b_a3b.py``.
"""

from repro_torch.models.config import LayerGroup, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="dense",     # assignment lists it under dense (MoE inside)
    d_model=2048,
    vocab_size=163840,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=11264,            # first dense layer (8 * expert width)
    layer_plan=(
        LayerGroup(mixer="attn", ffn="dense", count=1),
        LayerGroup(mixer="attn", ffn="moe", count=47),
    ),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2),
    supports_long_decode=False,
    citation="hf:moonshotai/Moonlight-16B-A3B",
)
