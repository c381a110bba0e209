"""qwen3-32b — dense decoder with qk-norm + GQA [hf:Qwen/Qwen3-8B family].

64L, d_model=5120, 64 heads GQA kv=8 (head_dim 128), d_ff=25600,
vocab 151936.  Full attention, no long-decode variant.  Port of
``repro/configs/qwen3_32b.py``.
"""

from repro_torch.models.config import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    d_model=5120,
    vocab_size=151936,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    d_ff=25600,
    layer_plan=(LayerGroup(mixer="attn", ffn="dense", count=64),),
    supports_long_decode=False,
    citation="hf:Qwen/Qwen3-32B",
)
