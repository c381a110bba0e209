"""deepseek-67b — llama-architecture dense decoder [arXiv:2401.02954].

95L, d_model=8192, 64 heads GQA kv=8 (head_dim 128), d_ff=22016,
vocab 102400.  The deepest assigned model.  Port of
``repro/configs/deepseek_67b.py``.
"""

from repro_torch.models.config import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    d_model=8192,
    vocab_size=102400,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    rope_theta=1e4,
    layer_plan=(LayerGroup(mixer="attn", ffn="dense", count=95),),
    supports_long_decode=False,
    citation="arXiv:2401.02954 (DeepSeek LLM 67B)",
)
