"""qwen3-8b — dense decoder, qk-norm + GQA [hf:Qwen/Qwen3-8B].

36L, d_model=4096, 32 heads GQA kv=8 (head_dim 128), d_ff=12288,
vocab 151936.  Port of ``repro/configs/qwen3_8b.py``.

``long_decode_variant`` adds a 4096 sliding window (the ring KV cache),
which makes the 500k decode shape allocatable:
``get_config("qwen3-8b", shape="long_500k")``.
"""

import dataclasses

from repro_torch.models.config import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    d_model=4096,
    vocab_size=151936,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    d_ff=12288,
    layer_plan=(LayerGroup(mixer="attn", ffn="dense", count=36),),
    supports_long_decode=True,     # via the SWA variant below
    citation="hf:Qwen/Qwen3-8B",
)


def long_decode_variant() -> ModelConfig:
    return dataclasses.replace(CONFIG, sliding_window=4096,
                               name=CONFIG.name + "-swa")
