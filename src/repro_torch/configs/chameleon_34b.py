"""chameleon-34b — early-fusion mixed-modal decoder [arXiv:2405.09818].

48L, d_model=8192, 64 heads GQA kv=8 (head_dim 128), d_ff=22016,
vocab 65536 — the vocabulary contains BOTH text tokens and VQ-VAE image
tokens (early fusion: one decoder, one token space).  qk-norm is real
Chameleon (they introduced it for training stability).

The VQ image tokenizer is not implemented: the model takes
already-quantized token ids, image-token spans indistinguishable from
text at the backbone level (that is early fusion's point).  Port of
``repro/configs/chameleon_34b.py``.
"""

from repro_torch.models.config import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    d_model=8192,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    qk_norm=True,
    d_ff=22016,
    rope_theta=1e4,
    layer_plan=(LayerGroup(mixer="attn", ffn="dense", count=48),),
    supports_long_decode=False,
    citation="arXiv:2405.09818 (Chameleon)",
)
