"""rwkv6-3b — Finch, attention-free linear-attention RNN with
data-dependent decay [arXiv:2404.05892].

32L, d_model=2560, channel-mix width 3.5*d = 8960, vocab 65536.  No KV
cache: decode carries an O(1) state.  Port of ``repro/configs/rwkv6_3b.py``.
"""

from repro_torch.models.config import LayerGroup, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    d_model=2560,
    vocab_size=65536,
    d_ff=8960,                       # == 3.5 * d_model (channel mix)
    layer_plan=(LayerGroup(mixer="rwkv6", ffn="rwkv_cm", count=32),),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    supports_long_decode=True,
    citation="arXiv:2404.05892 (RWKV-6 'Finch')",
)
