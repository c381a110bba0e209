"""deepseek-v3-671b — MLA + 1 shared / 256 routed top-8 MoE + MTP
[arXiv:2412.19437].

61L (first 3 dense, 58 MoE), d_model=7168, 128 heads of MLA
(q_lora 1536, kv_lora 512, nope 128 + rope 64, v 128), expert d_ff=2048,
dense d_ff=18432, vocab 129280, multi-token-prediction depth 1.

The MLA decode path caches the COMPRESSED latent (512+64 per token, vs
2*128*128=32768 for dense GQA).  There is no long-decode variant: full
attention over the latent remains O(context) compute per token, and the
model card caps context at 128k.  Port of
``repro/configs/deepseek_v3_671b.py``.
"""

from repro_torch.models.config import (
    LayerGroup,
    MLAConfig,
    ModelConfig,
    MoEConfig,
)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    d_model=7168,
    vocab_size=129280,
    num_heads=128,
    num_kv_heads=128,     # MLA: effectively MQA over the shared latent
    head_dim=128,
    d_ff=18432,           # dense layers 0..2
    layer_plan=(
        LayerGroup(mixer="mla", ffn="dense", count=3),
        LayerGroup(mixer="mla", ffn="moe", count=58),
    ),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1),
    mtp_depth=1,
    supports_long_decode=False,
    citation="arXiv:2412.19437 (DeepSeek-V3)",
)
