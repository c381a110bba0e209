"""whisper-large-v3 — encoder-decoder speech model [arXiv:2212.04356].

Transformer backbone only: the mel-spectrogram and conv frontend is a
stub, and the encoder takes precomputed frame embeddings (B, frames,
d_model).  32 encoder + 32 decoder layers, d_model=1280, 20 heads (MHA:
kv=20) of 64, d_ff=5120, vocab 51866 (padded to 51968).  Every decoder
layer attends to its own tokens, then to the encoder's frames (cross
attention); the decode state carries each layer's cross K/V.  Port of
``repro/configs/whisper_large_v3.py``.  No long-decode variant: the
decoder is full attention over a 448-token design context.
"""

from repro_torch.models.config import EncoderConfig, LayerGroup, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    d_model=1280,
    vocab_size=51866,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    layer_plan=(LayerGroup(mixer="attn", ffn="dense", count=32,
                           cross_attn=True),),
    encoder=EncoderConfig(num_layers=32, max_frames=1500),
    is_encoder_decoder=True,
    rope_theta=1e4,
    supports_long_decode=False,
    citation="arXiv:2212.04356 (Whisper); frontend stubbed per assignment",
)
