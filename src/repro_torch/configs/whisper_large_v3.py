"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed to frame embeddings.

32L (per side) d_model=1280 20H (GQA kv=20 -> MHA) d_ff=5120 vocab=51866.
[arXiv:2212.04356]
"""

from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    arch="whisper-large-v3",
    family="encdec",
    n_layers=32,                  # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    rope_theta=0.0,               # whisper uses absolute positions, not RoPE
    encdec=EncDecConfig(n_encoder_layers=32, cross_attention=True),
)
