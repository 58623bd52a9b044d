"""qwen1.5-0.5b [dense]: QKV bias, tied embeddings.

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936. [hf:Qwen/Qwen1.5-0.5B]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
)
