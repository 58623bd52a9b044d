"""phi3-medium-14b [dense]: RoPE + SwiGLU + GQA; biggest dense model assigned.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352. [arXiv:2404.14219]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    rope_theta=10000.0,
)
