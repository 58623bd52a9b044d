"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. [arXiv:2401.04088; hf]
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336),
)
