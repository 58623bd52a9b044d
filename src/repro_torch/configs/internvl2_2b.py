"""internvl2-2b [vlm]: InternViT frontend (stubbed to patch embeddings) +
InternLM2 text backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. [arXiv:2404.16821; hf]
"""

from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    arch="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    rope_theta=1e6,
    vlm=VLMConfig(n_image_tokens=256),
)
