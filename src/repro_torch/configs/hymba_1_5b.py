"""hymba-1.5b [hybrid]: parallel attention + mamba heads, meta tokens,
sliding-window attention with 3 global layers.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16.
[arXiv:2411.13676; hf]
"""

from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2, chunk=128),
    hybrid=HybridConfig(
        n_ssm_heads=8, global_layers=(0, 15, 31), meta_tokens=128, sliding_window=1024
    ),
)
