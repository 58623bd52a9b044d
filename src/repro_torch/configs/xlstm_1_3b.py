"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks (one sLSTM per 8 blocks).

48L d_model=2048 4H vocab=50304; d_ff=0 (blocks carry their own projections).
[arXiv:2405.04517]
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm=SSMConfig(state_dim=0, conv_width=4, expand=2, slstm_every=8, chunk=128),
)
