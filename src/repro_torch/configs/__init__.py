"""Architecture registry: ``--arch <id>`` resolves here.

The port serves and trains the dense qwen1.5-0.5b and trains the xLSTM
xlstm-1.3b; the other families of the JAX package's registry arrive with the
slices that port them.
"""

from . import qwen15_0_5b, xlstm_1_3b
from .base import ModelConfig, SSMConfig

ARCHS: dict[str, ModelConfig] = {m.CONFIG.arch: m.CONFIG for m in (qwen15_0_5b, xlstm_1_3b)}


__all__ = ["ARCHS", "ModelConfig", "SSMConfig"]
