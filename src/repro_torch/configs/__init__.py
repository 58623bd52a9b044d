"""Architecture registry: ``--arch <id>`` resolves here.

The port serves and trains the dense qwen1.5-0.5b, qwen3-4b, phi4-mini-3.8b
and phi3-medium-14b, the xLSTM xlstm-1.3b and the hybrid hymba-1.5b; the
other families of the JAX package's registry arrive with the slices that
port them.
"""

from . import (hymba_1_5b, phi3_medium_14b, phi4_mini_3_8b, qwen3_4b, qwen15_0_5b,
               xlstm_1_3b)
from .base import HybridConfig, ModelConfig, SSMConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.arch: m.CONFIG for m in (qwen15_0_5b, qwen3_4b, phi4_mini_3_8b, phi3_medium_14b,
                                      xlstm_1_3b, hymba_1_5b)
}


__all__ = ["ARCHS", "HybridConfig", "ModelConfig", "SSMConfig"]
