"""Architecture registry: ``--arch <id>`` resolves here.

The port serves and trains the dense qwen1.5-0.5b, qwen3-4b, phi4-mini-3.8b
and phi3-medium-14b, the xLSTM xlstm-1.3b and the hybrid hymba-1.5b, and
serves the MoE mixtral-8x7b and deepseek-v2-lite-16b (MLA); the VLM and
encoder-decoder families of the JAX package's registry arrive with the
slices that port them.
"""

from . import (deepseek_v2_lite_16b, hymba_1_5b, mixtral_8x7b, phi3_medium_14b, phi4_mini_3_8b,
               qwen3_4b, qwen15_0_5b, xlstm_1_3b)
from .base import HybridConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.arch: m.CONFIG for m in (deepseek_v2_lite_16b, mixtral_8x7b, qwen15_0_5b, qwen3_4b,
                                      phi4_mini_3_8b, phi3_medium_14b, xlstm_1_3b, hymba_1_5b)
}


__all__ = ["ARCHS", "HybridConfig", "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig"]
