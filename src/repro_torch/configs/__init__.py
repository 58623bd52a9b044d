"""Architecture registry: ``--arch <id>`` resolves here.

Every arch of the JAX package's registry: the dense qwen1.5-0.5b, qwen3-4b,
phi4-mini-3.8b and phi3-medium-14b, the xLSTM xlstm-1.3b, the hybrid
hymba-1.5b, the MoE mixtral-8x7b and deepseek-v2-lite-16b (MLA), the VLM
internvl2-2b (an image-patch prefix before a dense GQA backbone) and the
encoder-decoder whisper-large-v3 (frame embeddings in, text out).
"""

from . import (deepseek_v2_lite_16b, hymba_1_5b, internvl2_2b, mixtral_8x7b, phi3_medium_14b,
               phi4_mini_3_8b, qwen3_4b, qwen15_0_5b, whisper_large_v3, xlstm_1_3b)
from .base import (EncDecConfig, HybridConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig,
                   VLMConfig)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.arch: m.CONFIG for m in (whisper_large_v3, deepseek_v2_lite_16b, mixtral_8x7b,
                                      qwen3_4b, phi4_mini_3_8b, qwen15_0_5b, phi3_medium_14b,
                                      xlstm_1_3b, internvl2_2b, hymba_1_5b)
}


__all__ = ["ARCHS", "EncDecConfig", "HybridConfig", "MLAConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "VLMConfig"]
