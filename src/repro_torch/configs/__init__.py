"""Architecture registry: ``--arch <id>`` resolves here.

This slice of the port serves the dense qwen1.5-0.5b; the other families of
the JAX package's registry arrive with the slices that port them.
"""

from . import qwen15_0_5b
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {m.CONFIG.arch: m.CONFIG for m in (qwen15_0_5b,)}


__all__ = ["ARCHS", "ModelConfig"]
