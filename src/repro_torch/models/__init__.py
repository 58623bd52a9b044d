"""Models of the port: the dense decoder LM and its parameter layout."""

from . import params
from .lm import DecoderLM
from .registry import build_model

__all__ = ["DecoderLM", "build_model", "params"]
