"""Models of the port: the dense decoder LM, xLSTM and their parameter layout."""

from . import params
from .lm import DecoderLM
from .registry import build_model
from .xlstm import XLSTM

__all__ = ["DecoderLM", "XLSTM", "build_model", "params"]
