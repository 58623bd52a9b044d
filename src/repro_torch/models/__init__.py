"""Models of the port: the dense decoder LM, xLSTM, Hymba and their parameter layout."""

from . import params
from .hymba import Hymba
from .lm import DecoderLM
from .registry import build_model
from .xlstm import XLSTM

__all__ = ["DecoderLM", "Hymba", "XLSTM", "build_model", "params"]
