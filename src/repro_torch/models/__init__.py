"""Models of the port: the decoder LM (dense, MoE, MLA, VLM), the Whisper
encoder-decoder, xLSTM, Hymba and their parameter layout."""

from . import params
from .encdec import EncDecLM
from .hymba import Hymba
from .lm import DecoderLM
from .registry import build_model
from .xlstm import XLSTM

__all__ = ["DecoderLM", "EncDecLM", "Hymba", "XLSTM", "build_model", "params"]
