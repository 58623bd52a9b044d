"""Model registry: arch config -> model object."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .hymba import Hymba
from .lm import DecoderLM
from .xlstm import XLSTM

#: family -> the later slice of the port that brings it
_LATER_SLICE = {
    "vlm": "the VLM decoder slice",
    "encdec": "the Whisper encoder-decoder slice",
}


def build_model(cfg: ModelConfig, *, device="cuda") -> DecoderLM | XLSTM | Hymba:
    if cfg.family in ("dense", "moe"):
        return DecoderLM(cfg, device=device)
    if cfg.family == "ssm":
        return XLSTM(cfg, device=device)
    if cfg.family == "hybrid":
        return Hymba(cfg, device=device)
    if cfg.family in _LATER_SLICE:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER_SLICE[cfg.family]}"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
