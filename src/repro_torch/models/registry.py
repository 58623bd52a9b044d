"""Model registry: arch config -> model object, for every family of the JAX registry."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .encdec import EncDecLM
from .hymba import Hymba
from .lm import DecoderLM
from .xlstm import XLSTM


def build_model(cfg: ModelConfig, *, device="cuda") -> DecoderLM | EncDecLM | XLSTM | Hymba:
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, device=device)
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device)
    if cfg.family == "ssm":
        return XLSTM(cfg, device=device)
    if cfg.family == "hybrid":
        return Hymba(cfg, device=device)
    raise ValueError(f"unknown family {cfg.family!r}")
