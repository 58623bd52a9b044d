"""Model registry: arch config -> model object."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .lm import DecoderLM

#: family -> the later slice of the port that brings it
_LATER_SLICE = {
    "moe": "the MoE and MLA decoder slice",
    "vlm": "the VLM decoder slice",
    "ssm": "the xLSTM slice (mlstm_scan)",
    "hybrid": "the Hymba slice (ssd_scan)",
    "encdec": "the Whisper encoder-decoder slice",
}


def build_model(cfg: ModelConfig, *, device="cuda") -> DecoderLM:
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device)
    if cfg.family in _LATER_SLICE:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family!r} is not ported yet; it comes with "
            f"{_LATER_SLICE[cfg.family]}"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
