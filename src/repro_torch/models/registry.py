"""Model registry: arch config -> model object, for every family of the JAX
registry, and the batch's sharding spec (JAX's ``_dp_axes`` and ``_batch_spec``),
by which each data-parallel rank takes its rows of a global batch."""

from __future__ import annotations

from ..configs.base import ModelConfig
from .encdec import EncDecLM
from .hymba import Hymba
from .lm import DecoderLM
from .params import P
from .xlstm import XLSTM


def build_model(cfg: ModelConfig, *, model_axis: int = 16, mesh=None,
                device="cuda") -> DecoderLM | EncDecLM | XLSTM | Hymba:
    """The model of ``cfg``.  ``model_axis`` and ``mesh`` set only the layouts'
    sharding specs, as in JAX; the arithmetic is the same at any value."""
    kw = dict(model_axis=model_axis, mesh=mesh, device=device)
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, **kw)
    if cfg.family == "encdec":
        return EncDecLM(cfg, **kw)
    if cfg.family == "ssm":
        return XLSTM(cfg, **kw)
    if cfg.family == "hybrid":
        return Hymba(cfg, **kw)
    raise ValueError(f"unknown family {cfg.family!r}")


def _dp_axes(mesh) -> tuple[str, ...]:
    if mesh is None:
        return ("data",)
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_spec(mesh, batch: int, *trailing) -> tuple:
    """Shard batch over (pod, data) when divisible; replicate otherwise
    (long_500k has batch 1)."""
    dp = _dp_axes(mesh)
    if mesh is not None:
        dp_size = 1
        for a in dp:
            dp_size *= mesh.shape[a]
        if batch % max(1, dp_size) != 0:
            return P(None, *trailing)
    return P(dp if len(dp) > 1 else (dp[0] if dp else None), *trailing)
