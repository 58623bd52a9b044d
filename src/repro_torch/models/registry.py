"""Model registry: arch config -> model object, for every family of the JAX
registry, the batch's sharding spec (JAX's ``_dp_axes`` and ``_batch_spec``),
by which each data-parallel rank takes its rows of a global batch, and, as
in JAX, ``input_specs`` (each (arch x shape) cell's inputs as tensors on the
meta device with their spec trees) and ``step_fn`` (the cell's step)."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from . import params as PM
from .encdec import EncDecLM
from .hymba import Hymba
from .lm import DecoderLM
from .params import P
from .xlstm import XLSTM

#: encoder frames given to whisper when decoding (30 s window -> 1500 frames,
#: padded to a block-friendly 1536), JAX's
WHISPER_DECODE_ENC_LEN = 1536


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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _strip_dp(spec: tuple) -> tuple:
    """A spec with ``data`` and ``pod`` taken out of every entry."""
    def drop(e):
        if e in ("data", "pod"):
            return None
        if isinstance(e, tuple) and set(e) & {"data", "pod"}:
            rest = tuple(a for a in e if a not in ("data", "pod"))
            return rest if rest else None
        return e

    return P(*[drop(e) for e in spec])


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *, mesh=None, model=None):
    """(batch of meta tensors, matching spec tree) for one cell, JAX's
    ``input_specs``: int32 tokens, embeddings in the config's dtype, and for
    decode the model's cache (``params.abstract`` of its cache layout) with
    ``index`` a 0-d int32, whose cache specs lose ``data`` and ``pod`` where
    the batch does not divide over them.  No storage is allocated."""
    model = model or build_model(cfg, mesh=mesh, device="meta")
    B, S = shape.global_batch, shape.seq_len
    tok = _meta((B, S), torch.int32)
    tok_spec = _batch_spec(mesh, B, None)
    dt = PM.as_dtype(cfg.dtype)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            batch = {"enc_emb": _meta((B, S, cfg.d_model), dt), "tokens": tok, "labels": tok}
            spec = {"enc_emb": _batch_spec(mesh, B, None, None), "tokens": tok_spec,
                    "labels": tok_spec}
        elif cfg.family == "vlm":
            n_img = cfg.vlm.n_image_tokens
            t = _meta((B, S - n_img), torch.int32)
            batch = {"img_emb": _meta((B, n_img, cfg.d_model), dt), "tokens": t, "labels": t}
            spec = {"img_emb": _batch_spec(mesh, B, None, None), "tokens": tok_spec,
                    "labels": tok_spec}
        else:
            batch = {"tokens": tok, "labels": tok}
            spec = {"tokens": tok_spec, "labels": tok_spec}
        if shape.kind == "prefill":
            batch.pop("labels")
            spec.pop("labels")
        return batch, spec

    if cfg.family == "encdec":
        cache_lay = model.cache_layout(B, S, WHISPER_DECODE_ENC_LEN)
    else:
        cache_lay = model.cache_layout(B, S)
    cache_spec = PM.specs(cache_lay)
    if mesh is not None:
        dp_size = 1
        for a in _dp_axes(mesh):
            dp_size *= mesh.shape[a]
        if B % max(1, dp_size) != 0:
            cache_spec = PM.tree_map(_strip_dp, cache_spec)
    batch = {"tokens": _meta((B, 1), torch.int32), "cache": PM.abstract(cache_lay, cfg.dtype),
             "index": _meta((), torch.int32)}
    spec = {"tokens": _batch_spec(mesh, B, None), "cache": cache_spec, "index": P()}
    return batch, spec


def step_fn(cfg: ModelConfig, shape: ShapeConfig, model=None):
    """The step of one cell: ``loss``, ``prefill`` or ``decode_step``."""
    model = model or build_model(cfg, device="meta")
    if shape.kind == "train":
        return model.loss
    if shape.kind == "prefill":
        return model.prefill
    return model.decode_step
