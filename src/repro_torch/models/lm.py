"""Decoder LM, dense GQA path: the port of ``repro.models.lm.DecoderLM``.

Parameters are passed in as a nested dict with the JAX package's layout, as
the JAX methods take them, so a JAX parameter tree runs here unchanged
(``params.params_from_jax``).  The layers run in a Python loop where JAX scans
over the stacked layer axis; each stacked leaf is split once with
``unbind``, whose backward stacks the layers' gradients into one leaf of the
stacked shape again.  ``loss`` and ``backbone`` are differentiable with
autograd through the kernels' backward; ``prefill`` and ``decode_step`` run
under ``torch.no_grad``.  ``decode_step`` writes the new token's K and V
into the cache IN PLACE and returns that same cache object, where JAX returns
an updated copy.

The MoE, MLA and VLM branches of the JAX class arrive with their own slice.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from . import params as PM
from .layers import blockwise_attention, cache_slot, decode_attention, rms_norm, rope, swiglu


def _attn_layout(cfg: ModelConfig) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    lay = {
        "ln": PM.ParamInfo((D,), "ones"),
        "wq": PM.ParamInfo((D, H * hd)),
        "wk": PM.ParamInfo((D, Hkv * hd)),
        "wv": PM.ParamInfo((D, Hkv * hd)),
        "wo": PM.ParamInfo((H * hd, D)),
    }
    if cfg.qkv_bias:
        lay["bq"] = PM.ParamInfo((H * hd,), "zeros")
        lay["bk"] = PM.ParamInfo((Hkv * hd,), "zeros")
        lay["bv"] = PM.ParamInfo((Hkv * hd,), "zeros")
    if cfg.qk_norm:
        lay["q_norm"] = PM.ParamInfo((hd,), "ones")
        lay["k_norm"] = PM.ParamInfo((hd,), "ones")
    return lay


def _mlp_layout(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    return {
        "ln": PM.ParamInfo((D,), "ones"),
        "w_gate": PM.ParamInfo((D, cfg.d_ff)),
        "w_up": PM.ParamInfo((D, cfg.d_ff)),
        "w_down": PM.ParamInfo((cfg.d_ff, D)),
    }


class DecoderLM(nn.Module):
    """Dense GQA decoder (qwen-style: optional QKV bias, qk-norm, tied unembed)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        if cfg.family != "dense" or cfg.moe is not None or cfg.mla is not None:
            raise NotImplementedError(f"{cfg.arch}: only the dense decoder is ported")
        self.cfg = cfg
        self.device = resolve(device)
        self.dtype = PM.as_dtype(cfg.dtype)

    # -------------------------------------------------------------- layout
    def layer_layout(self) -> dict:
        return {"attn": _attn_layout(self.cfg), "mlp": _mlp_layout(self.cfg)}

    def layout(self) -> dict:
        cfg = self.cfg
        lay: dict[str, Any] = {
            "embed": PM.ParamInfo((cfg.vocab, cfg.d_model), scale=0.02),
            "final_ln": PM.ParamInfo((cfg.d_model,), "ones"),
            "layers": PM.stack(cfg.n_layers, self.layer_layout()),
        }
        if not cfg.tie_embeddings:
            lay["lm_head"] = PM.ParamInfo((cfg.d_model, cfg.vocab), scale=0.02)
        return lay

    def init_params(self, generator: torch.Generator) -> dict:
        return PM.init_params(self.layout(), generator, device=self.device, dtype=self.dtype)

    def cache_layout(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        window = cfg.sliding_window
        S_eff = min(seq, window) if window else seq
        per = {
            "k": PM.ParamInfo((batch, cfg.n_kv_heads, S_eff, cfg.resolved_head_dim), "zeros"),
            "v": PM.ParamInfo((batch, cfg.n_kv_heads, S_eff, cfg.resolved_head_dim), "zeros"),
        }
        return {"layers": PM.stack(cfg.n_layers, per)}

    def init_cache(self, batch: int, seq: int) -> dict:
        return PM.zeros_cache(self.cache_layout(batch, seq), device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------- pieces
    def embed(self, params, tokens):
        return params["embed"][tokens].to(self.dtype)

    def unembed(self, params, h):
        if self.cfg.tie_embeddings:
            return h @ params["embed"].T
        return h @ params["lm_head"]

    @staticmethod
    def _layer_params(params) -> list[dict]:
        """Per-layer views of the stacked ``params["layers"]``, split once per leaf."""
        split = PM.tree_map(lambda t: t.unbind(0), params["layers"])
        n = len(split["attn"]["ln"])
        return [PM.tree_map(lambda parts: parts[i], split) for i in range(n)]

    def _attention(self, p, x, positions, *, window: int):
        """Full-sequence causal attention block (dense branch of the JAX ``_attention``)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q = h @ p["wq"]
        k = h @ p["wk"]
        v = h @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q, k, v = q.view(B, S, H, hd), k.view(B, S, Hkv, hd), v.view(B, S, Hkv, hd)
        if cfg.qk_norm:
            # per head row, so before the transpose: the kernel takes the rows
            # as they lie, with no copy
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if cfg.rope_theta:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        out = blockwise_attention(q, k, v, causal=True, window=window)
        out = out.transpose(1, 2).reshape(B, S, H * hd)
        return x + out @ p["wo"]

    def _layer(self, p, x, positions):
        x = self._attention(p["attn"], x, positions, window=self.cfg.sliding_window)
        return self._mlp(p["mlp"], x)

    def backbone(self, params, x, positions):
        """Embedding-space input -> (final hidden states, aux loss 0.0 of the dense model)."""
        for p in self._layer_params(params):
            x = self._layer(p, x, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return rms_norm(x, params["final_ln"], self.cfg.norm_eps), aux

    def _mlp(self, p, x):
        h = rms_norm(x, p["ln"], self.cfg.norm_eps)
        return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])

    def _decode_attn(self, p, x, k_cache, v_cache, slot: int, pos, valid):
        """One-token attention; writes ``slot`` of this layer's cache in place.

        ``pos`` is the token's position as a (1,) int64 tensor and ``valid``
        the visible slots as an int32 (B,) tensor, both on the model's device
        and made once a step for every layer.
        """
        cfg = self.cfg
        B = x.shape[0]
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q = h @ p["wq"]
        k = h @ p["wk"]
        v = h @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        # (B, 1, heads * hd) -> (B, heads, 1, hd): with one position this is a view
        q = q.view(B, H, 1, hd)
        k = k.view(B, Hkv, 1, hd)
        v = v.view(B, Hkv, 1, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cfg.rope_theta:
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        k_cache[:, :, slot] = k[:, :, 0]
        v_cache[:, :, slot] = v[:, :, 0]
        out = decode_attention(q, k_cache, v_cache, valid, window=0)
        return x + out.view(B, 1, H * hd) @ p["wo"]

    # --------------------------------------------------------------- train
    def loss(self, params, batch):
        """Mean next-token cross-entropy; returns ``(total, {"nll", "aux"})``.

        batch: ``tokens`` and ``labels``, (B, S) integer tensors on the model's
        device.  Logits are cast to fp32 before the log-sum-exp, as in JAX.
        """
        tokens, labels = batch["tokens"], batch["labels"]
        x = self.embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        h, aux = self.backbone(params, x, positions)
        logits = self.unembed(params, h).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (lse - gold).mean()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------ serving
    @torch.no_grad()
    def prefill(self, params, batch):
        """Full-sequence forward returning the last position's fp32 logits (B, 1, vocab)."""
        x = self.embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        h, _ = self.backbone(params, x, positions)
        return self.unembed(params, h[:, -1:]).float()

    # -------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, params, batch):
        """One new token given a warm cache.

        batch: ``tokens`` (B, 1) integer tensor, ``cache`` from
        :meth:`init_cache`, ``index`` the int position of the new token.
        Returns ``(logits (B, 1, vocab) fp32, cache)``; the cache is updated
        in place.
        """
        cfg = self.cfg
        tokens, cache, index = batch["tokens"], batch["cache"], int(batch["index"])
        lp, lc = params["layers"], cache["layers"]
        slot, n_valid = cache_slot(index, lc["k"].shape[3], cfg.sliding_window)
        x = self.embed(params, tokens)
        # fills on the device, not copies from the host that would wait for it
        pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
        valid = torch.full((x.shape[0],), n_valid, dtype=torch.int32, device=x.device)
        for i in range(cfg.n_layers):
            attn = {name: t[i] for name, t in lp["attn"].items()}
            mlp = {name: t[i] for name, t in lp["mlp"].items()}
            x = self._decode_attn(attn, x, lc["k"][i], lc["v"][i], slot, pos, valid)
            x = self._mlp(mlp, x)
        h = rms_norm(x, params["final_ln"], cfg.norm_eps)
        return self.unembed(params, h).float(), cache
