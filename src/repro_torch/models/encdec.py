"""Whisper-style encoder-decoder: the port of ``repro.models.encdec.EncDecLM``.

Inputs arrive as precomputed frame embeddings (B, S_enc, d_model): the mel /
conv frontend is a stub, as in JAX.  The encoder is non-causal
self-attention and a GELU MLP with LayerNorm and sinusoidal positions; the
decoder is causal self-attention, cross attention to the encoder's output
and a GELU MLP, with learned positions and a tied unembedding.  q and v
projections have biases, k has none.

Parameters are a nested dict with the JAX package's layout leaf for leaf, so
a JAX tree runs here unchanged (``params.params_from_jax``); the layers run
in a Python loop over the stacked leaves, as ``DecoderLM``'s do, each
encoder and each decoder layer rematerialised under ``cfg.remat``
(``remat.remat``), as JAX wraps both scan bodies in ``jax.checkpoint``.  Every
full-sequence attention (the encoder's, the decoder's causal one and cross
attention, whose queries and keys differ in length) goes through
``layers.blockwise_attention``, so the flash kernels on the card; decode
attention over the self and the cross caches through the decode-attention
kernel.  LayerNorm and the tanh GELU are plain PyTorch (``layers``), as XLA
fuses them in JAX.

The decode cache holds per layer the self K and V (``seq`` slots) and the
cross K and V (``enc_len`` frames).  ``decode_step`` writes the new token's K
and V in place at ``layers.cache_slot(index, ...)`` (``IndexError`` past the
cache, where JAX clamps) and attends over every cross slot, as JAX does.
The serving engine does not fill the cross cache from :meth:`encode`: JAX's
engine decodes against zeros, and so does the port's; :meth:`fill_cross`
writes it from an encoder output, as ``prefill``'s cross attention forms it.

**The ``model`` axis.**  Built over a mesh of one rank's coordinates whose
``model`` axis is above 1, the model executes the layout's specs as
``DecoderLM`` does (``layers.ModelAxis``): in the encoder's self attention,
the decoder's causal self attention and its cross attention, ``wq``/``wk``/
``wv`` with ``bq``/``bv`` are column-parallel (this rank's heads; where the
head count does not divide the axis every rank computes every head from the
gathered projections) and ``wo`` row-parallel, ``bo`` added once after the
reduce; the GELU MLP's ``w_in``/``b_in`` column-parallel and ``w_out``
row-parallel (``layers.gelu_mlp``).  The tied unembedding follows
``layers.vocab_specs``: vocab-parallel logits and cross-entropy where the
vocab divides the axis (whisper-large-v3 at model 2), else ``embed`` cut on
d (model 4): the embedding's columns gathered, the unembedding a
row-parallel product of this rank's part of h, reduced.  Serving cuts the
self and the cross caches on their slots (frames); each attention's queries
are gathered to every head, and the decode kernel's partial mode over this
rank's slots is merged across the ranks (``serve.flash_decoding.
merge_partials``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from ..kernels import ops
from ..parallel import copy_to_region
from ..serve.flash_decoding import merge_partials
from . import params as PM
from .params import TP, P, dp_axes
from .remat import remat
from .layers import (ModelAxis, blockwise_attention, cache_shard_slot, decode_attention,
                     gelu_mlp, layer_norm, sinusoidal_positions, vocab_specs)

#: learned decoder positions: extended from Whisper's 448 to cover a 32k decode
MAX_DEC_POS = 32768


def _attn_layout(cfg: ModelConfig) -> dict:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return {
        "ln_g": PM.ParamInfo((D,), P(None), "ones"),
        "ln_b": PM.ParamInfo((D,), P(None), "zeros"),
        "wq": PM.ParamInfo((D, H * hd), P(None, TP)),
        "bq": PM.ParamInfo((H * hd,), P(TP), "zeros"),
        "wk": PM.ParamInfo((D, H * hd), P(None, TP)),
        "wv": PM.ParamInfo((D, H * hd), P(None, TP)),
        "bv": PM.ParamInfo((H * hd,), P(TP), "zeros"),
        "wo": PM.ParamInfo((H * hd, D), P(TP, None)),
        "bo": PM.ParamInfo((D,), P(None), "zeros"),
    }


def _mlp_layout(cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "ln_g": PM.ParamInfo((D,), P(None), "ones"),
        "ln_b": PM.ParamInfo((D,), P(None), "zeros"),
        "w_in": PM.ParamInfo((D, Fd), P(None, TP)),
        "b_in": PM.ParamInfo((Fd,), P(TP), "zeros"),
        "w_out": PM.ParamInfo((Fd, D), P(TP, None)),
        "b_out": PM.ParamInfo((D,), P(None), "zeros"),
    }


class EncDecLM(ModelAxis, nn.Module):
    #: a ``model`` axis above 1 runs tensor-parallel (``train.step`` and the
    #: dry-run read this)
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, *, model_axis: int = 16, mesh=None, device="cuda"):
        super().__init__()
        if cfg.family != "encdec" or cfg.encdec is None:
            raise ValueError(f"{cfg.arch}: family {cfg.family!r} is no encoder-decoder")
        self.cfg = cfg
        self.model_axis = model_axis
        self.mesh = mesh
        self.device = resolve(device)
        self.dtype = PM.as_dtype(cfg.dtype)
        self._init_model_axis(mesh)

    # -------------------------------------------------------------- layout
    def layout(self) -> dict:
        cfg = self.cfg
        enc_layer = {"attn": _attn_layout(cfg), "mlp": _mlp_layout(cfg)}
        dec_layer = {"self_attn": _attn_layout(cfg), "cross_attn": _attn_layout(cfg),
                     "mlp": _mlp_layout(cfg)}
        emb_spec = vocab_specs(cfg.vocab, cfg.d_model, self.model_axis)[0]
        lay: dict[str, Any] = {
            "embed": PM.ParamInfo((cfg.vocab, cfg.d_model), emb_spec, scale=0.02),
            "dec_pos": PM.ParamInfo((MAX_DEC_POS, cfg.d_model), P(None, None), scale=0.01),
            "enc_layers": PM.stack(cfg.encdec.n_encoder_layers, enc_layer),
            "dec_layers": PM.stack(cfg.n_layers, dec_layer),
        }
        for side in ("enc", "dec"):
            lay[f"{side}_ln_g"] = PM.ParamInfo((cfg.d_model,), P(None), "ones")
            lay[f"{side}_ln_b"] = PM.ParamInfo((cfg.d_model,), P(None), "zeros")
        return lay

    def cache_layout(self, batch: int, seq: int, enc_len: int) -> dict:
        H, hd = self.cfg.n_heads, self.cfg.resolved_head_dim
        spec = P(dp_axes(self.mesh), None, TP, None)
        per = {"k": PM.ParamInfo((batch, H, seq, hd), spec, "zeros"),
               "v": PM.ParamInfo((batch, H, seq, hd), spec, "zeros"),
               "cross_k": PM.ParamInfo((batch, H, enc_len, hd), spec, "zeros"),
               "cross_v": PM.ParamInfo((batch, H, enc_len, hd), spec, "zeros")}
        return {"layers": PM.stack(self.cfg.n_layers, per)}

    def init_cache(self, batch: int, seq: int, enc_len: int) -> dict:
        """A zero cache; over a ``model`` axis above 1, this rank's shard of it."""
        return self._zero_cache(self.cache_layout(batch, seq, enc_len))

    # ------------------------------------------------------------- pieces
    def _head_weight(self, params):
        return params["embed"].T    # tied unembedding

    def _qkv(self, p, xq, xkv):
        """q of ``xq`` and k, v of ``xkv`` as (B, h, S, hd); k has no bias.  Over
        a ``model`` axis (the inputs in the region), this rank's heads or,
        where the heads do not divide the axis, every head."""
        H, hd = self.cfg.n_heads, self.cfg.resolved_head_dim
        lo, hi, local = self._head_span(H)
        span = slice(lo, hi)
        q = self._heads(xq @ p["wq"] + p["bq"], H, hd, local, span).transpose(1, 2)
        k = self._heads(xkv @ p["wk"], H, hd, local, span).transpose(1, 2)
        v = self._heads(xkv @ p["wv"] + p["bv"], H, hd, local, span).transpose(1, 2)
        return q, k, v

    def _attn(self, p, x, kv, *, causal: bool):
        """Pre-norm attention block: self attention when ``kv`` is None, else
        cross attention to ``kv`` (the encoder's output, not normed again)."""
        B, S, _ = x.shape
        mesh = self.tp_mesh
        h = copy_to_region(layer_norm(x, p["ln_g"], p["ln_b"], self.cfg.norm_eps), mesh)
        q, k, v = self._qkv(p, h, h if kv is None else copy_to_region(kv, mesh))
        out = blockwise_attention(q, k, v, causal=causal)
        out = out.transpose(1, 2).reshape(B, S, -1)
        return self._attn_out(p, x, out, self._head_span(self.cfg.n_heads)[2]) + p["bo"]

    def _mlp(self, p, x):
        h = layer_norm(x, p["ln_g"], p["ln_b"], self.cfg.norm_eps)
        return x + gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"], p["b_out"], self.tp_mesh)

    def _encoder_layer(self, p, x):
        x = self._attn(p["attn"], x, None, causal=False)
        return self._mlp(p["mlp"], x)

    def _decoder_layer(self, p, x, enc_out):
        """One decoder layer; ``enc_out`` enters from outside a rematerialised
        layer as an input, so its gradient flows back to the encoder."""
        x = self._attn(p["self_attn"], x, None, causal=True)
        x = self._attn(p["cross_attn"], x, enc_out, causal=False)
        return self._mlp(p["mlp"], x)

    # -------------------------------------------------------------- encode
    def encode(self, params, enc_emb):
        """Frame embeddings (B, S_enc, d_model) -> the encoder's normed output."""
        cfg = self.cfg
        x = enc_emb.to(self.dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        body = remat(self._encoder_layer, cfg.remat)
        for p in PM.unstack(params["enc_layers"]):
            x = body(p, x)
        return layer_norm(x, params["enc_ln_g"], params["enc_ln_b"], cfg.norm_eps)

    # -------------------------------------------------------------- decode
    def _decoder(self, params, tokens, enc_out, pos0: int = 0):
        """The decoder's final normed hidden states (B, S, d_model)."""
        cfg = self.cfg
        S = tokens.shape[1]
        x = self.embed(params, tokens)
        x = x + params["dec_pos"][pos0:pos0 + S].to(x.dtype)
        body = remat(self._decoder_layer, cfg.remat)
        for p in PM.unstack(params["dec_layers"]):
            x = body(p, x, enc_out)
        return layer_norm(x, params["dec_ln_g"], params["dec_ln_b"], cfg.norm_eps)

    def decode_stack(self, params, tokens, enc_out, pos0: int = 0):
        """Decoder logits (B, S, vocab) in the model's dtype, positions from
        ``pos0`` (without a ``model`` axis)."""
        return self.unembed(params, self._decoder(params, tokens, enc_out, pos0))

    # ---------------------------------------------------------------- api
    def loss(self, params, batch):
        """Mean next-token cross-entropy over the decoder's tokens; returns
        ``(nll, {"nll", "aux"})`` with ``aux`` a 0.0 tensor (no experts).

        batch: ``enc_emb`` (B, S_enc, d_model), ``tokens`` and ``labels`` (B, S)
        integer tensors on the model's device.
        """
        self._check_tp()
        enc_out = self.encode(params, batch["enc_emb"])
        h = self._decoder(params, batch["tokens"], enc_out)
        nll = self._nll(params, h, batch["labels"].long())
        return nll, {"nll": nll, "aux": torch.zeros((), device=nll.device)}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Encoder and decoder over ``enc_emb`` and ``tokens``: the last
        position's fp32 logits (B, 1, vocab)."""
        self._check_tp()
        enc_out = self.encode(params, batch["enc_emb"])
        h = self._decoder(params, batch["tokens"], enc_out)
        return self._serve_logits(params, h[:, -1:])

    @torch.no_grad()
    def fill_cross(self, params, cache, enc_out) -> None:
        """Write every decoder layer's cross K and V of the encoder output
        ``enc_out`` (B, enc_len, d_model) into ``cache``, as ``prefill``'s
        cross attention forms them; over a ``model`` axis, this rank's frames
        of every head (every rank's columns of every frame gathered)."""
        lc = cache["layers"]
        B, F_, _ = enc_out.shape
        H, hd = self.cfg.n_heads, self.cfg.resolved_head_dim
        n = lc["cross_k"].shape[3]
        for i, p in enumerate(PM.unstack(params["dec_layers"])):
            cp = p["cross_attn"]
            if self.tp == 1:
                _, k, v = self._qkv(cp, enc_out, enc_out)
            else:
                k, v = (t.view(B, F_, H, hd).transpose(1, 2)[:, :, self.tp_rank * n:
                                                              (self.tp_rank + 1) * n]
                        for t in self._gather_columns(enc_out @ cp["wk"],
                                                      enc_out @ cp["wv"] + cp["bv"]))
            lc["cross_k"][i].copy_(k)
            lc["cross_v"][i].copy_(v)

    def _decode_attn(self, q, k_cache, v_cache, seen):
        """Decode attention of every head over this rank's slots: the kernel,
        or over a ``model`` axis its partial mode merged across the ranks."""
        if self.tp == 1:
            return decode_attention(q, k_cache, v_cache, seen)
        part, lse = ops.decode_attention_partial(q, k_cache, v_cache, seen)
        return merge_partials(part, lse, self.tp_mesh, TP, dtype=v_cache.dtype)

    @torch.no_grad()
    def decode_step(self, params, batch):
        """One decoder token: self attention against the cache, cross attention
        over every ``cross_k`` / ``cross_v`` slot.

        batch: ``tokens`` (B, 1), ``cache`` from :meth:`init_cache`, ``index``
        the int position of the new token.  Returns ``(logits (B, 1, vocab)
        fp32, cache)``, the cache updated in place.  The visible lengths of
        both caches are two int32 (B,) tensors made once a step, which every
        layer's decode attention shares.  Over a ``model`` axis the rows and
        the cache are this rank's (the module's docstring) and the logits
        are whole.
        """
        self._check_tp()
        cfg = self.cfg
        tokens, cache, index = batch["tokens"], batch["cache"], int(batch["index"])
        B = tokens.shape[0]
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        lc = cache["layers"]
        where = cache_shard_slot(index, lc["k"].shape[3] * self.tp, 0, self.tp)
        slot = where.local if where.owner == self.tp_rank else None
        x = self.embed(params, tokens)
        x = x + params["dec_pos"][index:index + 1].to(x.dtype)
        seen = torch.full((B,), where.counts[self.tp_rank], dtype=torch.int32, device=x.device)
        frames = torch.full((B,), lc["cross_k"].shape[3], dtype=torch.int32, device=x.device)
        local = self.tp == 1
        lp = params["dec_layers"]
        for i in range(lp["mlp"]["w_in"].shape[0]):
            sp, cp = ({n: t[i] for n, t in lp[side].items()}
                      for side in ("self_attn", "cross_attn"))
            hn = layer_norm(x, sp["ln_g"], sp["ln_b"], cfg.norm_eps)
            if local:
                q, k, v = self._qkv(sp, hn, hn)
            else:                                                        # every head
                q, k, v = (t.view(B, 1, H, hd).transpose(1, 2) for t in self._gather_columns(
                    hn @ sp["wq"] + sp["bq"], hn @ sp["wk"], hn @ sp["wv"] + sp["bv"]))
            k_cache, v_cache = lc["k"][i], lc["v"][i]
            if slot is not None:
                k_cache[:, :, slot] = k[:, :, 0]
                v_cache[:, :, slot] = v[:, :, 0]
            out = self._decode_attn(q, k_cache, v_cache, seen)
            x = self._attn_out(sp, x, out.view(B, 1, H * hd), local) + sp["bo"]
            hn = layer_norm(x, cp["ln_g"], cp["ln_b"], cfg.norm_eps)
            q = hn @ cp["wq"] + cp["bq"]
            if not local:
                q, = self._gather_columns(q)
            out = self._decode_attn(q.view(B, H, 1, hd), lc["cross_k"][i], lc["cross_v"][i],
                                    frames)
            x = self._attn_out(cp, x, out.view(B, 1, H * hd), local) + cp["bo"]
            x = self._mlp({n: t[i] for n, t in lp["mlp"].items()}, x)
        x = layer_norm(x, params["dec_ln_g"], params["dec_ln_b"], cfg.norm_eps)
        return self._serve_logits(params, x), cache
