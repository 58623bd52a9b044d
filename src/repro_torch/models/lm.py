"""Decoder LM: the port of ``repro.models.lm.DecoderLM``, dense GQA, MoE
(Mixtral-style top-k with a sliding window), MLA + MoE (DeepSeek-V2) and the
VLM backbone (InternVL2: image-patch embeddings before the text).

Parameters are passed in as a nested dict with the JAX package's layout, as
the JAX methods take them, so a JAX parameter tree runs here unchanged
(``params.params_from_jax``).  The layers run in a Python loop where JAX scans
over the stacked layer axis; each stacked leaf is split once with
``unbind``, whose backward stacks the layers' gradients into one leaf of the
stacked shape again.  DeepSeek's dense first layer is ``layer0``, outside the
stack, as in JAX.  ``loss`` and ``backbone`` are differentiable with
autograd through the kernels' backward, every layer (and ``layer0`` on its
own) rematerialised under ``cfg.remat`` as JAX's ``_remat`` does
(``remat.py``); ``prefill`` and ``decode_step`` run under ``torch.no_grad``.
``decode_step`` writes the new token's K and V (or MLA's latent ``c_kv`` and
``k_rope``) into the cache IN PLACE and returns that same cache object, where
JAX returns an updated copy.

MLA decodes with the absorbed projections, scoring against the latent cache
directly (plain PyTorch products, as JAX computes them outside any Pallas
kernel).  Its full-sequence attention (``loss``, ``prefill``) has q and k of
``qk_nope + qk_rope`` and v of ``v_head_dim`` channels, which the flash
kernels take on the card (192 and 128 at full width on the tensor cores in
bf16) and the plain flash version on the CPU.

The VLM branch is JAX's: ``loss`` and ``prefill`` take ``img_emb`` (B,
n_image_tokens, d_model), cast it to the model's dtype and put it before the
text embeddings; positions run over the whole sequence, and ``loss`` drops
the image positions' hidden states before the unembedding.  ``decode_step``
has no image path, as in JAX: a VLM serves as a text decoder.

**Tensor parallelism.**  Built over a mesh of one rank's coordinates
(``launch.mesh.Mesh`` or ``AbstractMesh``) whose ``model`` axis is above 1,
the model executes the layout's ``model`` entries, as ``jax.jit`` does with
those specs: its parameters are this rank's shards (``params.shard_params``;
:meth:`init_params` draws the full tree and cuts it) and ``loss`` runs
Megatron's regions (``repro_torch.parallel``; without a ``model`` axis each is
the identity, so the same code runs every axis size):

* attention: ``wq/wk/wv`` (and biases) column-parallel behind
  ``copy_to_region``, this rank's heads through the flash kernels, ``wo``
  row-parallel into ``reduce_from_region``.  Where the spec cuts inside a
  head (``H*hd`` or ``Hkv*hd`` not whole heads a rank), that projection is
  gathered over the axis and the heads this rank's queries need are taken
  (a gather whose backward sums the ranks' partial gradients); with the
  queries cut inside a head every rank computes every head and keeps its
  slice of the output for ``wo``.  MLA's ``w_dkv`` and ``kv_ln`` are
  replicated; their outputs enter the column-parallel ``w_uk`` / ``w_uv``
  through ``copy_to_region``;
* the dense MLP: the SwiGLU kernel on this rank's ``F/tp`` columns, its
  partial output reduced once; the MoE block as ``layers.moe_block`` says;
* ``_vocab_specs``: a vocab-parallel embedding (rows outside the shard
  masked, then summed), local-vocab logits and a vocab-parallel
  cross-entropy (the max over the axis, then the sum of exponentials and
  the gold logit summed over it, in fp32) where the vocab divides; the
  embedding's columns gathered and a row-parallel ``lm_head`` whose logits
  are summed where only ``d_model`` does; replicated otherwise.

Replicated leaves (norm gammas, ``router``, ``w_dkv``, ``kv_ln``) get the
same gradient on every rank of the axis.

**Serving over the ``model`` axis.**  The weights stay cut as above and the
decode cache is cut as JAX's specs cut it (:meth:`cache_layout`): a rank
holds slots ``[i S/tp, (i + 1) S/tp)`` of every kv head (or of MLA's
``c_kv`` and ``k_rope``) for its own rows over the data axes
(:meth:`init_cache`; ``params.shard_cache`` cuts a whole cache so).
``decode_step`` on such a rank:

* GQA: q, k and v of this rank's columns, gathered to every head in one
  all-gather of the three concatenated; the rank that holds the token's slot
  alone writes k and v there (``layers.cache_shard_slot``: a window's ring
  moves the writing rank as ``index % S`` wraps); the decode-attention
  kernel's partial mode over this rank's slots for every head
  (``ops.decode_attention_partial``: fp32 output and log-sum-exp), merged
  across the ranks (``serve.flash_decoding.merge_partials``), then this
  rank's slice of the heads into the row-parallel ``wo``;
* MLA: ``q_eff`` and the roped ``q_rope`` of this rank's heads, gathered to
  every head; the scores against this rank's slots of the latent cache,
  their ``(max, sum, context)`` over ``r`` in fp32 merged across ranks as
  above; this rank's heads through ``w_uv`` and ``wo``, reduced.  With the
  queries cut inside a head, the projection, ``w_uk`` and ``w_uv`` are
  gathered and every rank computes every head;
* the MLP, the experts and the embedding as in training; the experts route
  the global batch inside :meth:`rows_split`.

``prefill`` runs the tensor-parallel ``backbone``.  Both return the whole
``(B, 1, vocab)`` fp32 logits on every rank: a vocab cut's local logits
gathered, a ``d_model`` cut's row-parallel logits summed.  Against the
single-device decode this rounds differently in two places: the cross-rank
merge sums the ranks' normalised outputs (where one device sums over the
whole cache once), and MLA's context is taken from the fp32 probabilities
and cast once after the merge, where the single device (and JAX) casts the
normalised probabilities to the cache's dtype before the product.  In fp32
both are the order of sums alone.

With :meth:`rows_split` (``train.step.DataParallelStep``) the rows are one
rank's part of a batch cut over the data axes, and the experts route the
global batch (``layers.moe_route``).
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Any

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from ..kernels import ops
from ..parallel import (copy_to_region, gather_from_region, reduce_from_region,
                        scatter_to_region, tp_mesh, tp_size)
from ..serve.flash_decoding import merge_partials
from . import params as PM
from .params import TP, P, dp_axes
from .remat import remat
from .layers import (blockwise_attention, cache_shard_slot, decode_attention, moe_block,
                     rms_norm, rope, swiglu)




def _vocab_specs(vocab: int, d_model: int, model_axis: int) -> tuple[tuple, tuple]:
    """Shard embeddings on vocab when divisible, else on d_model, else replicate."""
    if vocab % model_axis == 0:
        return P(TP, None), P(None, TP)
    if d_model % model_axis == 0:
        return P(None, TP), P(TP, None)
    return P(None, None), P(None, None)


def _expert_specs(cfg: ModelConfig, model_axis: int) -> tuple[tuple, tuple]:
    """Expert parallelism when E divides the model axis; else tensor-shard
    inside each expert (mixtral: 8 experts on a 16-way axis)."""
    if cfg.moe.n_experts % model_axis == 0:
        return P(TP, None, None), P(TP, None, None)
    return P(None, None, TP), P(None, TP, None)


def _attn_layout(cfg: ModelConfig) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        return {
            "ln": PM.ParamInfo((D,), P(None), "ones"),
            "wq": PM.ParamInfo((D, H * qk), P(None, TP)),
            "w_dkv": PM.ParamInfo((D, m.kv_lora_rank + m.qk_rope_dim), P(None, None)),
            "kv_ln": PM.ParamInfo((m.kv_lora_rank,), P(None), "ones"),
            "w_uk": PM.ParamInfo((m.kv_lora_rank, H * m.qk_nope_dim), P(None, TP)),
            "w_uv": PM.ParamInfo((m.kv_lora_rank, H * m.v_head_dim), P(None, TP)),
            "wo": PM.ParamInfo((H * m.v_head_dim, D), P(TP, None)),
        }
    lay = {
        "ln": PM.ParamInfo((D,), P(None), "ones"),
        "wq": PM.ParamInfo((D, H * hd), P(None, TP)),
        "wk": PM.ParamInfo((D, Hkv * hd), P(None, TP)),
        "wv": PM.ParamInfo((D, Hkv * hd), P(None, TP)),
        "wo": PM.ParamInfo((H * hd, D), P(TP, None)),
    }
    if cfg.qkv_bias:
        lay["bq"] = PM.ParamInfo((H * hd,), P(TP), "zeros")
        lay["bk"] = PM.ParamInfo((Hkv * hd,), P(TP), "zeros")
        lay["bv"] = PM.ParamInfo((Hkv * hd,), P(TP), "zeros")
    if cfg.qk_norm:
        lay["q_norm"] = PM.ParamInfo((hd,), P(None), "ones")
        lay["k_norm"] = PM.ParamInfo((hd,), P(None), "ones")
    return lay


def _mlp_layout(cfg: ModelConfig, d_ff: int) -> dict:
    D = cfg.d_model
    return {
        "ln": PM.ParamInfo((D,), P(None), "ones"),
        "w_gate": PM.ParamInfo((D, d_ff), P(None, TP)),
        "w_up": PM.ParamInfo((D, d_ff), P(None, TP)),
        "w_down": PM.ParamInfo((d_ff, D), P(TP, None)),
    }


def _moe_layout(cfg: ModelConfig, model_axis: int) -> dict:
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    up_spec, down_spec = _expert_specs(cfg, model_axis)
    lay = {
        "ln": PM.ParamInfo((D,), P(None), "ones"),
        "router": PM.ParamInfo((D, E), P(None, None), scale=0.02),
        "w_gate": PM.ParamInfo((E, D, F), up_spec),
        "w_up": PM.ParamInfo((E, D, F), up_spec),
        "w_down": PM.ParamInfo((E, F, D), down_spec),
    }
    if cfg.moe.n_shared:
        S = cfg.moe.n_shared * F
        lay["shared_gate"] = PM.ParamInfo((D, S), P(None, TP))
        lay["shared_up"] = PM.ParamInfo((D, S), P(None, TP))
        lay["shared_down"] = PM.ParamInfo((S, D), P(TP, None))
    return lay


class DecoderLM(nn.Module):
    """Dense GQA / MoE / MLA / VLM decoder (qwen-style options: QKV bias,
    qk-norm, tied unembed)."""

    #: a ``model`` axis above 1 runs tensor-parallel (``train.step`` and the
    #: dry-run read this)
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, *, model_axis: int = 16, mesh=None, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.arch}: family {cfg.family!r} is no decoder LM")
        self.cfg = cfg
        self.model_axis = model_axis
        self.mesh = mesh
        self.device = resolve(device)
        self.dtype = PM.as_dtype(cfg.dtype)
        self.tp = tp_size(mesh)
        #: the mesh the regions run over: None without a ``model`` axis above 1,
        #: where every region is the identity
        self.tp_mesh = tp_mesh(mesh)
        self.tp_rank = mesh.coords[TP] if self.tp > 1 else 0
        self._row_axes: tuple = ()
        emb_spec = _vocab_specs(cfg.vocab, cfg.d_model, self.tp)[0]
        self._vocab_cut = (None if self.tp == 1 else "vocab" if emb_spec == P(TP, None) else
                           "d_model" if emb_spec == P(None, TP) else None)

    @contextlib.contextmanager
    def rows_split(self, axes):
        """Within: the rows are one rank's equal part of a batch cut over the
        mesh's ``axes`` (the experts route the global batch)."""
        prev, self._row_axes = self._row_axes, tuple(axes)
        try:
            yield
        finally:
            self._row_axes = prev

    def _check_tp(self) -> None:
        if self.tp > 1 and self.model_axis != self.tp:
            raise ValueError(f"{self.cfg.arch}: built for a model axis of {self.model_axis}, "
                             f"run over one of {self.tp}")

    # -------------------------------------------------------------- layout
    def layer_layout(self, *, moe: bool) -> dict:
        cfg = self.cfg
        if moe:
            return {"attn": _attn_layout(cfg), "mlp": _moe_layout(cfg, self.model_axis)}
        d_ff = cfg.moe.first_dense_ff if (cfg.moe and cfg.moe.first_dense) else cfg.d_ff
        return {"attn": _attn_layout(cfg), "mlp": _mlp_layout(cfg, d_ff)}

    def layout(self) -> dict:
        cfg = self.cfg
        emb_spec, head_spec = _vocab_specs(cfg.vocab, cfg.d_model, self.model_axis)
        lay: dict[str, Any] = {
            "embed": PM.ParamInfo((cfg.vocab, cfg.d_model), emb_spec, scale=0.02),
            "final_ln": PM.ParamInfo((cfg.d_model,), P(None), "ones"),
        }
        if not cfg.tie_embeddings:
            lay["lm_head"] = PM.ParamInfo((cfg.d_model, cfg.vocab), head_spec, scale=0.02)
        is_moe = cfg.moe is not None
        if is_moe and cfg.moe.first_dense:
            lay["layer0"] = self.layer_layout(moe=False)
            lay["layers"] = PM.stack(cfg.n_layers - 1, self.layer_layout(moe=True))
        else:
            lay["layers"] = PM.stack(cfg.n_layers, self.layer_layout(moe=is_moe))
        return lay

    def init_params(self, generator: torch.Generator) -> dict:
        """The full tree by the JAX package's rules; over a ``model`` axis, this
        rank's shards of it (every rank draws the same tree)."""
        layout = self.layout()
        full = PM.init_params(layout, generator, device=self.device, dtype=self.dtype)
        return PM.shard_params(full, layout, self.mesh) if self.tp > 1 else full

    def cache_layout(self, batch: int, seq: int) -> dict:
        """GQA K and V caches (a ring of ``min(seq, window)`` slots with a
        window), or MLA's latent ``c_kv`` and ``k_rope`` of ``seq`` slots."""
        cfg = self.cfg
        dp = dp_axes(self.mesh)
        if cfg.mla is not None:
            spec = P(dp, TP, None)
            per = {"c_kv": PM.ParamInfo((batch, seq, cfg.mla.kv_lora_rank), spec, "zeros"),
                   "k_rope": PM.ParamInfo((batch, seq, cfg.mla.qk_rope_dim), spec, "zeros")}
        else:
            window = cfg.sliding_window
            S_eff = min(seq, window) if window else seq
            kv = (batch, cfg.n_kv_heads, S_eff, cfg.resolved_head_dim)
            spec = P(dp, None, TP, None)
            per = {"k": PM.ParamInfo(kv, spec, "zeros"), "v": PM.ParamInfo(kv, spec, "zeros")}
        if cfg.moe is not None and cfg.moe.first_dense:
            return {"layer0": per, "layers": PM.stack(cfg.n_layers - 1, per)}
        return {"layers": PM.stack(cfg.n_layers, per)}

    def init_cache(self, batch: int, seq: int) -> dict:
        """A zero cache for ``batch`` requests of ``seq`` slots; over a ``model``
        axis above 1, this rank's shard of it (``params.cache_shards``)."""
        layout = self.cache_layout(batch, seq)
        if self.tp > 1:
            layout = PM.cache_shards(layout, self.mesh)
        return PM.zeros_cache(layout, device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------- pieces
    def embed(self, params, tokens):
        if self._vocab_cut == "vocab":
            rows = params["embed"].shape[0]
            local = tokens - self.tp_rank * rows
            mine = (local >= 0) & (local < rows)
            e = params["embed"][local.clamp(0, rows - 1)].to(self.dtype)
            return reduce_from_region(torch.where(mine[..., None], e, 0), self.tp_mesh)
        if self._vocab_cut == "d_model":
            return gather_from_region(params["embed"][tokens].to(self.dtype), self.tp_mesh, -1)
        return params["embed"][tokens].to(self.dtype)

    def _head_weight(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def unembed(self, params, h):
        return h @ self._head_weight(params)

    def _mla_latent(self, p, h):
        """MLA's down-projection of the normed input h: (normed latent, k_rope
        before RoPE).  ``w_dkv``'s two column blocks are two products, so each
        result is contiguous: the card's rmsnorm takes only contiguous rows, and
        a slice of one product would hand ``kv_ln`` strided ones."""
        r = self.cfg.mla.kv_lora_rank
        c_kv = rms_norm(h @ p["w_dkv"][:, :r], p["kv_ln"], self.cfg.norm_eps)
        return c_kv, h @ p["w_dkv"][:, r:]

    # ------------------------------------------- heads over the model axis
    def _head_span(self, n_heads: int) -> tuple[int, int, bool]:
        """``(lo, hi, local)``: the query heads this rank computes, and whether
        they are its own columns (whole heads a rank) or every head."""
        if n_heads % self.tp == 0:
            per = n_heads // self.tp
            return self.tp_rank * per, (self.tp_rank + 1) * per, True
        return 0, n_heads, False

    def _heads(self, t, n_heads: int, width: int, local: bool, pick):
        """(B, S, h, width): this rank's columns ``t`` of an (n_heads x width)
        projection as its heads, or with ``local`` False the projection
        gathered over the axis and the heads ``pick`` (a slice or an index
        list) taken."""
        B, S, _ = t.shape
        if local:
            return t.view(B, S, -1, width)
        full = gather_from_region(t, self.tp_mesh, -1, partial=True).view(B, S, n_heads, width)
        if isinstance(pick, slice):
            return full[:, :, pick].contiguous()
        return full.index_select(2, torch.tensor(pick, device=t.device))

    def _kv_pick(self, lo: int, hi: int, q_local: bool) -> tuple[bool, Any]:
        """``(local, pick)`` of the kv heads that queries ``lo:hi`` read: this
        rank's own columns where both head counts divide the axis, else the
        heads of a gathered projection (a slice where the groups stay
        uniform, one kv head a query otherwise)."""
        H, Hkv = self.cfg.n_heads, self.cfg.n_kv_heads
        if q_local and Hkv % self.tp == 0:
            return True, None
        G = H // Hkv
        k0, k1 = lo // G, (hi - 1) // G + 1
        want = [(lo + i) // G - k0 for i in range(hi - lo)]
        nq, nk = hi - lo, k1 - k0
        if nq % nk == 0 and want == [i // (nq // nk) for i in range(nq)]:
            return False, slice(k0, k1)
        return False, [(lo + i) // G for i in range(nq)]

    def _gather_columns(self, *parts, dim: int = -1):
        """Each of ``parts`` (one shape but the last dimension) with every rank's
        part of it concatenated along ``dim`` in rank order, in one all-gather
        of the parts side by side."""
        widths = [t.shape[-1] for t in parts]
        ranks = self.tp_mesh.all_gather(torch.cat(parts, -1), TP)
        out, start = [], 0
        for w in widths:
            out.append(torch.cat([r[..., start:start + w] for r in ranks], dim))
            start += w
        return out

    def _attn_out(self, p, x, out, local: bool):
        """x plus ``wo`` of the attention output (B, S, heads x v width):
        row-parallel, summed over the axis; with every head computed, this
        rank's slice of the output first."""
        if not local:
            cols = p["wo"].shape[0]
            out = out[..., self.tp_rank * cols:(self.tp_rank + 1) * cols]
        return x + reduce_from_region(out @ p["wo"], self.tp_mesh)

    def _attention(self, p, x, positions, *, window: int):
        """Full-sequence causal attention block (the JAX ``_attention``); over
        a ``model`` axis, this rank's heads (the module's docstring)."""
        cfg, mesh = self.cfg, self.tp_mesh
        B, S, _ = x.shape
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        ht = copy_to_region(h, mesh)
        lo, hi, local = self._head_span(H)
        span = slice(lo, hi)
        if cfg.mla is not None:
            m = cfg.mla
            q = self._heads(ht @ p["wq"], H, m.qk_nope_dim + m.qk_rope_dim, local, span)
            q = q.transpose(1, 2)
            q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
            c_kv, k_rope = self._mla_latent(p, h)
            c_kv, k_rope = copy_to_region(c_kv, mesh), copy_to_region(k_rope, mesh)
            k_rope = rope(k_rope[:, None], positions, cfg.rope_theta)           # (B, 1, S, r)
            q_rope = rope(q_rope, positions, cfg.rope_theta)
            k_nope = self._heads(c_kv @ p["w_uk"], H, m.qk_nope_dim, local, span).transpose(1, 2)
            v = self._heads(c_kv @ p["w_uv"], H, m.v_head_dim, local, span).transpose(1, 2)
            n = hi - lo
            k = torch.cat([k_nope, k_rope.expand(B, n, S, m.qk_rope_dim)], -1)
            q = torch.cat([q_nope, q_rope], -1)
            out = blockwise_attention(q, k, v, causal=True, window=window)
            return self._attn_out(p, x, out.transpose(1, 2).reshape(B, S, n * m.v_head_dim),
                                  local)
        q, k, v = ht @ p["wq"], ht @ p["wk"], ht @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        kv_local, pick = self._kv_pick(lo, hi, local)
        q = self._heads(q, H, hd, local, span)
        k = self._heads(k, cfg.n_kv_heads, hd, kv_local, pick)
        v = self._heads(v, cfg.n_kv_heads, hd, kv_local, pick)
        if cfg.qk_norm:
            # per head row, so before the transpose: the kernel takes the rows
            # as they lie, with no copy
            q = rms_norm(q, copy_to_region(p["q_norm"], mesh), cfg.norm_eps)
            k = rms_norm(k, copy_to_region(p["k_norm"], mesh), cfg.norm_eps)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if cfg.rope_theta:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        out = blockwise_attention(q, k, v, causal=True, window=window)
        return self._attn_out(p, x, out.transpose(1, 2).reshape(B, S, (hi - lo) * hd), local)

    def _mlp(self, p, x, *, moe: bool):
        """The MLP block: ``(x + the dense SwiGLU or the routed experts, aux)``;
        ``aux`` is the experts' load-balancing loss, 0.0 for a dense MLP."""
        cfg = self.cfg
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        if not moe:
            y = swiglu(copy_to_region(h, self.tp_mesh), p["w_gate"], p["w_up"], p["w_down"])
            return x + reduce_from_region(y, self.tp_mesh), 0.0
        shared = ((p["shared_gate"], p["shared_up"], p["shared_down"])
                  if "shared_gate" in p else None)
        y, aux = moe_block(h.reshape(-1, h.shape[-1]), p["router"], p["w_gate"], p["w_up"],
                           p["w_down"], top_k=cfg.moe.top_k,
                           capacity_factor=cfg.moe.capacity_factor, shared=shared,
                           mesh=self.mesh, data_axes=self._row_axes)
        return x + y.view(x.shape), aux

    def _layer(self, p, x, positions, *, moe: bool):
        x = self._attention(p["attn"], x, positions, window=self.cfg.sliding_window)
        return self._mlp(p["mlp"], x, moe=moe)

    def backbone(self, params, x, positions):
        """Embedding-space input -> (final hidden states, the experts' summed aux
        loss: a 0.0 tensor for a dense model).  Each layer, and ``layer0`` on
        its own, is rematerialised under ``cfg.remat`` (``remat.remat``)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        moe = self.cfg.moe is not None
        if "layer0" in params:
            x, a = remat(partial(self._layer, moe=False), self.cfg.remat)(params["layer0"], x,
                                                                         positions)
            aux = aux + a
        body = remat(partial(self._layer, moe=moe), self.cfg.remat)
        for p in PM.unstack(params["layers"]):
            x, a = body(p, x, positions)
            aux = aux + a
        return rms_norm(x, params["final_ln"], self.cfg.norm_eps), aux

    def _decode_attn(self, p, x, cache: dict, slot, pos, seen):
        """One-token attention; writes ``slot`` of this layer's cache in place
        (this rank's local slot, or None where another rank holds the token's).

        ``pos`` is the token's position as a (1,) int64 tensor, both on the
        model's device and made once a step for every layer, as is ``seen``:
        the visible slots of this rank's cache, an int32 (B,) count for GQA,
        a bool (S,) mask over the latent cache for MLA.
        """
        if self.cfg.mla is not None:
            return self._decode_attn_mla(p, x, cache["c_kv"], cache["k_rope"], slot, pos, seen)
        cfg = self.cfg
        B = x.shape[0]
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        k_cache, v_cache = cache["k"], cache["v"]
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q = h @ p["wq"]
        k = h @ p["wk"]
        v = h @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        if self.tp > 1:
            q, k, v = self._gather_columns(q, k, v)                     # every head
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
        if slot is not None:
            k_cache[:, :, slot] = k[:, :, 0]
            v_cache[:, :, slot] = v[:, :, 0]
        if self.tp == 1:
            out = decode_attention(q, k_cache, v_cache, seen, window=0)
            return x + out.view(B, 1, H * hd) @ p["wo"]
        part, lse = ops.decode_attention_partial(q, k_cache, v_cache, seen)
        out = merge_partials(part, lse, self.tp_mesh, TP, dtype=v_cache.dtype)
        return self._attn_out(p, x, out.view(B, 1, H * hd), local=False)

    def _decode_attn_mla(self, p, x, c_kv, k_rope, slot, pos, seen):
        """MLA decode with the absorbed projections, in JAX's roundings: q_eff in
        the model's dtype, both scores summed in fp32 (the bf16 operands cast
        to fp32, which is exact), scaled by 1/sqrt(qk_nope + qk_rope), the
        probabilities cast to the cache's dtype before the context product.
        Over a ``model`` axis, every head's scores against this rank's slots
        and the partial contexts merged across ranks (the module's docstring)."""
        cfg = self.cfg
        m = cfg.mla
        B = x.shape[0]
        H = cfg.n_heads
        r = m.kv_lora_rank
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        lo, hi, local = self._head_span(H)
        q, w_uk, w_uv = h @ p["wq"], p["w_uk"], p["w_uv"]
        if not local:                     # the queries cut inside a head: every head here
            q, = self._gather_columns(q)
            w_uk, w_uv = (torch.cat(self.tp_mesh.all_gather(w, TP), -1) for w in (w_uk, w_uv))
        n = hi - lo
        q = q.view(B, n, 1, m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
        q_rope = rope(q_rope, pos, cfg.rope_theta)[:, :, 0]              # (B, n, rope)
        c_new, kr_new = self._mla_latent(p, h)                            # (B, 1, r), (B, 1, rope)
        if slot is not None:
            c_kv[:, slot] = c_new[:, 0]
            k_rope[:, slot] = rope(kr_new, pos, cfg.rope_theta)[:, 0]
        # absorbed decode: score against the latent directly, heads as the batch
        w_uk = w_uk.view(r, n, m.qk_nope_dim).permute(1, 2, 0)              # (n, nope, r)
        q_eff = torch.bmm(q_nope[:, :, 0].transpose(0, 1), w_uk).transpose(0, 1)  # (B, n, r)
        if self.tp > 1 and local:
            q_eff, q_rope = self._gather_columns(q_eff, q_rope, dim=1)     # every head
        s = torch.bmm(q_eff.float(), c_kv.float().transpose(1, 2))          # (B, H, S)
        s = s + torch.bmm(q_rope.float(), k_rope.float().transpose(1, 2))
        s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
        s = torch.where(seen, s, -1e30)
        if self.tp == 1:
            pr = torch.softmax(s, dim=-1)
            ctx = torch.bmm(pr.to(c_kv.dtype), c_kv)                        # (B, H, r)
        else:
            top = s.amax(-1, keepdim=True)
            e = torch.exp(s - top) * seen
            l = e.sum(-1, keepdim=True)
            ctx = torch.bmm(e, c_kv.float()) / torch.where(l == 0, 1.0, l)
            lse = torch.where(l == 0, -math.inf, top + torch.log(l))
            ctx = merge_partials(ctx, lse, self.tp_mesh, TP, dtype=c_kv.dtype)[:, lo:hi]
        w_uv = w_uv.view(r, n, m.v_head_dim).transpose(0, 1)               # (n, r, vd)
        out = torch.bmm(ctx.transpose(0, 1), w_uv).transpose(0, 1)          # (B, n, vd)
        return self._attn_out(p, x, out.reshape(B, 1, n * m.v_head_dim), local)

    def _inputs(self, params, batch):
        """``(x, n_img)``: the text embeddings, behind ``img_emb``'s n_img
        positions in the model's dtype for a VLM (n_img 0 otherwise)."""
        x = self.embed(params, batch["tokens"])
        if self.cfg.vlm is None:
            return x, 0
        img = batch["img_emb"].to(x.dtype)
        return torch.cat([img, x], dim=1), img.shape[1]

    # --------------------------------------------------------------- train
    def loss(self, params, batch):
        """Mean next-token cross-entropy plus 0.01 x the experts' aux loss;
        returns ``(total, {"nll", "aux"})``.

        batch: ``tokens`` and ``labels``, (B, S) integer tensors on the model's
        device, and for a VLM ``img_emb`` (B, n_image_tokens, d_model), whose
        positions the loss does not count.  Logits are cast to fp32 before the
        log-sum-exp, as in JAX.
        """
        self._check_tp()
        labels = batch["labels"]
        x, n_img = self._inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        h, aux = self.backbone(params, x, positions)
        if n_img:
            h = h[:, n_img:]
        if self._vocab_cut == "vocab":
            nll = self._vocab_parallel_nll(params, h, labels.long())
            return nll + 0.01 * aux, {"nll": nll, "aux": aux}
        if self._vocab_cut == "d_model":
            h_part = scatter_to_region(h, self.tp_mesh, -1)
            logits = reduce_from_region(h_part @ self._head_weight(params), self.tp_mesh).float()
        else:
            logits = self.unembed(params, h).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (lse - gold).mean()
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    def _vocab_parallel_nll(self, params, h, labels):
        """The mean cross-entropy of this rank's vocab columns' fp32 logits:
        the max over the axis, the sum of exponentials and the gold logit
        (on the one rank whose columns hold it) summed over it."""
        mesh = self.tp_mesh
        logits = (copy_to_region(h, mesh) @ self._head_weight(params)).float()   # (B, S, V/tp)
        cols = logits.shape[-1]
        top = mesh.all_reduce(logits.detach().amax(-1), TP, op="max")
        lse = top + torch.log(reduce_from_region(torch.exp(logits - top[..., None]).sum(-1),
                                                 mesh))
        local = labels - self.tp_rank * cols
        mine = (local >= 0) & (local < cols)
        gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
        gold = reduce_from_region(torch.where(mine, gold, 0.0), mesh)
        return (lse - gold).mean()

    # ------------------------------------------------------------ serving
    def _serve_logits(self, params, h):
        """The whole fp32 logits of ``h`` on every rank: a vocab cut's local
        columns gathered, a ``d_model`` cut's row-parallel products summed."""
        if self._vocab_cut == "vocab":
            local = h @ self._head_weight(params)
            return torch.cat(self.tp_mesh.all_gather(local, TP), -1).float()
        if self._vocab_cut == "d_model":
            h_part = scatter_to_region(h, self.tp_mesh, -1)
            return reduce_from_region(h_part @ self._head_weight(params), self.tp_mesh).float()
        return self.unembed(params, h).float()

    @torch.no_grad()
    def prefill(self, params, batch):
        """Full-sequence forward returning the last position's fp32 logits (B, 1,
        vocab); a VLM's batch also holds ``img_emb``, as for :meth:`loss`."""
        self._check_tp()
        x, _ = self._inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        h, _ = self.backbone(params, x, positions)
        return self._serve_logits(params, h[:, -1:])

    # -------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, params, batch):
        """One new token given a warm cache.

        batch: ``tokens`` (B, 1) integer tensor, ``cache`` from
        :meth:`init_cache`, ``index`` the int position of the new token.
        Returns ``(logits (B, 1, vocab) fp32, cache)``; the cache is updated
        in place.  An index past a cache with no window raises ``IndexError``
        (``layers.cache_slot``): MLA's latent cache has no ring.  Over a
        ``model`` axis the rows and the cache are this rank's (the module's
        docstring) and the logits are whole.
        """
        self._check_tp()
        cfg = self.cfg
        tokens, cache, index = batch["tokens"], batch["cache"], int(batch["index"])
        x = self.embed(params, tokens)
        # fills on the device, not copies from the host that would wait for it
        pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
        top = cache["layers"]
        if cfg.mla is not None:
            S = top["c_kv"].shape[2]
            where = cache_shard_slot(index, S * self.tp, 0, self.tp)
            seen = torch.arange(S, device=x.device) < where.counts[self.tp_rank]
        else:
            S = top["k"].shape[3]
            where = cache_shard_slot(index, S * self.tp, cfg.sliding_window, self.tp)
            seen = torch.full((x.shape[0],), where.counts[self.tp_rank], dtype=torch.int32,
                              device=x.device)
        slot = where.local if where.owner == self.tp_rank else None
        if "layer0" in params:
            x = self._decode_attn(params["layer0"]["attn"], x, cache["layer0"], slot, pos, seen)
            x, _ = self._mlp(params["layer0"]["mlp"], x, moe=False)
        lp, moe = params["layers"], cfg.moe is not None
        for i in range(lp["attn"]["ln"].shape[0]):
            attn = {name: t[i] for name, t in lp["attn"].items()}
            mlp = {name: t[i] for name, t in lp["mlp"].items()}
            x = self._decode_attn(attn, x, {name: t[i] for name, t in top.items()}, slot, pos,
                                  seen)
            x, _ = self._mlp(mlp, x, moe=moe)
        h = rms_norm(x, params["final_ln"], cfg.norm_eps)
        return self._serve_logits(params, h), cache
