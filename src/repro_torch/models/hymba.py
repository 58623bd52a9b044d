"""Hymba: parallel attention + Mamba (SSM) heads in every block.

The port of ``repro.models.hymba.Hymba``: the full-sequence path (``loss``
and ``prefill``) and decoding (``decode_step``).  Parameters are a nested
dict with the JAX layout (``params.params_from_jax`` carries a JAX tree over
unchanged): the top level holds ``embed``, ``meta`` (the meta tokens),
``final_ln``, an untied ``lm_head``, one block per global layer
(``global_i``) and the stacked runs of sliding-window blocks between them
(``swa_i``), split once with ``unbind``.  A run may hold no block (the smoke config's ``swa_0``); its
zero-size leaves then take no part in the loss.

Per block both paths see the same normed input: windowed (or, in the global
layers, full) causal GQA attention through the flash kernel, and a selective
scan through ``kernels.ops.ssd_scan``, the hand-written SSD chunked-scan
kernels on the card (forward and backward), their plain versions on the CPU.
The two outputs are RMS-normed and averaged before the output projection.
The meta tokens are prepended to every sequence and count as positions for
RoPE and the window, as in the JAX model.  Each global and each
sliding-window block is rematerialised under ``cfg.remat``, as JAX wraps
each in ``jax.checkpoint`` (``remat.remat``).

Decoding keeps, per block, a KV cache (a full one of ``seq`` slots in the
global layers, a ring buffer of ``min(window, seq)`` slots in the
sliding-window ones, whose window is that ring: attention over it needs no
window of its own), the conv tail of the last ``W - 1`` inputs and the fp32
SSM state.  ``decode_step`` updates them IN PLACE and returns the same cache
object.  Attention goes through the decode-attention kernel, every norm
through the rmsnorm kernel and the MLP through the SwiGLU kernel; the SSM
step is plain PyTorch, with the JAX model's roundings.  As in JAX, the
token's ``index`` is used as given, for RoPE and for the slot: an offset for
the meta tokens is the caller's (the serving engine applies none).

**The ``model`` axis.**  Built over a mesh of one rank's coordinates whose
``model`` axis is above 1, the model executes the layout's specs as
``DecoderLM`` does (``layers.ModelAxis``): its parameters are this rank's
shards and the regions of ``repro_torch.parallel`` run between them.

* Attention: ``wq/wk/wv`` column-parallel; where ``H*hd`` or ``Hkv*hd`` cut
  inside a head (hymba-1.5b's 25 / 5 heads at model 2 and 4), every rank
  computes every head from the gathered projections, else its own heads.
* ``attn_ln`` and ``ssm_ln`` (``P(TP)`` over ``H*hd``) take their RMS over
  the whole row: each norm runs on the whole row with the gathered gamma
  (both gammas in one all-gather) and this rank keeps its columns, which feed
  the row-parallel ``wo`` and one reduce.  The attention row is whole where
  every head was computed, else its heads' outputs are gathered; the SSM row
  is ``ssm_proj``'s partial products summed both ways (``all_reduce_sum``).
* The SSM in-projection: ``w_in``'s columns are cut over ``2 ed``, so the
  ``chunk(2)`` into x and z would leave x on the low ranks and z on the high
  ones; the ranks' projections are exchanged (``regroup_columns``: one
  all-gather, its backward another) so that each holds its contiguous
  ``ed/tp`` channels of both.  ``conv``, ``d_skip`` and z act on those
  channels; ``w_bc``, ``w_dt`` and ``ssm_proj`` are row-parallel, B, C and
  dt reduced whole.  The SSD kernels scan this rank's ``nsh/tp`` heads (its
  channels are whole heads), or, where ``nsh`` does not divide the axis,
  every head from the gathered channels, of which the rank keeps its own.
* The SwiGLU MLP on ``F/tp`` columns; the embedding and ``lm_head`` by
  ``layers.vocab_specs`` (vocab 32001 is odd: ``embed`` cut on d and
  gathered, ``lm_head`` row-parallel); the meta tokens replicated.

Decoding over the axis: q, k, v and the in-projection gathered in one
all-gather; k and v cut on their slots (a sliding-window ring through
``layers.cache_shard_slot``), the decode kernel's partial mode over this
rank's slots merged across ranks (``serve.flash_decoding.merge_partials``);
the conv tail on the rank's contiguous channels.  The fp32 SSM state is cut
as JAX cuts it, on ``chd`` (``P(dp, None, TP, None)``): a rank holds
channels ``[r chd/tp, (r + 1) chd/tp)`` of every head, which are not the
channels its conv produces.  A step moves the conv's output to the state's
cut (the ranks' channels gathered, this rank's slice of every head taken),
updates the state and reads y there, and moves y back (gathered again, this
rank's contiguous channels taken).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from ..kernels import ops
from ..parallel import all_reduce_sum, copy_to_region, gather_from_region, reduce_from_region
from ..serve.flash_decoding import merge_partials
from . import params as PM
from .params import TP, P, dp_axes
from .remat import remat
from .layers import (ModelAxis, blockwise_attention, cache_shard_slot, causal_conv,
                     decode_attention, rms_norm, rope, swiglu, vocab_specs)


def ssd_scan(lf, b_in, x_in, c_out, *, chunk: int):
    """Mamba-2 SSD chunked scan over any sequence length (``hymba.py:126``).

    lf: (B, S, H) per-step log-decay (<= 0); b_in, c_out: (B, S, H, N); x_in:
    (B, S, H, chd).  A sequence that is not whole chunks of ``L = min(chunk,
    S)`` is padded with ``lf = 0`` and ``b = x = c = 0`` steps, which leave
    the state as it is, and y is cut back.  Returns ``(y (B, S, H, chd) in
    x_in's dtype, h_last (B, H, chd, N) fp32)``.
    """
    S = lf.shape[1]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        lf, b_in, x_in, c_out = (torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], 1)
                                 for t in (lf, b_in, x_in, c_out))
    y, h_last = ops.ssd_scan(lf, b_in, x_in, c_out, chunk=L)
    return y[:, :S], h_last


class Hymba(ModelAxis, nn.Module):
    """Global attention blocks alternating with runs of sliding-window blocks."""

    #: a ``model`` axis above 1 runs tensor-parallel (``train.step`` and the
    #: dry-run read this)
    tensor_parallel = True

    def __init__(self, cfg: ModelConfig, *, model_axis: int = 16, mesh=None, device="cuda"):
        super().__init__()
        if cfg.family != "hybrid" or cfg.hybrid is None or cfg.ssm is None:
            raise ValueError(f"{cfg.arch}: Hymba needs family 'hybrid', a hybrid and an ssm config")
        g = sorted(cfg.hybrid.global_layers)
        if g[0] != 0 or g[-1] != cfg.n_layers - 1:
            raise ValueError(f"{cfg.arch}: global layers {g} must include the first and the last")
        self.cfg = cfg
        self.model_axis = model_axis
        self.mesh = mesh
        self.device = resolve(device)
        self.dtype = PM.as_dtype(cfg.dtype)
        self.ed = cfg.ssm.expand * cfg.d_model   # SSM inner width
        self.N = cfg.ssm.state_dim
        self.n_ssm_heads = cfg.hybrid.n_ssm_heads
        # segment plan: global, swa run, global, swa run, ..., global
        self.swa_runs = [g[i + 1] - g[i] - 1 for i in range(len(g) - 1)]
        self.n_global = len(g)
        self._init_model_axis(mesh)

    # -------------------------------------------------------------- layout
    def block_layout(self) -> dict:
        cfg = self.cfg
        D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        ed, N, nsh = self.ed, self.N, self.n_ssm_heads
        return {
            "ln": PM.ParamInfo((D,), P(None), "ones"),
            # attention path
            "wq": PM.ParamInfo((D, H * hd), P(None, TP)),
            "wk": PM.ParamInfo((D, Hkv * hd), P(None, TP)),
            "wv": PM.ParamInfo((D, Hkv * hd), P(None, TP)),
            "attn_ln": PM.ParamInfo((H * hd,), P(TP), "ones"),
            # ssm path (per-head B, C and dt)
            "w_in": PM.ParamInfo((D, 2 * ed), P(None, TP)),
            "conv": PM.ParamInfo((cfg.ssm.conv_width, ed), P(None, TP), scale=0.3),
            "w_bc": PM.ParamInfo((ed, nsh * 2 * N), P(TP, None), scale=0.02),
            "w_dt": PM.ParamInfo((ed, nsh), P(TP, None), scale=0.02),
            "b_dt": PM.ParamInfo((nsh,), P(None), "zeros"),
            "a_log": PM.ParamInfo((nsh,), P(None), "zeros"),
            "d_skip": PM.ParamInfo((ed,), P(TP), "ones"),
            "ssm_proj": PM.ParamInfo((ed, H * hd), P(TP, None)),
            "ssm_ln": PM.ParamInfo((H * hd,), P(TP), "ones"),
            # fusion + mlp
            "wo": PM.ParamInfo((H * hd, D), P(TP, None)),
            "mlp_ln": PM.ParamInfo((D,), P(None), "ones"),
            "w_gate": PM.ParamInfo((D, cfg.d_ff), P(None, TP)),
            "w_up": PM.ParamInfo((D, cfg.d_ff), P(None, TP)),
            "w_down": PM.ParamInfo((cfg.d_ff, D), P(TP, None)),
        }

    def layout(self) -> dict:
        cfg = self.cfg
        emb_spec, head_spec = vocab_specs(cfg.vocab, cfg.d_model, self.model_axis)
        lay: dict[str, Any] = {
            "embed": PM.ParamInfo((cfg.vocab, cfg.d_model), emb_spec, scale=0.02),
            "meta": PM.ParamInfo((cfg.hybrid.meta_tokens, cfg.d_model), P(None, None),
                                 scale=0.02),
            "final_ln": PM.ParamInfo((cfg.d_model,), P(None), "ones"),
            "lm_head": PM.ParamInfo((cfg.d_model, cfg.vocab), head_spec, scale=0.02),
        }
        for i in range(self.n_global):
            lay[f"global_{i}"] = self.block_layout()
        for i, run in enumerate(self.swa_runs):
            lay[f"swa_{i}"] = PM.stack(run, self.block_layout())
        return lay

    def _segments(self, params) -> list[tuple[dict, list[dict]]]:
        """Each global block's parameters with the run of sliding-window blocks
        after it (empty after the last), each stacked leaf split once."""
        out = []
        for i in range(self.n_global):
            run: list[dict] = []
            if i < len(self.swa_runs):
                run = PM.unstack(params[f"swa_{i}"])
            out.append((params[f"global_{i}"], run))
        return out

    # --------------------------------------------------------------- paths
    def _ssm_in(self, p, ht):
        """(x_in, z): this rank's contiguous ``ed/tp`` channels of each from
        the in-projection of ``ht`` (the module's docstring)."""
        return self._split_halves(ht @ p["w_in"], self.ed)

    def _ssm_path(self, p, ht):
        """Selective scan over the full sequence.  ht: (B, S, D) normed input
        (in the region); returns (B, S, H * hd), over a ``model`` axis this
        rank's partial product with ``ssm_proj``."""
        cfg, mesh = self.cfg, self.tp_mesh
        B, S, _ = ht.shape
        N, nsh = self.N, self.n_ssm_heads
        x_in, z = self._ssm_in(p, ht)
        xc = F.silu(causal_conv(x_in, p["conv"]))
        bc = reduce_from_region(xc @ p["w_bc"], mesh).view(B, S, nsh, 2, N)  # (2, N) a head
        dt = F.softplus(reduce_from_region(xc @ p["w_dt"], mesh) + p["b_dt"])  # model dtype
        lf = dt * -torch.exp(p["a_log"].float())           # fp32 log-decay
        xs, local = xc, True
        if self.tp > 1:
            # from here on the ranks use their own heads: the gradients of the
            # whole B, C and dt are summed over the axis
            lo, hi, local = self._head_span(nsh)
            bc = copy_to_region(bc, mesh)[:, :, lo:hi]
            dt, lf = copy_to_region(dt, mesh)[..., lo:hi], copy_to_region(lf, mesh)[..., lo:hi]
            if not local:
                xs = gather_from_region(xc, mesh, -1, partial=True)
        xh = xs.view(B, S, -1, self.ed // nsh)
        y, _ = ssd_scan(lf, dt[..., None] * bc[..., 0, :], xh, bc[..., 1, :],
                        chunk=cfg.ssm.chunk)
        y = y.reshape(B, S, -1).to(ht.dtype)
        if not local:
            y = self._own_columns(y, xc.shape[-1])
        y = y + xc * p["d_skip"]
        return (y * F.silu(z)) @ p["ssm_proj"]

    def _fusion_gammas(self, p):
        """``attn_ln`` and ``ssm_ln`` whole: over a ``model`` axis, gathered in
        one all-gather (the backward keeps this rank's part)."""
        if self.tp == 1:
            return p["attn_ln"], p["ssm_ln"]
        return self._gather_whole((p["attn_ln"], 0), (p["ssm_ln"], 0))

    def _fuse(self, p, x, attn, ssm):
        """x plus ``wo`` of the two paths' whole rows (B, S, H * hd), each
        RMS-normed and averaged; over a ``model`` axis, this rank's columns
        into the row-parallel ``wo``."""
        eps = self.cfg.norm_eps
        g_attn, g_ssm = self._fusion_gammas(p)
        fused = 0.5 * (rms_norm(attn, g_attn, eps) + rms_norm(ssm, g_ssm, eps))
        return self._attn_out(p, x, fused, local=self.tp == 1)

    def _mlp(self, p, x):
        hm = rms_norm(x, p["mlp_ln"], self.cfg.norm_eps)
        y = swiglu(copy_to_region(hm, self.tp_mesh), p["w_gate"], p["w_up"], p["w_down"])
        return x + reduce_from_region(y, self.tp_mesh)

    def _block(self, p, x, positions, *, window: int):
        cfg, mesh = self.cfg, self.tp_mesh
        B, S, _ = x.shape
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        ht = copy_to_region(h, mesh)
        lo, hi, local = self._head_span(H)
        kv_local, pick = self._kv_pick(lo, hi, local)
        q = self._heads(ht @ p["wq"], H, hd, local, slice(lo, hi)).transpose(1, 2)
        k = self._heads(ht @ p["wk"], cfg.n_kv_heads, hd, kv_local, pick).transpose(1, 2)
        v = self._heads(ht @ p["wv"], cfg.n_kv_heads, hd, kv_local, pick).transpose(1, 2)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        attn = blockwise_attention(q, k, v, causal=True, window=window)
        attn = attn.transpose(1, 2).reshape(B, S, (hi - lo) * hd)
        if self.tp > 1 and local:
            attn = gather_from_region(attn, mesh, -1, partial=True)      # the whole row
        ssm = all_reduce_sum(self._ssm_path(p, ht), mesh, TP)
        return self._mlp(p, self._fuse(p, x, attn, ssm))

    # ------------------------------------------------------------ forward
    def backbone(self, params, x):
        positions = torch.arange(x.shape[1], device=x.device)
        win = self.cfg.hybrid.sliding_window
        g_block = remat(lambda p, h: self._block(p, h, positions, window=0), self.cfg.remat)
        s_block = remat(lambda p, h: self._block(p, h, positions, window=win), self.cfg.remat)
        for g, run in self._segments(params):
            x = g_block(g, x)
            for p in run:
                x = s_block(p, x)
        return rms_norm(x, params["final_ln"], self.cfg.norm_eps)

    def _embed_with_meta(self, params, tokens):
        x = self.embed(params, tokens)
        meta = params["meta"].to(x.dtype)[None].expand(x.shape[0], -1, -1)
        return torch.cat([meta, x], dim=1)

    def loss(self, params, batch):
        """Mean next-token cross-entropy over the text positions; returns
        ``(nll, {"nll", "aux": 0})``.

        batch: ``tokens`` and ``labels``, (B, S) integer tensors on the model's
        device.  The meta positions are dropped after the final norm; logits
        are cast to fp32 before the log-sum-exp, as in JAX.
        """
        self._check_tp()
        x = self._embed_with_meta(params, batch["tokens"])
        h = self.backbone(params, x)[:, self.cfg.hybrid.meta_tokens:]
        nll = self._nll(params, h, batch["labels"].long())
        return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Full-sequence forward returning the last position's fp32 logits (B, 1, vocab)."""
        self._check_tp()
        x = self._embed_with_meta(params, batch["tokens"])
        h = self.backbone(params, x)
        return self._serve_logits(params, h[:, -1:])

    # -------------------------------------------------------------- decode
    def cache_layout(self, batch: int, seq: int) -> dict:
        """Per block: ``k``, ``v`` (B, Hkv, slots, hd) and ``conv`` (B, W - 1, ed)
        in the model dtype, ``ssm`` (B, n_ssm_heads, ed / n_ssm_heads, N) in
        fp32; ``seq`` slots in the global blocks, ``min(window, seq)`` in the
        stacked sliding-window runs."""
        cfg = self.cfg
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        nsh = self.n_ssm_heads
        dp = dp_axes(self.mesh)

        def kv(S):
            return {
                "k": PM.ParamInfo((batch, Hkv, S, hd), P(dp, None, TP, None), "zeros"),
                "v": PM.ParamInfo((batch, Hkv, S, hd), P(dp, None, TP, None), "zeros"),
                "conv": PM.ParamInfo((batch, cfg.ssm.conv_width - 1, self.ed),
                                     P(dp, None, TP), "zeros"),
                "ssm": PM.ParamInfo((batch, nsh, self.ed // nsh, self.N),
                                    P(dp, None, TP, None), "zeros", dtype="float32"),
            }

        lay: dict[str, Any] = {f"global_{i}": kv(seq) for i in range(self.n_global)}
        for i, run in enumerate(self.swa_runs):
            lay[f"swa_{i}"] = PM.stack(run, kv(min(cfg.hybrid.sliding_window, seq)))
        return lay

    def init_cache(self, batch: int, seq: int) -> dict:
        """A zero cache; over a ``model`` axis above 1, this rank's shard of it."""
        return self._zero_cache(self.cache_layout(batch, seq))

    def _to_state_cut(self, xc):
        """(B, 1, ed/tp) conv channels -> (B, nsh, chd/tp, 1): the state's
        channels of every head, from every rank's conv channels."""
        B, nsh = xc.shape[0], self.n_ssm_heads
        chd = self.ed // nsh
        w = chd // self.tp
        full = torch.cat(self.tp_mesh.all_gather(xc, TP), -1).view(B, nsh, chd)
        return full[:, :, self.tp_rank * w:(self.tp_rank + 1) * w, None]

    def _to_conv_cut(self, y):
        """(B, nsh, chd/tp, 1) y on the state's channels -> (B, 1, ed/tp) on this
        rank's contiguous conv channels."""
        B = y.shape[0]
        full = torch.cat(self.tp_mesh.all_gather(y, TP), 2).reshape(B, self.ed)
        return self._own_columns(full, self.ed // self.tp).view(B, 1, -1)

    def _ssm_step(self, p, h, c, x_in, z):
        """One step of the selective scan (``_ssm_path`` with ``state``,
        ``hymba.py:263``).  h: (B, 1, D) normed input, ``x_in`` and ``z`` its
        in-projection's channels; ``c``'s ``conv`` and ``ssm`` are updated in
        place.  Returns (B, 1, H * hd), over a ``model`` axis this rank's
        partial product with ``ssm_proj``."""
        B = h.shape[0]
        N, nsh = self.N, self.n_ssm_heads
        mesh = self.tp_mesh
        conv_in = torch.cat([c["conv"], x_in], dim=1)                  # (B, W, channels)
        c["conv"].copy_(conv_in[:, 1:])
        W = p["conv"].shape[0]
        xc = F.silu(sum(conv_in[:, i:i + 1] * p["conv"][i] for i in range(W)))
        bc = reduce_from_region(xc @ p["w_bc"], mesh).view(B, nsh, 2, N)
        dt = F.softplus(reduce_from_region(xc @ p["w_dt"], mesh) + p["b_dt"]).view(B, nsh)
        a_t = torch.exp(dt * -torch.exp(p["a_log"].float()))           # fp32 decay
        bx_in = dt[..., None] * bc[:, :, 0]                             # (B, nsh, N)
        xs = xc.view(B, nsh, self.ed // nsh, 1) if self.tp == 1 else self._to_state_cut(xc)
        outer = xs * bx_in[:, :, None]                                  # model dtype
        state = c["ssm"].mul_(a_t[..., None, None]).add_(outer.float())
        y = state @ bc[:, :, 1].float()[..., None]
        y = y.view(B, 1, self.ed) if self.tp == 1 else self._to_conv_cut(y)
        y = y.to(h.dtype) + xc * p["d_skip"]
        return (y * F.silu(z)) @ p["ssm_proj"]

    def _decode_block(self, p, x, c, slot, pos, valid):
        """One token through a block; writes ``slot`` of its KV cache (this
        rank's local slot, or None where another rank holds the token's) and
        its SSM state in place.  ``pos``: the token's position, a (1,) int64
        tensor; ``valid``: this rank's visible slots, an int32 (B,) tensor;
        both on the model's device and made once a step for every block."""
        cfg, mesh = self.cfg, self.tp_mesh
        B = x.shape[0]
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
        if self.tp == 1:
            x_in, z = (h @ p["w_in"]).chunk(2, dim=-1)
        else:
            q, k, v, up = self._gather_columns(q, k, v, h @ p["w_in"])     # every column
            c_ = self.ed // self.tp
            x_in = self._own_columns(up[..., :self.ed], c_)
            z = self._own_columns(up[..., self.ed:], c_)
        q = rope(q.view(B, H, 1, hd), pos, cfg.rope_theta)
        k = rope(k.view(B, Hkv, 1, hd), pos, cfg.rope_theta)
        if slot is not None:
            c["k"][:, :, slot] = k[:, :, 0]
            c["v"][:, :, slot] = v.view(B, Hkv, hd)
        if self.tp == 1:
            attn = decode_attention(q, c["k"], c["v"], valid, window=0)
        else:
            part, lse = ops.decode_attention_partial(q, c["k"], c["v"], valid)
            attn = merge_partials(part, lse, mesh, TP, dtype=c["v"].dtype)
        ssm = all_reduce_sum(self._ssm_step(p, h, c, x_in, z), mesh, TP)
        x = self._fuse(p, x, attn.view(B, 1, H * hd), ssm)
        return self._mlp(p, x)

    @torch.no_grad()
    def decode_step(self, params, batch):
        """One new token given a warm cache.

        batch: ``tokens`` (B, 1) integer tensor, ``cache`` from
        :meth:`init_cache`, ``index`` the int position of the new token, used
        as given (no meta-token offset).  Returns ``(logits (B, 1, vocab) fp32,
        cache)``; the cache is updated in place.  An ``index`` past the global
        layers' cache raises ``IndexError``.  Over a ``model`` axis the rows
        and the cache are this rank's (the module's docstring) and the logits
        are whole.
        """
        self._check_tp()
        cfg = self.cfg
        tokens, cache, index = batch["tokens"], batch["cache"], int(batch["index"])
        win = cfg.hybrid.sliding_window
        x = self.embed(params, tokens)
        B = x.shape[0]
        # one position and one valid-length tensor a step for each cache length,
        # filled on the device and handed to every block
        pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
        valid: dict[int, torch.Tensor] = {}

        def plan(S: int, window: int):
            where = cache_shard_slot(index, S * self.tp, window, self.tp)
            if S not in valid:
                valid[S] = torch.full((B,), where.counts[self.tp_rank], dtype=torch.int32,
                                      device=x.device)
            return (where.local if where.owner == self.tp_rank else None), valid[S]

        for i, (g, run) in enumerate(self._segments(params)):
            c = cache[f"global_{i}"]
            slot, vl = plan(c["k"].shape[2], 0)
            x = self._decode_block(g, x, c, slot, pos, vl)
            if run:
                cs = cache[f"swa_{i}"]
                slot, vl = plan(cs["k"].shape[3], win)
                for j, p in enumerate(run):
                    x = self._decode_block(p, x, {n: t[j] for n, t in cs.items()}, slot, pos, vl)
        h = rms_norm(x, params["final_ln"], cfg.norm_eps)
        return self._serve_logits(params, h), cache
