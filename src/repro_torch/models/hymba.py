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
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from ..kernels import ops
from . import params as PM
from .params import TP, P, dp_axes
from .remat import remat
from .layers import (blockwise_attention, cache_slot, causal_conv, decode_attention, rms_norm,
                     rope, swiglu)


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


class Hymba(nn.Module):
    """Global attention blocks alternating with runs of sliding-window blocks."""

    #: no tensor-parallel execution of a ``model`` axis (``train.step`` raises)
    tensor_parallel = False

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
        div_v = cfg.vocab % self.model_axis == 0
        div_d = cfg.d_model % self.model_axis == 0
        emb_spec = P(TP, None) if div_v else (P(None, TP) if div_d else P(None, None))
        head_spec = P(None, TP) if div_v else (P(TP, None) if div_d else P(None, None))
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

    def init_params(self, generator: torch.Generator) -> dict:
        return PM.init_params(self.layout(), generator, device=self.device, dtype=self.dtype)

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
    def _ssm_path(self, p, h):
        """Selective scan over the full sequence.  h: (B, S, D) normed input;
        returns (B, S, H * hd)."""
        cfg = self.cfg
        B, S, _ = h.shape
        N, nsh = self.N, self.n_ssm_heads
        x_in, z = (h @ p["w_in"]).chunk(2, dim=-1)
        xc = F.silu(causal_conv(x_in, p["conv"]))
        bc = (xc @ p["w_bc"]).view(B, S, nsh, 2, N)       # (2, N) interleaved per head
        dt = F.softplus(xc @ p["w_dt"] + p["b_dt"])        # (B, S, nsh) in the model dtype
        lf = dt * -torch.exp(p["a_log"].float())           # fp32 log-decay
        xh = xc.view(B, S, nsh, self.ed // nsh)
        y, _ = ssd_scan(lf, dt[..., None] * bc[..., 0, :], xh, bc[..., 1, :],
                        chunk=cfg.ssm.chunk)
        y = y.reshape(B, S, self.ed).to(h.dtype) + xc * p["d_skip"]
        return (y * F.silu(z)) @ p["ssm_proj"]

    def _block(self, p, x, positions, *, window: int):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q = (h @ p["wq"]).view(B, S, H, hd).transpose(1, 2)
        k = (h @ p["wk"]).view(B, S, Hkv, hd).transpose(1, 2)
        v = (h @ p["wv"]).view(B, S, Hkv, hd).transpose(1, 2)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        attn = blockwise_attention(q, k, v, causal=True, window=window)
        attn = attn.transpose(1, 2).reshape(B, S, H * hd)
        ssm = self._ssm_path(p, h)
        fused = 0.5 * (rms_norm(attn, p["attn_ln"], cfg.norm_eps)
                       + rms_norm(ssm, p["ssm_ln"], cfg.norm_eps))
        x = x + fused @ p["wo"]
        hm = rms_norm(x, p["mlp_ln"], cfg.norm_eps)
        return x + swiglu(hm, p["w_gate"], p["w_up"], p["w_down"])

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
        x = params["embed"][tokens].to(self.dtype)
        meta = params["meta"].to(x.dtype)[None].expand(x.shape[0], -1, -1)
        return torch.cat([meta, x], dim=1)

    def loss(self, params, batch):
        """Mean next-token cross-entropy over the text positions; returns
        ``(nll, {"nll", "aux": 0})``.

        batch: ``tokens`` and ``labels``, (B, S) integer tensors on the model's
        device.  The meta positions are dropped after the final norm; logits
        are cast to fp32 before the log-sum-exp, as in JAX.
        """
        x = self._embed_with_meta(params, batch["tokens"])
        h = self.backbone(params, x)[:, self.cfg.hybrid.meta_tokens:]
        logits = (h @ params["lm_head"]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
        nll = (lse - gold).mean()
        return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Full-sequence forward returning the last position's fp32 logits (B, 1, vocab)."""
        x = self._embed_with_meta(params, batch["tokens"])
        h = self.backbone(params, x)
        return (h[:, -1:] @ params["lm_head"]).float()

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
        return PM.zeros_cache(self.cache_layout(batch, seq), device=self.device, dtype=self.dtype)

    def _ssm_step(self, p, h, c):
        """One step of the selective scan (``_ssm_path`` with ``state``,
        ``hymba.py:263``).  h: (B, 1, D) normed input; ``c``'s ``conv`` and
        ``ssm`` are updated in place.  Returns (B, 1, H * hd)."""
        B = h.shape[0]
        N, nsh = self.N, self.n_ssm_heads
        x_in, z = (h @ p["w_in"]).chunk(2, dim=-1)
        conv_in = torch.cat([c["conv"], x_in], dim=1)                  # (B, W, ed)
        c["conv"].copy_(conv_in[:, 1:])
        W = p["conv"].shape[0]
        xc = F.silu(sum(conv_in[:, i:i + 1] * p["conv"][i] for i in range(W)))
        bc = (xc @ p["w_bc"]).view(B, nsh, 2, N)
        dt = F.softplus(xc @ p["w_dt"] + p["b_dt"]).view(B, nsh)      # model dtype
        a_t = torch.exp(dt * -torch.exp(p["a_log"].float()))           # fp32 decay
        bx_in = dt[..., None] * bc[:, :, 0]                             # (B, nsh, N)
        outer = xc.view(B, nsh, self.ed // nsh, 1) * bx_in[:, :, None]  # model dtype
        state = c["ssm"].mul_(a_t[..., None, None]).add_(outer.float())
        y = (state @ bc[:, :, 1].float()[..., None]).view(B, 1, self.ed)
        y = y.to(h.dtype) + xc * p["d_skip"]
        return (y * F.silu(z)) @ p["ssm_proj"]

    def _decode_block(self, p, x, c, slot: int, pos, valid):
        """One token through a block; writes ``slot`` of its KV cache and its
        SSM state in place.  ``pos``: the token's position, a (1,) int64
        tensor; ``valid``: the visible slots, an int32 (B,) tensor; both on the
        model's device and made once a step for every block."""
        cfg = self.cfg
        B = x.shape[0]
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q = rope((h @ p["wq"]).view(B, H, 1, hd), pos, cfg.rope_theta)
        k = rope((h @ p["wk"]).view(B, Hkv, 1, hd), pos, cfg.rope_theta)
        c["k"][:, :, slot] = k[:, :, 0]
        c["v"][:, :, slot] = (h @ p["wv"]).view(B, Hkv, hd)
        attn = decode_attention(q, c["k"], c["v"], valid, window=0).view(B, 1, H * hd)
        ssm = self._ssm_step(p, h, c)
        fused = 0.5 * (rms_norm(attn, p["attn_ln"], cfg.norm_eps)
                       + rms_norm(ssm, p["ssm_ln"], cfg.norm_eps))
        x = x + fused @ p["wo"]
        hm = rms_norm(x, p["mlp_ln"], cfg.norm_eps)
        return x + swiglu(hm, p["w_gate"], p["w_up"], p["w_down"])

    @torch.no_grad()
    def decode_step(self, params, batch):
        """One new token given a warm cache.

        batch: ``tokens`` (B, 1) integer tensor, ``cache`` from
        :meth:`init_cache`, ``index`` the int position of the new token, used
        as given (no meta-token offset).  Returns ``(logits (B, 1, vocab) fp32,
        cache)``; the cache is updated in place.  An ``index`` past the global
        layers' cache raises ``IndexError``.
        """
        cfg = self.cfg
        tokens, cache, index = batch["tokens"], batch["cache"], int(batch["index"])
        win = cfg.hybrid.sliding_window
        x = params["embed"][tokens].to(self.dtype)
        B = x.shape[0]
        # one position and one valid-length tensor a step for each cache length,
        # filled on the device and handed to every block
        pos = torch.full((1,), index, dtype=torch.int64, device=x.device)
        valid: dict[int, torch.Tensor] = {}

        def plan(S: int, window: int):
            slot, n_valid = cache_slot(index, S, window)
            if S not in valid:
                valid[S] = torch.full((B,), n_valid, dtype=torch.int32, device=x.device)
            return slot, valid[S]

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
        return (h @ params["lm_head"]).float(), cache
