"""xLSTM: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar, stepped).

The port of ``repro.models.xlstm.XLSTM``: the training path and decoding.
Parameters are a nested dict with the JAX layout (``params.params_from_jax``
carries a JAX tree over unchanged).  The stack is ``n_layers // slstm_every`` groups of
``slstm_every - 1`` mLSTM blocks and one sLSTM block; the stacked ``groups``
leaves are split once with ``unbind``, whose backward stacks the blocks'
gradients into one leaf of the stacked shape again.

The mLSTM core goes through ``kernels.ops.mlstm_scan``: the hand-written
chunked kernels on the card (forward and backward), their plain versions on
the CPU.  The sLSTM recurrence is a true time loop that the JAX package runs
with ``lax.scan`` and no Pallas kernel; here it is a Python loop over the
sequence of the fp32 step.  Its post-FFN is the ``swiglu`` function, so it
runs the SwiGLU kernel.  Each mLSTM and each sLSTM block is
rematerialised under ``cfg.remat``, as JAX wraps each in ``jax.checkpoint``
(``remat.remat``); under ``"dots"`` the sLSTM time loop runs again in the
backward pass (its recurrent products are per head, batched).

Decoding carries the recurrent state in the cache, O(1) in the sequence:
per mLSTM block C, n and m (fp32) and the conv tail (the model dtype), per
sLSTM block c, n, m and h (fp32), all starting at zero as in JAX (m too:
the stabiliser cancels from h).  ``decode_step`` updates them IN PLACE and
returns the same cache object; :func:`mlstm_decode`, plain PyTorch as in JAX
(no Pallas body), updates C where it lies.  Every norm goes through the
rmsnorm kernel and the sLSTM post-FFN through the SwiGLU kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from ..kernels import ops
from . import params as PM
from .params import TP, P, dp_axes
from .remat import remat
from .layers import causal_conv, rms_norm, swiglu

_NEG = -1e30


def mlstm_decode(q, k, v, i_raw, log_f, state):
    """Single-token mLSTM update (``xlstm.py:97``).  q, k: (B, H, dqk); v: (B,
    H, dv); gates (B, H); ``state``: fp32 ``(C (B, H, dqk, dv), n (B, H, dqk),
    m (B, H))``, updated IN PLACE.  Returns ``(h (B, H, dv) fp32, state)``.

    Three kernels touch C, and none makes a temporary of its size: C scaled
    by the forget gate, the rank-1 ``(i k) v^T`` added by a batched
    ``baddbmm_``, then read by ``q C``.  JAX forms ``i (k v^T)`` instead, so the sums round in another
    order (within 1e-4 of it).
    """
    C, n, m = state
    B, H, dqk = q.shape
    dv = v.shape[-1]
    q = q.float() * dqk ** -0.5
    k, v = k.float(), v.float()
    m_new = torch.maximum(log_f + m, i_raw)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(i_raw - m_new)
    C.mul_(f_s[..., None, None])
    C.view(B * H, dqk, dv).baddbmm_((i_s[..., None] * k).view(B * H, dqk, 1),
                                    v.view(B * H, 1, dv))
    n.mul_(f_s[..., None]).add_(i_s[..., None] * k)
    m.copy_(m_new)
    num = torch.bmm(q.view(B * H, 1, dqk), C.view(B * H, dqk, dv)).view(B, H, dv)
    den = torch.maximum((q * n).sum(-1).abs(), torch.exp(-m_new))
    return num / den[..., None], state


class XLSTM(nn.Module):
    """48-block stack: one sLSTM block per ``slstm_every``, the rest mLSTM."""

    #: no tensor-parallel execution of a ``model`` axis (``train.step`` raises)
    tensor_parallel = False

    def __init__(self, cfg: ModelConfig, *, model_axis: int = 16, mesh=None, device="cuda"):
        super().__init__()
        if cfg.family != "ssm" or cfg.ssm is None:
            raise ValueError(f"{cfg.arch}: XLSTM needs family 'ssm' and an ssm config")
        if cfg.n_layers % cfg.ssm.slstm_every:
            raise ValueError(f"{cfg.arch}: {cfg.n_layers} layers are not whole groups of "
                             f"{cfg.ssm.slstm_every}")
        self.cfg = cfg
        self.model_axis = model_axis
        self.mesh = mesh
        self.device = resolve(device)
        self.dtype = PM.as_dtype(cfg.dtype)
        D = cfg.d_model
        self.ed = cfg.ssm.expand * D          # mLSTM inner width
        self.H = cfg.n_heads
        self.dv = self.ed // self.H
        self.dqk = self.dv // 2
        self.sh = cfg.n_heads                 # sLSTM heads
        self.sdh = D // self.sh
        self.s_ff = 2688                      # the JAX model's sLSTM FFN width

    # -------------------------------------------------------------- layout
    def mlstm_layout(self) -> dict:
        D, ed, H = self.cfg.d_model, self.ed, self.H
        return {
            "ln": PM.ParamInfo((D,), P(None), "ones"),
            "w_up": PM.ParamInfo((D, 2 * ed), P(None, TP)),
            "conv": PM.ParamInfo((self.cfg.ssm.conv_width, ed), P(None, TP), scale=0.3),
            "wq": PM.ParamInfo((ed, H * self.dqk), P(TP, None)),
            "wk": PM.ParamInfo((ed, H * self.dqk), P(TP, None)),
            "wv": PM.ParamInfo((ed, H * self.dv), P(TP, None)),
            "w_i": PM.ParamInfo((ed, H), P(TP, None), scale=0.02),
            "b_i": PM.ParamInfo((H,), P(None), "zeros"),
            "w_f": PM.ParamInfo((ed, H), P(TP, None), scale=0.02),
            # "ones" ignores the scale, as the JAX _init_leaf does: b_f starts at 1.0
            "b_f": PM.ParamInfo((H,), P(None), init="ones", scale=3.0),
            "out_ln": PM.ParamInfo((ed,), P(TP), "ones"),
            "w_down": PM.ParamInfo((ed, D), P(TP, None)),
        }

    def slstm_layout(self) -> dict:
        D, sh, dh = self.cfg.d_model, self.sh, self.sdh
        return {
            "ln": PM.ParamInfo((D,), P(None), "ones"),
            # sh=4 heads cannot shard a 16-way axis; shard the dh dims
            "w_gates": PM.ParamInfo((D, sh, dh, 4), P(None, None, TP, None)),
            "r_gates": PM.ParamInfo((sh, dh, dh, 4), P(None, TP, None, None), scale=0.02),
            "b_gates": PM.ParamInfo((sh, dh, 4), P(None, TP, None), "zeros"),
            "out_ln": PM.ParamInfo((D,), P(None), "ones"),
            "w_out": PM.ParamInfo((D, D), P(None, TP)),
            "ffn_ln": PM.ParamInfo((D,), P(None), "ones"),
            "ffn_gate": PM.ParamInfo((D, self.s_ff), P(None, TP)),
            "ffn_up": PM.ParamInfo((D, self.s_ff), P(None, TP)),
            "ffn_down": PM.ParamInfo((self.s_ff, D), P(TP, None)),
        }

    def layout(self) -> dict:
        cfg = self.cfg
        every = cfg.ssm.slstm_every
        groups = cfg.n_layers // every
        div_v = cfg.vocab % self.model_axis == 0
        div_d = cfg.d_model % self.model_axis == 0
        emb_spec = P(TP, None) if div_v else (P(None, TP) if div_d else P(None, None))
        head_spec = P(None, TP) if div_v else (P(TP, None) if div_d else P(None, None))
        return {
            "embed": PM.ParamInfo((cfg.vocab, cfg.d_model), emb_spec, scale=0.02),
            "groups": PM.stack(
                groups,
                {"mlstm": PM.stack(every - 1, self.mlstm_layout()), "slstm": self.slstm_layout()},
            ),
            "final_ln": PM.ParamInfo((cfg.d_model,), P(None), "ones"),
            "lm_head": PM.ParamInfo((cfg.d_model, cfg.vocab), head_spec, scale=0.02),
        }

    def init_params(self, generator: torch.Generator) -> dict:
        return PM.init_params(self.layout(), generator, device=self.device, dtype=self.dtype)

    @staticmethod
    def _group_params(params) -> list[tuple[list[dict], dict]]:
        """Per-group views of the stacked ``params["groups"]``: the group's mLSTM
        blocks and its sLSTM block, each stacked leaf split once."""
        groups = params["groups"]
        G, E = groups["mlstm"]["ln"].shape[:2]
        m_split = PM.tree_map(lambda t: t.flatten(0, 1).unbind(0), groups["mlstm"])
        s_split = PM.tree_map(lambda t: t.unbind(0), groups["slstm"])
        return [([PM.tree_map(lambda parts: parts[g * E + j], m_split) for j in range(E)],
                 PM.tree_map(lambda parts: parts[g], s_split)) for g in range(G)]

    # ------------------------------------------------------------- blocks
    def _mlstm_qkvif(self, p, xc, xv):
        B, S, _ = xc.shape
        H = self.H
        q = (xc @ p["wq"]).view(B, S, H, self.dqk).transpose(1, 2)
        k = (xc @ p["wk"]).view(B, S, H, self.dqk).transpose(1, 2)
        v = (xv @ p["wv"]).view(B, S, H, self.dv).transpose(1, 2)
        i_raw = (xc @ p["w_i"] + p["b_i"]).transpose(1, 2)
        log_f = F.logsigmoid(xc @ p["w_f"] + p["b_f"]).transpose(1, 2)
        return q, k, v, i_raw, log_f

    def _mlstm_block(self, p, x):
        cfg = self.cfg
        B, S, _ = x.shape
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        x_in, z = (h @ p["w_up"]).chunk(2, dim=-1)
        xc = F.silu(causal_conv(x_in, p["conv"]))
        q, k, v, i_raw, log_f = self._mlstm_qkvif(p, xc, x_in)
        hh = ops.mlstm_scan(q, k, v, i_raw, log_f, chunk=cfg.ssm.chunk)
        hh = hh.transpose(1, 2).reshape(B, S, self.ed).to(x.dtype)
        hh = rms_norm(hh, p["out_ln"], cfg.norm_eps) * F.silu(z)
        return x + hh @ p["w_down"]

    def _slstm_block(self, p, x):
        cfg = self.cfg
        B, S, D = x.shape
        sh, dh = self.sh, self.sdh
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        # input-driven gate preactivations; the recurrent term (depends on
        # h_{t-1}) is added inside the loop
        gates = (h.float() @ p["w_gates"].float().reshape(D, -1)).view(B, S, sh, dh, 4) \
            + p["b_gates"].float()
        r = p["r_gates"].float().reshape(sh, dh, dh * 4)
        c = torch.zeros((B, sh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        m = torch.full_like(c, _NEG)
        h_prev = torch.zeros_like(c)
        hs = []
        for t in range(S):
            rec = torch.bmm(h_prev.transpose(0, 1), r).transpose(0, 1).view(B, sh, dh, 4)
            g_t = gates[:, t] + rec
            z = torch.tanh(g_t[..., 0])
            i_raw = g_t[..., 1]
            lf_m = F.logsigmoid(g_t[..., 2]) + m
            o = torch.sigmoid(g_t[..., 3])
            m = torch.maximum(lf_m, i_raw)
            i_s = torch.exp(i_raw - m)
            f_s = torch.exp(lf_m - m)
            c = f_s * c + i_s * z
            n = f_s * n + i_s
            h_prev = o * c / torch.clamp(n, min=1e-6)
            hs.append(h_prev)
        hh = torch.stack(hs, 1).reshape(B, S, D).to(x.dtype)
        x = x + rms_norm(hh, p["out_ln"], cfg.norm_eps) @ p["w_out"]
        # post-FFN (xLSTM sLSTM blocks carry a ~4/3 gated projection)
        h = rms_norm(x, p["ffn_ln"], cfg.norm_eps)
        return x + swiglu(h, p["ffn_gate"], p["ffn_up"], p["ffn_down"])

    # ------------------------------------------------------------ forward
    def backbone(self, params, x):
        m_block = remat(self._mlstm_block, self.cfg.remat)
        s_block = remat(self._slstm_block, self.cfg.remat)
        for mlstm, slstm in self._group_params(params):
            for p in mlstm:
                x = m_block(p, x)
            x = s_block(slstm, x)
        return rms_norm(x, params["final_ln"], self.cfg.norm_eps)

    def loss(self, params, batch):
        """Mean next-token cross-entropy; returns ``(nll, {"nll", "aux": 0})``.

        batch: ``tokens`` and ``labels``, (B, S) integer tensors on the model's
        device.  Logits are cast to fp32 before the log-sum-exp, as in JAX.
        """
        x = params["embed"][batch["tokens"]].to(self.dtype)
        h = self.backbone(params, x)
        logits = (h @ params["lm_head"]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
        nll = (lse - gold).mean()
        return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Full-sequence forward returning the last position's fp32 logits (B, 1, vocab)."""
        x = params["embed"][batch["tokens"]].to(self.dtype)
        h = self.backbone(params, x)
        return (h[:, -1:] @ params["lm_head"]).float()

    # -------------------------------------------------------------- decode
    def cache_layout(self, batch: int, seq: int) -> dict:
        """The recurrent state, O(1) in ``seq``: per mLSTM block ``C`` (B, H,
        dqk, dv), ``n`` (B, H, dqk) and ``m`` (B, H) in fp32 and ``conv`` (B,
        W - 1, ed) in the model dtype; per sLSTM block ``c``, ``n``, ``m``, ``h``
        (B, heads, head dim) in fp32; stacked as the parameters are."""
        cfg = self.cfg
        every = cfg.ssm.slstm_every
        H, W = self.H, cfg.ssm.conv_width
        dp = dp_axes(self.mesh)
        f32 = dict(init="zeros", dtype="float32")
        # H (4 heads) does not divide a 16-way model axis; the large per-head
        # state dims shard on 'model' instead
        m_state = {
            "C": PM.ParamInfo((batch, H, self.dqk, self.dv), P(dp, None, TP, None), **f32),
            "n": PM.ParamInfo((batch, H, self.dqk), P(dp, None, TP), **f32),
            "m": PM.ParamInfo((batch, H), P(dp, None), **f32),
            "conv": PM.ParamInfo((batch, W - 1, self.ed), P(dp, None, TP), "zeros"),
        }
        s_state = {name: PM.ParamInfo((batch, self.sh, self.sdh), P(dp, None, TP), **f32)
                   for name in ("c", "n", "m", "h")}
        return {"groups": PM.stack(cfg.n_layers // every,
                                   {"mlstm": PM.stack(every - 1, m_state), "slstm": s_state})}

    def init_cache(self, batch: int, seq: int) -> dict:
        return PM.zeros_cache(self.cache_layout(batch, seq), device=self.device, dtype=self.dtype)

    def _mlstm_decode_block(self, p, x, st):
        cfg = self.cfg
        B = x.shape[0]
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        x_in, z = (h @ p["w_up"]).chunk(2, dim=-1)                  # (B, 1, ed)
        conv_in = torch.cat([st["conv"], x_in], dim=1)
        st["conv"].copy_(conv_in[:, 1:])
        W = p["conv"].shape[0]
        xc = F.silu(sum(conv_in[:, i:i + 1] * p["conv"][i] for i in range(W)))
        q, k, v, i_raw, log_f = self._mlstm_qkvif(p, xc, x_in)
        hh, _ = mlstm_decode(q[:, :, 0], k[:, :, 0], v[:, :, 0], i_raw[:, :, 0], log_f[:, :, 0],
                             (st["C"], st["n"], st["m"]))
        hh = hh.reshape(B, 1, self.ed).to(x.dtype)
        hh = rms_norm(hh, p["out_ln"], cfg.norm_eps) * F.silu(z)
        return x + hh @ p["w_down"]

    def _slstm_decode_block(self, p, x, st):
        cfg = self.cfg
        B, _, D = x.shape
        sh, dh = self.sh, self.sdh
        h = rms_norm(x, p["ln"], cfg.norm_eps)[:, 0]
        g = (h.float() @ p["w_gates"].float().reshape(D, -1)).view(B, sh, dh, 4) \
            + p["b_gates"].float()
        r = p["r_gates"].float().reshape(sh, dh, dh * 4)
        g = g + torch.bmm(st["h"].transpose(0, 1), r).transpose(0, 1).view(B, sh, dh, 4)
        z = torch.tanh(g[..., 0])
        i_raw = g[..., 1]
        lf = F.logsigmoid(g[..., 2])
        o = torch.sigmoid(g[..., 3])
        m_new = torch.maximum(lf + st["m"], i_raw)
        i_s = torch.exp(i_raw - m_new)
        f_s = torch.exp(lf + st["m"] - m_new)
        c = st["c"].mul_(f_s).add_(i_s * z)
        n = st["n"].mul_(f_s).add_(i_s)
        st["m"].copy_(m_new)
        h_new = st["h"].copy_(o * c / torch.clamp(n, min=1e-6))
        x = x + rms_norm(h_new.reshape(B, 1, D).to(x.dtype), p["out_ln"], cfg.norm_eps) \
            @ p["w_out"]
        hf = rms_norm(x, p["ffn_ln"], cfg.norm_eps)
        return x + swiglu(hf, p["ffn_gate"], p["ffn_up"], p["ffn_down"])

    @torch.no_grad()
    def decode_step(self, params, batch):
        """One new token given the recurrent state.

        batch: ``tokens`` (B, 1) integer tensor and ``cache`` from
        :meth:`init_cache` (an ``index`` is not needed).  Returns ``(logits
        (B, 1, vocab) fp32, cache)``; the cache is updated in place.
        """
        x = params["embed"][batch["tokens"]].to(self.dtype)
        mc, sc = batch["cache"]["groups"]["mlstm"], batch["cache"]["groups"]["slstm"]
        for g, (mlstm, slstm) in enumerate(self._group_params(params)):
            for j, p in enumerate(mlstm):
                x = self._mlstm_decode_block(p, x, {n: t[g, j] for n, t in mc.items()})
            x = self._slstm_decode_block(slstm, x, {n: t[g] for n, t in sc.items()})
        h = rms_norm(x, params["final_ln"], self.cfg.norm_eps)
        return (h @ params["lm_head"]).float(), batch["cache"]
