"""xLSTM: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar, stepped).

The port of ``repro.models.xlstm.XLSTM``'s training path.  Parameters are a
nested dict with the JAX layout (``params.params_from_jax`` carries a JAX
tree over unchanged).  The stack is ``n_layers // slstm_every`` groups of
``slstm_every - 1`` mLSTM blocks and one sLSTM block; the stacked ``groups``
leaves are split once with ``unbind``, whose backward stacks the blocks'
gradients into one leaf of the stacked shape again.

The mLSTM core goes through ``kernels.ops.mlstm_scan``: the hand-written
chunked kernels on the card (forward and backward), their plain versions on
the CPU.  The sLSTM recurrence is a true time loop that the JAX package runs
with ``lax.scan`` and no Pallas kernel; here it is a Python loop over the
sequence of the fp32 step.  Its post-FFN is the ``swiglu`` function, so it
runs the SwiGLU kernel.  ``jax.checkpoint`` around each block (``cfg.remat``)
changes memory, not values, and is not ported.  Decoding (``mlstm_decode``,
the sLSTM step with a cache) comes with the xLSTM decode slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from ..kernels import ops
from . import params as PM
from .layers import rms_norm, swiglu

_NEG = -1e30


class XLSTM(nn.Module):
    """48-block stack: one sLSTM block per ``slstm_every``, the rest mLSTM."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        super().__init__()
        if cfg.family != "ssm" or cfg.ssm is None:
            raise ValueError(f"{cfg.arch}: XLSTM needs family 'ssm' and an ssm config")
        if cfg.n_layers % cfg.ssm.slstm_every:
            raise ValueError(f"{cfg.arch}: {cfg.n_layers} layers are not whole groups of "
                             f"{cfg.ssm.slstm_every}")
        self.cfg = cfg
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
            "ln": PM.ParamInfo((D,), "ones"),
            "w_up": PM.ParamInfo((D, 2 * ed)),
            "conv": PM.ParamInfo((self.cfg.ssm.conv_width, ed), scale=0.3),
            "wq": PM.ParamInfo((ed, H * self.dqk)),
            "wk": PM.ParamInfo((ed, H * self.dqk)),
            "wv": PM.ParamInfo((ed, H * self.dv)),
            "w_i": PM.ParamInfo((ed, H), scale=0.02),
            "b_i": PM.ParamInfo((H,), "zeros"),
            "w_f": PM.ParamInfo((ed, H), scale=0.02),
            # "ones" ignores the scale, as the JAX _init_leaf does: b_f starts at 1.0
            "b_f": PM.ParamInfo((H,), init="ones", scale=3.0),
            "out_ln": PM.ParamInfo((ed,), "ones"),
            "w_down": PM.ParamInfo((ed, D)),
        }

    def slstm_layout(self) -> dict:
        D, sh, dh = self.cfg.d_model, self.sh, self.sdh
        return {
            "ln": PM.ParamInfo((D,), "ones"),
            "w_gates": PM.ParamInfo((D, sh, dh, 4)),
            "r_gates": PM.ParamInfo((sh, dh, dh, 4), scale=0.02),
            "b_gates": PM.ParamInfo((sh, dh, 4), "zeros"),
            "out_ln": PM.ParamInfo((D,), "ones"),
            "w_out": PM.ParamInfo((D, D)),
            "ffn_ln": PM.ParamInfo((D,), "ones"),
            "ffn_gate": PM.ParamInfo((D, self.s_ff)),
            "ffn_up": PM.ParamInfo((D, self.s_ff)),
            "ffn_down": PM.ParamInfo((self.s_ff, D)),
        }

    def layout(self) -> dict:
        cfg = self.cfg
        every = cfg.ssm.slstm_every
        groups = cfg.n_layers // every
        return {
            "embed": PM.ParamInfo((cfg.vocab, cfg.d_model), scale=0.02),
            "groups": PM.stack(
                groups,
                {"mlstm": PM.stack(every - 1, self.mlstm_layout()), "slstm": self.slstm_layout()},
            ),
            "final_ln": PM.ParamInfo((cfg.d_model,), "ones"),
            "lm_head": PM.ParamInfo((cfg.d_model, cfg.vocab), scale=0.02),
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
    def _conv(self, x, w):
        """Causal depthwise conv along time.  x: (B, S, ed); w: (W, ed)."""
        W, S = w.shape[0], x.shape[1]
        pad = F.pad(x, (0, 0, W - 1, 0))
        return sum(pad[:, i:i + S] * w[i] for i in range(W))

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
        xc = F.silu(self._conv(x_in, p["conv"]))
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
        for mlstm, slstm in self._group_params(params):
            for p in mlstm:
                x = self._mlstm_block(p, x)
            x = self._slstm_block(slstm, x)
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
    def _decode_not_ported(self) -> NotImplementedError:
        return NotImplementedError(
            f"{self.cfg.arch}: xLSTM decoding (the recurrent-state cache, mlstm_decode and "
            "the sLSTM step) comes with the xLSTM decode slice")

    def cache_layout(self, batch: int, seq: int) -> dict:
        raise self._decode_not_ported()

    def decode_step(self, params, batch):
        raise self._decode_not_ported()
