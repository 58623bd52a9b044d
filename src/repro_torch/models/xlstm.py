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

**The ``model`` axis.**  Built over a mesh of one rank's coordinates whose
``model`` axis is above 1, the model executes the layout's specs as the
other families do (``layers.ModelAxis``): its parameters are this rank's
shards and the regions of ``repro_torch.parallel`` run between them.

* mLSTM: the normed input copied into the region; ``w_up``'s columns are cut
  over ``2 ed``, so the ranks' products are exchanged to give each its
  contiguous ``ed/tp`` channels of x and of z (``ModelAxis._split_halves``);
  ``conv`` acts on them.  ``wq``, ``wk``, ``wv``, ``w_i`` and ``w_f`` are
  row-parallel: the five partial products side by side in one all-reduce
  (fp32, cast once), after which every rank holds whole q, k, v and gates.
  The scan runs on this rank's ``H/tp`` heads, which give its contiguous
  ``ed/tp`` columns of the output, or, where H does not divide the axis, on
  every head, of which the rank keeps its columns.  ``out_ln`` takes its RMS
  over the whole row: the row is whole (the heads' outputs gathered), the
  gamma gathered, and the rank keeps its columns, multiplies them by its
  ``silu(z)`` and feeds the row-parallel ``w_down`` and one reduce.
* sLSTM: the cell runs whole on every rank.  ``w_gates``, ``b_gates`` and
  ``r_gates`` (JAX cuts them on dh, the recurrent one on its input dh) are
  gathered whole in one all-gather a block, and the gate pre-activations and
  the whole time loop are the single device's: no collective runs inside the
  loop (an exact copy of JAX's cut would sum the recurrent product over the
  axis at every step).  ``out_ln`` is replicated; ``w_out`` is
  column-parallel (the normed row copied in, the output gathered); the
  post-FFN runs the SwiGLU kernel on ``2688/tp`` columns.
* The embedding and the unembedding by ``layers.vocab_specs``.

Decoding keeps JAX's cut of the state: mLSTM ``C`` and ``n`` on ``dqk``
(``P(dp, None, TP, None)``), ``m`` replicated, the conv tail on the rank's
``ed/tp`` channels, the sLSTM ``c``, ``n``, ``m`` and ``h`` on dh.  An mLSTM
step takes the rank's ``dqk/tp`` slice of every head's q and k, updates its
``C`` and ``n`` shards in place and ``m`` identically everywhere, and sums
the partial numerator and ``q . n`` in one fp32 all-reduce before the
denominator's ``max(|q . n|, exp(-m))`` (:func:`mlstm_decode_partial`).
An sLSTM step forms its dh's gate columns from its own ``w_gates`` and
``b_gates``, and the recurrent term from its own ``h`` shard and input rows
of ``r_gates``: a partial product over every output, summed over the axis
once, of which it keeps its dh; ``h_new`` is gathered whole for the
replicated ``out_ln``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve
from ..kernels import ops
from ..parallel import copy_to_region, gather_from_region, reduce_from_region, total_fp32
from . import params as PM
from .params import TP, P, dp_axes
from .remat import remat
from .layers import ModelAxis, causal_conv, rms_norm, swiglu, vocab_specs

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
    num, qn, m_new = mlstm_decode_partial(q, k, v, i_raw, log_f, state, dqk=q.shape[-1])
    den = torch.maximum(qn.abs(), torch.exp(-m_new))
    return num / den[..., None], state


def mlstm_decode_partial(q, k, v, i_raw, log_f, state, *, dqk: int):
    """:func:`mlstm_decode`'s update and reads on a cut of ``dqk``: q and k are
    this rank's slice (B, H, dqk/tp) of every head's, ``state`` its shards
    ``(C (B, H, dqk/tp, dv), n (B, H, dqk/tp), m (B, H))``, updated IN PLACE
    (m whole, the same on every rank).  Returns ``(num (B, H, dv), q . n (B,
    H), m_new)``: sums over this rank's slice, whose totals over the axis give
    ``h = num / max(|q . n|, exp(-m_new))``; q is scaled by the whole ``dqk``."""
    C, n, m = state
    B, H, w = q.shape
    dv = v.shape[-1]
    q = q.float() * dqk ** -0.5
    k, v = k.float(), v.float()
    m_new = torch.maximum(log_f + m, i_raw)
    f_s = torch.exp(log_f + m - m_new)
    i_s = torch.exp(i_raw - m_new)
    C.mul_(f_s[..., None, None])
    C.view(B * H, w, dv).baddbmm_((i_s[..., None] * k).view(B * H, w, 1),
                                  v.reshape(B * H, 1, dv))
    n.mul_(f_s[..., None]).add_(i_s[..., None] * k)
    m.copy_(m_new)
    num = torch.bmm(q.view(B * H, 1, w), C.view(B * H, w, dv)).view(B, H, dv)
    return num, (q * n).sum(-1), m_new


class XLSTM(ModelAxis, nn.Module):
    """48-block stack: one sLSTM block per ``slstm_every``, the rest mLSTM."""

    #: a ``model`` axis above 1 runs tensor-parallel (``train.step`` and the
    #: dry-run read this)
    tensor_parallel = True

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
        self._init_model_axis(mesh)

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
        emb_spec, head_spec = vocab_specs(cfg.vocab, cfg.d_model, self.model_axis)
        return {
            "embed": PM.ParamInfo((cfg.vocab, cfg.d_model), emb_spec, scale=0.02),
            "groups": PM.stack(
                groups,
                {"mlstm": PM.stack(every - 1, self.mlstm_layout()), "slstm": self.slstm_layout()},
            ),
            "final_ln": PM.ParamInfo((cfg.d_model,), P(None), "ones"),
            "lm_head": PM.ParamInfo((cfg.d_model, cfg.vocab), head_spec, scale=0.02),
        }

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
        """q, k (B, H, S, dqk), v (B, H, S, dv), i_raw and log_f (B, H, S) of
        every head.  Over a ``model`` axis the five row-parallel products of
        this rank's channels are summed in one all-reduce, side by side, and
        the biases added; the ranks then read parts of the whole, so its
        backward sums their gradients."""
        B, S, _ = xc.shape
        H = self.H
        if self.tp == 1:
            q, k, v = xc @ p["wq"], xc @ p["wk"], xv @ p["wv"]
            i_raw, f_pre = xc @ p["w_i"] + p["b_i"], xc @ p["w_f"] + p["b_f"]
        else:
            mesh = self.tp_mesh
            parts = [xc @ p["wq"], xc @ p["wk"], xv @ p["wv"], xc @ p["w_i"], xc @ p["w_f"]]
            widths = [t.shape[-1] for t in parts]
            bias = torch.cat([p["b_i"].new_zeros(sum(widths[:3])), p["b_i"], p["b_f"]])
            whole = reduce_from_region(torch.cat(parts, -1), mesh) + bias
            q, k, v, i_raw, f_pre = copy_to_region(whole, mesh).split(widths, -1)
        q = q.view(B, S, H, self.dqk).transpose(1, 2)
        k = k.view(B, S, H, self.dqk).transpose(1, 2)
        v = v.view(B, S, H, self.dv).transpose(1, 2)
        return q, k, v, i_raw.transpose(1, 2), F.logsigmoid(f_pre).transpose(1, 2)

    def _mlstm_out(self, p, hh, z, local: bool):
        """``w_down`` of ``out_ln(hh) * silu(z)``: hh (B, S, ed), or over a
        ``model`` axis the channels of the heads this rank scanned (its own
        with ``local``, else every head's).  The RMS is taken over the whole
        row with the gamma gathered; this rank's columns feed the
        row-parallel ``w_down``, summed over the axis."""
        eps = self.cfg.norm_eps
        if self.tp == 1:
            return (rms_norm(hh, p["out_ln"], eps) * F.silu(z)) @ p["w_down"]
        mesh = self.tp_mesh
        if local:
            hh = gather_from_region(hh, mesh, -1, partial=True)
        (gamma,) = self._gather_whole((p["out_ln"], 0))
        hh = self._own_columns(rms_norm(hh, gamma, eps), self.ed // self.tp)
        return reduce_from_region((hh * F.silu(z)) @ p["w_down"], mesh)

    def _mlstm_block(self, p, x):
        cfg = self.cfg
        B, S, _ = x.shape
        h = copy_to_region(rms_norm(x, p["ln"], cfg.norm_eps), self.tp_mesh)
        x_in, z = self._split_halves(h @ p["w_up"], self.ed)
        xc = F.silu(causal_conv(x_in, p["conv"]))
        q, k, v, i_raw, log_f = self._mlstm_qkvif(p, xc, x_in)
        lo, hi, local = self._head_span(self.H)
        if hi - lo < self.H:
            q, k, v, i_raw, log_f = (t[:, lo:hi] for t in (q, k, v, i_raw, log_f))
        hh = ops.mlstm_scan(q, k, v, i_raw, log_f, chunk=cfg.ssm.chunk)
        hh = hh.transpose(1, 2).reshape(B, S, -1).to(x.dtype)
        return x + self._mlstm_out(p, hh, z, local)

    def _slstm_cell(self, p):
        """``w_gates``, ``b_gates`` and ``r_gates`` whole: over a ``model``
        axis, every rank's dh of each gathered in one all-gather."""
        if self.tp == 1:
            return p["w_gates"], p["b_gates"], p["r_gates"]
        return self._gather_whole((p["w_gates"], 2), (p["b_gates"], 1), (p["r_gates"], 1))

    def _slstm_block(self, p, x):
        cfg, mesh = self.cfg, self.tp_mesh
        B, S, D = x.shape
        sh, dh = self.sh, self.sdh
        w_gates, b_gates, r_gates = self._slstm_cell(p)
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        # input-driven gate preactivations; the recurrent term (depends on
        # h_{t-1}) is added inside the loop
        gates = (h.float() @ w_gates.float().reshape(D, -1)).view(B, S, sh, dh, 4) \
            + b_gates.float()
        r = r_gates.float().reshape(sh, dh, dh * 4)
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
        y = copy_to_region(rms_norm(hh, p["out_ln"], cfg.norm_eps), mesh) @ p["w_out"]
        x = x + gather_from_region(y, mesh, -1)
        # post-FFN (xLSTM sLSTM blocks carry a ~4/3 gated projection)
        h = copy_to_region(rms_norm(x, p["ffn_ln"], cfg.norm_eps), mesh)
        return x + reduce_from_region(swiglu(h, p["ffn_gate"], p["ffn_up"], p["ffn_down"]), mesh)

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
        self._check_tp()
        x = self.embed(params, batch["tokens"])
        h = self.backbone(params, x)
        nll = self._nll(params, h, batch["labels"].long())
        return nll, {"nll": nll, "aux": torch.zeros((), dtype=torch.float32, device=x.device)}

    @torch.no_grad()
    def prefill(self, params, batch):
        """Full-sequence forward returning the last position's fp32 logits (B, 1, vocab)."""
        self._check_tp()
        x = self.embed(params, batch["tokens"])
        h = self.backbone(params, x)
        return self._serve_logits(params, h[:, -1:])

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
        """A zero cache; over a ``model`` axis above 1, this rank's shard of it."""
        return self._zero_cache(self.cache_layout(batch, seq))

    def _mlstm_decode_block(self, p, x, st):
        cfg = self.cfg
        B = x.shape[0]
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        x_in, z = self._split_halves(h @ p["w_up"], self.ed)        # (B, 1, ed / tp)
        conv_in = torch.cat([st["conv"], x_in], dim=1)
        st["conv"].copy_(conv_in[:, 1:])
        W = p["conv"].shape[0]
        xc = F.silu(sum(conv_in[:, i:i + 1] * p["conv"][i] for i in range(W)))
        q, k, v, i_raw, log_f = (t[:, :, 0] for t in self._mlstm_qkvif(p, xc, x_in))
        state = (st["C"], st["n"], st["m"])
        if self.tp == 1:
            hh, _ = mlstm_decode(q, k, v, i_raw, log_f, state)
        else:
            w = self.dqk // self.tp
            mine = slice(self.tp_rank * w, (self.tp_rank + 1) * w)
            num, qn, m_new = mlstm_decode_partial(q[..., mine], k[..., mine], v, i_raw, log_f,
                                                  state, dqk=self.dqk)
            total = total_fp32(torch.cat([num, qn[..., None]], -1), self.tp_mesh, TP)
            den = torch.maximum(total[..., -1].abs(), torch.exp(-m_new))
            hh = total[..., :-1] / den[..., None]
        hh = hh.reshape(B, 1, self.ed).to(x.dtype)
        return x + self._mlstm_out(p, hh, z, local=False)

    def _slstm_decode_block(self, p, x, st):
        cfg, mesh = self.cfg, self.tp_mesh
        B, _, D = x.shape
        sh, dh = self.sh, self.sdh
        w = dh // self.tp                                               # this rank's dh
        h = rms_norm(x, p["ln"], cfg.norm_eps)[:, 0]
        g = (h.float() @ p["w_gates"].float().reshape(D, -1)).view(B, sh, w, 4) \
            + p["b_gates"].float()
        r = p["r_gates"].float().reshape(sh, w, dh * 4)
        rec = torch.bmm(st["h"].transpose(0, 1), r).transpose(0, 1)
        if self.tp == 1:
            g = g + rec.view(B, sh, dh, 4)
        else:
            # this rank's input rows: a partial sum over every output, summed once
            rec = total_fp32(rec, mesh, TP).view(B, sh, dh, 4)
            g = g + rec[:, :, self.tp_rank * w:(self.tp_rank + 1) * w]
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
        if self.tp > 1:
            (h_new,) = self._gather_columns(h_new)                      # (B, sh, dh)
        y = rms_norm(h_new.reshape(B, 1, D).to(x.dtype), p["out_ln"], cfg.norm_eps) @ p["w_out"]
        x = x + gather_from_region(y, mesh, -1)
        hf = rms_norm(x, p["ffn_ln"], cfg.norm_eps)
        return x + reduce_from_region(swiglu(hf, p["ffn_gate"], p["ffn_up"], p["ffn_down"]), mesh)

    @torch.no_grad()
    def decode_step(self, params, batch):
        """One new token given the recurrent state.

        batch: ``tokens`` (B, 1) integer tensor and ``cache`` from
        :meth:`init_cache` (an ``index`` is not needed).  Returns ``(logits
        (B, 1, vocab) fp32, cache)``; the cache is updated in place.  Over a
        ``model`` axis the cache is this rank's shard (the module's docstring)
        and the logits are whole.
        """
        self._check_tp()
        x = self.embed(params, batch["tokens"])
        mc, sc = batch["cache"]["groups"]["mlstm"], batch["cache"]["groups"]["slstm"]
        for g, (mlstm, slstm) in enumerate(self._group_params(params)):
            for j, p in enumerate(mlstm):
                x = self._mlstm_decode_block(p, x, {n: t[g, j] for n, t in mc.items()})
            x = self._slstm_decode_block(slstm, x, {n: t[g] for n, t in sc.items()})
        h = rms_norm(x, params["final_ln"], self.cfg.norm_eps)
        return self._serve_logits(params, h), batch["cache"]
