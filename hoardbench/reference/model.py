"""The plain reference: a decoder LM's loss and gradients in float32 PyTorch.

Written from the configuration file's keys (Hugging Face names) and nothing
of the program: the embedding; per layer an RMSNorm, causal attention (GQA,
or DeepSeek-V2's multi-head latent attention: q without a low-rank path, the
latent ``c_kv`` normed, keys of ``qk_nope`` channels from it beside one
shared rope key), a residual, an RMSNorm and the MLP (SwiGLU, or routed
experts with shared ones); a final RMSNorm and the output head; the mean
next-token cross-entropy plus ``aux_loss_coef`` times the experts'
load-balancing loss.  Departures from the published models, each named in
the configuration file under ``reduced`` or ``assumed``: RoPE on every
channel of a head (on MLA's rope channels), rotated as two halves, and
unscaled (a ``rope_scaling`` group only as YaRN at factor 1, whose
frequencies and score scale are plain RoPE's); an
untied output head; the top-k router probabilities renormalised; capacity
``ceil(N k / E * capacity_factor)`` slots an expert, filled token-major, the
pairs past it dropped; a Switch-style balancing loss over the batch.

Parameters are a nested dict whose leaves stack the layers on a leading
axis (``layers.attn.wq`` is ``(L, D, H hd)``), the tree the program takes.
:meth:`Reference.grads` runs the forward without autograd, keeping each
layer's input, and then the backward layer by layer, recomputing one layer
at a time under autograd and writing its gradients into the stacked leaves:
the memory is the parameters, their gradients and one layer's activations
(the head's, a block of vocabulary columns at a time).

``precision="fp8"`` is the control: every product computed in float8 e4m3,
forward and backward: its operands, and in the backward the gradient that
enters its two products, each rounded with one scale a tensor (its largest
magnitude to 448), the products summed in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: vocabulary columns of the output head taken at a time
HEAD_COLUMNS = 16384
#: the largest magnitude of float8 e4m3
FP8_MAX = 448.0
#: elements rounded to float8 at a time
FP8_SLICE = 1 << 24


def dims(cfg: dict) -> dict:
    """The sizes the reference reads from a configuration file."""
    assumed = cfg.get("assumed", {})
    d = {
        "D": cfg["hidden_size"], "H": cfg["num_attention_heads"],
        "Hkv": cfg["num_key_value_heads"], "V": cfg["vocab_size"],
        "L": cfg["num_hidden_layers"], "eps": cfg["rms_norm_eps"],
        "theta": float(cfg["rope_theta"]), "F": cfg["intermediate_size"],
        "mla": "kv_lora_rank" in cfg, "moe": "n_routed_experts" in cfg,
    }
    if cfg.get("tie_word_embeddings"):
        raise ValueError("the reference holds an untied output head")
    scaling = cfg.get("rope_scaling")
    if scaling is not None and (scaling.get("type"), scaling.get("factor")) != ("yarn", 1):
        raise ValueError("the reference applies plain RoPE: no rope_scaling, or YaRN at factor 1")
    if d["mla"]:
        d.update(r=cfg["kv_lora_rank"], dn=cfg["qk_nope_head_dim"], dr=cfg["qk_rope_head_dim"],
                 dv=cfg["v_head_dim"])
    else:
        d["hd"] = assumed.get("head_dim", d["D"] // d["H"])
    if d["moe"]:
        d.update(E=cfg["n_routed_experts"], k=cfg["num_experts_per_tok"],
                 Fe=cfg["moe_intermediate_size"], n_shared=cfg["n_shared_experts"],
                 n_dense=cfg["first_k_dense_replace"], cf=assumed["capacity_factor"],
                 aux_coef=assumed["aux_loss_coef"])
        if d["n_dense"] > 1:
            raise ValueError("the reference holds at most one leading dense layer")
    return d


def _leaf(shape, init="normal", std=None):
    """``(shape, init, std)``: normal at ``std`` (default ``fan_in ** -0.5``,
    fan-in the second-last dimension), or ``ones``."""
    if init == "normal" and std is None:
        std = shape[-2] ** -0.5
    return (tuple(shape), init, std)


def _stack(n: int, tree: dict) -> dict:
    return {k: _stack(n, v) if isinstance(v, dict) else ((n, *v[0]), v[1], v[2])
            for k, v in tree.items()}


def layout(cfg: dict) -> dict:
    """The parameter tree as ``(shape, init, std)`` leaves."""
    d = dims(cfg)
    D, H = d["D"], d["H"]
    if d["mla"]:
        attn = {"ln": _leaf((D,), "ones"), "wq": _leaf((D, H * (d["dn"] + d["dr"]))),
                "w_dkv": _leaf((D, d["r"] + d["dr"])), "kv_ln": _leaf((d["r"],), "ones"),
                "w_uk": _leaf((d["r"], H * d["dn"])), "w_uv": _leaf((d["r"], H * d["dv"])),
                "wo": _leaf((H * d["dv"], D))}
    else:
        hd, Hkv = d["hd"], d["Hkv"]
        attn = {"ln": _leaf((D,), "ones"), "wq": _leaf((D, H * hd)),
                "wk": _leaf((D, Hkv * hd)), "wv": _leaf((D, Hkv * hd)),
                "wo": _leaf((H * hd, D))}
    dense = {"ln": _leaf((D,), "ones"), "w_gate": _leaf((D, d["F"])),
             "w_up": _leaf((D, d["F"])), "w_down": _leaf((d["F"], D))}
    tree = {"embed": _leaf((d["V"], D), std=0.02), "final_ln": _leaf((D,), "ones"),
            "lm_head": _leaf((D, d["V"]), std=0.02)}
    if not d["moe"]:
        tree["layers"] = _stack(d["L"], {"attn": attn, "mlp": dense})
        return tree
    E, Fe, S = d["E"], d["Fe"], d["n_shared"] * d["Fe"]
    moe = {"ln": _leaf((D,), "ones"), "router": _leaf((D, E), std=0.02),
           "w_gate": _leaf((E, D, Fe)), "w_up": _leaf((E, D, Fe)), "w_down": _leaf((E, Fe, D))}
    if S:
        moe.update(shared_gate=_leaf((D, S)), shared_up=_leaf((D, S)), shared_down=_leaf((S, D)))
    if d["n_dense"]:
        tree["layer0"] = {"attn": attn, "mlp": dense}
    tree["layers"] = _stack(d["L"] - d["n_dense"], {"attn": attn, "mlp": moe})
    return tree


def leaves(tree: dict, prefix: str = "") -> list:
    """``(dotted name, leaf)`` pairs in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def tree_from(names_values: dict) -> dict:
    """A nested dict from ``{dotted name: value}``."""
    tree: dict = {}
    for name, v in names_values.items():
        *path, last = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _fp8(x, amax=None):
    """``x`` rounded to float8 e4m3 at one scale (``amax``, the largest
    magnitude of the tensor it is part of, or ``x``'s own, to 448), back in
    ``x``'s type; slice by slice, so that the only copy of ``x``'s size is the
    result."""
    if amax is None:
        lo, hi = torch.aminmax(x.detach())
        amax = torch.maximum(hi.abs(), lo.abs())
    s = amax.clamp_min(1e-30) / FP8_MAX
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    flat, dst = x.detach().reshape(-1), out.view(-1)
    for i in range(0, flat.numel(), FP8_SLICE):
        dst[i:i + FP8_SLICE] = (flat[i:i + FP8_SLICE] / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return out


class _FP8MatMul(torch.autograd.Function):
    """``a @ b`` with both operands in e4m3, and in the backward the output's
    gradient in e4m3 too, before each of its two products; ``b`` is a matrix
    or batched as ``a``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)            # rounded again in the backward: no copies kept
        return torch.matmul(_fp8(a), _fp8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        qa, qb, qg = _fp8(a), _fp8(b), _fp8(g)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            db = torch.matmul(qa.transpose(-1, -2), qg)
        return da, db


class Reference:
    """The loss and gradients of the configuration ``cfg`` (a configuration
    file's dict) in float32, or with every product's operands in float8
    (``precision="fp8"``, the control)."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"no reference precision {precision!r}")
        self.d = dims(cfg)
        self.fp8 = precision == "fp8"

    # ------------------------------------------------------------ pieces
    def mm(self, a, b):
        return _FP8MatMul.apply(a, b) if self.fp8 else torch.matmul(a, b)

    def norm(self, x, gamma):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.d["eps"]) * gamma

    def rope(self, x, pos):
        half = x.shape[-1] // 2
        freqs = self.d["theta"] ** (-torch.arange(half, dtype=torch.float32,
                                                  device=x.device) / half)
        ang = pos[:, None].float() * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attend(self, q, k, v):
        """Causal softmax attention, one batch row at a time.  q (B, H, S, dq);
        k (B, Hkv, S, dq); v (B, Hkv, S, dv); a query head reads kv head
        ``h // (H / Hkv)``."""
        B, H, S, dq = q.shape
        G = H // k.shape[1]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        out = []
        for b in range(B):
            kb = k[b].repeat_interleave(G, 0)
            vb = v[b].repeat_interleave(G, 0)
            s = self.mm(q[b], kb.transpose(-1, -2)) * dq ** -0.5
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
            out.append(self.mm(p, vb))
        return torch.stack(out)

    def attention(self, p, x, pos):
        d = self.d
        B, S, D = x.shape
        H = d["H"]
        h = self.norm(x, p["ln"])
        if d["mla"]:
            dn, dr, r = d["dn"], d["dr"], d["r"]
            q = self.mm(h, p["wq"]).view(B, S, H, dn + dr).transpose(1, 2)
            lat = self.mm(h, p["w_dkv"])
            c_kv = self.norm(lat[..., :r], p["kv_ln"])
            k_rope = self.rope(lat[..., r:][:, None], pos)                  # (B, 1, S, dr)
            k_nope = self.mm(c_kv, p["w_uk"]).view(B, S, H, dn).transpose(1, 2)
            v = self.mm(c_kv, p["w_uv"]).view(B, S, H, d["dv"]).transpose(1, 2)
            q = torch.cat([q[..., :dn], self.rope(q[..., dn:], pos)], -1)
            k = torch.cat([k_nope, k_rope.expand(B, H, S, dr)], -1)
        else:
            hd, Hkv = d["hd"], d["Hkv"]
            q = self.rope(self.mm(h, p["wq"]).view(B, S, H, hd).transpose(1, 2), pos)
            k = self.rope(self.mm(h, p["wk"]).view(B, S, Hkv, hd).transpose(1, 2), pos)
            v = self.mm(h, p["wv"]).view(B, S, Hkv, hd).transpose(1, 2)
        o = self.attend(q, k, v)
        return x + self.mm(o.transpose(1, 2).reshape(B, S, -1), p["wo"])

    def swiglu(self, h, wg, wu, wd):
        return self.mm(F.silu(self.mm(h, wg)) * self.mm(h, wu), wd)

    def experts(self, p, h):
        """Routed experts (with the shared ones) on the rows ``h`` (N, D):
        ``(output, balancing loss)``."""
        d = self.d
        N = h.shape[0]
        E, k = d["E"], d["k"]
        probs = torch.softmax(self.mm(h, p["router"]), -1)
        top, idx = probs.sort(dim=-1, descending=True, stable=True)
        gates, idx = top[:, :k], idx[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        cap = max(1, math.ceil(N * k / E * d["cf"]))
        onehot = F.one_hot(idx.reshape(-1), E)                               # (N k, E)
        slot = ((onehot.cumsum(0) - onehot) * onehot).sum(-1).view(N, k)
        keep = slot < cap
        y = torch.zeros_like(h)
        for e in range(E):
            rows, kk = torch.nonzero((idx == e) & keep, as_tuple=True)
            if rows.numel():
                ye = self.swiglu(h[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
                y = y.index_add(0, rows, ye * gates[rows, kk][:, None])
        if "shared_gate" in p:
            y = y + self.swiglu(h, p["shared_gate"], p["shared_up"], p["shared_down"])
        counts = onehot.view(N, k, E).sum(1).float()
        aux = E * (probs.mean(0) * (counts.mean(0) / k)).sum()
        return y, aux

    def layer(self, p, x, pos, moe: bool):
        """One block: ``(output, balancing loss or None)``."""
        x = self.attention(p["attn"], x, pos)
        m = p["mlp"]
        h = self.norm(x, m["ln"])
        if not moe:
            return x + self.swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), None
        y, aux = self.experts(m, h.reshape(-1, h.shape[-1]))
        return x + y.view(x.shape), aux

    # ------------------------------------------------------------ blocks
    def _blocks(self, params):
        """``(params of the block, its gradient tree or None, moe)`` per block in order;
        stacked blocks as views of the stacked leaves."""
        out = []
        if "layer0" in params:
            out.append((params["layer0"], ("layer0", None), False))
        n = params["layers"]["attn"]["ln"].shape[0]
        for i in range(n):
            out.append((_index(params["layers"], i), ("layers", i), self.d["moe"]))
        return out

    def _q(self, x, amax=None):
        """An operand of a product as this precision takes it."""
        return _fp8(x, amax) if self.fp8 else x

    def _head(self, params, x, labels, grads):
        """The final norm, the head and the mean cross-entropy of ``x`` (B, S, D):
        ``(nll, dx)``.  The head is taken :data:`HEAD_COLUMNS` vocabulary
        columns at a time, its gradient written out by hand (softmax less the
        one-hot, over the rows): the logits of a whole vocabulary are never
        held.  The head's and the norm's gradients go into ``grads``, and
        ``dx`` is the loss's gradient at ``x``."""
        N = labels.numel()
        W = params["lm_head"]
        V = W.shape[1]
        y = labels.reshape(-1)
        amax = W.abs().amax() if self.fp8 else None
        xl = x.detach().requires_grad_()
        gl = params["final_ln"].detach().requires_grad_()
        with torch.enable_grad():
            h = self.norm(xl, gl)
        hd = h.detach().reshape(N, -1)
        qh = self._q(hd)
        top = torch.full((N,), float("-inf"), device=x.device)
        acc = torch.zeros(N, device=x.device)
        gold = torch.zeros(N, device=x.device)
        for c in range(0, V, HEAD_COLUMNS):
            z = qh @ self._q(W[:, c:c + HEAD_COLUMNS], amax)
            new_top = torch.maximum(top, z.amax(-1))
            acc = acc * torch.exp(top - new_top) + torch.exp(z - new_top[:, None]).sum(-1)
            top = new_top
            mine = (y >= c) & (y < c + z.shape[1])
            gold = torch.where(mine, z.gather(-1, (y - c).clamp(0, z.shape[1] - 1)[:, None])[:, 0],
                               gold)
        lse = top + torch.log(acc)
        nll = float((lse - gold).mean())
        dh = torch.zeros_like(hd)
        gW = grads["lm_head"]
        rows = torch.arange(N, device=x.device)
        for c in range(0, V, HEAD_COLUMNS):
            Wb = self._q(W[:, c:c + HEAD_COLUMNS], amax)
            g = torch.exp(qh @ Wb - lse[:, None])
            mine = (y >= c) & (y < c + g.shape[1])
            g[rows[mine], y[mine] - c] -= 1.0
            g = self._q(g / N)
            gW[:, c:c + HEAD_COLUMNS] = qh.T @ g
            dh += g @ Wb.T
        with torch.enable_grad():
            dx, dg = torch.autograd.grad(h, [xl, gl], grad_outputs=dh.view_as(h))
        grads["final_ln"].copy_(dg)
        return nll, dx

    def grads(self, params, tokens, labels, grads) -> tuple[float, float, float]:
        """Write the gradient of the loss at ``params`` into ``grads`` (a tree of
        zeroed tensors shaped as ``params``); return ``(loss, nll, aux)``."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        blocks = self._blocks(params)
        inputs, aux = [], 0.0
        with torch.no_grad():
            x = params["embed"][tokens]
            for p, _, moe in blocks:
                inputs.append(x)
                x, a = self.layer(p, x, pos, moe)
                if a is not None:
                    aux += float(a)
        nll, dx = self._head(params, x, labels, grads)
        coef = self.d.get("aux_coef", 0.0)
        for (p, (where, i), moe), x_in in zip(reversed(blocks), reversed(inputs)):
            names = [n for n, _ in leaves(p)]
            flat = [t.detach().requires_grad_() for _, t in leaves(p)]
            xi = x_in.detach().requires_grad_()
            with torch.enable_grad():
                out, a = self.layer(tree_from(dict(zip(names, flat))), xi, pos, moe)
                outs, gouts = [out], [dx]
                if a is not None:
                    outs.append(a)
                    gouts.append(torch.tensor(coef, device=a.device))
                g = torch.autograd.grad(outs, [xi, *flat], grad_outputs=gouts)
            dx = g[0]
            target = dict(leaves(grads[where]))
            for n, gi in zip(names, g[1:]):
                (target[n] if i is None else target[n][i]).copy_(gi)
            del out, a, outs, g
        grads["embed"].index_add_(0, tokens.reshape(-1), dx.reshape(-1, dx.shape[-1]))
        return nll + coef * aux, nll, aux


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
