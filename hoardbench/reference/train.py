"""The reference's training steps: :class:`~.model.Reference`'s gradients and
AdamW, in float32 (TF32 off), followed for the first steps of a run.

AdamW as the optimizer's paper (Loshchilov and Hutter) and the configuration
of the run give it: the gradient clipped to a global norm of ``grad_clip``;
moments ``b1``, ``b2`` with bias correction; decoupled weight decay on every
leaf; the learning rate warmed up linearly, ``lr * min(1, t / warmup_steps)``
at step ``t`` (1-based).  A leaf is updated in slices of :data:`SLICE`
elements, so the temporaries stay small beside the state.
"""

from __future__ import annotations

import torch

from .model import Reference, leaves

#: elements of a leaf updated at a time
SLICE = 1 << 25


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


class AdamW:
    def __init__(self, opt: dict):
        self.o = opt
        self.t = 0

    def step(self, params: list, grads: list, mu: list, nu: list) -> float:
        """One update in place; returns the clip scale it applied."""
        o = self.o
        self.t += 1
        t = self.t
        gnorm = sum(_norm(g) ** 2 for g in grads) ** 0.5
        scale = min(1.0, o["grad_clip"] / max(gnorm, 1e-9))
        lr = o["lr"] * min(1.0, t / max(1, o["warmup_steps"]))
        b1, b2 = o["b1"], o["b2"]
        b1c, b2c = 1 - b1 ** t, 1 - b2 ** t
        for p, g, m, v in zip(params, grads, mu, nu):
            for sl in _slices(p.numel()):
                ps, gs, ms, vs = (x.view(-1)[sl] for x in (p, g, m, v))
                gs = gs * scale
                ms.mul_(b1).add_(gs, alpha=1 - b1)
                vs.mul_(b2).addcmul_(gs, gs, value=1 - b2)
                upd = (ms / b1c) / ((vs / b2c).sqrt_() + o["eps"]) + o["weight_decay"] * ps
                ps.sub_(lr * upd)
        return scale


def _diff_norm(host, g, scale: float) -> float:
    """``||host - g * scale||``, ``host`` on the host, slice by slice on ``g``'s device."""
    total = 0.0
    for sl in _slices(g.numel()):
        part = host.reshape(-1)[sl].to(g.device) - g.reshape(-1)[sl] * scale
        total += _norm(part) ** 2
    return total ** 0.5


def _slices(n: int):
    return [slice(i, i + SLICE) for i in range(0, n, SLICE)] or [slice(0, 0)]


def follow(cfg: dict, params: dict, batches, opt: dict, precision: str = "fp32",
           keep_grads: bool = False, compare_to: dict = None) -> dict:
    """Run the reference's first ``len(batches)`` training steps from
    ``params`` (float32 tensors, updated in place) on ``batches`` (``(tokens,
    labels)`` int64 tensors on the parameters' device).

    Returns each step's ``losses``, the leaf norms of the first gradient
    before (``grad_raw``) and after the clip (``grad``), both by dotted leaf
    name, with ``keep_grads`` the first gradient after the clip itself, leaf
    by leaf on the host (``grad_tensors``), and with ``compare_to`` (such
    host tensors by leaf name) the norm of each leaf's difference from it
    (``grad_diff_norms``).  The parameters are left as the last step made
    them.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(cfg, precision)
        names = [n for n, _ in leaves(params)]
        flat = [t for _, t in leaves(params)]
        mu = [torch.zeros_like(t) for t in flat]
        nu = [torch.zeros_like(t) for t in flat]
        adamw = AdamW(opt)
        out: dict = {"losses": []}
        for i, (tokens, labels) in enumerate(batches):
            gtree = _zeros_like_tree(params)
            loss, _, _ = ref.grads(params, tokens, labels, gtree)
            out["losses"].append(loss)
            grads = [g for _, g in leaves(gtree)]
            if i == 0:
                out["grad_raw"] = {n: _norm(g) for n, g in zip(names, grads)}
            scale = adamw.step(flat, grads, mu, nu)
            if i == 0:
                out["grad"] = {n: v * scale for n, v in out["grad_raw"].items()}
                if keep_grads:
                    out["grad_tensors"] = {n: g.to("cpu", copy=True).mul_(scale)
                                           for n, g in zip(names, grads)}
                if compare_to is not None:
                    out["grad_diff_norms"] = {n: _diff_norm(compare_to[n], g, scale)
                                              for n, g in zip(names, grads)}
            del gtree, grads
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _zeros_like_tree(tree: dict) -> dict:
    return {k: _zeros_like_tree(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}
