"""AdamW with an fp32 master copy, and int8 gradient compression.

The port of ``repro.train.optimizer`` without its ZeRO sharding specs,
which wait for the multi-device slice.  The arithmetic is the JAX update's,
in the same order: global-norm clip in fp32, bias-corrected moments,
decoupled weight decay, the new master cast to the parameter's dtype.  The
schedule, the clip scale and the bias corrections stay 0-d tensors on the
device, so an update never waits for the host.

Where JAX returns new trees, :func:`adamw_update` updates the parameters and
the state IN PLACE and returns the same objects: at qwen1.5-0.5b's width the
fp32 state is 5.6 GB, and a second copy of it would double that.  It also
takes a large leaf in slices of :data:`UPDATE_SLICE` elements: the update's
fp32 temporaries (about a dozen the size of what is updated at once) would
otherwise set the step's peak memory, 13.6 GiB above the state at
xlstm-1.3b's 704 M-element stacked leaves.  Each element's arithmetic is the
same either way.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import params as PM


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    master_fp32: bool = True


#: elements of a leaf updated at a time (256 MiB of fp32 a temporary)
UPDATE_SLICE = 1 << 26


def _slices(*leaves):
    """The leaves (None stays None) as matching flat slices of at most
    :data:`UPDATE_SLICE` elements each, or whole where one is not contiguous."""
    if not all(t is None or t.is_contiguous() for t in leaves):
        return [leaves]
    n = leaves[0].numel()
    flat = [None if t is None else t.view(-1) for t in leaves]
    return [[None if t is None else t[i:i + UPDATE_SLICE] for t in flat]
            for i in range(0, n, UPDATE_SLICE)] or [leaves]


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``; ``step`` is the int32 count before the update."""
    warm = torch.clamp((step + 1).float() / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """fp32 ``mu``, ``nu`` (and ``master``, a copy of the params) and an int32 ``count``."""
    device = PM.tree_leaves(params)[0].device
    state = {
        "mu": PM.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
        "nu": PM.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_fp32:
        state["master"] = PM.tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step, in place; returns ``(params, state, {"grad_norm", "lr"})``.

    ``grads`` and ``params`` are trees of one structure; leaves are visited in
    sorted-key order, as ``jax.tree.leaves`` visits them.  The update runs in
    a profiler range of its own name, which ``launch/trace.py`` groups by.
    """
    with torch.profiler.record_function("adamw_update"):
        return _adamw_update(grads, state, params, cfg)


def _adamw_update(grads, state, params, cfg: AdamWConfig):
    lr = _schedule(cfg, state["count"])
    state["count"].add_(1)
    count = state["count"].float()

    flat_g = PM.tree_leaves(grads)
    gsq = sum(g.float().square().sum() for g in flat_g)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1c = 1 - cfg.b1 ** count
    b2c = 1 - cfg.b2 ** count

    flat_p = PM.tree_leaves(params)
    flat_ms = PM.tree_leaves(state["master"]) if "master" in state else [None] * len(flat_p)
    for leaf in zip(flat_p, flat_g, PM.tree_leaves(state["mu"]), PM.tree_leaves(state["nu"]),
                    flat_ms):
        for p, g, mu, nu, master in _slices(*leaf):
            g = g.float() * scale
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            base = master if master is not None else p.float()
            step = mu / b1c / (torch.sqrt(nu / b2c) + cfg.eps) + cfg.weight_decay * base
            new = base - lr * step
            if master is not None:
                master.copy_(new)
            p.copy_(new)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def compress_int8(g, error):
    """Error-feedback int8 quantisation: returns ``(q, scale, new_error)``."""
    gf = g.float() + error
    scale = torch.clamp(gf.abs().max(), min=1e-9) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_error = gf - q.float() * scale
    return q, scale, new_error


def decompress_int8(q, scale):
    return q.float() * scale
