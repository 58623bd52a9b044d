"""AdamW with an fp32 master copy, ZeRO-1 state sharding and int8 gradient
compression.

The port of ``repro.train.optimizer``.  The arithmetic is the JAX update's,
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

ZeRO-1: :func:`opt_state_specs` adds the ``data`` axis to the first
unsharded, divisible dimension of each leaf's spec (JAX's rule,
:func:`zero_spec_for`).  Where JAX leaves the split to pjit, the port does it
by hand: :func:`init_zero_state` keeps only this rank's shard of ``master``,
``mu`` and ``nu``, each a contiguous tensor of its own;
:func:`zero_update_shards` updates the shards from the full synced
gradient with :func:`adamw_update`'s own per-element arithmetic (the clip
scale from the whole gradient, so the same on every rank), and
:func:`gather_params` gathers the new parameter shards over ``data``, so
that every rank holds the same parameters, bit for bit those
:func:`adamw_update` gives on the whole leaves.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..launch.mesh import NamedSharding
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


def abstract_opt_state(layout, cfg: AdamWConfig) -> dict:
    """:func:`init_opt_state`'s structure on the meta device, from a layout
    (JAX's ``abstract_opt_state``): fp32 ``mu``, ``nu`` (and ``master``) and an
    int32 ``count``, no storage."""
    f32 = lambda i: torch.empty(i.shape, dtype=torch.float32, device="meta")  # noqa: E731
    state = {"mu": PM.tree_map(f32, layout), "nu": PM.tree_map(f32, layout),
             "count": torch.empty((), dtype=torch.int32, device="meta")}
    if cfg.master_fp32:
        state["master"] = PM.tree_map(f32, layout)
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


def _step_scalars(grads, state, cfg: AdamWConfig) -> dict:
    """Advance ``count``; the step's lr, global-norm clip scale (fp32, over
    every leaf of ``grads``) and bias corrections, as 0-d device tensors."""
    lr = _schedule(cfg, state["count"])
    state["count"].add_(1)
    count = state["count"].float()
    gsq = sum(g.float().square().sum() for g in PM.tree_leaves(grads))
    gnorm = torch.sqrt(gsq)
    return {"lr": lr, "gnorm": gnorm,
            "scale": torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0),
            "b1c": 1 - cfg.b1 ** count, "b2c": 1 - cfg.b2 ** count}


def _update_leaf(p, g, mu, nu, master, k: dict, cfg: AdamWConfig) -> None:
    """One leaf's (or one shard's) AdamW update in place, slice by slice."""
    for p, g, mu, nu, master in _slices(p, g, mu, nu, master):
        g = g.float() * k["scale"]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        base = master if master is not None else p.float()
        step = mu / k["b1c"] / (torch.sqrt(nu / k["b2c"]) + cfg.eps) + cfg.weight_decay * base
        new = base - k["lr"] * step
        if master is not None:
            master.copy_(new)
        p.copy_(new)


def _masters(state, n: int) -> list:
    return PM.tree_leaves(state["master"]) if "master" in state else [None] * n


def _adamw_update(grads, state, params, cfg: AdamWConfig):
    k = _step_scalars(grads, state, cfg)
    flat_p = PM.tree_leaves(params)
    for leaf in zip(flat_p, PM.tree_leaves(grads), PM.tree_leaves(state["mu"]),
                    PM.tree_leaves(state["nu"]), _masters(state, len(flat_p))):
        _update_leaf(*leaf, k, cfg)
    return params, state, {"grad_norm": k["gnorm"], "lr": k["lr"]}


# ------------------------------------------------------------- ZeRO specs
def zero_spec_for(param_spec: tuple, shape: tuple[int, ...], data_size: int,
                  axis: str = "data") -> tuple:
    """Add the ``data`` axis to the first unsharded, divisible dimension."""
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (e, s) in enumerate(zip(entries, shape)):
        if e is None and data_size > 0 and s % data_size == 0 and s >= data_size:
            entries[i] = axis
            return PM.P(*entries)
    return PM.P(*entries)


def opt_state_specs(layout, mesh, cfg: AdamWConfig, axis: str = "data") -> dict:
    """Sharding-spec tree matching ``init_opt_state``'s structure.  ``mesh``
    needs only ``shape`` and ``axis_names`` (a stand-in serves)."""
    data_size = mesh.shape[axis] if (mesh is not None and axis in mesh.axis_names) else 1
    sharded = PM.tree_map(lambda i: zero_spec_for(i.spec, i.shape, data_size, axis), layout)
    state = {"mu": sharded, "nu": sharded, "count": PM.P()}
    if cfg.master_fp32:
        state["master"] = sharded
    return state


def zero_shardings(layout, mesh, cfg: AdamWConfig) -> dict:
    """:func:`opt_state_specs` over ``mesh`` as :class:`NamedSharding` s."""
    return PM.tree_map(lambda spec: NamedSharding(mesh, spec),
                       opt_state_specs(layout, mesh, cfg))


def init_zero_state(params, shardings: dict, cfg: AdamWConfig) -> dict:
    """This rank's shard of :func:`init_opt_state` (``shardings`` from
    :func:`zero_shardings`): zero moments and the fp32 master of its part of
    each leaf, and the int32 ``count``."""
    per_leaf = shardings["mu"]
    shards = PM.tree_map(lambda pair: pair[1].shard(pair[0].detach()),
                         _zip(params, per_leaf))
    device = PM.tree_leaves(params)[0].device
    state = {
        "mu": PM.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                          shards),
        "nu": PM.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                          shards),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_fp32:
        state["master"] = PM.tree_map(lambda t: t.to(torch.float32), shards)
    return state


def _zip(*trees):
    """A tree of tuples from trees of one structure (leaves in sorted-key order)."""
    it = iter(zip(*(PM.tree_leaves(t) for t in trees)))
    return PM.tree_map(lambda _: next(it), trees[0])


@torch.no_grad()
def zero_update_shards(grads, state, params, shardings: dict, cfg: AdamWConfig):
    """The first half of the ZeRO-1 AdamW step: update this rank's state
    shards (:func:`init_zero_state`) in place from ``grads``, the full synced
    gradients, the same on every rank.  Returns the new parameter shards (a
    list in leaf order) and ``{"grad_norm", "lr"}`` as :func:`adamw_update`
    does; :func:`gather_params` is the second half."""
    with torch.profiler.record_function("zero_update"):
        k = _step_scalars(grads, state, cfg)
        flat_p = PM.tree_leaves(params)
        shards = []
        for p, g, mu, nu, master, sh in zip(flat_p, PM.tree_leaves(grads),
                                            PM.tree_leaves(state["mu"]),
                                            PM.tree_leaves(state["nu"]),
                                            _masters(state, len(flat_p)),
                                            PM.tree_leaves(shardings["mu"])):
            p_shard = sh.shard(p)
            _update_leaf(p_shard, sh.shard(g), mu, nu, master, k, cfg)
            shards.append(p_shard)
    return shards, {"grad_norm": k["gnorm"], "lr": k["lr"]}


@torch.no_grad()
def gather_params(params, shards: list, shardings: dict):
    """Gather every rank's new parameter ``shards`` (in leaf order) over the
    mesh's ``data`` axis into ``params``, in place; return it."""
    for p, p_shard, sh in zip(PM.tree_leaves(params), shards,
                              PM.tree_leaves(shardings["mu"])):
        p.copy_(sh.gather(p_shard))
    return params


def compress_int8(g, error):
    """Error-feedback int8 quantisation: returns ``(q, scale, new_error)``."""
    gf = g.float() + error
    scale = torch.clamp(gf.abs().max(), min=1e-9) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_error = gf - q.float() * scale
    return q, scale, new_error


def decompress_int8(q, scale):
    return q.float() * scale
