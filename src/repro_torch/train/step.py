"""Train and eval steps: loss + gradient + AdamW update.

The port of ``repro.train.step``.  ``make_train_step(model)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
autograd through the model's kernels gives the gradients of every leaf, and
:func:`~repro_torch.train.optimizer.adamw_update` applies them in place.
The metrics are 0-d tensors on the model's device (``loss``, ``nll``,
``aux``, ``grad_norm``, ``lr``), so a step never waits for the host.

``make_train_step(model, opt_cfg, mesh)`` is the counterpart of JAX's
``jax.jit(make_train_step(...), in_shardings=(params, ZeRO opt state,
batch))`` over a mesh of (``pod``, ``data``) ranks (:class:`DataParallelStep`):
each rank takes its rows of the global batch by the batch spec
(``registry._batch_spec``), computes its loss and gradients, syncs them
(``sync.two_level_grad_sync``) and applies the ZeRO-1 update
(``optimizer.zero_update_shards``, ``gather_params``).  The ``model`` axis
(tensor parallelism) is not ported: a mesh whose ``model`` axis is above 1
raises.  Neither is the MoE aux loss across ranks (JAX's is a product of
global batch means, which rank means do not give): an MoE model over more
than one data-parallel rank raises.

:func:`step_costs` and :func:`step_flops` are the counterparts of JAX's
``compiled_step_costs`` and ``compiled_step_flops``: where JAX walks the
compiled HLO, they count one real train step as PyTorch dispatches it
(:mod:`repro_torch.roofline.count`), through the loss, autograd and
``adamw_update``, on the batch's device: on ``meta`` with no weights (the
dry-run's), on the CPU or the card with weights drawn from seed 0, or with
the caller's.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..launch.mesh import NamedSharding
from ..models import params as PM
from ..models.registry import _batch_spec, _dp_axes
from ..roofline import count as _count
from .optimizer import (AdamWConfig, abstract_opt_state, adamw_update, gather_params,
                        init_opt_state, init_zero_state, zero_shardings, zero_update_shards)
from .sync import init_error_state, two_level_grad_sync


def make_train_step(model, opt_cfg: Optional[AdamWConfig] = None, mesh=None):
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None:
        return DataParallelStep(model, opt_cfg, mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _grads(model, params, batch)
        params, opt_state, opt_metrics = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def _grads(model, params, batch):
    """``(loss, metrics, gradient tree)`` of ``model.loss`` at ``params``."""
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch)
    flat = PM.tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    # a leaf the loss never reads (a zero-size stacked run) gets a zero gradient
    it = iter(torch.zeros_like(t) if g is None else g for g, t in zip(grads, flat))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        PM.tree_map(lambda _: next(it), params)


class DataParallelStep:
    """``train_step(params, opt_state, batch)`` on one rank of ``mesh``.

    ``params`` are whole on every rank, ``opt_state`` this rank's ZeRO-1
    shards (:meth:`init_opt_state`), ``batch`` the global batch, of which the
    rank takes its rows (:meth:`rows`).  The metrics are the global batch's:
    ``loss``, ``nll`` and ``aux`` are the means of the ranks' (equal row
    counts), ``grad_norm`` that of the synced gradient.  ``compress`` turns
    on the int8 pod hop of the sync, whose error state the step keeps
    (``errors``).  ``times`` holds the last step's host milliseconds of the
    sync, of the shards' update and of the parameters' gather, each ending
    in a synchronize on the card.
    """

    def __init__(self, model, opt_cfg: AdamWConfig, mesh, *, compress: bool = False):
        if mesh.shape.get("model", 1) > 1:
            raise NotImplementedError(
                f"a 'model' axis of {mesh.shape['model']}: tensor-parallel execution is not "
                "ported; train over (pod, data) with model 1")
        self.dp_axes = _dp_axes(mesh)
        self.dp_size = mesh.axis_size(self.dp_axes) if self.dp_axes else 1
        if model.cfg.moe is not None and self.dp_size > 1:
            raise NotImplementedError(
                f"{model.cfg.arch}: MoE over {self.dp_size} data-parallel ranks. The Switch aux "
                "loss is a product of batch means, so the mean of the ranks' aux losses is not "
                "the global batch's; data-parallel MoE is not ported")
        self.model, self.opt_cfg, self.mesh = model, opt_cfg, mesh
        self.compress = compress
        self.shardings = zero_shardings(model.layout(), mesh, opt_cfg)
        self.errors = None
        self.times: dict[str, float] = {}

    def init_opt_state(self, params) -> dict:
        return init_zero_state(params, self.shardings, self.opt_cfg)

    def rows(self, batch: dict) -> dict:
        """This rank's rows of every leaf of the global ``batch`` (dim 0 cut
        by ``_batch_spec``; whole where the batch does not divide)."""
        B = PM.tree_leaves(batch)[0].shape[0]
        sharding = NamedSharding(self.mesh, _batch_spec(self.mesh, B))
        return {k: v[sharding.index(v.shape)[:1]] for k, v in batch.items()}

    def grads(self, params, batch: dict):
        """``(loss, metrics, gradients)`` of this rank's rows."""
        return _grads(self.model, params, self.rows(batch))

    def sync(self, grads):
        """The synced gradients; with ``compress``, the error state advances."""
        if self.compress and self.errors is None:
            self.errors = init_error_state(grads)
        synced, errors = two_level_grad_sync(grads, self.errors, self.mesh,
                                             compress=self.compress)
        if self.compress:
            self.errors = errors
        return synced

    def update(self, synced, opt_state, params):
        """The ZeRO-1 update, its two halves timed."""
        t0 = self._clock()
        shards, metrics = zero_update_shards(synced, opt_state, params, self.shardings,
                                             self.opt_cfg)
        t1 = self._clock()
        params = gather_params(params, shards, self.shardings)
        t2 = self._clock()
        self.times.update(update_ms=(t1 - t0) * 1e3, gather_ms=(t2 - t1) * 1e3)
        return params, opt_state, metrics

    def mean_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of a 0-d ``t`` over the data-parallel ranks, in fp32."""
        total = t.detach().to(torch.float32, copy=True).reshape(1)
        if self.dp_axes:
            self.mesh.all_reduce(total, self.dp_axes)
        return (total / self.dp_size)[0]

    def _clock(self) -> float:
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        return time.perf_counter()

    def __call__(self, params, opt_state, batch):
        loss, metrics, grads = self.grads(params, batch)
        t0 = self._clock()
        synced = self.sync(grads)
        del grads
        self.times = {"sync_ms": (self._clock() - t0) * 1e3}
        params, opt_state, opt_metrics = self.update(synced, opt_state, params)
        metrics = {k: self.mean_over_ranks(v) for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics, "loss": self.mean_over_ranks(loss)}


def step_costs(model, batch, *, opt_cfg: Optional[AdamWConfig] = None, params=None,
               opt_state=None) -> dict:
    """The counts of one train step of ``make_train_step(model, opt_cfg)`` on
    ``batch`` (:meth:`repro_torch.roofline.count.StepCounter.result`):
    ``flops``, ``traffic_bytes``, their parts, each kernel's calls and costs,
    and the live-bytes peak over the parameters, the optimizer state and the
    batch it starts with.  Without ``params``, a batch on the meta device
    takes ``params.abstract`` and an abstract AdamW state (nothing drawn),
    any other the model's weights from seed 0 and a fresh state.  The step
    updates ``params`` and ``opt_state`` in place, as a train step does."""
    opt_cfg = opt_cfg or AdamWConfig()
    device = PM.tree_leaves(batch)[0].device
    if params is None:
        if device.type == "meta":
            layout = model.layout()
            params = PM.abstract(layout, model.cfg.dtype)
            opt_state = abstract_opt_state(layout, opt_cfg)
        else:
            params, opt_state = init_train_state(model, torch.Generator().manual_seed(0),
                                                 opt_cfg)
    elif opt_state is None:
        opt_state = init_opt_state(params, opt_cfg)
    step = make_train_step(model, opt_cfg)
    return _count.count(step, params, opt_state, batch)[1]


def step_flops(model, batch, *, opt_cfg: Optional[AdamWConfig] = None, params=None,
               opt_state=None) -> float:
    """The FLOPs of one train step (:func:`step_costs`'s ``flops``): PyTorch's
    matmul formulas plus the hand-written kernels' costs."""
    return step_costs(model, batch, opt_cfg=opt_cfg, params=params,
                      opt_state=opt_state)["flops"]


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {**metrics, "loss": loss}

    return eval_step


def init_train_state(model, generator: torch.Generator, opt_cfg: Optional[AdamWConfig] = None):
    """Random parameters by the JAX package's rules, and a fresh optimizer state."""
    opt_cfg = opt_cfg or AdamWConfig()
    params = model.init_params(generator)
    return params, init_opt_state(params, opt_cfg)


def token_batch_from_bytes(payloads: Sequence[bytes], seq_len: int, vocab: int, *,
                           device="cuda") -> dict:
    """Decode raw item payloads (int32 records) into a ``{tokens, labels}`` batch.

    Each payload is one dataset item: little-endian int32 token ids, the first
    ``seq_len`` of which form one sequence; ids are folded into ``[0, vocab)``.
    Labels are the next tokens, the first token wrapping around to the end.
    Both are int64 tensors on ``device``.
    """
    rows = []
    for p in payloads:
        toks = np.frombuffer(p, dtype=np.int32)[:seq_len]
        if len(toks) < seq_len:
            raise ValueError(f"item payload holds {len(toks)} int32 tokens, need {seq_len}")
        rows.append(toks)
    tokens = np.abs(np.stack(rows)) % vocab
    labels = np.roll(tokens, -1, axis=1)
    dev = resolve(device)
    return {
        "tokens": torch.as_tensor(tokens, dtype=torch.int64).to(dev),
        "labels": torch.as_tensor(labels, dtype=torch.int64).to(dev),
    }
