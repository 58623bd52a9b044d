"""Train and eval steps: loss + gradient + AdamW update.

The port of ``repro.train.step``.  ``make_train_step(model)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
autograd through the model's kernels gives the gradients of every leaf, and
:func:`~repro_torch.train.optimizer.adamw_update` applies them in place.
The metrics are 0-d tensors on the model's device (``loss``, ``nll``,
``aux``, ``grad_norm``, ``lr``), so a step never waits for the host.

``make_train_step(model, opt_cfg, mesh)`` is the counterpart of JAX's
``jax.jit(make_train_step(...), in_shardings=(params, ZeRO opt state,
batch))`` over a (``pod``, ``data``, ``model``) mesh
(:class:`DataParallelStep`): each rank takes its rows of the global batch
by the batch spec (``registry._batch_spec``; the ranks of one ``model``
group share their rows), computes its loss and gradients, syncs them over
(``pod``, ``data``) (``sync.two_level_grad_sync``) and applies the ZeRO-1
update (``optimizer.zero_update_shards``, ``gather_params``).  A ``model``
axis above 1 runs a ``DecoderLM`` built over the same mesh tensor-parallel
(``models/lm.py``): its parameters are the rank's shards
(``params.shard_params``).  Hymba, xLSTM and the encoder-decoder have no
tensor-parallel execution and raise.  An MoE model over more than one data
rank routes the global batch, as JAX does on it (``layers.moe_route``: the
global capacity and queue, the aux loss of global means).

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
from ..models import params as PM
from ..models.registry import _batch_spec, _dp_axes
from ..parallel import NamedSharding
from ..roofline import count as _count
from ..serve.engine import data_rows
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

    ``params`` are this rank's (whole leaves, or with a ``model`` axis above
    1 its shards: ``params.shard_params``), ``opt_state`` its ZeRO-1 shards
    (:meth:`init_opt_state`), ``batch`` the global batch, of which the rank
    takes its rows (:meth:`rows`).  The metrics are the global batch's:
    ``loss``, ``nll`` and ``aux`` are the means of the data ranks' (equal row
    counts; an MoE model's aux is the global batch's on every rank),
    ``grad_norm`` that of the synced gradient.  ``compress`` turns on the
    int8 pod hop of the sync, whose error state the step keeps (``errors``).
    ``times`` holds the last step's host milliseconds of the sync, of the
    shards' update and of the parameters' gather, each ending in a
    synchronize on the card.
    """

    def __init__(self, model, opt_cfg: AdamWConfig, mesh, *, compress: bool = False):
        tp = mesh.shape.get("model", 1)
        if tp > 1 and not model.tensor_parallel:
            raise NotImplementedError(
                f"{model.cfg.arch}: the {model.cfg.family} family ({type(model).__name__}) has no "
                f"tensor-parallel execution; a 'model' axis of {tp} is ported for DecoderLM "
                "only, train it over (pod, data) with model 1")
        if tp > 1 and (model.mesh is not mesh or model.model_axis != tp):
            raise ValueError(f"{model.cfg.arch}: over a model axis of {tp} the model must be "
                             f"built with model_axis={tp} and this mesh")
        self.dp_axes = _dp_axes(mesh)
        self.dp_size = mesh.axis_size(self.dp_axes) if self.dp_axes else 1
        if model.cfg.moe is not None and self.dp_size > 1 and model.mesh is not mesh:
            raise ValueError(f"{model.cfg.arch}: MoE over {self.dp_size} data ranks routes the "
                             "global batch; build the model with this mesh")
        self.model, self.opt_cfg, self.mesh = model, opt_cfg, mesh
        self.compress = compress
        self.shardings = zero_shardings(model.layout(), mesh, opt_cfg)
        self.errors = None
        self.times: dict[str, float] = {}

    def init_opt_state(self, params) -> dict:
        return init_zero_state(params, self.shardings, self.opt_cfg)

    def param_shardings(self) -> dict:
        """A rank's parameters as ``NamedSharding`` s: the specs' ``model``
        entries (a checkpoint's ``shardings`` for ``params``)."""
        return PM.tree_map(lambda sh: NamedSharding(self.mesh, PM.keep_axes(sh.spec, ("model",))),
                           self.shardings["mu"])

    def rows(self, batch: dict) -> dict:
        """This rank's rows of every leaf of the global ``batch`` (dim 0 cut
        by ``_batch_spec``; whole where the batch does not divide)."""
        B = PM.tree_leaves(batch)[0].shape[0]
        sharding = NamedSharding(self.mesh, _batch_spec(self.mesh, B))
        return {k: v[sharding.index(v.shape)[:1]] for k, v in batch.items()}

    def grads(self, params, batch: dict):
        """``(loss, metrics, gradients)`` of this rank's rows; where the rows
        are a part of the batch over more than one data rank, the model knows
        it (``DecoderLM.rows_split``)."""
        rows = self.rows(batch)
        split = (self.dp_size > 1 and hasattr(self.model, "rows_split")
                 and PM.tree_leaves(rows)[0].shape[0] < PM.tree_leaves(batch)[0].shape[0])
        if not split:
            return _grads(self.model, params, rows)
        with self.model.rows_split(self.dp_axes):
            return _grads(self.model, params, rows)

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


def tp_step_costs(model, batch, mesh, *, opt_cfg: Optional[AdamWConfig] = None) -> dict:
    """:func:`step_costs` of one rank's step of ``make_train_step(model,
    opt_cfg, mesh)`` (a :class:`DataParallelStep`, tensor-parallel where the
    mesh's ``model`` axis is above 1) on the global ``batch`` of meta tensors,
    under a ``launch.mesh.AbstractMesh``: this rank's parameter shards (of
    ``params.abstract``: nothing drawn), its ZeRO-1 state and the collectives
    it makes (``collectives``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    step = DataParallelStep(model, opt_cfg, mesh)
    layout = model.layout()
    params = PM.shard_params(PM.abstract(layout, model.cfg.dtype), layout, mesh)
    return _count.count(step, params, step.init_opt_state(params), batch)[1]


def tp_serve_costs(model, mesh, kind: str, batch: int, seq: int) -> dict:
    """The counts (:func:`repro_torch.roofline.count.count`) of one rank's
    ``prefill`` (``kind`` "prefill": ``seq`` positions, a VLM's image ones
    among them) or ``decode_step`` (``kind`` "decode": the last slot of a cache
    of ``seq``) for a global ``batch`` of requests, on meta under a
    ``launch.mesh.AbstractMesh``: this rank's parameter shards (of
    ``params.abstract``: nothing drawn), its rows (the batch cut over the data
    axes where it divides, inside ``model.rows_split``; whole otherwise), its
    shard of the cache (``model.init_cache``) and the collectives it makes.
    ``start_bytes`` is the weights' shards, the cache shard and the inputs;
    ``peak_bytes`` adds the step's peak above them."""
    cfg = model.cfg
    layout = model.layout()
    params = PM.shard_params(PM.abstract(layout, cfg.dtype), layout, mesh)
    axes, cut = data_rows(mesh, batch)
    rows = cut.stop - cut.start
    meta = torch.device("meta")
    if kind == "decode":
        step = model.decode_step
        inputs = {"tokens": torch.empty((rows, 1), dtype=torch.int32, device=meta),
                  "cache": model.init_cache(batch, seq), "index": seq - 1}
    elif kind == "prefill":
        step = model.prefill
        n_img = cfg.vlm.n_image_tokens if cfg.vlm is not None else 0
        inputs = {"tokens": torch.empty((rows, seq - n_img), dtype=torch.int32, device=meta)}
        if n_img:
            inputs["img_emb"] = torch.empty((rows, n_img, cfg.d_model),
                                            dtype=PM.as_dtype(cfg.dtype), device=meta)
    else:
        raise ValueError(f"serving has no step of kind {kind!r}")
    with model.rows_split(axes):
        return _count.count(step, params, inputs)[1]


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
