"""Train and eval steps: loss + gradient + AdamW update.

The port of ``repro.train.step``.  ``make_train_step(model)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
autograd through the model's kernels gives the gradients of every leaf, and
:func:`~repro_torch.train.optimizer.adamw_update` applies them in place.
The metrics are 0-d tensors on the model's device (``loss``, ``nll``,
``aux``, ``grad_norm``, ``lr``), so a step never waits for the host.

``compiled_step_flops`` and ``compiled_step_costs`` read XLA's compiled
program and have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve
from ..models import params as PM
from .optimizer import AdamWConfig, adamw_update, init_opt_state


def make_train_step(model, opt_cfg: Optional[AdamWConfig] = None):
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = model.loss(leaves, batch)
        flat = PM.tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss never reads (a zero-size stacked run) gets a zero gradient
        it = iter(torch.zeros_like(t) if g is None else g for g, t in zip(grads, flat))
        grad_tree = PM.tree_map(lambda _: next(it), params)
        params, opt_state, opt_metrics = adamw_update(grad_tree, opt_state, params, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss.detach()}

    return train_step


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
