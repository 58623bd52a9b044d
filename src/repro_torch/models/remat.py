"""Rematerialisation of a block: the port of the JAX models' ``_remat``.

``remat(fn, policy)`` gives ``cfg.remat`` JAX's meaning:

* ``"none"``: ``fn`` as it is; autograd keeps every activation it saves.
* ``"full"``: ``jax.checkpoint`` with ``nothing_saveable``; here the
  non-reentrant ``torch.utils.checkpoint``, which keeps the block's inputs
  alone and runs the block again in the backward pass.
* anything else (``"dots"``, JAX's default): ``dots_with_no_batch_dims_saveable``;
  here the same checkpoint with a selective policy that keeps the outputs of
  the products with no batch dimension (``aten.mm`` and ``aten.addmm``, what
  ``x @ W`` becomes at dispatch) and recomputes every other op, ``aten.bmm``
  among them (attention scores, the routed experts' products and the
  sLSTM's recurrent products have batch dimensions, and JAX recomputes them
  too).

The hand-written kernels are pybind calls inside ``torch.autograd.Function``s
(``kernels/ops.py``); the policy sees no aten op of theirs, so under
``"dots"`` and ``"full"`` every forward kernel of a block runs again in the
recompute.  For flash attention that is JAX's behaviour (its products have
batch dimensions); for the SwiGLU forward it is not: JAX's ``"dots"`` keeps
``x @ Wg``, ``x @ Wu`` and the down product, which the kernel computes in
one launch.  The values are the same either way; the FLOPs differ.

No block draws a random number, so the checkpoint does not save and restore
the RNG state (``preserve_rng_state=False``).  The recompute stops at the
block's last saved tensor (PyTorch's early stop), as XLA drops the unused
tail of a rematerialised body.  Only ``loss`` runs under autograd: a call
with gradients off (``prefill``, ``decode_step``, the engines) runs ``fn``
directly.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: the products with no batch dimension: JAX's ``dots_with_no_batch_dims_saveable``
SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` rematerialised under ``policy`` (``cfg.remat``): see the module's
    docstring."""
    if policy == "none":
        return fn
    kwargs = dict(use_reentrant=False, preserve_rng_state=False)
    if policy != "full":
        kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, **kwargs)

    return wrapped

