"""Explicit data-parallel gradient sync with int8 compression across pods:
the port of ``repro.train.sync``.

A two-level reduction, as JAX's ``shard_map`` runs it:

    1. the mean over ``data`` (inside a pod), at full precision;
    2. error-feedback int8 quantisation (``compress_int8``), dequantised,
       then the mean over ``pod`` (across pods).

Error feedback keeps the quantisation bias out of the update: the residual
re-enters the next step.  With no ``pod`` axis, or with ``compress=False``,
the sync is a plain mean over (``data``, ``pod``) and the errors come back
unchanged.

As in JAX, the pod mean is taken over the dequantised fp32 values: the int8
payload and its scale are what a deployment would put on the wire, but
neither the reference nor the port sends them.  JAX's ``pmean`` keeps each
leaf's dtype; the port sums a leaf in fp32 and casts the mean back to the
leaf's dtype, so a bf16 gradient is rounded once, after the sum, where JAX
may round at each partial sum.  The compressed path returns fp32 leaves, as
JAX's does (the pod mean of dequantised fp32).
"""

from __future__ import annotations

import torch

from ..models import params as PM
from ..parallel import total_fp32
from .optimizer import compress_int8, decompress_int8


def _mean(g: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``g`` over the slice along ``axes``, summed in fp32, in ``g``'s dtype."""
    return total_fp32(g, mesh, axes).div_(mesh.axis_size(axes)).to(g.dtype)


def two_level_grad_sync(grads, errors, mesh, *, compress: bool = True):
    """All-reduce ``grads`` over (data, pod); int8 on the pod hop.

    ``grads`` and ``errors`` are trees of one structure, each rank holding
    whole leaves.  Returns ``(synced grads, new errors)``; neither input is
    changed.
    """
    axes = tuple(a for a in ("data", "pod") if a in mesh.axis_names)
    if "pod" not in mesh.axis_names or not compress:
        return PM.tree_map(lambda g: _mean(g, mesh, axes), grads), errors

    def sync_one(g, e):
        g = _mean(g, mesh, "data")
        q, scale, new_e = compress_int8(g, e)
        return _mean(decompress_int8(q, scale), mesh, "pod"), new_e

    pairs = iter([sync_one(g, e) for g, e in zip(PM.tree_leaves(grads),
                                                   PM.tree_leaves(errors))])
    both = PM.tree_map(lambda _: next(pairs), grads)
    return PM.tree_map(lambda p: p[0], both), PM.tree_map(lambda p: p[1], both)


def init_error_state(grads_template):
    """fp32 zeros shaped as each leaf of ``grads_template``, on its device."""
    return PM.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                       grads_template)
