"""Parameter layout: one declarative tree yields init, caches and JAX import.

A model describes its parameters as a nested dict of :class:`ParamInfo`
(shape + initializer), the JAX package's layout without its sharding specs.
Weights are ``(in, out)`` and applied as ``x @ W``; stacked layers carry a
leading layer axis (:func:`stack`).  With the same layout on both sides, a JAX
parameter tree carries over leaf by leaf with no transpose
(:func:`params_from_jax`).

Trees are walked in sorted-key order, the order of ``jax.tree.flatten``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ParamInfo:
    shape: tuple[int, ...]
    init: str = "normal"           # normal | zeros | ones | small
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)


def as_dtype(dtype: str | torch.dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; choose from {sorted(DTYPES)}")
    return DTYPES[dtype]


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a nested dict, visiting keys in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def stack(n: int, layout):
    """Prepend a stacked-layers axis to every leaf of ``layout``."""
    return tree_map(lambda i: replace(i, shape=(n, *i.shape)), layout)


def _init_leaf(info: ParamInfo, generator: torch.Generator, device, dtype) -> torch.Tensor:
    if info.init == "zeros":
        return torch.zeros(info.shape, dtype=dtype, device=device)
    if info.init == "ones":
        return torch.ones(info.shape, dtype=dtype, device=device)
    fan_in = info.shape[-2] if len(info.shape) >= 2 else max(1, info.shape[-1])
    std = info.scale if info.scale is not None else fan_in ** -0.5
    if info.init == "small":
        std = 0.02
    draw = torch.randn(info.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * std).to(device=device, dtype=dtype)


def init_params(layout, generator: torch.Generator, *, device, dtype) -> dict:
    """Random parameters by the JAX package's rules (``params.py`` ``_init_leaf``):
    normal * fan_in**-0.5 unless ``scale`` overrides, ones or zeros where the
    layout says so.  Leaves are drawn in sorted-key order from ``generator``,
    so one seed gives one model on any device."""
    dt = as_dtype(dtype)
    return tree_map(lambda i: _init_leaf(i, generator, device, dt), layout)


def zeros_cache(layout, *, device, dtype) -> dict:
    """A zero-filled cache for a cache layout."""
    dt = as_dtype(dtype)
    return tree_map(lambda i: torch.zeros(i.shape, dtype=dt, device=device), layout)


def params_from_jax(tree, *, device, dtype) -> dict:
    """Carry a JAX parameter tree (leaves as numpy arrays) into the port.

    The port keeps the JAX layout, so each leaf is converted as it is: no
    transpose, no reshape.  Each leaf is copied, so the port may update it in
    place (the decode cache) without touching the caller's array.
    """
    dt = as_dtype(dtype)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), dtype=dt, device=device), tree
    )


def cache_from_jax(tree, *, device, dtype) -> dict:
    """Carry a JAX decode cache (``(n, B, Hkv, S, hd)`` numpy leaves) into the port."""
    for leaf in tree_leaves(tree):
        if np.ndim(leaf) != 5:
            raise ValueError(f"cache leaf of shape {np.shape(leaf)}, expected (n, B, Hkv, S, hd)")
    return params_from_jax(tree, device=device, dtype=dtype)

