"""Parameter layout: one declarative tree yields init, caches, specs and JAX import.

A model describes its parameters as a nested dict of :class:`ParamInfo`
(shape, sharding spec, initializer and, where it differs from the model's, a
dtype), the JAX package's layout.  A spec is the port's stand-in for JAX's
``PartitionSpec``: a tuple with one entry a dimension, each ``None``
(replicated), a mesh axis name or a tuple of axis names (:func:`P` makes
one, :func:`specs` reads a layout's).  The ZeRO layout of the optimizer
state (``train.optimizer.opt_state_specs``) and a rank's rows of a batch
(``registry._batch_spec``) are derived from them, and :func:`shard_params`
cuts a rank's parameters by their ``model`` entries, which a decoder built
over a mesh with a ``model`` axis executes (``lm.py``).

:func:`abstract` gives a layout's tensors on the meta device (no storage,
no draw) for the dry-run; :func:`param_count` and :func:`param_bytes` are
JAX's.

Weights are ``(in, out)`` and applied as ``x @ W``; stacked layers carry a
leading layer axis (:func:`stack`).  With the same layout on both sides, a JAX
parameter tree carries over leaf by leaf with no transpose
(:func:`params_from_jax`).

Trees are walked in sorted-key order, the order of ``jax.tree.flatten``.
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..parallel import NamedSharding

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: elements drawn from one seed on the host: a larger leaf is drawn in slices
#: of this many, each from its own seed, on parallel threads
DRAW_SLICE = 1 << 22


DP = ("pod", "data")          # batch axes (pod present only multi-pod)
TP = "model"


def dp_axes(mesh) -> tuple | None:
    """The batch axes of a cache spec: (pod, data) with no mesh, else those
    of the two the mesh has (None if it has neither), as JAX's ``_dp``."""
    if mesh is None:
        return DP
    return tuple(a for a in DP if a in mesh.axis_names) or None


def _entry(e):
    """A spec entry as JAX keeps it: one axis in a tuple is that axis, none is None."""
    if isinstance(e, (tuple, list)):
        return None if not e else (e[0] if len(e) == 1 else tuple(e))
    return e


def P(*entries) -> tuple:
    """A sharding spec, ``PartitionSpec(*entries)`` of JAX as a plain tuple."""
    return tuple(_entry(e) for e in entries)


@dataclass(frozen=True)
class ParamInfo:
    shape: tuple[int, ...]
    spec: tuple = ()
    init: str = "normal"           # normal | zeros | ones | small
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)
    dtype: Optional[str] = None    # overrides the model dtype (fp32 state in a bf16 cache)


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


def specs(layout):
    """The tree of sharding specs of a layout, leaf for leaf."""
    return tree_map(lambda i: i.spec, layout)


def abstract(layout, dtype="bfloat16"):
    """Tensors on ``torch.device("meta")`` with the layout's shapes and dtypes
    (``info.dtype or dtype``), JAX's ``jax.ShapeDtypeStruct`` tree: no storage
    and no draw, so a dry-run builds any model at full size."""
    meta = torch.device("meta")
    return tree_map(lambda i: torch.empty(i.shape, dtype=as_dtype(i.dtype or dtype),
                                          device=meta), layout)


def param_count(layout) -> int:
    """The number of elements of every leaf of a layout."""
    total = 0
    for info in tree_leaves(layout):
        c = 1
        for s in info.shape:
            c *= s
        total += c
    return total


def param_bytes(layout, dtype="bfloat16") -> int:
    """The bytes of every leaf of a layout, each in ``info.dtype or dtype``."""
    total = 0
    for info in tree_leaves(layout):
        c = 1
        for s in info.shape:
            c *= s
        total += c * as_dtype(info.dtype or dtype).itemsize
    return total


def stack(n: int, layout):
    """Prepend a stacked-layers axis to every leaf of ``layout`` (replicated
    on that axis: ``None`` heads its spec)."""
    return tree_map(lambda i: replace(i, shape=(n, *i.shape), spec=(None, *i.spec)), layout)


def unstack(stacked) -> list:
    """Per-layer views of a tree stacked by :func:`stack`, each leaf split once
    with ``unbind`` (whose backward stacks the layers' gradients again)."""
    split = tree_map(lambda t: t.unbind(0), stacked)
    n = len(tree_leaves(split)[0])
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


@functools.lru_cache(maxsize=1)
def _draw_pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=os.cpu_count() or 1)


def _host_normal(shape, generator: torch.Generator, std: float, dtype) -> torch.Tensor:
    """normal * ``std`` of ``shape`` in ``dtype`` on the host, from one seed taken
    from ``generator``: slice ``i`` of :data:`DRAW_SLICE` elements is drawn
    from seed + i, in fp32 and scaled before the cast, so the values do not
    depend on how many threads draw them."""
    seed = int(torch.randint(0, 1 << 62, (), generator=generator))
    out = torch.empty(shape, dtype=dtype)
    flat = out.view(-1)

    def fill(start: int) -> None:
        part = flat[start:start + DRAW_SLICE]
        g = torch.Generator().manual_seed(seed + start // DRAW_SLICE)
        part.copy_(torch.randn(part.numel(), generator=g).mul_(std))

    starts = range(0, flat.numel(), DRAW_SLICE)
    if len(starts) > 1:
        list(_draw_pool().map(fill, starts))
    elif starts:
        fill(0)
    return out


def _init_leaf(info: ParamInfo, generator: torch.Generator, device, dtype) -> torch.Tensor:
    dtype = as_dtype(info.dtype or dtype)
    if info.init == "zeros":
        return torch.zeros(info.shape, dtype=dtype, device=device)
    if info.init == "ones":
        return torch.ones(info.shape, dtype=dtype, device=device)
    fan_in = info.shape[-2] if len(info.shape) >= 2 else max(1, info.shape[-1])
    std = info.scale if info.scale is not None else fan_in ** -0.5
    if info.init == "small":
        std = 0.02
    if generator.device.type == "cpu":
        return _host_normal(info.shape, generator, std, dtype).to(device)
    draw = torch.randn(info.shape, generator=generator, dtype=torch.float32,
                       device=generator.device)
    return (draw * std).to(device=device, dtype=dtype)


def init_params(layout, generator: torch.Generator, *, device, dtype) -> dict:
    """Random parameters by the JAX package's rules (``params.py`` ``_init_leaf``):
    normal * fan_in**-0.5 unless ``scale`` overrides, ones or zeros where the
    layout says so, each leaf in ``info.dtype or dtype``.  Leaves take their
    draws in sorted-key order from ``generator``.  A host generator gives each
    leaf a seed and draws it on the host (:func:`_host_normal`, in parallel
    slices), so one seed gives one model on any device; a generator on the
    card draws there, with the card's own numbers."""
    return tree_map(lambda i: _init_leaf(i, generator, device, dtype), layout)


def zeros_cache(layout, *, device, dtype) -> dict:
    """A zero-filled cache for a cache layout, each leaf in ``info.dtype or dtype``."""
    return tree_map(lambda i: torch.zeros(i.shape, dtype=as_dtype(i.dtype or dtype),
                                          device=device), layout)


def keep_axes(spec: tuple, axes) -> tuple:
    """``spec`` with every mesh axis outside ``axes`` taken out of its entries."""
    def keep(e):
        names = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        return tuple(a for a in names if a in axes)

    return P(*[keep(e) for e in spec])


def _paths(tree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def shard_params(params, layout, mesh):
    """This rank's shard of every full leaf of ``params``, cut by the ``model``
    entries of its spec in ``layout`` (``NamedSharding.shard``: a contiguous
    tensor of its own).  A leaf whose dimension does not split over the mesh
    raises, naming the leaf."""
    out = []
    for path, t, info in zip(_paths(params), tree_leaves(params), tree_leaves(layout)):
        sharding = NamedSharding(mesh, keep_axes(info.spec, (TP,)))
        try:
            out.append(sharding.shard(t))
        except ValueError as err:
            raise ValueError(f"{path}: {err}") from None
    it = iter(out)
    return tree_map(lambda _: next(it), params)


def _tensor_from_numpy(a, *, device, dtype=None) -> torch.Tensor:
    """A numpy leaf as a new tensor: cast to ``dtype``, or, with ``dtype=None``,
    in the leaf's own type (a 2-byte ``bfloat16`` leaf of ``ml_dtypes``, as
    JAX hands it over, becomes ``torch.bfloat16``)."""
    a = np.asarray(a)
    if dtype is not None:
        return torch.tensor(a.astype(np.float32), dtype=as_dtype(dtype), device=device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def params_from_jax(tree, *, device, dtype) -> dict:
    """Carry a JAX parameter or optimizer-state tree (leaves as numpy arrays)
    into the port.

    The port keeps the JAX layout, so each leaf is converted as it is: no
    transpose, no reshape.  Each leaf is copied, so the port may update it in
    place (the decode cache, the optimizer) without touching the caller's
    array.  ``dtype`` casts every leaf to one type; ``dtype=None`` keeps each
    leaf's own (an optimizer state's int32 ``count`` and fp32 moments).
    """
    return tree_map(lambda a: _tensor_from_numpy(a, device=device, dtype=dtype), tree)


def cache_from_jax(tree, layout, *, device, dtype) -> dict:
    """Carry a JAX decode cache tree (numpy leaves of any rank) into the port.

    ``layout`` is the model's ``cache_layout`` for the same batch and length:
    the tree must have its keys and each leaf its shape.  Each leaf is cast to
    ``info.dtype or dtype``, so an fp32 state leaf stays fp32 beside a bf16 KV
    cache, as ``zeros_cache`` makes it.
    """
    if isinstance(layout, ParamInfo):
        if np.shape(tree) != tuple(layout.shape):
            raise ValueError(f"cache leaf of shape {np.shape(tree)}, the layout says "
                             f"{tuple(layout.shape)}")
        return _tensor_from_numpy(tree, device=device, dtype=layout.dtype or dtype)
    if not isinstance(tree, dict) or sorted(tree) != sorted(layout):
        raise ValueError(f"cache keys {sorted(tree) if isinstance(tree, dict) else tree!r}, "
                         f"the layout says {sorted(layout)}")
    return {k: cache_from_jax(tree[k], layout[k], device=device, dtype=dtype)
            for k in sorted(layout)}

