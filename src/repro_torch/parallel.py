"""The parallel layer the models, the optimizer and the launchers share.

:class:`NamedSharding` is the port's ``jax.sharding.NamedSharding``: a spec
(``models.params.P``) over a mesh, which cuts a full leaf into this rank's
shard, a contiguous tensor of its own, and gathers the shards back.

The parallel regions are Megatron's conjugate pairs over a mesh axis, as
``torch.autograd.Function`` s: :func:`copy_to_region` (identity forward,
all-reduce backward), :func:`reduce_from_region` (all-reduce forward,
identity backward), :func:`gather_from_region` and :func:`scatter_to_region`
along a dimension, :func:`regroup_columns`, which moves columns from one cut
of a row to another, and :func:`all_reduce_sum`, the differentiable sum over
an axis (a sum both ways).  Their all-reduces sum in fp32 and cast
back once, as ``train/sync.py`` does, where JAX's ``psum`` keeps the
leaf's dtype.  With no mesh, or where this rank is alone on the axes, a
region is the identity and returns its input as it is, so a model built
without a ``model`` axis runs the same operations as one with no regions.

A mesh here is any object with the interface of ``launch.mesh.Mesh`` or
``AbstractMesh`` (axes, this rank's coordinates, ``all_reduce`` and
``all_gather``); this module imports neither.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

TP = "model"


def tp_size(mesh) -> int:
    """The ``model`` axis a model built over ``mesh`` executes: its size on a
    mesh of one rank's coordinates, 1 with no mesh or a stand-in of shapes."""
    if mesh is None or not hasattr(mesh, "coords"):
        return 1
    return mesh.shape.get(TP, 1)


def tp_mesh(mesh):
    """``mesh`` where it executes a ``model`` axis above 1 (:func:`tp_size`),
    else None, over which the regions are the identity."""
    return mesh if tp_size(mesh) > 1 else None


# ---------------------------------------------------------------- shardings
def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: dimension ``i`` of a leaf is cut into
    ``prod(sizes of spec[i]'s axes)`` equal parts, the rank taking part
    number (its coordinates on those axes, row-major in the entry's order)."""

    mesh: Any
    spec: tuple

    def index(self, shape: Sequence[int]) -> tuple[slice, ...]:
        """This rank's slice of a leaf of ``shape``."""
        return self.index_of(self.mesh.coords, shape)

    def index_of(self, coords: dict, shape: Sequence[int]) -> tuple[slice, ...]:
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {tuple(shape)}")
        out = []
        for d, size in enumerate(shape):
            axes = _entry_axes(self.spec[d]) if d < len(self.spec) else ()
            parts, part = 1, 0
            for a in axes:
                parts *= self.mesh.shape[a]
                part = part * self.mesh.shape[a] + coords[a]
            if size % parts:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not split "
                                 f"{parts} ways ({self.spec[d]})")
            n = size // parts
            out.append(slice(part * n, (part + 1) * n))
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of this rank's shard of a leaf of ``shape``."""
        return tuple(sl.stop - sl.start for sl in self.index(shape))

    def axes(self) -> tuple:
        """The mesh axes that cut a leaf, in mesh order."""
        used = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full`` as a contiguous tensor of its own."""
        part = full[self.index(full.shape)]
        return part.clone(memory_format=torch.contiguous_format)

    def full_shape(self, shard_shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of the leaf whose shards have ``shard_shape``."""
        return tuple(n * (self.mesh.axis_size(_entry_axes(self.spec[d]))
                          if d < len(self.spec) else 1)
                     for d, n in enumerate(shard_shape))

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The full leaf from every rank's ``shard``, on every rank."""
        axes = self.axes()
        if not axes or self.mesh.axis_size(axes) == 1:
            return shard
        shape = self.full_shape(shard.shape)
        full = shard.new_empty(shape)
        for rank, part in zip(self.mesh.group_ranks(axes), self.mesh.all_gather(shard, axes)):
            full[self.index_of(self.mesh.coords_of(rank), shape)] = part
        return full


# ---------------------------------------------------------- parallel regions
def _alone(mesh, axes) -> bool:
    return mesh is None or mesh.axis_size(axes) == 1


def total_fp32(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``t`` over the slice along ``axes`` as a new fp32 tensor."""
    total = t.detach().to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    return mesh.all_reduce(total, axes)


def sum_fp32(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:func:`total_fp32` cast back to ``t``'s dtype once."""
    return total_fp32(t, mesh, axes).to(t.dtype)


def _part(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's part of ``t`` cut along ``dim`` into the slice's size, contiguous."""
    n = mesh.axis_size(axes)
    return t.chunk(n, dim)[mesh.index_in(axes)].contiguous()


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_fp32(g, ctx.mesh, ctx.axes), None, None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return sum_fp32(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, partial):
        ctx.mesh, ctx.axes, ctx.dim, ctx.partial = mesh, axes, dim, partial
        return torch.cat(mesh.all_gather(x.contiguous(), axes), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = sum_fp32(g, ctx.mesh, ctx.axes)
        return _part(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None, None


class _ScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _part(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.mesh.all_gather(g.contiguous(), ctx.axes), ctx.dim), None, None, None


class _RegroupColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, picks):
        ctx.mesh, ctx.axes, ctx.picks, ctx.width = mesh, axes, picks, x.shape[-1]
        full = torch.cat(mesh.all_gather(x.contiguous(), axes), -1)
        return torch.cat([full[..., s] for s in picks[mesh.index_in(axes)]], -1)

    @staticmethod
    def backward(ctx, g):
        parts = ctx.mesh.all_gather(g.contiguous(), ctx.axes)
        full = g.new_empty((*g.shape[:-1], ctx.width * len(parts)))
        for pick, part in zip(ctx.picks, parts):
            start = 0
            for s in pick:
                n = s.stop - s.start
                full[..., s] = part[..., start:start + n]
                start += n
        i = ctx.mesh.index_in(ctx.axes)
        return full[..., i * ctx.width:(i + 1) * ctx.width], None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return sum_fp32(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return sum_fp32(g, ctx.mesh, ctx.axes), None, None


def copy_to_region(x: torch.Tensor, mesh, axes=TP) -> torch.Tensor:
    """``x`` into a region that splits its work over ``axes``: the identity
    forward; backward, the sum of the ranks' partial gradients."""
    if _alone(mesh, axes):
        return x
    return _CopyToRegion.apply(x, mesh, axes)


def reduce_from_region(x: torch.Tensor, mesh, axes=TP) -> torch.Tensor:
    """The ranks' partial results of a region summed over ``axes``; backward,
    the identity (the gradient of a replicated value is whole on each rank)."""
    if _alone(mesh, axes):
        return x
    return _ReduceFromRegion.apply(x, mesh, axes)


def gather_from_region(x: torch.Tensor, mesh, dim: int, axes=TP, *,
                       partial: bool = False) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in the slice's order.
    Backward, this rank's part of the gradient: as it stands where every rank
    computes the same thing from the result, summed over ``axes`` first with
    ``partial`` (each rank uses a part of the result, such as the heads of
    its own queries)."""
    if _alone(mesh, axes):
        return x
    return _GatherFromRegion.apply(x, mesh, axes, dim, partial)


def scatter_to_region(x: torch.Tensor, mesh, dim: int, axes=TP) -> torch.Tensor:
    """This rank's part of a replicated ``x`` along ``dim``; backward, the
    ranks' gradients gathered."""
    if _alone(mesh, axes):
        return x
    return _ScatterToRegion.apply(x, mesh, axes, dim)


def regroup_columns(x: torch.Tensor, mesh, picks, axes=TP) -> torch.Tensor:
    """The columns ``picks[i]`` (slices of the whole row, side by side) on the
    slice's rank ``i``, where each rank holds its contiguous part of the row
    in ``x``: the ranks' parts gathered and this rank's columns taken.  The
    picks cover every column once, so the backward moves each column's
    gradient back to the rank that holds it: one all-gather, no sum."""
    if _alone(mesh, axes):
        return torch.cat([x[..., s] for s in picks[0]], -1)
    return _RegroupColumns.apply(x, mesh, axes, picks)


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, differentiable: backward is the sum of
    the ranks' gradients too (each rank's loss reads the total)."""
    if _alone(mesh, axes):
        return x
    return _AllReduceSum.apply(x, mesh, axes)
