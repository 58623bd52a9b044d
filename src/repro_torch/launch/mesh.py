"""Named meshes over ``torch.distributed``: the port of ``repro.launch.mesh``.

A :class:`Mesh` names the ranks of one process group by coordinates on its
axes, JAX's ``Mesh`` over processes: ``shape`` maps each axis to its size
(``{"pod": 2, "data": 16, "model": 16}``), ``axis_names`` keeps their order,
and rank ``r`` sits at the row-major coordinates of ``r`` (``coords``).  For
every set of axes whose size is above 1 it holds one process group for each
slice along that set (the ranks that share their coordinates on every other
axis), made with plain ``dist.new_group`` by every rank in the same order;
the set of all axes uses the world group.  PyTorch's ``DeviceMesh`` is not
used: it picks the backend from the device type, and NCCL refuses two
ranks on one card.

The backend is an argument the caller must give, and nothing switches it.
With ``gloo``, ``all_reduce`` takes CUDA tensors as they are (gloo copies
them to host memory and reduces there), while ``all_gather``, which gloo
does not offer for CUDA tensors, moves its payload through host memory
explicitly and gathers its bytes, so any dtype comes back bit for bit.
A collective that the backend refuses raises.

:class:`NamedSharding` is the port's ``jax.sharding.NamedSharding``: a spec
(``params.P``) over a mesh, which cuts a full leaf into this rank's shard,
a contiguous tensor of its own, and gathers the shards back.

``make_production_mesh`` and ``make_test_mesh`` are functions, never module
constants, as in JAX: importing this module touches no process group.
:func:`run_ranks` starts a world of spawned processes and returns what each
rank's function returned.
"""

from __future__ import annotations

import datetime
import itertools
import math
import multiprocessing
import queue
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """Ranks of the default process group named by mesh coordinates.

    If no process group exists, the mesh starts one with ``backend`` from
    ``init_method`` (``file://`` or ``tcp://localhost:<port>``) as ``rank`` of
    a world of ``prod(shape)``; otherwise the group must already have that
    backend and size.  Several meshes may view one world (``pod 2 x data 2``
    and ``data 1 x model 4`` over the same 4 ranks).  ``timeout`` bounds every
    collective, rendezvous included.  ``device`` is where the ranks' tensors
    live: ``"cuda"`` (the default) or ``"cpu"``.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *, backend: str,
                 init_method: Optional[str] = None, rank: Optional[int] = None,
                 timeout: float = 120.0, device="cuda"):
        if not backend:
            raise ValueError("a mesh needs an explicit backend ('gloo' or 'nccl')")
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self.backend = backend
        self.device = resolve(device)
        self._timeout = datetime.timedelta(seconds=timeout)
        if not dist.is_initialized():
            if init_method is None or rank is None:
                raise ValueError("no process group yet: give init_method and rank")
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=self.size, timeout=self._timeout)
        elif dist.get_backend() != backend or dist.get_world_size() != self.size:
            raise ValueError(f"the process group is {dist.get_backend()} over "
                             f"{dist.get_world_size()} ranks; this mesh asks for {backend} "
                             f"over {self.size}")
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        self._groups: dict[tuple, tuple] = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                self._make_groups(axes)

    def coords_of(self, rank: int) -> dict[str, int]:
        """The row-major coordinates of ``rank``, axis by axis."""
        out = {}
        for axis in reversed(self.axis_names):
            rank, out[axis] = divmod(rank, self.shape[axis])
        return {a: out[a] for a in self.axis_names}

    def _rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for axis in self.axis_names:
            r = r * self.shape[axis] + coords[axis]
        return r

    def _make_groups(self, axes: tuple) -> None:
        """One group for each slice along ``axes`` (every rank makes every
        group, in one order); keep the one this rank is in."""
        size = math.prod(self.shape[a] for a in axes)
        if size == 1:
            return
        if size == self.size:
            self._groups[axes] = (dist.group.WORLD, list(range(self.size)))
            return
        others = [a for a in self.axis_names if a not in axes]
        for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
            base = dict(zip(others, fixed))
            ranks = sorted(self._rank_of({**base, **dict(zip(axes, c))})
                           for c in itertools.product(*(range(self.shape[a]) for a in axes)))
            group = dist.new_group(ranks, timeout=self._timeout)
            if self.rank in ranks:
                self._groups[axes] = (group, ranks)

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def _axes(self, axes) -> tuple:
        """``axes`` (a name or names) in mesh order; raise on one the mesh lacks."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in names if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh's {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def group_ranks(self, axes) -> list[int]:
        """The global ranks of this rank's slice along ``axes``, in row-major order."""
        key = self._axes(axes)
        return self._groups[key][1] if key in self._groups else [self.rank]

    # ------------------------------------------------------------ collectives
    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the slice along ``axes``; return it."""
        key = self._axes(axes)
        if key in self._groups:
            dist.all_reduce(t, op=_OPS[op], group=self._groups[key][0])
        return t

    def all_gather(self, t: torch.Tensor, axes) -> list[torch.Tensor]:
        """Every rank's ``t`` of the slice along ``axes``, in the order of
        :meth:`group_ranks`, bit for bit, on ``t``'s device."""
        key = self._axes(axes)
        if key not in self._groups:
            return [t]
        group, ranks = self._groups[key]
        src = t.detach().contiguous().reshape(-1)
        if self.backend == "gloo" and src.is_cuda:
            src = src.cpu()                    # gloo gathers host tensors only
        payload = src.view(torch.uint8)
        parts = [torch.empty_like(payload) for _ in ranks]
        dist.all_gather(parts, payload, group=group)
        return [p.view(t.dtype).reshape(t.shape).to(t.device) for p in parts]

    def barrier(self) -> None:
        dist.barrier()


def make_production_mesh(*, multi_pod: bool = False, backend: str, **kw) -> Mesh:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, backend=backend, **kw)


def make_test_mesh(data: int = 2, model: int = 2, pods: int = 0, *, backend: str,
                   **kw) -> Mesh:
    """Small meshes: (pod, data, model) with ``pods``, else (data, model)."""
    if pods:
        return Mesh((pods, data, model), ("pod", "data", "model"), backend=backend, **kw)
    return Mesh((data, model), ("data", "model"), backend=backend, **kw)


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

    mesh: Mesh
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


# ------------------------------------------------------------ spawned worlds
def _rank_main(inbox, results, fn, rank: int, world_size: int, init_method: str) -> None:
    try:
        args = inbox.get()
        results.put((rank, True, fn(rank, world_size, init_method, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args, init_method: str,
              timeout: float = 120.0) -> list:
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    processes started with ``spawn`` and return their results by rank.

    ``fn`` must be importable by name and its results picklable (numbers,
    strings, numpy arrays).  A rank that raises, or a world not done within
    ``timeout`` seconds, stops every process and raises here with the
    failing rank's traceback.
    """
    ctx = multiprocessing.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(inbox, results, fn, r, world_size, init_method))
             for r in range(world_size)]
    for p in procs:
        p.start()
    for _ in procs:
        # through a queue, whose feeder thread writes while the ranks start:
        # arguments on the start pipe would hold each start until its rank
        # had imported them
        inbox.put(args)
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} not "
                                   f"done within {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited ({[procs[r].exitcode for r in dead]}) "
                                       "without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [out[r] for r in range(world_size)]
