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

A shard of a leaf over a mesh is ``repro_torch.parallel.NamedSharding``'s.
:class:`AbstractMesh` is JAX's ``AbstractMesh``: the axes and a rank's
coordinates without a process group, over which a ``NamedSharding`` gives
shard shapes (the dry-run's per-rank bytes).  Its collectives, on meta
tensors only, give the shapes a real mesh's would (an all-reduce the same
tensor, an all-gather one copy a rank), so one rank's step runs on the meta
device (the dry-run's count of a tensor-parallel step).  Every collective
of either mesh is one call to the step counter
(:func:`repro_torch.roofline.count.collective`).  With ``timed``, a
:class:`Mesh` synchronizes the card around each collective and adds its
host seconds to ``spent`` by axes.

``make_production_mesh`` and ``make_test_mesh`` are functions, never module
constants, as in JAX: importing this module touches no process group;
``make_abstract_production_mesh`` gives the production shapes alone.
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
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve
from ..roofline import count as _count

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class _MeshAxes:
    """Named axes and row-major coordinates, the part of a mesh that needs no
    process group: ``shape`` (axis -> size), ``axis_names``, ``size``."""

    def _set_axes(self, shape: Sequence[int], axis_names: Sequence[str]) -> None:
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())

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

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def group_ranks(self, axes) -> list[int]:
        """The global ranks of this rank's slice along ``axes``, in row-major order."""
        key = self._axes(axes)
        return sorted(self._rank_of({**self.coords, **dict(zip(key, c))})
                      for c in itertools.product(*(range(self.shape[a]) for a in key)))

    def index_in(self, axes) -> int:
        """This rank's place in its slice along ``axes`` (:meth:`group_ranks`)."""
        return self.group_ranks(axes).index(self.rank)

    # ------------------------------------------------------------ collectives
    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the slice along ``axes``; return it."""
        key = self._axes(axes)
        n = self.axis_size(key)
        if n > 1:
            _count.collective("all_reduce", t.numel() * t.element_size())
            self._reduce(t, key, op)
        return t

    def all_gather(self, t: torch.Tensor, axes) -> list[torch.Tensor]:
        """Every rank's ``t`` of the slice along ``axes``, in the order of
        :meth:`group_ranks`, bit for bit, on ``t``'s device."""
        key = self._axes(axes)
        n = self.axis_size(key)
        if n == 1:
            return [t]
        _count.collective("all_gather", n * t.numel() * t.element_size())
        payload = self._payload(t)
        parts = [torch.empty_like(payload) for _ in range(n)]
        self._gather(parts, payload, key)
        return [p.view(t.dtype).reshape(t.shape).to(t.device) for p in parts]

    def _payload(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().contiguous().reshape(-1).view(torch.uint8)

    def _axes(self, axes) -> tuple:
        """``axes`` (a name or names) in mesh order; raise on one the mesh lacks."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in names if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh's {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)


def _meta_only(t: torch.Tensor) -> None:
    if t.device.type != "meta":
        raise RuntimeError(f"an AbstractMesh has no process group: a collective over a "
                           f"{t.device.type} tensor would return no other rank's data")


class AbstractMesh(_MeshAxes):
    """A mesh of shapes alone, JAX's ``jax.sharding.AbstractMesh``: named axes
    and the coordinates of ``rank`` (0 unless given), no process group and no
    device.  A :class:`NamedSharding` over it gives a leaf's shard shape
    (:meth:`NamedSharding.shard_shape`); ``opt_state_specs`` and
    ``registry.input_specs`` read its ``shape`` and ``axis_names``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *, rank: int = 0):
        self._set_axes(shape, axis_names)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = self.coords_of(rank)
        self.device = torch.device("meta")

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"

    def _reduce(self, t, key, op) -> None:
        """An all-reduce leaves the shape as it is."""
        _meta_only(t)

    def _gather(self, parts, payload, key) -> None:
        """An all-gather's parts are the shapes already made."""
        _meta_only(payload)

    def barrier(self) -> None:
        pass


class Mesh(_MeshAxes):
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
        self._set_axes(shape, axis_names)
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
        self.timed = False
        self.spent: dict[tuple, float] = {}
        self._groups: dict[tuple, tuple] = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                self._make_groups(axes)

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

    # ------------------------------------------------------------ collectives
    def _timed(self, key, fn) -> None:
        if not self.timed:
            fn()
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.spent[key] = self.spent.get(key, 0.0) + time.perf_counter() - t0

    def _reduce(self, t, key, op) -> None:
        self._timed(key, lambda: dist.all_reduce(t, op=_OPS[op], group=self._groups[key][0]))

    def _payload(self, t: torch.Tensor) -> torch.Tensor:
        src = t.detach().contiguous().reshape(-1)
        if self.backend == "gloo" and src.is_cuda:
            src = src.cpu()                    # gloo gathers host tensors only
        return src.view(torch.uint8)

    def _gather(self, parts, payload, key) -> None:
        self._timed(key, lambda: dist.all_gather(parts, payload, group=self._groups[key][0]))

    def barrier(self) -> None:
        dist.barrier()


def production_mesh_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """``(shape, axis_names)``: 16 x 16 (data, model), or 2 x 16 x 16 (pod,
    data, model) with ``multi_pod``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, backend: str, **kw) -> Mesh:
    """The production mesh (:func:`production_mesh_shape`) over a process group."""
    return Mesh(*production_mesh_shape(multi_pod), backend=backend, **kw)


def make_abstract_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> AbstractMesh:
    """The production mesh's shapes alone, with no process group (the dry-run's)."""
    return AbstractMesh(*production_mesh_shape(multi_pod), rank=rank)


def make_test_mesh(data: int = 2, model: int = 2, pods: int = 0, *, backend: str,
                   **kw) -> Mesh:
    """Small meshes: (pod, data, model) with ``pods``, else (data, model)."""
    if pods:
        return Mesh((pods, data, model), ("pod", "data", "model"), backend=backend, **kw)
    return Mesh((data, model), ("data", "model"), backend=backend, **kw)


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


#: seconds ``run_ranks`` waits, once it sees a rank dead without a result,
#: for the other ranks still running to end before it names the dead ones
DEATH_GRACE = 5.0


def run_ranks(fn: Callable, world_size: int, *args, init_method: str,
              timeout: float = 120.0) -> list:
    """Run ``fn(rank, world_size, init_method, *args)`` in ``world_size``
    processes started with ``spawn`` and return their results by rank.

    ``fn`` must be importable by name and its results picklable (numbers,
    strings, numpy arrays).  A rank that raises, or a world not done within
    ``timeout`` seconds, stops every process and raises here with the
    failing rank's traceback.  A rank that exits without a result is seen
    within a second; the ranks then get :data:`DEATH_GRACE` seconds more to
    end (or until every one has), and the error names every rank that exited
    without a result by then, so ranks that die a few seconds apart are all
    named.
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
                if any(r not in out and p.exitcode for r, p in enumerate(procs)):
                    grace = time.monotonic() + DEATH_GRACE
                    while (time.monotonic() < grace
                           and any(p.exitcode is None for r, p in enumerate(procs)
                                   if r not in out)):
                        time.sleep(0.05)
                    dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
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
        # arguments that no rank took would keep the queue's feeder thread
        # writing, and this process from exiting, for ever
        inbox.cancel_join_thread()
        inbox.close()
    return [out[r] for r in range(world_size)]
