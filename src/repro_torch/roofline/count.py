"""Counts of one step as PyTorch dispatches it: the port's ``roofline/hlo_walk.py``.

JAX prices a step from its compiled HLO; PyTorch has no HLO, so what the
port counts is its own dispatch.  :class:`StepCounter` is a
``TorchDispatchMode`` that sees every aten op of a step (the forward, the
autograd backward and the optimizer alike) and keeps:

* **matmul FLOPs** (``matmul_flops``): PyTorch's own formulas
  (``torch.utils.flop_counter.flop_registry``: ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolutions, attention), 2 a multiply-accumulate, exact
  integers;
* **a traffic proxy** (``aten_bytes``): the input plus output bytes of each
  aten op, views and ``empty`` counting zero;
* **each hand-written kernel call** (``kernels``), by name: the wrappers of
  ``kernels/ops.py`` enter :func:`kernel` around everything they run for one
  call (forward or backward), which is priced once by
  :mod:`repro_torch.kernels.cost`.  No aten op inside that entry is counted
  beside it: not the plain version's ops on the CPU, not the wrapper's own
  copies and products on the card or on meta.  So the same step gives the
  same counts on ``meta``, ``cpu`` and ``cuda``;
* **the peak of live tensor bytes** (``peak_bytes``): every storage an op
  makes is counted from its birth until PyTorch frees it (a weak reference
  on the storage), inside kernel entries too, on top of the storages alive
  when the count starts (``start_bytes``, from :meth:`StepCounter.track`).

Under a rematerialised block (``models/remat.py``) the recompute's aten ops
and kernel calls count again; the products that the selective policy
serves from its cache do not (they reach no mode below it), and what it
keeps counts toward the live bytes.  Every backward of ``kernels/ops.py``
reads its saved tensors, which starts its block's recompute, before it
enters its own kernel entry, so the recomputed kernels count as calls of
their own.

The hand-written kernels' costs and the aten counts add up to ``flops``
and ``traffic_bytes``; kernel costs are summed with ``math.fsum``, so their
order does not matter.

JAX's ``collective_bytes`` and ``_while_multipliers``
(``repro/roofline/analysis.py``) parse XLA's text; here each collective of
a mesh (``launch/mesh.py``: the tensor-parallel regions, the gradient sync,
the ZeRO gather) is one call of :func:`collective` with the bytes this
rank puts in (``collectives``, ``collective_bytes``), and the process
group's own ops (``c10d``) are not counted as aten ops, so a rank's step
counts the same on meta under an ``AbstractMesh`` as on a real rank.
PyTorch runs loops as they are.  The analytic cell
(:func:`repro_torch.roofline.table.analytic_cell`) keeps its own
collective term.

A host read (``.item()``, ``float(t)``) cannot run on meta; no step of the
port's models or of ``adamw_update`` has one.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

#: the counter of the step being counted, if any: the kernel wrappers read it
ACTIVE: Optional["StepCounter"] = None

_FREE_OPS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
             torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts of the aten ops and kernel calls run while it is entered (see
    the module's docstring).  One counter at a time: entering one sets
    :data:`ACTIVE`."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0
        self.aten_bytes = 0
        self.ops = 0
        self._kernels: dict[str, list] = {}
        self.collectives: dict[str, dict] = {}
        self._depth = 0
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.start_bytes = 0
        self.peak_bytes = 0

    # ------------------------------------------------------------ live bytes
    def _born(self, storage) -> None:
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, *trees) -> None:
        """Count the storages of every tensor in ``trees`` as alive from now
        (the state and the batch a step starts with): ``start_bytes``."""
        for t in _tensors(trees):
            self._born(t.untyped_storage())
        self.start_bytes = self.live_bytes

    # -------------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if self._depth == 0 and func.namespace != "c10d":
            self.ops += 1
            packet = func._overloadpacket
            formula = flop_registry.get(packet)
            if formula is not None:
                self.matmul_flops += int(formula(*args, **kwargs, out_val=out))
            if not (func.is_view or packet in _FREE_OPS):
                self.aten_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            s = t.untyped_storage()
            if id(s) not in held:
                self._born(s)
        return out

    def __enter__(self):
        global ACTIVE
        if ACTIVE is not None:
            raise RuntimeError("a step counter is already active")
        ACTIVE = self
        return super().__enter__()

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = None
        return super().__exit__(*exc)

    # --------------------------------------------------------------- kernels
    def kernel(self, name: str, cost, fn: Callable, *args):
        """``fn(*args)`` as one call of kernel ``name`` priced ``cost`` (a
        ``KernelCost``); aten ops inside count toward live bytes alone.  A
        kernel entry inside another is part of it.  The call counts when it
        is entered: a rematerialised block's recompute may stop with an
        exception inside the entry after the kernel ran (the checkpoint's
        early stop at the block's last saved tensor, which a forward
        ``autograd.Function`` saves after its launch)."""
        if self._depth == 0:
            self._kernels.setdefault(name, []).append(cost)
        self._depth += 1
        try:
            return fn(*args)
        finally:
            self._depth -= 1

    def collective(self, kind: str, nbytes: int) -> None:
        c = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += nbytes

    @property
    def kernels(self) -> dict:
        """Kernel name -> ``{"calls", "flops", "bytes", "transcendentals"}``."""
        return {name: {"calls": len(costs),
                       "flops": math.fsum(c.flops for c in costs),
                       "bytes": math.fsum(c.bytes_accessed for c in costs),
                       "transcendentals": math.fsum(c.transcendentals for c in costs)}
                for name, costs in sorted(self._kernels.items())}

    def result(self) -> dict:
        """The counts as a dict: ``flops`` and ``traffic_bytes`` (aten plus
        kernels), their parts, ``kernels``, ``aten_ops``, and the live-bytes
        figures (``peak_bytes`` includes ``start_bytes``)."""
        k = self.kernels
        kernel_flops = math.fsum(v["flops"] for v in k.values())
        kernel_bytes = math.fsum(v["bytes"] for v in k.values())
        return {
            "flops": float(self.matmul_flops) + kernel_flops,
            "traffic_bytes": float(self.aten_bytes) + kernel_bytes,
            "matmul_flops": self.matmul_flops,
            "aten_bytes": self.aten_bytes,
            "kernel_flops": kernel_flops,
            "kernel_bytes": kernel_bytes,
            "kernels": k,
            "collectives": {n: dict(c) for n, c in sorted(self.collectives.items())},
            "collective_bytes": sum(c["bytes"] for c in self.collectives.values()),
            "aten_ops": self.ops,
            "start_bytes": self.start_bytes,
            "peak_bytes": self.peak_bytes,
            "peak_above_start_bytes": self.peak_bytes - self.start_bytes,
        }


def kernel(name: str, cost: Callable, fn: Callable, *args):
    """``fn(*args)``, counted as one call of kernel ``name`` priced by
    ``cost()`` when a :class:`StepCounter` is active; plain ``fn(*args)``
    otherwise (one global read)."""
    counter = ACTIVE
    if counter is None:
        return fn(*args)
    return counter.kernel(name, cost(), fn, *args)


def collective(kind: str, nbytes: int) -> None:
    """Count one collective of ``nbytes`` this rank sends when a
    :class:`StepCounter` is active."""
    if ACTIVE is not None:
        ACTIVE.collective(kind, nbytes)


def count(fn: Callable, *args) -> tuple:
    """``(fn(*args), counts)``: run ``fn`` under a fresh :class:`StepCounter`
    whose start is the storages of ``args``."""
    counter = StepCounter()
    counter.track(args)
    with counter:
        out = fn(*args)
    return out, counter.result()
