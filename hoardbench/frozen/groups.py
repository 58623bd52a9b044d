"""Grouping a profiler trace's device kernels: a frozen copy of
``repro_torch.launch.trace``'s ``kernel_group``, ``is_routed_expert_bmm`` and
``root_name``.  The port's own kernel names are read from its CUDA sources
(``port_kernels``), as the original reads them."""

from __future__ import annotations

import re
from pathlib import Path

#: CPU ranges the harness opens around the loop's parts; a root is looked for
#: below them
HARNESS_PREFIX = "hoardbench."


def port_kernels(csrc: Path) -> dict:
    """Each ``__global__`` function of the ``.cu`` files in ``csrc`` -> its source's stem."""
    return {
        name: p.stem
        for p in sorted(Path(csrc).glob("*.cu"))
        for name in re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                               p.read_text())
    }


def kernel_group(name: str, own_kernels) -> str:
    """The port's own kernels by name, cuBLAS's products, and PyTorch's other ops."""
    own = re.match(r"(?:void )?\(anonymous namespace\)::(?:\w+::)*(\w+)", name)
    if own and own.group(1) in own_kernels:
        return own.group(1)
    if "nvjet" in name or "gemm" in name or "cutlass" in name:
        return "cublas"
    return "torch_other"


def is_routed_expert_bmm(input_shapes, n_experts: int, d_expert: int, d_model: int) -> bool:
    """Whether an ``aten::bmm`` with these input shapes is one of the routed
    experts' products or their gradients: both operands (E, ., .), and among
    their inner dims the model width and the expert width."""
    if len(input_shapes) < 2 or any(len(s) != 3 for s in input_shapes[:2]):
        return False
    a, b = input_shapes[:2]
    inner = {*a[1:], *b[1:]}
    return a[0] == b[0] == n_experts and {d_model, d_expert} <= inner


def root_name(event) -> str:
    """The outermost CPU event above ``event`` below the harness's own ranges:
    an op, a profiler range, or an autograd node (without the engine's prefix)."""
    while event.cpu_parent is not None and not event.cpu_parent.name.startswith(HARNESS_PREFIX):
        event = event.cpu_parent
    return event.name.removeprefix("autograd::engine::evaluate_function: ")


def under(event, name: str) -> bool:
    """Whether ``event`` or a CPU event above it is named ``name``."""
    while event is not None:
        if event.name == name:
            return True
        event = event.cpu_parent
    return False
