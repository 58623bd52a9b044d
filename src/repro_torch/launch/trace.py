"""What the step profilers share: grouping a ``torch.profiler`` trace's device
kernels and summing them per step.

The port's own kernels are named by their ``__global__`` functions in
``kernels/csrc``; cuBLAS's products and PyTorch's other ops form one group
each.  Used by ``launch/trace_serve.py`` and ``launch/trace_train.py``.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

from ..kernels import build

#: the port's kernels: the ``__global__`` functions of ``kernels/csrc``
PORT_KERNELS = frozenset(re.findall(
    r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
    "".join(p.read_text() for p in sorted(build.CSRC.glob("*.cu")))))


def kernel_group(name: str) -> str:
    """The port's own kernels by name, cuBLAS's products, and PyTorch's other ops."""
    own = re.match(r"void \(anonymous namespace\)::(\w+)", name)
    if own and own.group(1) in PORT_KERNELS:
        return own.group(1)
    if "nvjet" in name or "gemm" in name or "cutlass" in name:
        return "cublas"
    return "torch_other"


def device_summary(prof, steps: int, traced_ms: float, top: int = 12) -> dict:
    """Per-step device busy time, idle share, launches, time by kernel group and
    top kernels of a trace of ``steps`` steps that took ``traced_ms`` each;
    raise if no device time."""
    by_name: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(v[1] for v in by_name.values()) / 1e3 / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    groups: dict[str, float] = defaultdict(float)
    for name, (_, us) in by_name.items():
        groups[kernel_group(name)] += us / 1e3 / steps
    return {
        "traced_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1 - busy_ms / traced_ms,
        "kernel_launches_per_step": sum(v[0] for v in by_name.values()) / steps,
        "ms_per_step_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [
            {"name": n[:80], "per_step": c / steps, "ms_per_step": us / 1e3 / steps}
            for n, (c, us) in ranked
        ],
    }
