"""What the step profilers share: grouping a ``torch.profiler`` trace's device
kernels and summing them per step.

The port's own kernels are named by their ``__global__`` functions in
``kernels/csrc`` and grouped again by source file (one per kernel wrapper,
so the SSD scan's four forward launches form the group ``ssd_scan``);
cuBLAS's products and PyTorch's other ops form one group each; for a model
with routed experts, the experts' batched products form ``routed_experts``
(:func:`split_routed_experts`).  PyTorch's other ops are broken down again by
the outermost CPU event that launched them (:func:`root_name`): a forward op
by its own name (``aten::gelu``), a backward op by its autograd node
(``GeluBackward0``: the backward of the forward op of that name), and the
optimizer by its profiler range, ``adamw_update``.  Used by
``launch/trace_serve.py`` and ``launch/trace_train.py``.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

from ..kernels import build

#: the port's kernels: each ``__global__`` function of ``kernels/csrc`` -> its source's
#: stem.  Every kernel there is written ``__global__ void __launch_bounds__(...) name(``,
#: the bounds an expression such as ``Layout<kWG>::kThreads, 1``.
KERNEL_SOURCE = {
    name: p.stem
    for p in sorted(build.CSRC.glob("*.cu"))
    for name in re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(",
                           p.read_text())
}
PORT_KERNELS = frozenset(KERNEL_SOURCE)


def kernel_group(name: str) -> str:
    """The port's own kernels by name, cuBLAS's products, and PyTorch's other ops."""
    # a template kernel's name starts with its return type, a plain one's does not;
    # a kernel may sit in a namespace inside the anonymous one
    own = re.match(r"(?:void )?\(anonymous namespace\)::(?:\w+::)*(\w+)", name)
    if own and own.group(1) in PORT_KERNELS:
        return own.group(1)
    if "nvjet" in name or "gemm" in name or "cutlass" in name:
        return "cublas"
    return "torch_other"


def source_group(name: str) -> str:
    """The port's kernels by source file (``ssd_scan``, ``ssd_scan_bwd``, ...: one
    group per kernel wrapper), cuBLAS's products, and PyTorch's other ops."""
    group = kernel_group(name)
    return KERNEL_SOURCE.get(group, group)


def is_routed_expert_bmm(input_shapes, moe_cfg, d_model: int) -> bool:
    """Whether an ``aten::bmm`` with these input shapes is one of ``moe_block``'s
    routed-expert products or their gradients: both operands (E, ., .) and
    among their inner dims the model width D and the expert width F (buffers
    (E, C, D), weights (E, D, F) / (E, F, D), hidden (E, C, F), and their
    transposes in the backward)."""
    if len(input_shapes) < 2 or any(len(s) != 3 for s in input_shapes[:2]):
        return False
    a, b = input_shapes[:2]
    inner = {*a[1:], *b[1:]}
    return a[0] == b[0] == moe_cfg.n_experts and {d_model, moe_cfg.d_expert} <= inner


def split_routed_experts(prof, cfg, steps: int, res: dict) -> None:
    """Move the device time of the routed experts' batched products (forward and
    backward: :func:`is_routed_expert_bmm`) out of their kernels' groups in
    ``res`` into the group ``routed_experts``.  The trace must record shapes."""
    for e in prof.events():
        if e.name != "aten::bmm" or not is_routed_expert_bmm(e.input_shapes, cfg.moe,
                                                              cfg.d_model):
            continue
        for k in e.kernels:
            ms = k.duration / 1e3 / steps
            for key, group in (("ms_per_step_by_group", kernel_group(k.name)),
                               ("ms_per_step_by_source", source_group(k.name))):
                res[key][group] -= ms
                res[key]["routed_experts"] = res[key].get("routed_experts", 0.0) + ms


def root_name(event) -> str:
    """The outermost CPU event above ``event``: an op, a profiler range, or an
    autograd node (named without the engine's prefix)."""
    while event.cpu_parent is not None:
        event = event.cpu_parent
    return event.name.removeprefix("autograd::engine::evaluate_function: ")


def torch_other_by_root(events, steps: int, top: int = 16) -> dict:
    """Device ms a step of PyTorch's other kernels (``kernel_group`` "torch_other")
    by :func:`root_name` of the CPU event that launched them, the largest
    ``top``."""
    out: dict[str, float] = defaultdict(float)
    for e in events:
        for k in getattr(e, "kernels", ()):
            if kernel_group(k.name) == "torch_other":
                out[root_name(e)] += k.duration / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def device_summary(prof, steps: int, traced_ms: float, top: int = 12) -> dict:
    """Per-step device busy time, idle share, launches, time by kernel group and
    top kernels of a trace of ``steps`` steps that took ``traced_ms`` each;
    raise if no device time.  A profiler range (``adamw_update``) also
    appears on the device's timeline, spanning its kernels: it is no kernel
    and is not counted."""
    by_name: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(v[1] for v in by_name.values()) / 1e3 / steps
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    groups: dict[str, float] = defaultdict(float)
    sources: dict[str, float] = defaultdict(float)
    for name, (_, us) in by_name.items():
        groups[kernel_group(name)] += us / 1e3 / steps
        sources[source_group(name)] += us / 1e3 / steps
    return {
        "traced_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1 - busy_ms / traced_ms,
        "kernel_launches_per_step": sum(v[0] for v in by_name.values()) / steps,
        "ms_per_step_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "ms_per_step_by_source": dict(sorted(sources.items(), key=lambda kv: -kv[1])),
        "torch_other_ms_per_step_by_root": torch_other_by_root(prof.events(), steps),
        "top_kernels": [
            {"name": n[:80], "per_step": c / steps, "ms_per_step": us / 1e3 / steps}
            for n, (c, us) in ranked
        ],
    }
