"""Reading a ``torch.profiler`` trace of a few training steps.

:func:`reduce` turns the profiler's events into what the per-layer readers
take: the device's busy time (the union of its operations' intervals), its
operations' count, the device time under the
optimizer's range, of the routed experts' products, and of each group of
operations as the frozen grouping names them (``frozen.groups``), and the
device's idle gaps labelled by what the host was doing in them
(the harness's range and the outermost operation inside it; outside them
``host:between_ranges``).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

from .frozen import groups

#: the optimizer's profiler range in the program (``train/optimizer.py``)
ADAMW_RANGE = "adamw_update"
#: entries of each list of the breakdown
BREAKDOWN_ENTRIES = 10


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def _union(intervals):
    """Sorted, merged ``(start, end)`` intervals."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _host_label(tops, starts, t) -> str:
    """What the host ran at ``t``: the harness's range (``tops``, sorted by
    start) and the outermost event inside it."""
    i = bisect.bisect_right(starts, t) - 1
    if i < 0 or tops[i].time_range.end < t:
        return "host:between_ranges"
    top = tops[i]
    for c in top.cpu_children:
        if c.time_range.start <= t <= c.time_range.end:
            return f"{top.name}>{c.name.removeprefix('autograd::engine::evaluate_function: ')}"
    return top.name


def reduce(prof, steps: int, own_kernels, experts=None) -> dict:
    """The trace's sums over ``steps`` steps (all times in seconds).

    ``own_kernels``: the port's kernel names (``groups.port_kernels``);
    ``experts``: ``(n_experts, d_expert, d_model)`` for a model with routed
    experts (the trace must then record shapes)."""
    events = prof.events()
    dev = [e for e in events if _is_device(e)]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    by_group: dict = defaultdict(float)
    for e in dev:
        by_group[groups.kernel_group(e.name, own_kernels)] += e.time_range.elapsed_us() / 1e6
    merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy = sum(t - s for s, t in merged) / 1e6

    adamw = routed = 0.0
    torch_other: dict = defaultdict(float)
    for e in events:
        ks = getattr(e, "kernels", None)
        if not ks or _is_device(e):
            continue
        secs = sum(k.duration for k in ks) / 1e6
        if groups.under(e, ADAMW_RANGE):
            adamw += secs
        if (experts is not None and e.name == "aten::bmm"
                and groups.is_routed_expert_bmm(e.input_shapes, *experts)):
            routed += secs
            continue
        for k in ks:
            if groups.kernel_group(k.name, own_kernels) == "torch_other":
                torch_other[f"torch_other:{groups.root_name(e)}"] += k.duration / 1e6

    ops = {g: s for g, s in by_group.items() if g != "torch_other"}
    if routed:
        ops["cublas"] = ops.get("cublas", 0.0) - routed
        ops["routed_experts"] = routed
    ops.update(torch_other)

    tops = sorted((e for e in events if e.name.startswith(groups.HARNESS_PREFIX)
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in tops]
    gaps: dict = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gaps[_host_label(tops, starts, (a + b) / 2)] += (b - a) / 1e6

    return {
        "steps": steps,
        "busy_s": busy,
        "launches": len(dev),
        "own_s": sum(s for g, s in by_group.items() if g in own_kernels),
        "adamw_s": adamw,
        "routed_experts_s": routed,
        "device_ops": sorted(([n, s] for n, s in ops.items() if s > 0),
                             key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES],
    }
