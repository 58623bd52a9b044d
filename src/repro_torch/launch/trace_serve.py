"""Where a serving decode step spends its time on the card.

    python -m repro_torch.launch.trace_serve [--steps 16] [--trace out.json]

Builds qwen1.5-0.5b at full width in bf16 from a seeded init, warms a KV
cache of the serving shape (8 requests, prompt 128, cache 168) and runs
``--steps`` decode steps twice: once untraced, timed on the host clock around
work that ends in a synchronize, and once under ``torch.profiler``.  From the
trace it prints the device's busy time per step (the sum of kernel durations;
one stream, so kernels do not overlap), its idle share of the traced wall
time, the kernel launches per step, and the kernels by device time.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS
from ..models import build_model
from ..serve import ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    model = build_model(ARCHS[args.arch], device="cuda")
    params = model.init_params(torch.Generator().manual_seed(args.seed))
    B, P = args.requests, args.prompt_len
    srv = ServingEngine(model, params, cache_len=P + 2 * args.steps + 8, batch=B)
    gen = torch.Generator().manual_seed(args.seed)
    srv.prefill_tokens(torch.randint(0, model.cfg.vocab, (B, P), generator=gen).numpy())
    tok = torch.zeros((B, 1), dtype=torch.int64, device="cuda")

    def run(start: int) -> None:
        for i in range(args.steps):
            srv._step(tok, start + i)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(P)
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(P + args.steps)
        traced_ms = (time.perf_counter() - t0) / args.steps * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_name: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us()
    if not by_name:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(v[1] for v in by_name.values()) / 1e3 / args.steps
    launches = sum(v[0] for v in by_name.values()) / args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    res = {
        "card": torch.cuda.get_device_name(0),
        "host_ms_per_step": host_ms,
        "traced_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1 - busy_ms / traced_ms,
        "kernel_launches_per_step": launches,
        "top_kernels": [
            {"name": n[:80], "per_step": c / args.steps, "ms_per_step": us / 1e3 / args.steps}
            for n, (c, us) in top
        ],
    }
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
