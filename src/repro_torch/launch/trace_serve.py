"""Where a serving decode step spends its time on the card.

    python -m repro_torch.launch.trace_serve [--steps 16] [--trace out.json]

Builds qwen1.5-0.5b at full width in bf16 from a seeded init, warms a KV
cache of the serving shape (8 requests, prompt 128, cache 168) and runs
``--steps`` decode steps twice: once untraced, timed on the host clock around
work that ends in a synchronize, and once under ``torch.profiler``.  From the
trace it prints the device's busy time per step (the sum of kernel durations;
one stream, so kernels do not overlap), its idle share of the traced wall
time, the kernel launches per step, the time by kernel group and the
kernels by device time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS
from ..models import build_model
from ..serve import ServingEngine
from .trace import device_summary


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

    res = {"card": torch.cuda.get_device_name(0), "host_ms_per_step": host_ms,
           **device_summary(prof, args.steps, traced_ms)}
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
