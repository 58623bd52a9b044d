"""Where a training step spends its time on the card.

    python -m repro_torch.launch.trace_train [--arch qwen1.5-0.5b|xlstm-1.3b|hymba-1.5b|
        deepseek-v2-lite-16b|mixtral-8x7b|internvl2-2b|whisper-large-v3] [--layers N] \\
        [--batch 8] [--seq 512] [--steps 3] [--trace out.json]

Builds the architecture (default qwen1.5-0.5b) at full width and depth in
bf16 (``--layers`` cuts the depth: deepseek-v2-lite-16b's 15.7 B parameters
and their AdamW state do not fit one card; its dense ``layer0`` counts as
one of them) from a seeded init drawn on the card (xlstm-1.3b's 2.92 B draws are
slow on the host, and the values do not change what is timed;
``launch.train`` draws on the host instead), with a fresh
AdamW state and runs ``make_train_step`` on one batch of the training
corpus: two warm-up steps, ``--steps`` steps timed on the host clock around
work that ends in a synchronize, and ``--steps`` more under
``torch.profiler``.  From the trace it prints the device's busy time per
step (the sum of kernel durations; one stream, so kernels do not overlap),
its idle share of the traced wall time, the kernel launches per step, the
time by kernel group (the port's kernels by name, cuBLAS, PyTorch's other
ops), the same by source (the port's kernels by their ``csrc`` file: one
group per kernel wrapper, ``ssd_scan`` and ``ssd_scan_bwd`` for Hymba's scan)
and the kernels by device time, and the peak device memory of the run
(``torch.cuda.max_memory_allocated()``).  For a model with routed experts the
experts' batched products and their gradients form their own group,
``routed_experts``, as in ``trace_serve``.  internvl2-2b's ``--seq``
positions hold its 256 image tokens and ``seq - 256`` text tokens, and
whisper-large-v3 takes ``--seq`` text tokens over the 1500 frames of its
30-second window (:data:`WHISPER_FRAMES`): the image and frame embeddings
are drawn from a seeded generator on the card, as no corpus holds them.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS
from ..data import TokenDatasetSpec, TokenLoader
from ..models import build_model
from ..train import AdamWConfig, init_train_state, make_train_step
from .train import ITEMS_PER_CHUNK, NEEDS_EMBEDDINGS
from .trace import device_summary, split_routed_experts

#: encoder frames a sequence: Whisper's 30-second window
WHISPER_FRAMES = 1500


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params, opt = init_train_state(model, gen, opt_cfg)
    n_img = cfg.vlm.n_image_tokens if cfg.vlm is not None else 0
    text = args.seq - n_img
    spec = TokenDatasetSpec("train-corpus", n_sequences=max(256, args.batch * 32),
                            seq_len=text, vocab=model.cfg.vocab, seed=args.seed)
    toks, labels = next(iter(TokenLoader(spec, batch=args.batch, items_per_chunk=ITEMS_PER_CHUNK)))
    batch = {"tokens": torch.from_numpy(toks).long().cuda(),
             "labels": torch.from_numpy(labels).long().cuda()}
    if cfg.family in NEEDS_EMBEDDINGS:
        rows = n_img or WHISPER_FRAMES
        batch[NEEDS_EMBEDDINGS[cfg.family]] = torch.randn(
            (args.batch, rows, cfg.d_model), generator=gen, device="cuda", dtype=model.dtype)
    step = make_train_step(model, opt_cfg)

    def run(n: int) -> None:
        nonlocal params, opt
        for _ in range(n):
            params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()

    run(2)
    t0 = time.perf_counter()
    run(args.steps)
    host_ms = (time.perf_counter() - t0) / args.steps * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=cfg.moe is not None) as prof:
        t0 = time.perf_counter()
        run(args.steps)
        traced_ms = (time.perf_counter() - t0) / args.steps * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    res = {"card": torch.cuda.get_device_name(0), "arch": args.arch, "n_layers": cfg.n_layers,
           "host_ms_per_step": host_ms, "tokens_per_step": args.batch * text,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           **device_summary(prof, args.steps, traced_ms, top=20)}
    if cfg.moe is not None:
        split_routed_experts(prof, cfg, args.steps, res)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
