"""Serving launcher: batched generation over the synthetic prompt corpus.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b [--full-config] \\
        [--device cuda|cpu] [--dtype bfloat16|float32]

The port of ``repro.launch.serve``, for every arch of ``configs.ARCHS``: the
dense decoders, the MoE ``mixtral-8x7b`` and ``deepseek-v2-lite-16b`` (MLA),
``hymba-1.5b``, ``xlstm-1.3b``, ``internvl2-2b`` (as a text decoder: decoding
has no image path, in JAX neither) and ``whisper-large-v3`` (against the
engine's zero cross cache of 64 frames, as JAX's launcher serves it).  The
model runs from a seeded random init drawn on the host (one ``--seed`` gives
one model on the card and on the CPU), or with ``--init-on device`` on a
generator of ``--device``.  The prompts live in the Hoard cache:
as the JAX launcher does, ``main`` builds the cluster, stripes a prompt
corpus of ``max(64, requests)`` items at 8 items per chunk into a fresh
``hoard_serve_*`` temporary directory, and reads request ``i``'s prompt as
node 0 through ``StripeStore.read_item`` (CRC-verified, closest replica), so
both launchers serve the same prompts.  ``main`` returns the generated
tokens, the prompts and the timings as a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCHS
from ..data import TokenDatasetSpec
from ..models import build_model
from ..serve import ServeConfig, ServingEngine
from .train import stripe_corpus

#: items per stripe chunk of the prompt corpus, as the JAX launcher stripes it
PROMPT_ITEMS_PER_CHUNK = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture (default: smoke config)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="working dtype (default: the config's)")
    ap.add_argument("--init-on", default="host", choices=["host", "device"],
                    help="where the seeded weights are drawn: on the host (default; one "
                         "seed gives one model on every device) or on --device (seconds "
                         "instead of tens at full config, another draw than the host's)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch] if args.full_config else ARCHS[args.arch].smoke()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg, device=args.device)
    draw_on = model.device if args.init_on == "device" else "cpu"
    params = model.init_params(torch.Generator(device=draw_on).manual_seed(args.seed))

    dspec = TokenDatasetSpec("prompts", n_sequences=max(64, args.requests),
                             seq_len=args.prompt_len, vocab=cfg.vocab, seed=args.seed)
    topo, store, _ = stripe_corpus(dspec, None, items_per_chunk=PROMPT_ITEMS_PER_CHUNK,
                                   prefix="hoard_serve_")
    prompts = np.stack([
        np.frombuffer(store.read_item("prompts", i, topo.nodes[0]), np.int32)
        for i in range(args.requests)
    ])

    cache_len = args.prompt_len + args.new_tokens + 8
    srv = ServingEngine(model, params, cache_len=cache_len, batch=args.requests)
    _sync(model.device)
    t0 = time.perf_counter()
    out = srv.generate(prompts, ServeConfig(max_new_tokens=args.new_tokens,
                                            temperature=args.temperature, seed=args.seed))
    _sync(model.device)
    dt = time.perf_counter() - t0
    steps = args.prompt_len + args.new_tokens
    tps = args.requests * args.new_tokens / dt
    print(f"[serve] {cfg.arch} {cfg.dtype} on {model.device}: generated {out.shape} tokens "
          f"in {dt:.3f}s ({tps:.1f} tok/s, {steps} decode steps, "
          f"{dt / steps * 1e3:.3f} ms/step)")
    for i in range(min(2, args.requests)):
        print(f"req{i}: {out[i][:12].tolist()}")
    return {"tokens": out, "prompts": prompts, "seconds": dt, "tokens_per_s": tps,
            "steps": steps, "ms_per_step": dt / steps * 1e3}


if __name__ == "__main__":
    main()
