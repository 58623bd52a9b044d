"""Training launcher: the synthetic token corpus -> train loop with checkpoints.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b|xlstm-1.3b [--full-config] \\
        [--device cuda|cpu] [--dtype bfloat16|float32] --steps 50 --batch 8 \\
        --seq 128 --ckpt-dir DIR

The port of ``repro.launch.train``: its flags and loop.  The corpus is
the JAX launcher's (``TokenDatasetSpec(dataset_id, max(256, batch * 32),
seq, vocab, seed)`` at 16 items per chunk), read by :class:`TokenLoader`, so
the batches are byte for byte the JAX loader's.  Each step is the model's
``loss`` (``DecoderLM`` or ``XLSTM``) -> gradient -> ``adamw_update``; the
initial parameters are drawn on the host from ``--seed`` and moved to the
model's device, so a seed gives the same weights on every device.  A
checkpoint every ``--ckpt-every`` steps and a final blocking one; a
``StragglerMonitor``, a ``PreemptionGuard`` and ``run_with_restarts`` around
the loop, which re-raises once its restart budget is spent.  The Hoard
cluster that the JAX launcher stripes the corpus over (``build_cluster``,
``materialize_token_dataset``) is host-side simulator code that arrives with
the stripe-store slice, and with it the JAX launcher's ``--data-root``.

``main`` returns the per-step losses and times, the restarts, and the
seconds the final save took.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from ..configs import ARCHS
from ..data import TokenDatasetSpec, TokenLoader
from ..models import build_model
from ..train import (
    AdamWConfig,
    CheckpointManager,
    PreemptionGuard,
    SamplerState,
    StragglerMonitor,
    config_digest,
    init_train_state,
    make_train_step,
    run_with_restarts,
)

#: items per stripe chunk of the training corpus, as the JAX launcher stripes it
ITEMS_PER_CHUNK = 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--dataset-id", default="train-corpus")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture (default: smoke config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="working dtype (default: the config's)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch] if args.full_config else ARCHS[args.arch].smoke()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    dspec = TokenDatasetSpec(args.dataset_id, n_sequences=max(256, args.batch * 32),
                             seq_len=args.seq, vocab=cfg.vocab, seed=args.seed)
    digest = config_digest(cfg)
    step_fn = make_train_step(model, opt_cfg)
    dev = model.device
    log: dict = {"losses": [], "step_ms": [], "restarts": 0, "ckpt_seconds": 0.0}

    def loop(resume) -> int:
        params, opt = init_train_state(model, torch.Generator().manual_seed(args.seed), opt_cfg)
        sampler = SamplerState(seed=args.seed)
        start = 0
        if resume is not None and ckpt.latest_step() is not None:
            start, params, opt, sampler = ckpt.restore(template={"params": params, "opt": opt})
            print(f"[restore] resumed from step {start}")
        loader = TokenLoader(dspec, batch=args.batch, items_per_chunk=ITEMS_PER_CHUNK,
                             state=sampler)
        monitor = StragglerMonitor()
        it = iter(loader)
        with PreemptionGuard() as guard:
            for step in range(start, args.steps):
                t0 = time.perf_counter()
                toks, labels = next(it)
                batch = {"tokens": torch.from_numpy(toks).long().to(dev),
                         "labels": torch.from_numpy(labels).long().to(dev)}
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])      # waits for the step to finish
                dt = time.perf_counter() - t0
                log["losses"].append(loss)
                log["step_ms"].append(dt * 1e3)
                if monitor.record(dt):
                    print(f"[straggler] step {step} took {dt:.2f}s")
                if step % 10 == 0 or step == args.steps - 1:
                    print(f"step {step:5d} loss={loss:.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} {dt * 1000:.0f}ms")
                if (step + 1) % args.ckpt_every == 0 or guard.should_stop:
                    ckpt.save(step + 1, params, opt, sampler=loader.state, config_digest=digest)
                if guard.should_stop:
                    print("[preempt] checkpointed and exiting")
                    break
        t0 = time.perf_counter()
        ckpt.save(args.steps, params, opt, sampler=loader.state, config_digest=digest,
                  blocking=True)
        log["ckpt_seconds"] = time.perf_counter() - t0
        return args.steps

    def on_restart(n, err):
        log["restarts"] = n
        print(f"[restart {n}] {err}")

    final = run_with_restarts(loop, on_restart=on_restart)
    print(f"done at step {final}; checkpoints in {ckpt_dir}")
    return {**log, "final_step": final, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
