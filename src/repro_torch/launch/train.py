"""Training launcher: Hoard-cached data -> train loop with checkpoints.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b|xlstm-1.3b|hymba-1.5b| \\
        deepseek-v2-lite-16b|mixtral-8x7b [--full-config] [--device cuda|cpu] \\
        [--dtype bfloat16|float32] --steps 50 --batch 8 --seq 128 --ckpt-dir DIR \\
        [--data-root DIR]

The port of ``repro.launch.train``: its flags and loop.  It builds the
paper's cluster (``build_cluster``: simulated clock, topology, stripe store,
cache, placement), points the store at ``--data-root`` (a fresh
``hoard_*`` temporary directory when none is given) and stripes the token
corpus there as real chunk files over the first four nodes' directories
(``TokenDatasetSpec(dataset_id, max(256, batch * 32), seq, vocab, seed)`` at
16 items per chunk, :func:`~repro_torch.data.materialize_token_dataset`).
:class:`TokenLoader` reads every batch back as node 0 through
``StripeStore.read_item``, CRC-verified and from the closest replica, so the
chunk files and the batches are byte for byte the JAX launcher's.  As in
JAX, each launch builds a fresh cache, so a second launch over the same
``--data-root`` stripes the corpus anew.

Each step is the model's ``loss`` (``DecoderLM``, dense or with routed
experts and, for deepseek-v2-lite-16b, MLA; ``XLSTM``; ``Hymba``) ->
gradient -> ``adamw_update``; the initial parameters are drawn on the host
from ``--seed`` and moved to the model's device, so a seed gives the same
weights on every device.  A checkpoint every ``--ckpt-every`` steps and a
final blocking one; a ``StragglerMonitor``, a ``PreemptionGuard`` and
``run_with_restarts`` around the loop, which re-raises once its restart
budget is spent.

The corpus holds tokens only, so ``internvl2-2b`` and ``whisper-large-v3``,
whose ``loss`` also needs ``img_emb`` or ``enc_emb``, are refused before the
model is built (:data:`NEEDS_EMBEDDINGS`); JAX's launcher fails on them too,
later, with a ``KeyError`` inside ``loss``.  Train those families through
``make_train_step`` with the embeddings in the batch.

``main`` returns the per-step losses and times (``step_ms``, and within it
``load_ms``, the host time ``next`` on the loader took), each step's item
ids and the CRC-32 of its token bytes, the restarts, the seconds the final
save and the corpus's striping took, and the data root.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
import zlib

import torch

from ..configs import ARCHS
from ..core import build_cluster
from ..data import TokenDatasetSpec, TokenLoader, materialize_token_dataset
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
#: family -> the batch entry its ``loss`` needs beside the corpus's tokens
NEEDS_EMBEDDINGS = {"vlm": "img_emb", "encdec": "enc_emb"}


def stripe_corpus(spec: TokenDatasetSpec, data_root, *, items_per_chunk: int,
                  prefix: str = "hoard_"):
    """Build the cluster and stripe ``spec`` under ``data_root`` (or a fresh
    temporary directory) over the first four nodes, as the JAX launchers do.

    Returns ``(topo, store, seconds)``, ``seconds`` the host time the
    striping took.
    """
    _, topo, store, cache, _ = build_cluster()
    store.root = data_root or tempfile.mkdtemp(prefix=prefix)
    t0 = time.perf_counter()
    materialize_token_dataset(store, cache, spec, topo.nodes[:4],
                              items_per_chunk=items_per_chunk)
    return topo, store, time.perf_counter() - t0


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
    ap.add_argument("--data-root", default=None,
                    help="directory of the striped corpus (default: a fresh temporary one)")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture (default: smoke config)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                    help="working dtype (default: the config's)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch] if args.full_config else ARCHS[args.arch].smoke()
    if cfg.family in NEEDS_EMBEDDINGS:
        raise SystemExit(f"{cfg.arch}: its loss needs {NEEDS_EMBEDDINGS[cfg.family]!r} beside "
                         "the tokens, which the token corpus does not hold; train it through "
                         "make_train_step with the embeddings in the batch")
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg, device=args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    dspec = TokenDatasetSpec(args.dataset_id, n_sequences=max(256, args.batch * 32),
                             seq_len=args.seq, vocab=cfg.vocab, seed=args.seed)
    topo, store, materialize_seconds = stripe_corpus(dspec, args.data_root,
                                                     items_per_chunk=ITEMS_PER_CHUNK)
    print(f"[hoard] dataset {args.dataset_id!r} striped over 4 nodes "
          f"({dspec.n_sequences} seqs x {args.seq} tokens)")
    digest = config_digest(cfg)
    step_fn = make_train_step(model, opt_cfg)
    dev = model.device
    log: dict = {"losses": [], "step_ms": [], "load_ms": [], "batch_ids": [],
                 "batch_crc32": [], "restarts": 0, "ckpt_seconds": 0.0,
                 "materialize_seconds": materialize_seconds, "data_root": store.root}

    def loop(resume) -> int:
        params, opt = init_train_state(model, torch.Generator().manual_seed(args.seed), opt_cfg)
        sampler = SamplerState(seed=args.seed)
        start = 0
        if resume is not None and ckpt.latest_step() is not None:
            start, params, opt, sampler = ckpt.restore(template={"params": params, "opt": opt})
            print(f"[restore] resumed from step {start}")
        loader = TokenLoader(store, dspec, topo.nodes[0], batch=args.batch, state=sampler)
        monitor = StragglerMonitor()
        it = iter(loader)
        with PreemptionGuard() as guard:
            for step in range(start, args.steps):
                t0 = time.perf_counter()
                toks, labels = next(it)
                load_ms = (time.perf_counter() - t0) * 1e3
                batch = {"tokens": torch.from_numpy(toks).long().to(dev),
                         "labels": torch.from_numpy(labels).long().to(dev)}
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])      # waits for the step to finish
                dt = time.perf_counter() - t0
                log["losses"].append(loss)
                log["step_ms"].append(dt * 1e3)
                log["load_ms"].append(load_ms)
                log["batch_ids"].append(loader.last_ids.tolist())
                log["batch_crc32"].append(zlib.crc32(toks.tobytes()))
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
