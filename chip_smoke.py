#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, the result line last
    python3 chip_smoke.py --only mlstm    # card, build and one kernel check (or ssd, decode, flash)
    python3 chip_smoke.py --only serve    # card, build, the decode checks and the serve runs
    python3 chip_smoke.py --only embedded # card, build, internvl2-2b's and Whisper's phases
    python3 chip_smoke.py --only hoard    # card, build and the Hoard data-plane phase
    python3 chip_smoke.py --only multi    # card, build and the 4-rank phase (phase 11)
    python3 chip_smoke.py --only dryrun   # card, build, the H100 table and compute-plane checks
    python3 chip_smoke.py --only phi      # card, build, the phi configs' checks, serves, training
    python3 chip_smoke.py --only remat    # card, build and the remat check on qwen's train cell
    python3 chip_smoke.py --only tp       # card, build and the tensor-parallel phase (phase 13)

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. card: the card's name and power limit from ``nvidia-smi``; TF32 off.
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, fp32
   and bf16: the serving kernels at every shape at which a serve run of
   phase 5 launches them, read from the models' layouts
   (``serve_kernel_shapes``: rmsnorm rows of 512 (deepseek-v2-lite-16b's
   kv_ln), 1024, 1600, 2048, 2560, 3072, 4096 and 5120 and qwen3-4b's q_norm
   and k_norm head rows (128, 128) and (32, 128); SwiGLU (8, 1024, 2816), (8,
   1600, 5504), (8, 2048, 2688), (4, 2560, 9728), the phi configs' (8, 3072,
   8192) and (8, 5120, 17920) and deepseek-v2-lite-16b's layer0 (8, 2048,
   10944) and shared experts (8, 2048, 2816); decode attention G 1 over 168
   slots, G 5 over 168, G 4 at hd 128 over 88 and the phi configs' G 3 and G
   4 at hd 128 over 168) and a small shape; decode attention also at one
   long request (32768 slots), 8 requests of 4096, qwen3-4b's (G 4, hd
   128), hymba-1.5b's (G 5, window 1024 and none), G 16 and an hd that takes its ``simt`` route
   (``DECODE_SHAPES``), with valid lengths 0, 1, S, S + 40 and random and
   windows across its split plan's span edges, each call made twice and
   compared bit for bit, held against the plain version of its split plan
   and its ``simt`` kernel checked on the same inputs, three CUDA-graph
   replays on new inputs and valid lengths, and its times at the serving
   shape, at hymba-1.5b's and qwen3-4b's serving shapes and at two long
   caches by graph replay beside the ``simt`` kernel's and SDPA's; rmsnorm
   and SwiGLU timed at every serving shape too; rmsnorm also at the qwen,
   hymba-1.5b and MoE training rows (deepseek-v2-lite-16b's kv_ln (4096,
   512) and (4096, 2048), mixtral-8x7b's (8192, 4096)) and a ragged one
   (both its routes asserted; its device time from a replayed CUDA graph,
   its host path step by step); swiglu_mlp at the qwen, hymba-1.5b and
   deepseek-v2-lite-16b training shapes (layer0's (4096, 2048, 10944), the
   shared experts' (4096, 2048, 2816)), phi4-mini-3.8b's (2048, 3072, 8192)
   and at ragged shapes that reach each of its three routes
   (``SWIGLU_SHAPES``), the split-K route asserted at every serving shape;
   flash attention forward and backward at the five sweep shapes of
   ``tests/test_kernels.py``, their window and ragged rows again at hd 64 (the
   tensor-core route), a GQA shape (G 8, hd 128), causal queries behind a
   longer cache (q_offset 256) and the training shape, then
   with v narrower than q and k (``MOE_FLASH_SHAPES``: the sweep with v of
   half width, MLA's (192, 128) ragged, behind a longer cache, with a window
   and at deepseek-v2-lite-16b's training shape 2 x 16 x 2048, the smoke
   widths (48, 32) on the CUDA cores) and mixtral-8x7b's training shape (32
   heads over 8, 8192, window 4096), the tensor-core rows of these held to
   the plain versions with P and dS rounded as the route rounds them, each
   backward called twice and its two results compared bit for bit, and
   queries that see no key at hd 64 and at (192, 128) (zero gradients on
   the tensor-core route); autograd through ``ops.flash_attention`` against
   the plain backward, in bf16 at the qwen and deepseek training shapes
   through the tensor-core forward; the RMSNorm backward
   (``RMSNORM_BWD_SHAPES``) and the SwiGLU backward through
   ``ops.swiglu_mlp``, whose forward saves a = x Wg and b = x Wu
   (``SWIGLU_BWD_SHAPES``), at the qwen, hymba-1.5b, xlstm-1.3b and MoE
   training shapes and ragged ones, fp32 and bf16, each called twice and
   compared bit
   for bit, their routes asserted and their PR 12-17 kernels (``block``,
   ``simt``) checked on the same inputs.  Each bf16
   check prints the route it took, and the flash forward's and backward's
   routes are asserted.  Then each kernel's time beside its plain
   version's, one PyTorch library call's, and its bound from bytes and
   operations; the SwiGLU and flash forwards and the flash backward also
   beside their CUDA-core kernels (``simt_ms``) on the same inputs, and the
   flash backward beside SDPA's backward by backend (each forced with
   ``sdpa_kernel``; ``library_ms`` is the fastest that takes the inputs).
   The two backwards also by replayed CUDA graphs at qwen's and
   hymba-1.5b's shapes, beside PyTorch's autograd of the same function
   replayed the same way and their PR 12-17 kernels; the SwiGLU backward's
   kernel alone, and the SwiGLU forward and backward together; the RMSNorm
   backward wrapper's host path step by step.
   Also the mLSTM forward and backward (xlstm-1.3b's core): the CUDA-core
   route at the sweep of ``tests/test_kernels.py:130-141`` and the training
   shape, fp32 and bf16; the tensor-core route at four bf16 shapes of chunk
   128 up to the training shape, in the model's transposed layout (no copy)
   and contiguous, held to the plain versions with its bf16 roundings, each
   backward called twice and compared bit for bit, and timed by replayed
   CUDA graphs beside the CUDA-core kernels;
   the SSD scan forward and backward (hymba-1.5b's core) at the sweep of
   ``tests/test_extensions.py:19-30``, a chunk shorter than its length, a
   padded sequence (through ``models.hymba.ssd_scan``), the smoke shape,
   four shapes of chunk 128 and the training shape, fp32 and bf16, the
   tensor-core route asserted in bf16 at chunk 128 and held to the plain
   version with its bf16 roundings, each backward called twice and compared
   bit for bit, and timed beside the CUDA-core kernels; flash attention
   forward and backward at hymba-1.5b's training shapes (25 query heads
   over 5, 2176 positions, window 1024 and 0), and at deepseek-v2-lite-16b's
   and mixtral-8x7b's, those two also by replayed CUDA graphs, beside SDPA's
   fastest backend that takes their v (named; the others' refusals kept);
   flash forward and backward at internvl2-2b's and whisper-large-v3's
   shapes (``EMBEDDED_FLASH``: Whisper's encoder, 1500 frames, and cross
   attention, 448 or 32 queries over 1500 keys, non-causal with neither
   side a whole tile) and a small ragged non-causal row, held to the plain
   versions with the route's roundings and timed at four of them beside
   SDPA; decode attention over Whisper's 1500 cross frames; SwiGLU forward
   and backward at internvl2-2b's (4096, 2048, 8192).  phi4-mini-3.8b's
   training shapes: rmsnorm forward and backward (2048, 3072), SwiGLU
   forward and backward (2048, 3072, 8192), flash forward and backward (2,
   24 / 8, 1024, 128) causal, held to the plain versions and timed
   (``phi4_*`` keys, the flash rows' ``phi4``).
4. full width: qwen1.5-0.5b in fp32, one ``decode_step`` on the card against
   the same weights on the CPU; then, cut to 2 layers, ``loss`` and every
   gradient leaf on a (2, 200) batch against the CPU; then xlstm-1.3b in
   fp32 cut to 8 layers (7 mLSTM + 1 sLSTM), ``loss``, every gradient leaf
   and ``prefill`` on a (1, 256) batch against the CPU; then hymba-1.5b in
   fp32 cut to 4 layers and a window of 256, the same on a (1, 384) batch;
   deepseek-v2-lite-16b in fp32 cut to 2 layers (layer0 and 1 MoE layer)
   and mixtral-8x7b cut to 1 layer and a window of 64, the same on a (1,
   256) batch, the routing of every MoE layer compared with the CPU's first
   (``on_both_routed``: a difference passes only at a near-tie, which is
   printed and counted, and the CPU then runs again with the card's experts
   replayed through ``moe_route``); internvl2-2b in fp32 cut to 2 layers,
   loss, every gradient leaf and the image-prefixed prefill on 256 image
   and 200 text positions; whisper-large-v3 cut to 1 + 1 layers, the same
   on 1 x (1500 frames, 448 tokens), then ``encode`` of 2 x 1500 frames and
   8 decode steps over a cross cache filled from it, against the CPU.
   Decoding at full width in fp32 against the CPU with the same weights
   (``--only serve`` runs these and phase 5): qwen3-4b cut to 2 layers, one
   ``decode_step``, then ``loss``, every gradient leaf and ``prefill``; the
   same for phi4-mini-3.8b and phi3-medium-14b cut to 1 layer
   (``PHI_CHECK_LAYERS``; hd 128, groups of 3 and 4); hymba-1.5b cut to 4 layers (global 0 and 3) and a window of 64, 64
   ``decode_step``s from index 128 (the meta offset) on a random cache, so
   the ring of 64 slots wraps, the logits at every step and every cache leaf
   at the end within 2e-3; xlstm-1.3b cut to 8 layers, 32 steps from the
   zero state, the logits within 2e-3 at every step and the last within
   2e-3 of the card's ``prefill`` of the same 32 tokens; deepseek-v2-lite-16b
   cut to 2 layers (layer0 and 1 MoE layer), 16 steps of 8 requests from a
   zero cache at index 0 and 16 from a random latent cache at index 100;
   mixtral-8x7b cut to 1 layer and a window of 64, 16 steps of 8 requests
   from index 116 on a random cache, across the ring's end.  For the two MoE
   models the routing of every MoE layer and step is compared with the
   CPU's first: it may differ only at a near-tie (the k-th and (k+1)-th
   router probabilities within 1e-5 on both devices), which is printed and
   counted, the step's logits then not compared and the CPU handed the
   card's cache; any other difference fails.
5. serve: deepseek-v2-lite-16b's smoke config in fp32, ``prefill`` on the
   card through the flash kernel (v narrower than q and k) equal to the
   CPU's; a small fp32 serve at the smoke configs of qwen1.5-0.5b, hymba-1.5b, xlstm-1.3b,
   deepseek-v2-lite-16b, mixtral-8x7b, internvl2-2b and whisper-large-v3 through
   ``repro_torch.launch.serve.main`` on the card and on the CPU (one seed
   names one model on both), token for token; then nine bf16 runs at full
   config through ``repro_torch.launch.serve.main`` (``SERVE_RUNS``; the
   weights drawn on the card, ``--init-on device``):
   qwen1.5-0.5b, hymba-1.5b, xlstm-1.3b, deepseek-v2-lite-16b (27 layers,
   15.7 B parameters), internvl2-2b (a text decoder), whisper-large-v3
   (the engine's 64 zero frames), phi4-mini-3.8b (32 layers) and
   phi3-medium-14b (40 layers, 28 GB in bf16) with 8 requests, prompt 128
   and 32 new tokens, qwen3-4b with 4, 64 and 16; each model freed before
   the next.  Each with the kernels' launch counts set to 0 just
   before and read just after, each kernel's count equal to its launches per
   decode step times the steps; every swiglu_mlp launch must have taken the
   split-K tensor-core route, every rmsnorm the ``vec`` body, every
   decode_attention the ``split`` route, every call at a shape that phase 3
   checked (``launched_shapes``), the decode-attention wrapper must have made
   no valid_len tensor (the models pass one a step), and the tokens must lie
   in the config's vocabulary; ms per decode step, tokens/s and peak device
   memory printed.  Then xlstm-1.3b's plain mLSTM update alone at its serving
   shape, by CUDA-graph replay, beside its bound; internvl2-2b's
   image-prefixed prefill (2 x (256 + 128)); Whisper outside the engine:
   ``encode`` of 8 x 1500 frames, the cross cache filled from it, 32 decode
   steps over it and their last logits against ``prefill`` of the same
   tokens (``BF16_LOGIT_TOL``), every launch counted and at a checked shape.
6. train: every training step below runs its config's rematerialisation,
   JAX's ``"dots"`` (``REMAT``): a block's forward kernels run twice a step
   (the forward and the recompute in the backward pass), its backward
   kernels once, the final norm once; the launches a step are derived from
   each model's blocks (``train_launches``: qwen1.5-0.5b's rmsnorm 2 x 2 x
   24 + 1, its backward 49, SwiGLU and flash 48 forward and 24 backward).
   qwen1.5-0.5b in bf16, full width and depth, through
   ``repro_torch.launch.train.main`` (batch 8, seq 512, 6 steps, a final
   checkpoint and ``--data-root`` in temporary directories under
   ``build/``), with the launch counts set to 0 just before and checked per
   step just after, every swiglu_mlp and flash_attention launch (forward
   and backward) on the tensor-core route and every rmsnorm (forward and
   backward) on ``vec``; the corpus the launcher striped checked on disk
   (``check_train_corpus``: every chunk file of ``node0..node3`` with its
   manifest CRC and the seeded bytes, every batch the run read equal to
   the seeded rows at its ids), the loader's ms a step and its share of the
   step printed; then the remat check (``remat_check``, alone by ``--only
   remat``): the loss and every gradient of one step at the run's 8 x 512
   from the same weights under ``"none"``, ``"dots"`` and ``"full"``, equal
   bit for bit, each policy's launches counted, its ms, its peak above the
   start and the step counter's peak on meta printed; then 8 steps on one
   fixed batch, whose loss must fall by 0.05.  Then the Hoard data plane
   (``phase_hoard``, alone by ``--only hoard``): (a) 8 x 512 records of qwen's
   tokens read through HoardFS (``FileDataset.read_item_bytes``), the
   simulated clock drained, decoded on the card and equal to the
   ``TokenLoader``'s rows, then two bf16 steps at full width with
   ``TRAIN_PER_STEP`` launches a step; (b) a 317 MB bf16
   and fp32 state (the smoke train state and qwen's full-width embedding)
   saved and restored through ``HoardCheckpointManager``, bit for bit on
   the card, its MB/s printed; (c) a flipped byte in one replica of a
   corpus at replication 2 read back right and healed.  The launchers'
   corpora in phases 6 to 10 are striped under ``build/`` and read through
   the stripe store.
7. train xLSTM: ``launch.train.main`` for xlstm-1.3b at its smoke config on
   the card, with a checkpoint; then xlstm-1.3b in bf16 at full width, cut
   to 8 of its 48 layers (``XLSTM_TRAIN``), batch 4 x seq 512 from the launcher's corpus, 2 steps
   of ``make_train_step`` with the launch counts set to 0 just before and
   checked per step just after (the routes as qwen's: the SwiGLU forward and
   backward on the tensor cores, every rmsnorm on ``vec``; and every mLSTM
   scan forward and backward on the tensor cores), the peak memory of the
   steps and of one loss and gradient alone, and 8 steps on a fixed (2, 128)
   batch.
8. train Hymba: the same for hymba-1.5b: ``launch.train.main`` at its smoke
   config with a checkpoint, then the full model in bf16 (32 layers), batch
   2 x seq 2048 from the launcher's corpus, 4 steps with the launch counts
   checked per step (and the routes, as qwen's, and every SSD scan forward
   and backward on the tensor cores), and 8 steps on a fixed
   (2, 128) batch.
9. train MoE: the same for deepseek-v2-lite-16b and mixtral-8x7b, each
   ``launch.train.main`` at its smoke config with a checkpoint, then in bf16
   at full width and a cut depth (``DEEPSEEK_TRAIN``: 4 layers, batch 2 x
   2048; ``MIXTRAL_TRAIN``: 2 layers, 1 x 8192), 4 steps with the launch
   counts checked per step (``DEEPSEEK_PER_STEP``, ``MIXTRAL_PER_STEP``) and
   the routes as qwen's (every flash forward and backward on the tensor
   cores: MLA's (192, 128) for deepseek), and 8 steps on a fixed (2, 128)
   batch.
10. train VLM and Whisper: ``launch.train`` must refuse internvl2-2b and
   whisper-large-v3 (their loss needs ``img_emb`` / ``enc_emb``); then each
   in bf16 at full width and depth through ``make_train_step`` with seeded
   embeddings in the batch (``train_embedded``): internvl2-2b on 2 x (256 +
   1792) positions, whisper-large-v3 on 4 x (1500 frames, 448 tokens), 4
   steps with the launch counts checked per step (``INTERNVL_PER_STEP``,
   ``WHISPER_PER_STEP``), the routes (every flash on the tensor cores) and
   every launch at a checked shape, and 8 steps on a fixed batch whose loss
   must fall by 0.05.  Then phi4-mini-3.8b as the MoE models (phase 9) at
   full width and depth (32 layers, 4.45 B parameters), batch 2 x 1024
   (``PHI4_TRAIN``: the step counter on meta puts its peak at 72.3 GiB), no
   checkpoint; phi3-medium-14b is not trained (its fp32 AdamW state alone is
   about 168 GB).  ``--only phi`` runs the phi configs' fp32 checks, serve
   runs and this training run.
11. multi (``phase_multi``, alone by ``--only multi``): 4 ranks spawned on
   the one card over ``gloo`` (``mesh.run_ranks``, rendezvous through a file
   under ``build/``, a timeout on the world and on every collective), mesh
   pod 2 x data 2 x model 1, qwen1.5-0.5b in bf16 at full width, cut to 4
   layers (``MULTI``; 24 until the tensor-parallel phase joined the script),
   parameters of seed 0 drawn on the card in every rank, the train phase's
   8 x 512 batch read through the stripe store, 2 rows a rank.  The parent
   first takes the whole batch's gradient in one process.  (a) 3 steps of
   ``make_train_step(model, opt_cfg, mesh)`` with the plain sync, each
   rank's launches exactly ``MULTI_PER_STEP`` a step on ``TRAIN_ROUTES``;
   after step 1 every rank's synced gradient within ``GRAD_TOL`` of the
   parent's, the ZeRO-1 update equal bit for bit to ``adamw_update`` on
   the same gradient (parameters, every state shard, the grad norm; one
   rank at a time), and every rank's parameters equal to rank 0's.  (b)
   The compressed sync of step 1's gradients within 0.02 of each leaf's
   largest entry of the plain sync (JAX's bound), its residual nonzero and
   equal to gf - deq exactly; one whole compressed step at the end.  (c)
   The ZeRO state of (a) saved whole, restored at pod 1 x data 4 on the
   same ranks (every shard equal to its slice of the gathered leaves) and
   onto the one device in the parent (every leaf's CRC equal).  (d) Flash
   decoding over the model axis of a data 1 x model 4 view, q (8, 16, 1,
   64) over a 32768-slot cache, 8192 slots a rank, valid lengths 1, 130,
   8193 and 32768, within ``TOL`` of the decode-attention kernel on the
   whole cache in bf16 and fp32.  Prints each step's ms, the sync, update
   and gather ms a step, the peak GiB a rank, and the card's name and
   power limit.
12. compute plane (PR 28's dry-run and roofline): ``check_h100_values``
   after the kernel checks (the H100 table the meta route reads, against the
   card's properties and ``rt_rmsnorm_bwd_vec_config``); then, after the
   timed steps of the train, Hymba, deepseek, mixtral, internvl2, Whisper and
   phi4-mini-3.8b phases, one counted step of ``train.step_costs`` on the card and the same
   step counted on the meta device with no weights (``dryrun_check``): (a)
   FLOPs, traffic and every kernel's entries equal, (b) the meta live-bytes
   peak within ``DRYRUN_TOL`` of ``max_memory_allocated`` over the counted
   step, (c) the median step no faster than ``analytic_cell`` on mesh 1x1
   (H100 constants); the xLSTM phase has none (its sLSTM loop takes minutes
   to count on meta).  The train phase also runs ``run_scenario`` on the cut
   workload of ``SCENARIO`` with ``hoard`` and ``posix``, its compute
   ``RooflineCompute`` at qwen's measured step (``scenario_check``).
   ``--only dryrun`` runs these alone, each cell on a random batch after 3
   timed steps of its own.
13. tp (``phase_tp``, alone by ``--only tp``): tensor parallelism of the
   ``model`` axis and data-parallel MoE, 4 ranks spawned on the one card
   over ``gloo`` as in phase 11, bf16.  The parent first checks the kernels
   at the shard shapes against the plain versions, forward and backward
   (``TP_RMSNORM``, ``TP_SWIGLU``: SwiGLU at F / model 1408, 704, 5472,
   2736; ``TP_FLASH``: 8 and 4 heads a rank at (64, 64) and (192, 128)),
   with their times, bounds and the library's, and takes each model's
   single-process step on the whole batch (``tp_reference``).  (a)
   qwen1.5-0.5b at full width and depth on the train phase's 8 x 512 batch
   (the stripe store): data 2 x model 2, 3 steps; data 1 x model 4, one
   step; the ZeRO + TP state of data 2 x model 2 saved whole, restored at
   data 1 x model 4 on the same ranks (every shard equal to its slice of
   the gathered leaf) and onto the one device in the parent (every leaf's
   CRC equal).  (b) deepseek-v2-lite-16b at 4 layers on 2 x 2048 (its own corpus)
   over data 2 x model 2, one step: its 64 experts 32 a rank, its routing
   the global batch's, each MoE layer routed through the single-process
   step's experts (the ranks' own routing compared and reported first); the
   dropped pairs summed over the data ranks equal the single process's, aux
   within ``TP_AUX_TOL`` and the aux of rank-local means (the fault of a
   routing that ignores the data axis) outside it.  In both, after step 1 every rank's synced
   gradient shards within ``GRAD_TOL`` of their slices of the single-process
   gradient (of each leaf's largest entry) and the loss within
   ``TP_LOSS_TOL``; every step's launches exactly ``TRAIN_PER_STEP`` /
   ``DEEPSEEK_PER_STEP`` on ``TRAIN_ROUTES``, every launch at a checked
   shape; the replicated leaves equal on every rank, bit for bit.  Prints
   each step's ms, the TP all-reduce, data sync, update and gather ms a step
   (each span ending in a synchronize), the peak GiB a rank, and the card's
   name and power limit.
14. output: one ``{"serve": ...}``, ``{"serve_hymba": ...}``,
   ``{"serve_xlstm": ...}``, ``{"serve_qwen3": ...}``, ``{"serve_deepseek":
   ...}`` (with the MoE decode checks' near-ties), ``{"serve_internvl2":
   ...}``, ``{"serve_whisper": ...}``, ``{"serve_phi4": ...}``,
   ``{"serve_phi3": ...}``, ``{"train": ...}`` (the remat check under
   ``remat``), ``{"hoard": ...}``,
   ``{"train_xlstm": ...}``, ``{"train_hymba": ...}``, ``{"train_deepseek":
   ...}`` and ``{"train_mixtral": ...}`` (with the fp32 loss checks'
   near-ties), ``{"train_internvl2": ...}``, ``{"train_whisper": ...}``,
   ``{"train_phi4": ...}``, ``{"multi": ...}``, ``{"tp": ...}``,
   ``{"h100_table": ...}`` and ``{"kernels": [...]}`` line (the rows of
   rmsnorm, SwiGLU and flash, forward and backward, with the shard shapes'
   checks and times as ``tp_shapes``), then the last line ``{"ok": true,
   "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen1.5-0.5b"
SERVE = dict(requests=8, prompt_len=128, new_tokens=32)
CACHE_LEN = SERVE["prompt_len"] + SERVE["new_tokens"] + 8      # as launch/serve.py sizes it
VALID = SERVE["prompt_len"] + SERVE["new_tokens"]              # visible positions, last step
TRAIN = dict(batch=8, seq=512, steps=6)
TRAIN_ROWS = TRAIN["batch"] * TRAIN["seq"]
#: (N, D, F) of hymba-1.5b's SwiGLU at its training shape (2 x 2176 rows)
HYMBA_SWIGLU = (4352, 1600, 5504)
#: (N, D, F) of deepseek-v2-lite-16b's dense MLPs at its training shape (2 x 2048
#: rows): layer0's (d_ff 10944) and the 2 shared experts' (2 x 1408)
DEEPSEEK_SWIGLU = ((4096, 2048, 10944), (4096, 2048, 2816))
#: (N, D, F) of internvl2-2b's SwiGLU at its training shape (2 x (256 + 1792) rows),
#: and at its image-prefixed prefill and fixed training batch (2 x (256 + 128))
INTERNVL_SWIGLU = (4096, 2048, 8192)
INTERNVL_PREFIX_SWIGLU = (768, 2048, 8192)
PHI4 = "phi4-mini-3.8b"
PHI3 = "phi3-medium-14b"
#: phi4-mini-3.8b trained in bf16 at full width and depth (32 layers, 4.45 B
#: parameters) on 2 x 1024 tokens: its weights, bf16 gradients and fp32 AdamW
#: state take 66.3 GiB, and the step counter on meta puts the step's peak at
#: 72.3 GiB at every batch from 1 x 512 to 2 x 1024 (the update's temporaries
#: outgrow the activations), so neither the depth nor the batch is cut
PHI4_TRAIN = dict(batch=2, seq=1024, steps=4)
#: its kernels' shapes: rmsnorm (rows, D), SwiGLU (rows, D, F), flash (B, Hq, Hkv,
#: Sq, Skv, hd, hdv, causal, window)
PHI4_ROWS = PHI4_TRAIN["batch"] * PHI4_TRAIN["seq"]
PHI4_RMSNORM = (PHI4_ROWS, 3072)
PHI4_SWIGLU = (PHI4_ROWS, 3072, 8192)
PHI4_FLASH = (PHI4_TRAIN["batch"], 24, 8, PHI4_TRAIN["seq"], PHI4_TRAIN["seq"], 128, 128,
              True, 0)
#: (rows, D) of the rmsnorm forward and backward at the MoE training shapes:
#: deepseek-v2-lite-16b's kv_ln on the MLA latent (512) and its d_model norms
#: (2 x 2048 rows); mixtral-8x7b's d_model norms (1 x 8192 rows)
MOE_RMSNORM = ((4096, 512), (4096, 2048), (8192, 4096))
#: (N, D, F): the serving and the qwen training shape, ragged shapes that reach
#: the split-K route (20 rows) and the 128-row route (333 rows) with D and F no
#: multiple of the tiles, a bf16 shape that TMA refuses (D = 100, not a multiple
#: of 8: the CUDA-core route), and hymba-1.5b's training shape
#: of hymba-1.5b's training shape, the MoE, internvl2-2b and phi4-mini-3.8b training
#: shapes; the other models' serving shapes join them in ``check_swiglu``
#: (``serve_kernel_shapes``)
SWIGLU_SHAPES = ((SERVE["requests"], 1024, 2816), (TRAIN_ROWS, 1024, 2816), (20, 96, 224),
                 (333, 200, 712), (37, 100, 260), HYMBA_SWIGLU, *DEEPSEEK_SWIGLU,
                 INTERNVL_SWIGLU, INTERNVL_PREFIX_SWIGLU, PHI4_SWIGLU)
TOL = {  # tests/test_kernels.py
    "rmsnorm": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "swiglu_mlp": {torch.float32: 1e-4, torch.bfloat16: 5e-2},
    "decode_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "flash_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
}
#: gradients: fp32 sums in another order; bf16 outputs rounded once
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
#: (B, Hq, Hkv, Sq, Skv, hd, causal, window): the sweep of tests/test_kernels.py:32-36,
#: its window (G 4) and ragged rows again at hd 64, where they take the
#: tensor-core routes, then GQA with G 8 and hd 128, causal queries behind a
#: longer cache (q_offset = Skv - Sq, as every causal shape here takes), then
#: the training shape
FLASH_SHAPES = (
    (1, 2, 2, 128, 128, 32, True, 0),
    (2, 4, 2, 256, 256, 64, True, 0),
    (1, 8, 2, 192, 192, 32, True, 64),
    (2, 2, 2, 128, 256, 64, False, 0),
    (1, 4, 4, 100, 100, 16, True, 0),
    (1, 8, 2, 192, 192, 64, True, 64),
    (1, 4, 4, 100, 100, 64, True, 0),
    (1, 16, 2, 300, 300, 128, True, 0),
    (1, 4, 2, 200, 456, 64, True, 0),
    (TRAIN["batch"], 16, 16, TRAIN["seq"], TRAIN["seq"], 64, True, 0),
)
#: the rematerialisation of every config's blocks in training (``ModelConfig.remat``,
#: JAX's default), at which the launch counts a step are derived
REMAT = "dots"
#: the hand-written forward kernels of a training step, each with a backward kernel
#: of its own (``NAME_bwd``)
TRAIN_KERNELS = ("rmsnorm", "swiglu", "flash_attention", "mlstm_scan", "ssd_scan")


def train_launches(blocks: dict, outside: dict | None = None, remat: str = REMAT) -> dict:
    """Kernel launches a training step from its structure: ``blocks`` the forward
    kernels of the model's blocks, ``outside`` those outside every block (the
    final norm).  A block's forward kernels run once in the forward and, under
    a remat policy other than ``"none"``, once more in the backward pass's
    recompute; every backward kernel runs once for each kernel of the forward;
    no decode attention."""
    outside = outside or {}
    runs = 1 if remat == "none" else 2
    out = {"decode_attention": 0}
    for name in TRAIN_KERNELS:
        n, once = blocks.get(name, 0), outside.get(name, 0)
        out[name] = runs * n + once
        out[f"{name}_bwd"] = n + once
    return out


#: qwen1.5-0.5b's 24 layers: 2 norms, one attention and one SwiGLU each; the final norm
QWEN_BLOCKS = ({"rmsnorm": 2 * 24, "swiglu": 24, "flash_attention": 24}, {"rmsnorm": 1})
#: kernel launches per training step of qwen1.5-0.5b
TRAIN_PER_STEP = train_launches(*QWEN_BLOCKS)
#: the route every launch of these modules must take in the bf16 runs: the
#: tensor cores at training rows (qwen and Hymba; xLSTM has only SwiGLU), with
#: split-K at serving's 8 rows, the SwiGLU backward too; every rmsnorm forward
#: and backward on the one-warp-a-row body
TRAIN_ROUTES = {"swiglu": "wgmma", "flash_attention": "wgmma", "flash_attention_bwd": "wgmma",
                "rmsnorm": "vec", "swiglu_bwd": "wgmma", "rmsnorm_bwd": "vec"}
SERVE_ROUTES = {"swiglu": "wgmma_split_k", "rmsnorm": "vec", "decode_attention": "split"}
XLSTM = "xlstm-1.3b"
#: 2 timed steps (4 before the blocks were rematerialised): under "dots" the
#: selective checkpoint's dispatch mode sees each of the sLSTM loop's ops, in the
#: forward and again in the recompute, and a step takes 3-4x as long
#: at 8 of its 48 layers (one of its 6 groups of 7 mLSTM blocks and one sLSTM
#: block) since the tensor-parallel phase joined the script: its sLSTM loop
#: sets the phase's time
XLSTM_TRAIN = dict(batch=4, seq=512, steps=2, layers=8)
XLSTM_GROUPS = XLSTM_TRAIN["layers"] // 8
#: kernel launches per training step of xlstm-1.3b at that depth (each mLSTM
#: block: 2 norms and one scan; each sLSTM block: 3 norms and one SwiGLU; the
#: final norm)
XLSTM_PER_STEP = train_launches({"rmsnorm": 2 * 7 * XLSTM_GROUPS + 3 * XLSTM_GROUPS,
                                 "swiglu": XLSTM_GROUPS, "mlstm_scan": 7 * XLSTM_GROUPS},
                                {"rmsnorm": 1})
XLSTM_ROUTES = {"swiglu": "wgmma", "rmsnorm": "vec", "swiglu_bwd": "wgmma", "rmsnorm_bwd": "vec",
                "mlstm_scan": "wgmma", "mlstm_scan_bwd": "wgmma"}
#: (B, H, S, dqk, dv, chunk): the sweep of tests/test_kernels.py:130-141, then the
#: training shape of xlstm-1.3b (dqk 512, dv 1024, chunk 128)
MLSTM_SHAPES = tuple((2, 2, 256, dqk, dv, chunk) for chunk in (32, 64, 128)
                     for dqk, dv in ((16, 32), (32, 32))) + ((4, 4, 512, 512, 1024, 128),)
#: (B, H, S, dqk, dv, chunk) of the tensor-core route's checks, bf16: one chunk
#: (no carried state), dqk 64 (half of a 128-column tile), three chunks, and the
#: training shape of xlstm-1.3b
MLSTM_TC_SHAPES = ((1, 2, 128, 64, 64, 128), (2, 2, 256, 64, 128, 128),
                   (1, 3, 384, 128, 256, 128), (4, 4, 512, 512, 1024, 128))
#: mLSTM outputs and gradients, relative to the largest entry (entries grow with
#: dqk): tests/test_kernels.py:154 in fp32, one bf16 rounding in bf16; the
#: tensor-core route against the plain version with the same bf16 roundings
#: (``bf16_products``) is held to the bf16 bound
MLSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
HYMBA = "hymba-1.5b"
HYMBA_TRAIN = dict(batch=2, seq=2048, steps=4)
#: kernel launches per training step of hymba-1.5b (32 blocks: 4 norms, one
#: attention, one scan and one SwiGLU each; the final norm)
HYMBA_PER_STEP = train_launches({"rmsnorm": 4 * 32, "swiglu": 32, "flash_attention": 32,
                                 "ssd_scan": 32}, {"rmsnorm": 1})
#: Hymba's routes: qwen's, and the tensor cores for every SSD scan forward and
#: backward
HYMBA_ROUTES = {**TRAIN_ROUTES, "ssd_scan": "wgmma", "ssd_scan_bwd": "wgmma"}
#: (B, S, H, N, chd, chunk): the sweep of tests/test_extensions.py:19-30; a chunk
#: longer than the sequence (L = 40, not a multiple of 16); the smoke config's
#: shape (seq 64 + 8 meta tokens, padded to 3 chunks of 32; chd 128); shapes of
#: chunk 128 that take the tensor-core route in bf16 (N 16, 32, 48, 64; chd 64
#: to 400, one not a multiple of 64); the training shape of hymba-1.5b (seq 2048
#: + 128 meta tokens, chd 400)
SSD_SHAPES = tuple((2, 128, 2, N, chd, chunk) for chunk in (32, 64)
                   for N, chd in ((8, 16), (16, 32))) + (
    (1, 40, 3, 16, 48, 128), (2, 96, 2, 16, 128, 32), (2, 256, 2, 16, 64, 128),
    (1, 256, 3, 32, 200, 128), (2, 256, 2, 48, 136, 128), (1, 256, 2, 64, 400, 128),
    (2, 2176, 8, 16, 400, 128))
#: SSD outputs and gradients, relative to the largest entry, as the mLSTM's:
#: fp32 sums in another order, one bf16 rounding of each output in bf16; the
#: tensor-core route against the plain version with the same bf16 roundings
#: (``bf16_products``) is held to the bf16 bound, its gradients too
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: (B, Hq, Hkv, S, hd, window): hymba-1.5b's attention at its training shape
HYMBA_FLASH = ((2, 25, 5, 2176, 64, 1024), (2, 25, 5, 2176, 64, 0))
#: (B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window): v narrower than q and k.  The
#: sweep of FLASH_SHAPES' first five rows with v of half their width (the CUDA
#: cores in both dtypes); MLA's widths (192, 128) causal, behind a longer cache
#: (q_offset = Skv - Sq) and ragged, with a window, and at deepseek-v2-lite-16b's
#: training shape (batch 2 x 2048, 16 heads); its smoke widths (48, 32); then
#: mixtral-8x7b's training shape (1 x 8192, 32 heads over 8, hd 128, window
#: 4096).  In bf16 the (192, 128) and (128, 128) rows take the tensor cores.
MOE_FLASH_SHAPES = tuple((*s[:6], s[5] // 2, *s[6:]) for s in FLASH_SHAPES[:5]) + (
    (1, 4, 2, 200, 456, 192, 128, True, 0),
    (1, 4, 2, 300, 300, 192, 128, True, 64),
    (1, 4, 4, 64, 64, 48, 32, True, 0),
    (2, 16, 16, 2048, 2048, 192, 128, True, 0),
    (1, 32, 8, 8192, 8192, 128, 128, True, 4096),
)
#: (B, Hq, Hkv, S, hd, hdv, window) of the flash times at the MoE training shapes
DEEPSEEK_FLASH = (2, 16, 16, 2048, 192, 128, 0)
MIXTRAL_FLASH = (1, 32, 8, 8192, 128, 128, 4096)
QWEN3 = "qwen3-4b"
DEEPSEEK = "deepseek-v2-lite-16b"
MIXTRAL = "mixtral-8x7b"
INTERNVL = "internvl2-2b"
WHISPER = "whisper-large-v3"
#: Whisper's 30-second window of 1500 encoder frames and its decoder's 448 positions
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
#: the bf16 training runs of the two families at full width and depth: internvl2-2b
#: on 2 x (256 image + 1792 text) positions, whisper-large-v3 on 4 x (1500 frames,
#: 448 tokens); ``seq`` counts the text tokens
INTERNVL_TRAIN = dict(batch=2, seq=1792, steps=4)
WHISPER_TRAIN = dict(batch=4, seq=WHISPER_TOKENS, frames=WHISPER_FRAMES, steps=4)
#: the bf16 MoE training runs at full width and a cut depth: deepseek-v2-lite-16b's
#: 15.7 B parameters and their AdamW state (about 250 GB) do not fit one card, so
#: layer0 and 3 MoE layers (2.25 B parameters); mixtral-8x7b at 2 layers (3.16 B)
#: and one sequence of 8192, so that its window of 4096 binds over half the rows
DEEPSEEK_TRAIN = dict(batch=2, seq=2048, steps=4, layers=4)
MIXTRAL_TRAIN = dict(batch=1, seq=8192, steps=4, layers=2)
#: kernel launches per training step: deepseek-v2-lite-16b at 4 layers (layer0
#: rematerialised on its own, as in JAX), 3 norms each (kv_ln on the MLA latent
#: among them) and the final norm, one flash attention each (MLA's (192, 128)),
#: layer0's SwiGLU and the 3 MoE layers' shared experts (the routed experts are
#: batched products); mixtral-8x7b at 2 layers, 2 norms and one attention each
#: and the final norm, no SwiGLU kernel
DEEPSEEK_PER_STEP = train_launches({"rmsnorm": 3 * 4, "swiglu": 4, "flash_attention": 4},
                                   {"rmsnorm": 1})
MIXTRAL_PER_STEP = train_launches({"rmsnorm": 2 * 2, "flash_attention": 2}, {"rmsnorm": 1})
#: kernel launches per training step: internvl2-2b's 24 layers as qwen's (the image
#: positions go through the backbone); whisper-large-v3's 32 encoder and 32
#: decoder layers, each rematerialised, one flash attention each in the encoder
#: and two (causal self, cross) in the decoder, their LayerNorm and GELU plain
#: PyTorch
INTERNVL_PER_STEP = TRAIN_PER_STEP
WHISPER_PER_STEP = train_launches({"flash_attention": 3 * 32})
#: phi4-mini-3.8b's 32 layers as qwen's
PHI4_PER_STEP = train_launches({"rmsnorm": 2 * 32, "swiglu": 32, "flash_attention": 32},
                               {"rmsnorm": 1})
#: the policies of the remat check on qwen's train cell (``remat_check``)
REMAT_POLICIES = ("none", "dots", "full")
WHISPER_ROUTES = {"flash_attention": "wgmma", "flash_attention_bwd": "wgmma"}
#: (B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window) of the flash launches of the two
#: families' runs: internvl2-2b's training shape and its image-prefixed prefill
#: (2 x (256 + 128)); whisper-large-v3's encoder, cross and causal decoder
#: attention at its training shape, and its encoder over 8 requests' 1500 frames
#: with prefill's cross and decoder attention over 32 tokens
EMBEDDED_FLASH = (
    (2, 16, 8, 2048, 2048, 128, 128, True, 0),
    (2, 16, 8, 384, 384, 128, 128, True, 0),
    (4, 20, 20, WHISPER_FRAMES, WHISPER_FRAMES, 64, 64, False, 0),
    (4, 20, 20, WHISPER_TOKENS, WHISPER_FRAMES, 64, 64, False, 0),
    (4, 20, 20, WHISPER_TOKENS, WHISPER_TOKENS, 64, 64, True, 0),
    (8, 20, 20, WHISPER_FRAMES, WHISPER_FRAMES, 64, 64, False, 0),
    (8, 20, 20, 32, WHISPER_FRAMES, 64, 64, False, 0),
    (8, 20, 20, 32, 32, 64, 64, True, 0),
)
#: the timed rows among them: name -> its index in EMBEDDED_FLASH
EMBEDDED_FLASH_TIMES = {"internvl2": 0, "whisper_encoder": 2, "whisper_cross": 3,
                        "whisper_decoder": 4}
#: router probabilities this close at the k-th and (k+1)-th place may pick another
#: expert on the card than on the CPU in fp32: the fp32 decode checks allow a
#: routing difference there (and only there), print it and count it
NEAR_TIE = 1e-5
#: the bf16 serve runs through ``launch.serve.main`` at full config: run -> (arch,
#: requests, prompt length, new tokens, kernel launches per decode step; every
#: other kernel none).  qwen1.5-0.5b: 24 layers of 2 norms, one attention and one
#: SwiGLU, and the final norm; hymba-1.5b: 32 blocks of 4 norms, one attention and
#: one SwiGLU; xlstm-1.3b: 42 mLSTM blocks of 2 norms, 6 sLSTM blocks of 3 norms
#: and one SwiGLU, no attention; qwen3-4b: 36 layers of 4 norms (q_norm and
#: k_norm among them), one attention and one SwiGLU; deepseek-v2-lite-16b: 27
#: layers of 3 norms (kv_ln on the MLA latent among them) and one SwiGLU
#: (layer0's dense MLP, then the 26 MoE layers' shared experts; the routed
#: experts are batched products), the final norm, and no decode-attention kernel
#: (MLA's absorbed products); internvl2-2b as qwen's (it decodes text alone);
#: whisper-large-v3: 32 decoder layers of self and cross decode attention (over
#: the engine's 64 zero frames), LayerNorm and GELU plain PyTorch; phi4-mini-3.8b
#: (32 layers, 24 query heads over 8, hd 128) and phi3-medium-14b (40 layers, 40
#: over 10, hd 128; 28 GB in bf16, freed before the next run) as qwen's.  qwen3-4b
#: serves fewer and shorter requests, to bound the run's time.  mixtral-8x7b has
#: no bf16 run: 93 GB do not fit one card.
SERVE_RUNS = {
    "serve": (ARCH, SERVE["requests"], SERVE["prompt_len"], SERVE["new_tokens"],
              {"rmsnorm": 2 * 24 + 1, "swiglu": 24, "decode_attention": 24}),
    "serve_hymba": (HYMBA, 8, 128, 32,
                    {"rmsnorm": 4 * 32 + 1, "swiglu": 32, "decode_attention": 32}),
    "serve_xlstm": (XLSTM, 8, 128, 32, {"rmsnorm": 2 * 42 + 3 * 6 + 1, "swiglu": 6}),
    "serve_qwen3": (QWEN3, 4, 64, 16,
                    {"rmsnorm": 4 * 36 + 1, "swiglu": 36, "decode_attention": 36}),
    "serve_deepseek": (DEEPSEEK, 8, 128, 32, {"rmsnorm": 3 * 27 + 1, "swiglu": 27}),
    "serve_internvl2": (INTERNVL, 8, 128, 32,
                        {"rmsnorm": 2 * 24 + 1, "swiglu": 24, "decode_attention": 24}),
    "serve_whisper": (WHISPER, 8, 128, 32, {"decode_attention": 2 * 32}),
    "serve_phi4": (PHI4, 8, 128, 32,
                   {"rmsnorm": 2 * 32 + 1, "swiglu": 32, "decode_attention": 32}),
    "serve_phi3": (PHI3, 8, 128, 32,
                   {"rmsnorm": 2 * 40 + 1, "swiglu": 40, "decode_attention": 40}),
}
#: SDPA's backends timed for the flash backward's yardstick (torch.nn.attention.SDPBackend)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")
#: dense peak rates by input type (NVIDIA H100 SXM data sheet, no sparsity)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def memory_rate(name: str) -> float:
    """Device-memory bytes/s of the card, by part (NVIDIA data sheets)."""
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12
        if "NVL" in name:
            return 3.9e12
        return 3.35e12
    if "H200" in name:
        return 4.8e12
    raise RuntimeError(f"no memory rate on record for {name!r}")


# ------------------------------------------------------------------ helpers
def randn(gen, shape, dtype, scale=1.0, device="cuda"):
    """Normal draws of ``gen``'s sequence, scaled, cast and moved.  For the
    card, a host generator gives the draw a seed (its next draw) and a
    generator on the card draws it: the kernel checks' inputs then take
    milliseconds, where the host's draws of them took a minute."""
    if gen.device.type == "cpu" and torch.device(device).type == "cuda":
        gen = torch.Generator(device=device).manual_seed(
            int(torch.randint(0, 2**62, (), generator=gen)))
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(device=device,
                                                                             dtype=dtype)


def time_ms(fn, arg_sets, rounds: int, warmup: int = 2, issue: bool = False):
    """Milliseconds per call, CUDA events around back-to-back calls that cycle
    through ``arg_sets`` (distinct weights keep the L2 cache cold, as in the
    model's walk over its layers), after ``warmup`` calls.  With ``issue``,
    also the host's milliseconds per call to issue them: when the two are
    equal, the host, not the device, sets the pace."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    calls = rounds * len(arg_sets)
    t0 = time.perf_counter()
    start.record()
    for _ in range(rounds):
        for args in arg_sets:
            fn(*args)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    end.synchronize()
    ms = start.elapsed_time(end) / calls
    return (ms, host_ms) if issue else ms


def max_err(got, want, tol) -> float:
    got, want = got.detach().float(), want.detach().float()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return float((got - want).abs().max())


def grad_ms(out_fn, inputs, dout, rounds: int, issue: bool = False):
    """(backward ms, forward + backward ms) of autograd through ``out_fn``;
    with ``issue``, each as ``time_ms``'s (ms, host issue ms)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = out_fn(*leaves)
    bwd = time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), [()],
                  rounds, warmup=3, issue=issue)
    both = time_ms(lambda: torch.autograd.grad(out_fn(*leaves), leaves, dout), [()], rounds,
                   warmup=3, issue=issue)
    return bwd, both


def bound(bytes_moved: float, ops: float, dtype, rate: float) -> tuple[float, str]:
    t_bytes = bytes_moved / rate
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def reset_counts(kernel_modules) -> None:
    """Set every launch count, and every per-route count, to 0."""
    for m in kernel_modules:
        m.launches = 0
        for name in getattr(m, "route_launches", {}):
            m.route_launches[name] = 0


def read_counts(kernel_modules) -> tuple[dict, dict]:
    """(launches by module, launches by route of the modules that have routes)."""
    counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernel_modules}
    routes = {m.__name__.rsplit(".", 1)[1]: dict(m.route_launches) for m in kernel_modules
              if hasattr(m, "route_launches")}
    return counts, routes


def check_routes(routes: dict, counts: dict, want: dict, run: str) -> None:
    """Raise unless every launch of each module in ``want`` took its route there."""
    for module, route in want.items():
        if routes[module][route] != counts[module]:
            raise AssertionError(f"{module}: {counts[module]} launches in the {run} run, "
                                 f"{routes[module]} by route; expected all {route}")


@functools.lru_cache(maxsize=1)
def serve_kernel_shapes() -> dict:
    """Kernel -> {shape: prefix} of the shapes at which the runs of
    ``SERVE_RUNS`` launch it, read from each model's own layouts: rmsnorm
    (rows, D) of every norm's gain (B rows; B x heads for q_norm and k_norm),
    swiglu_mlp (B, D, F) of every gate weight of a dense MLP or of shared
    experts (not the routed experts' ``w_gate`` beside a ``router``: those are
    batched products), decode_attention (B, Hq, Hkv, S, visible at the last step, hd)
    of every K cache (Whisper's 64-frame cross cache, all visible, among them).
    The kernel checks hold each against its plain version
    and time it under its prefix (the run's, and the leaf's where D is not
    d_model or the gate is a shared expert's); ``serve_run`` fails on a
    launch at a shape outside the checks."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model

    def leaves(tree, name="", parent=None):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], k, tree)
        else:
            yield name, tree, parent

    out = {"rmsnorm": {}, "swiglu_mlp": {}, "decode_attention": {}}

    def add(kernel, shape, prefix):
        if shape not in out[kernel]:
            taken = sum(p.startswith(prefix) for p in out[kernel].values())
            out[kernel][shape] = f"{prefix}{taken}_" if taken else prefix

    for run, (arch, B, prompt_len, new_tokens, _) in SERVE_RUNS.items():
        cfg = ARCHS[arch]
        model = build_model(cfg, device="cpu")
        heads = {"q_norm": cfg.n_heads, "k_norm": cfg.n_kv_heads}
        for name, info, parent in leaves(model.layout()):
            if name.endswith(("ln", "norm")):
                D = info.shape[-1]
                add("rmsnorm", (B * heads.get(name, 1), D),
                    f"{run}_" if D == cfg.d_model and name not in heads else f"{run}_{name}_")
            elif name.endswith("_gate") and not (name == "w_gate" and "router" in parent):
                add("swiglu_mlp", (B, *info.shape[-2:]),
                    f"{run}_{name}_" if name.startswith("shared") else f"{run}_")
        cache_len = prompt_len + new_tokens + 8
        encdec = cfg.encdec is not None
        lay = model.cache_layout(B, cache_len, 64) if encdec else model.cache_layout(B, cache_len)
        for name, info, _ in leaves(lay):
            if name in ("k", "cross_k"):
                _, Hkv, S, hd = info.shape[-4:]
                add("decode_attention", (B, cfg.n_heads, Hkv, S,
                                         S if name == "cross_k" else prompt_len + new_tokens, hd),
                    f"{run}_{name}_" if encdec else f"{run}_")
    return out


def rmsnorm_shapes() -> tuple:
    """(rows, D) of the rmsnorm checks: ``RMSNORM_SHAPES`` and every serving row."""
    return tuple(dict.fromkeys((*RMSNORM_SHAPES, *serve_kernel_shapes()["rmsnorm"])))


def swiglu_shapes() -> tuple:
    """(N, D, F) of the swiglu_mlp checks: ``SWIGLU_SHAPES`` and every serving shape."""
    return tuple(dict.fromkeys((*SWIGLU_SHAPES, *serve_kernel_shapes()["swiglu_mlp"])))


def decode_shapes() -> tuple:
    """``DECODE_SHAPES`` and every serving shape that they do not cover, in
    their (B, Hkv, S, hd, groups, windows) form."""
    covered = {(B, Hkv * G, Hkv, S, hd) for B, Hkv, S, hd, groups, _ in DECODE_SHAPES
               for G in groups}
    extra = [(B, Hkv, S, hd, (Hq // Hkv,), (0,))
             for B, Hq, Hkv, S, _, hd in serve_kernel_shapes()["decode_attention"]
             if (B, Hq, Hkv, S, hd) not in covered]
    return (*DECODE_SHAPES, *extra)


#: a small ragged non-causal row (cross attention: queries fewer than keys, no
#: side a whole tile) beside the families' shapes
RAGGED_CROSS_FLASH = (1, 4, 4, 56, 150, 64, 64, False, 0)


def flash_shapes() -> list:
    """(B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window, as_route) of the flash
    checks: FLASH_SHAPES and hymba-1.5b's (v as wide as q and k, held to the
    plain versions as they are), MOE_FLASH_SHAPES, the small ragged
    non-causal row, EMBEDDED_FLASH and PHI4_FLASH (held to the plain versions
    with P and dS rounded as the tensor-core route rounds them)."""
    hymba = [(B, Hq, Hkv, S, S, hd, True, w) for B, Hq, Hkv, S, hd, w in HYMBA_FLASH]
    shapes = [(*s[:6], s[5], *s[6:], False) for s in (*FLASH_SHAPES, *hymba)]
    return shapes + [(*s, True) for s in (*MOE_FLASH_SHAPES, RAGGED_CROSS_FLASH,
                                          *EMBEDDED_FLASH, PHI4_FLASH)]


def flash_key(B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window, q_offset) -> tuple:
    return (B, Hq, Hkv, Sq, Skv, hd, hdv, bool(causal), window, q_offset)


def checked_shapes() -> dict:
    """Kernel -> the set of shapes its checks cover, keyed as
    ``launched_shapes`` records them."""
    return {"rmsnorm": set(rmsnorm_shapes()), "swiglu_mlp": set(swiglu_shapes()),
            "decode_attention": {(B, Hkv * G, Hkv, S, hd)
                                 for B, Hkv, S, hd, groups, _ in decode_shapes()
                                 for G in groups},
            "decode_attention_partial": set(),
            "flash_attention": {flash_key(*s[:9], s[4] - s[3] if s[7] else 0)
                                for s in flash_shapes()}}


def check_launched(shapes: dict, run: str) -> None:
    """Raise unless every shape ``launched_shapes`` recorded is one the checks cover."""
    covered = checked_shapes()
    for kernel, seen in shapes.items():
        if not seen <= covered[kernel]:
            raise AssertionError(f"{run}: {kernel} launched at {sorted(seen - covered[kernel])}, "
                                 "which no kernel check covers")


@contextlib.contextmanager
def launched_shapes():
    """Record the shape of every call of ``ops.rmsnorm``, ``ops.swiglu_mlp``,
    ``ops.decode_attention`` and ``ops.flash_attention`` (the models reach the
    kernels through them): rmsnorm (rows, D), swiglu_mlp (rows, D, F),
    decode_attention (B, Hq, Hkv, S, hd), flash_attention (B, Hq, Hkv, Sq,
    Skv, hd, hdv, causal, window, q_offset)."""
    from repro_torch.kernels import ops

    def flash(q, k, v, *, causal=True, window=0, q_offset=0):
        return flash_key(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                         v.shape[3], causal, window, q_offset)

    def decode(q, k, *_, **__):
        return (q.shape[0], q.shape[1], *k.shape[1:])

    keys = {"rmsnorm": lambda x, g, **_: (x.numel() // x.shape[-1], x.shape[-1]),
            "swiglu_mlp": lambda x, wg, *_: (x.numel() // x.shape[-1], *wg.shape),
            "decode_attention": decode, "decode_attention_partial": decode,
            "flash_attention": flash}
    seen = {name: set() for name in keys}
    saved = {name: getattr(ops, name) for name in keys}

    def recording(name):
        fn, key, out = saved[name], keys[name], seen[name]

        def call(*args, **kwargs):
            out.add(key(*args, **kwargs))
            return fn(*args, **kwargs)
        return call

    for name in keys:
        setattr(ops, name, recording(name))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# ------------------------------------------------------------------ phases
def phase_card() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this run needs a CUDA card")
    smi = card_line()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    from repro_torch.kernels import build

    path, seconds = build.build()
    build.library()
    print(f"[build] {path.name} in {seconds:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


#: (rows, D) of the rmsnorm checks: the serving, qwen training and hymba-1.5b
#: training rows (the "vec" route), a small row and a ragged one (D = 100: the
#: "block" route), the MoE training rows, internvl2-2b's image-prefixed rows (2 x
#: (256 + 128)), phi4-mini-3.8b's training rows; the other models' serving rows
#: join them in ``check_rmsnorm`` (``serve_kernel_shapes``; an fp32 row over
#: ``VEC_MAX_ROW_BYTES``, phi3-medium-14b's 5120, takes the "block" route)
RMSNORM_SHAPES = ((SERVE["requests"], 1024), (TRAIN_ROWS, 1024), (4352, 1600), (37, 96),
                  (37, 100), *MOE_RMSNORM, INTERNVL_PREFIX_SWIGLU[:2], PHI4_RMSNORM)


def graph_ms(fn, arg_sets, calls: int = 24, replays: int = 20, stream=None):
    """Device milliseconds per call: ``calls`` back-to-back calls cycling
    through ``arg_sets``, captured into a CUDA graph and replayed, so that the
    host's time to issue them is out of the measurement.  Warm-up and capture
    run on ``stream`` (a new side stream by default; autograd's backward runs
    on the stream of its forward, so a backward alone is captured on the
    stream its forward ran on).  Returns ``(ms, how)``; where the capture
    fails (a launch that does not record into a graph), the profiler's kernel
    time of the same calls instead."""
    try:
        side = stream or torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for args in arg_sets:
                fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for i in range(calls):
                fn(*arg_sets[i % len(arg_sets)])
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (calls * replays), "cuda graph replay"
    except RuntimeError as e:
        print(f"[kernels] CUDA graph capture failed ({str(e).splitlines()[0][:120]}); "
              "profiler kernel time instead")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages() if ev.device_time_total > 0)
    return total / 1e3 / calls, "profiler kernel time"


def autograd_graph_ms(out_fn, input_sets, douts, calls: int, replays: int) -> float:
    """Device ms of the backward alone of ``out_fn`` by CUDA-graph replay: the
    forwards run once on a side stream, the captured calls are
    ``torch.autograd.grad`` of each retained graph in turn."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [[t.detach().clone().requires_grad_() for t in s] for s in input_sets]
        outs = [out_fn(*lv) for lv in leaves]
    return graph_ms(lambda i: torch.autograd.grad(outs[i], leaves[i], douts[i], retain_graph=True),
                    [(i,) for i in range(len(input_sets))], calls, replays, stream=side)[0]


def _enter_exit(ctx) -> None:
    with ctx:
        pass


def rmsnorm_host_steps(x, g, reps: int = 2000) -> dict:
    """Host microseconds per call of each step of the wrapper's former host
    path (device context, ``current_stream``, checks on every call), alone,
    and of the lean path's steps, at these inputs (the launches run too)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as kr

    lib = build.library()
    out = torch.empty_like(x)
    D, rows = x.shape[-1], x.numel() // x.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    steps = {
        "device_check": lambda: x.is_cuda and g.is_cuda and x.device == g.device,
        "check_args": lambda: kr.check_args(x, g),
        "empty_like": lambda: torch.empty_like(x),
        "device_context": lambda: _enter_exit(torch.cuda.device(x.device)),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes_launch": lambda: lib.rt_rmsnorm(x.data_ptr(), g.data_ptr(), out.data_ptr(), rows,
                                                D, 1e-5, 0 if x.dtype == torch.float32 else 1,
                                                stream),
        "build_check": lambda: build.check(0, "rt_rmsnorm"),
        "lean_checked_once": lambda: build.checked_once(
            kr._checked, (x.shape, g.shape, x.dtype, g.dtype, x.device, g.device),
            kr._check_key, x, g),
        "lean_raw_stream": lambda: torch._C._cuda_getCurrentRawStream(x.device.index),
        "lean_launch": lambda: kr.launch("vec", x, g, 1e-5),
        "lean_wrapper": lambda: kr.rmsnorm_cuda(x, g),
        "F.rms_norm": lambda: F.rms_norm(x, (D,), g, 1e-5),
    }
    found = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        found[name] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    return found


def rmsnorm_graph_check(ops, ref, x, g) -> float:
    """Capture one ``ops.rmsnorm`` call into a CUDA graph, write new values into
    its input, replay, and hold the output against the plain version: the
    ctypes launch records into a graph and reads the tensors it was given."""
    x, g = x.clone(), g.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.rmsnorm(x, g, eps=1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.rmsnorm(x, g, eps=1e-5)
    x.copy_(torch.flip(x, (0,)) * 0.5)
    graph.replay()
    torch.cuda.synchronize()
    err = max_err(out, ref.rmsnorm_ref(x, g, 1e-5), TOL["rmsnorm"][x.dtype])
    print(f"[kernels] rmsnorm captured in a CUDA graph: replay on new inputs within {err:.3e} "
          "of the plain version")
    return err


#: the key prefixes of the rmsnorm times at MOE_RMSNORM's rows
MOE_RMSNORM_PREFIXES = ("deepseek_kv_ln_", "deepseek_", "mixtral_")


def check_rmsnorm(gen, ops, ref, rate):
    """RMSNORM_SHAPES in fp32 and bf16, each check with the route it took; times
    at the serving shape (the row), the qwen training shape (``train_*``),
    hymba-1.5b's (``hymba_*``), the MoE training rows (MOE_RMSNORM_PREFIXES),
    phi4-mini-3.8b's (``phi4_*``) and the other models' serving rows
    (``serve_kernel_shapes``' prefixes): host-paced ``ms`` with the host's ``issue_ms``,
    ``device_ms`` from a replayed CUDA graph, the ``block`` body on the same inputs
    (``block_ms``, device), ``F.rms_norm``'s host-paced and device times.  At
    the serving shape also the autograd Function that training calls, beside
    the direct call that ``ops.rmsnorm`` makes when no gradient is needed,
    and each step of the wrapper's host path (``host_steps_us``)."""
    from repro_torch.kernels import rmsnorm as kr

    errs, routes = {}, {}
    for rows, D in rmsnorm_shapes():
        for dt in (torch.float32, torch.bfloat16):
            x, g = randn(gen, (rows, D), dt), randn(gen, (D,), dt)
            routes[(rows, D, dt)] = kr.route(x, g)
            want = ("vec" if D % 8 == 0 and D * x.element_size() <= kr.VEC_MAX_ROW_BYTES
                    else "block")
            if routes[(rows, D, dt)] != want:
                raise AssertionError(f"rmsnorm {(rows, D, dt)}: route {routes[(rows, D, dt)]}, "
                                     f"expected {want}")
            got = ops.rmsnorm(x, g, eps=1e-5)
            errs[(rows, D, dt)] = max_err(got, ref.rmsnorm_ref(x, g, 1e-5),
                                          TOL["rmsnorm"][dt])
            errs[(rows, D, dt, "block")] = max_err(kr.launch("block", x, g, 1e-5),
                                                   ref.rmsnorm_ref(x, g, 1e-5),
                                                   TOL["rmsnorm"][dt])
    torch.cuda.synchronize()
    print(f"[kernels] rmsnorm errors {errs}")
    print(f"[kernels] rmsnorm routes {routes}")
    row = {"name": "rmsnorm"}
    for prefix, (N, D), n_sets in (("", RMSNORM_SHAPES[0], 24), ("train_", RMSNORM_SHAPES[1], 8),
                                   ("hymba_", RMSNORM_SHAPES[2], 8),
                                   *((p, shape, 8) for p, shape in zip(MOE_RMSNORM_PREFIXES,
                                                                       MOE_RMSNORM)),
                                   ("phi4_", PHI4_RMSNORM, 8),
                                   *((k, shape, 24) for shape, k in
                                     serve_kernel_shapes()["rmsnorm"].items()
                                     if shape != RMSNORM_SHAPES[0])):
        dt = torch.bfloat16
        sets = [(randn(gen, (N, D), dt), randn(gen, (D,), dt)) for _ in range(n_sets)]
        b_ms, b_by = bound((2 * N * D + D) * 2, 4 * N * D, dt, rate)
        ms, issue = time_ms(lambda x, g: ops.rmsnorm(x, g, eps=1e-5), sets, 20, issue=True)
        device_ms, how = graph_ms(lambda x, g: ops.rmsnorm(x, g, eps=1e-5), sets)
        lib_ms, lib_issue = time_ms(lambda x, g: F.rms_norm(x, (D,), g, 1e-5), sets, 20,
                                    issue=True)
        row.update({
            f"{prefix}shape": f"x ({N}, {D}) bf16", f"{prefix}kernel_route": kr.route(*sets[0]),
            f"{prefix}max_abs_err": errs[(N, D, dt)],
            f"{prefix}ms": ms, f"{prefix}issue_ms": issue,
            f"{prefix}device_ms": device_ms, f"{prefix}device_ms_from": how,
            f"{prefix}block_ms": graph_ms(lambda x, g: kr.launch("block", x, g, 1e-5), sets)[0],
            f"{prefix}plain_ms": time_ms(lambda x, g: ref.rmsnorm_ref(x, g, 1e-5), sets, 20),
            f"{prefix}library_ms": lib_ms, f"{prefix}library_issue_ms": lib_issue,
            f"{prefix}library_device_ms": graph_ms(lambda x, g: F.rms_norm(x, (D,), g, 1e-5),
                                                   sets)[0],
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by,
        })
        if not prefix:
            row["function_ms"], row["function_issue_ms"] = time_ms(
                lambda x, g: ops.RMSNorm.apply(x, g, 1e-5), sets, 20, issue=True)
            row["host_steps_us"] = rmsnorm_host_steps(*sets[0])
            row["graph_replay_max_abs_err"] = rmsnorm_graph_check(ops, ref, *sets[0])
        del sets
    print(f"[kernels] rmsnorm host steps (us a call) {row['host_steps_us']}")
    return row


def _swiglu_lib(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


#: the key prefixes of the SwiGLU times at DEEPSEEK_SWIGLU's shapes
DEEPSEEK_SWIGLU_PREFIXES = ("deepseek_layer0_", "deepseek_shared_")


def check_swiglu(gen, ops, ref, rate):
    """SWIGLU_SHAPES in fp32 and bf16, each bf16 check with the route it took,
    the split-K tensor-core route asserted at every serving shape; times at
    the serving shape (the row), the qwen training shape (its ``train_*``
    keys), hymba-1.5b's (``hymba_*``), deepseek-v2-lite-16b's
    (DEEPSEEK_SWIGLU_PREFIXES), internvl2-2b's (``internvl2_*``),
    phi4-mini-3.8b's (``phi4_*``) and the other models' serving shapes
    (``serve_kernel_shapes``' prefixes), each beside the CUDA-core kernel's on the
    same inputs (``simt_ms``); at serving's rows also the kernel's and three
    ``@``'s device times from replayed CUDA graphs (``device_ms``,
    ``library_device_ms``)."""
    from repro_torch.kernels import swiglu as ks

    serving = {shape: k for shape, k in serve_kernel_shapes()["swiglu_mlp"].items()
               if shape != SWIGLU_SHAPES[0]}
    errs, routes = {}, {}
    for N, D, Fd in swiglu_shapes():
        for dt in (torch.float32, torch.bfloat16):
            x = randn(gen, (N, D), dt)
            wg, wu = randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (D, Fd), dt, D ** -0.5)
            wd = randn(gen, (Fd, D), dt, Fd ** -0.5)
            routes[(N, D, Fd, dt)] = ks.route(x, wg, wu, wd)
            got = ops.swiglu_mlp(x, wg, wu, wd)
            errs[(N, D, Fd, dt)] = max_err(got, ref.swiglu_ref(x, wg, wu, wd),
                                           TOL["swiglu_mlp"][dt])
            del x, wg, wu, wd, got
    print(f"[kernels] swiglu_mlp errors {errs}")
    print(f"[kernels] swiglu_mlp bf16 routes "
          f"{ {k[:3]: v for k, v in routes.items() if k[3] == torch.bfloat16} }")
    for shape in (SWIGLU_SHAPES[0], *serving):
        if routes[(*shape, torch.bfloat16)] != "wgmma_split_k":
            raise AssertionError(f"swiglu_mlp {shape} bf16: route "
                                 f"{routes[(*shape, torch.bfloat16)]}")
    row = {"name": "swiglu_mlp"}
    # the timed inputs are drawn on the card: 8 sets of phi3-medium-14b's serving
    # weights are 2.2 G draws, which the host's generator takes tens of seconds for
    tgen = torch.Generator(device="cuda").manual_seed(1)
    for prefix, (N, D, Fd), n_sets, rounds in (("", SWIGLU_SHAPES[0], 24, 5),
                                               ("train_", SWIGLU_SHAPES[1], 2, 3),
                                               ("hymba_", HYMBA_SWIGLU, 2, 3),
                                               *((p, shape, 2, 3) for p, shape in
                                                 zip(DEEPSEEK_SWIGLU_PREFIXES, DEEPSEEK_SWIGLU)),
                                               ("internvl2_", INTERNVL_SWIGLU, 2, 3),
                                               ("phi4_", PHI4_SWIGLU, 2, 3),
                                               *((k, shape, 8, 10)
                                                 for shape, k in serving.items())):
        dt = torch.bfloat16
        sets = [(randn(tgen, (N, D), dt), randn(tgen, (D, Fd), dt, D ** -0.5),
                 randn(tgen, (D, Fd), dt, D ** -0.5), randn(tgen, (Fd, D), dt, Fd ** -0.5))
                for _ in range(n_sets)]
        b_ms, b_by = bound((2 * N * D + 3 * D * Fd) * 2, 6 * N * D * Fd + 4 * N * Fd, dt, rate)
        row.update({
            f"{prefix}shape": f"x ({N}, {D}), d_ff {Fd} bf16",
            f"{prefix}kernel_route": routes[(N, D, Fd, dt)],
            f"{prefix}max_abs_err": errs[(N, D, Fd, dt)],
            f"{prefix}ms": time_ms(ops.swiglu_mlp, sets, rounds),
            f"{prefix}simt_ms": time_ms(lambda *a: ks.launch("simt", *a), sets, rounds),
            f"{prefix}plain_ms": time_ms(ref.swiglu_ref, sets, rounds),
            f"{prefix}library_ms": time_ms(_swiglu_lib, sets, rounds),
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by,
        })
        if N < ks.MIN_TILE_ROWS:
            # serving's rows: the host may set the pace of back-to-back calls
            row[f"{prefix}device_ms"], row[f"{prefix}device_ms_from"] = graph_ms(
                ops.swiglu_mlp, sets)
            row[f"{prefix}library_device_ms"] = graph_ms(_swiglu_lib, sets)[0]
        del sets
    return row


def _sdpa(q, k, v, valid):
    S = k.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] < valid[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=q.shape[1] != k.shape[1])


#: (B, Hkv, S, hd, groups G, windows) of the decode sweep: the serving shape,
#: the earlier small and hd-128 shapes, one long request (split-K), eight at
#: 4096, qwen3-4b's layout (G 4, hd 128), hymba-1.5b's (G 5 over its 1024
#: window and without), G 16 (two blocks a kv head), an hd that is no
#: multiple of 8 (the "simt" route), Whisper's cross cache over 1500 frames
#: (serve_whisper's decode after ``encode``); the other models' serving shapes
#: join them in ``check_decode_attention`` (``decode_shapes``).  "cross": a window
#: of 1.5 spans of the split plan, whose start falls inside a span
DECODE_SHAPES = (
    (SERVE["requests"], 16, CACHE_LEN, 64, (1, 2), (0, 64)),
    (2, 2, 100, 32, (1, 2), (0, 64)),
    (1, 2, 700, 128, (8,), (0, 64)),
    (1, 16, 32768, 64, (1,), (0, "cross")),
    (8, 16, 4096, 64, (1,), (0, "cross")),
    (8, 8, 4096, 128, (4,), (0, "cross")),
    (2, 5, 2176, 64, (5,), (0, 1024)),
    (2, 2, 3000, 128, (16,), (0, "cross")),
    (2, 2, 100, 36, (1, 4), (0, 64)),
    (SERVE["requests"], 20, WHISPER_FRAMES, 64, (1,), (0,)),
)


def decode_valid_sets(gen, B: int, S: int) -> list:
    """int32 (B,) valid lengths on the card that together hold 0, 1, S, S + 40
    (past the cache: the window ends past it too) and a random length."""
    want = [0, 1, S, S + 40, int(torch.randint(1, S + 1, (1,), generator=gen))]
    rows = [want[i:i + B] for i in range(0, len(want), B)] if B < len(want) else [want]
    out = []
    for r in rows:
        fill = torch.randint(1, S + 1, (B - len(r),), generator=gen).tolist()
        out.append(torch.tensor(r + fill, dtype=torch.int32, device="cuda"))
    return out


def decode_graph_check(gen, ops, ref, B, Hkv, S, hd, G) -> float:
    """Capture one ``ops.decode_attention`` call (bf16) into a CUDA graph, write
    new q, k, v and new valid lengths (0, 1, S and random ones) into its inputs,
    replay, and hold the output against the plain version: the grid does not
    depend on valid_len and the split route's scratch lives in the graph."""
    dt = torch.bfloat16
    q = randn(gen, (B, Hkv * G, 1, hd), dt)
    k, v = randn(gen, (B, Hkv, S, hd), dt), randn(gen, (B, Hkv, S, hd), dt)
    valid = torch.full((B,), S // 2, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.decode_attention(q, k, v, valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, valid)
    for t in (q, k, v):
        t.copy_(randn(gen, t.shape, dt))
    new = torch.randint(1, S + 1, (B,), generator=gen).to(torch.int32)
    new[0], new[-1] = 0, S
    if B > 2:
        new[1] = 1
    valid.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    err = max_err(out, ref.decode_attention_ref(q, k, v, valid), TOL["decode_attention"][dt])
    print(f"[kernels] decode_attention {(B, Hkv, S, hd, G)} captured in a CUDA graph: replay on "
          f"new inputs and valid lengths {new.tolist()} within {err:.3e} of the plain version")
    return err


def check_decode_attention(gen, ops, ref, rate):
    """DECODE_SHAPES in fp32 and bf16 with valid lengths 0, 1, S, S + 40 and
    random: each call's route asserted, the call made twice and compared bit for
    bit, held against the plain version (and, on the split route, against the
    plain version of its split plan), and the ``simt`` kernel on the
    same inputs.  Two CUDA-graph replays on new inputs.  Times at the serving
    shape (the row), at the other models' serving shapes
    (``serve_kernel_shapes``' prefixes), at Whisper's cross cache of 1500 frames
    (``whisper_cross1500_*``), at (8, 16, 4096, 64) (``s4096_*``) and (1, 16, 32768, 64)
    (``s32768_*``), bf16, every position visible at the long shapes: ``ms`` from
    events around back-to-back calls, ``issue_ms`` the host's time to issue
    them, ``device_ms`` from a replayed CUDA graph, ``simt_ms`` the ``simt``
    kernel's device time, the plain version, and SDPA host-paced
    (``library_ms``) and by graph replay (``library_device_ms``)."""
    from repro_torch.kernels import decode_attention as kd

    errs, routes = {}, {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for B, Hkv, S, hd, groups, windows in decode_shapes():
        for G in groups:
            plan = kd.plan_splits(B, Hkv, S, hd, G, n_sm=n_sm)
            for window in windows:
                w = plan.span + plan.span // 2 if window == "cross" else window
                for dt in (torch.float32, torch.bfloat16):
                    q = randn(gen, (B, Hkv * G, 1, hd), dt)
                    k, v = randn(gen, (B, Hkv, S, hd), dt), randn(gen, (B, Hkv, S, hd), dt)
                    want_route = "split" if hd % 8 == 0 else "simt"
                    if kd.route(q, k, v) != want_route:
                        raise AssertionError(f"decode_attention {(B, Hkv, S, hd, G)}: route "
                                             f"{kd.route(q, k, v)}, expected {want_route}")
                    routes[(B, Hkv, S, hd, G)] = (want_route, plan.n_split)
                    tol = TOL["decode_attention"][dt]
                    key = (B, Hkv, G, S, hd, w, dt)
                    for valid in decode_valid_sets(gen, B, S):
                        before = dict(kd.route_launches)
                        got = ops.decode_attention(q, k, v, valid, window=w)
                        again = ops.decode_attention(q, k, v, valid, window=w)
                        if kd.route_launches[want_route] != before[want_route] + 2:
                            raise AssertionError(f"decode_attention {key}: calls took "
                                                 f"{kd.route_launches}, not {want_route}")
                        if not torch.equal(got, again):
                            raise AssertionError(f"decode_attention {key}: two calls differ")
                        want = ref.decode_attention_ref(q, k, v, valid, window=w)
                        e = [max_err(got, want, tol),
                             max_err(kd.launch("simt", q, k, v, valid, w), want, tol)]
                        if want_route == "split":
                            e.append(max_err(got, ref.decode_attention_split_ref(
                                q, k, v, valid, window=w, spans=plan.spans), tol))
                        errs[key] = max(errs.get(key, 0.0), *e)
                    del q, k, v
    torch.cuda.synchronize()
    print(f"[kernels] decode_attention errors {errs}")
    print(f"[kernels] decode_attention (route, n_split) {routes}")
    row = {"name": "decode_attention",
           "graph_replay_max_abs_err": max(
               decode_graph_check(gen, ops, ref, SERVE["requests"], 16, CACHE_LEN, 64, 1),
               decode_graph_check(gen, ops, ref, 8, 16, 4096, 64, 1),
               decode_graph_check(gen, ops, ref, 2, 5, 2176, 64, 5))}
    dt = torch.bfloat16
    for prefix, (B, H, Hkv, S, vis, hd), n_sets, rounds in (
            ("", (SERVE["requests"], 16, 16, CACHE_LEN, VALID, 64), 24, 20),
            *((k, shape, 24, 20) for shape, k in serve_kernel_shapes()["decode_attention"].items()
              if shape != (SERVE["requests"], 16, 16, CACHE_LEN, VALID, 64)),
            ("whisper_cross1500_", (SERVE["requests"], 20, 20, WHISPER_FRAMES, WHISPER_FRAMES,
                                    64), 8, 20),
            ("s4096_", (8, 16, 16, 4096, 4096, 64), 2, 20),
            ("s32768_", (1, 16, 16, 32768, 32768, 64), 2, 20)):
        valid = torch.full((B,), vis, dtype=torch.int32, device="cuda")
        sets = [(randn(gen, (B, H, 1, hd), dt), randn(gen, (B, Hkv, S, hd), dt),
                 randn(gen, (B, Hkv, S, hd), dt), valid) for _ in range(n_sets)]
        q, k, v, _ = sets[0]
        err = max_err(ops.decode_attention(q, k, v, valid),
                      ref.decode_attention_ref(q, k, v, valid), TOL["decode_attention"][dt])
        b_ms, b_by = bound((2 * B * H * hd + 2 * B * Hkv * vis * hd) * 2 + 4 * B,
                           4 * B * H * vis * hd, dt, rate)
        ms, issue = time_ms(ops.decode_attention, sets, rounds, issue=True)
        device_ms, how = graph_ms(ops.decode_attention, sets)
        plan = kd.plan_splits(B, Hkv, S, hd, H // Hkv, n_sm=n_sm)
        row.update({
            f"{prefix}shape": f"q ({B}, {H}, 1, {hd}), cache ({B}, {Hkv}, {S}, {hd}), "
                              f"valid {vis}, bf16",
            f"{prefix}kernel_route": kd.route(q, k, v), f"{prefix}n_split": plan.n_split,
            f"{prefix}max_abs_err": err,
            f"{prefix}ms": ms, f"{prefix}issue_ms": issue,
            f"{prefix}device_ms": device_ms, f"{prefix}device_ms_from": how,
            f"{prefix}simt_ms": graph_ms(lambda *a: kd.launch("simt", *a, 0), sets)[0],
            f"{prefix}plain_ms": time_ms(ref.decode_attention_ref, sets, rounds),
            f"{prefix}library_ms": time_ms(_sdpa, sets, rounds),
            f"{prefix}library_device_ms": graph_ms(_sdpa, sets)[0],
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by,
        })
        del sets, q, k, v
    row.update(check_decode_partial(gen, ops, ref, rate))
    print(f"[kernels] decode_attention device ms "
          f"{ {k: v for k, v in row.items() if k.endswith('device_ms')} }")
    return row


def _lse_err(got, want, tol) -> float:
    """The largest gap of a partial mode's lse from the plain version's: the
    same rows -inf (no visible slot), the others within ``tol``."""
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError("decode_attention partial: lse -inf in other rows than the plain "
                             "version's")
    keep = ~torch.isneginf(want)
    return max_err(got[keep], want[keep], tol) if keep.any() else 0.0


def _flash_lse(q, k, v, valid):
    """The library call beside the partial mode: aten's flash attention, which
    returns the output and its log-sum-exp (every slot visible)."""
    return torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)[:2]


def check_decode_partial(gen, ops, ref, rate) -> dict:
    """The partial mode (``ops.decode_attention_partial``) at phase_tp's serving
    shard shapes (``TP_PARTIAL``) in fp32 and bf16, on both routes: valid
    counts 0 (no visible slot: zeros and lse -inf), part of the shard and all
    of it, in one call; the output and lse held to the plain version
    (``ref.decode_attention_partial_ref``) within ``TOL``, each call made
    twice and compared bit for bit.  Times at each shape in bf16 with every
    slot visible: the kernel (events and graph replay), the plain version,
    aten's flash attention with its log-sum-exp (``library_ms``) and the
    bound (q read, K and V read, the fp32 output and lse written)."""
    from repro_torch.kernels import decode_attention as kd

    out, errs = {}, {}
    for B, H, Hkv, S, hd in TP_PARTIAL:
        for dt in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, 1, hd), dt)
            k, v = randn(gen, (B, Hkv, S, hd), dt), randn(gen, (B, Hkv, S, hd), dt)
            fill = [0, S // 2 + 1, S] + [S] * (B - 3)
            valid = torch.tensor(fill[:B], dtype=torch.int32, device="cuda")
            tol = TOL["decode_attention"][dt]
            want = ref.decode_attention_partial_ref(q, k, v, valid)
            before = dict(kd.route_launches)
            got = ops.decode_attention_partial(q, k, v, valid)
            again = ops.decode_attention_partial(q, k, v, valid)
            if kd.route_launches["split"] != before["split"] + 2:
                raise AssertionError(f"decode_attention partial {(B, H, S, hd)}: calls took "
                                     f"{kd.route_launches}, not split")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"decode_attention partial {(B, H, S, hd)}: two calls differ")
            simt = kd.launch("simt", q, k, v, valid, 0, partial=True)
            e = []
            for o, lse in (got, simt):
                if o.dtype != torch.float32 or lse.shape != (B, H):
                    raise AssertionError(f"decode_attention partial: out {o.dtype}, lse "
                                         f"{tuple(lse.shape)}")
                if not torch.equal(o[0], torch.zeros_like(o[0])):
                    raise AssertionError("decode_attention partial: a row with no visible slot "
                                         "is not zeros")
                e += [max_err(o, want[0], tol), _lse_err(lse, want[1], tol)]
            errs[(B, H, Hkv, S, hd, str(dt))] = max(e)
            del q, k, v
    print(f"[kernels] decode_attention partial errors {errs}")
    dt = torch.bfloat16
    for B, H, Hkv, S, hd in TP_PARTIAL:
        prefix = f"tp_partial_{B}x{S}_"
        valid = torch.full((B,), S, dtype=torch.int32, device="cuda")
        sets = [(randn(gen, (B, H, 1, hd), dt), randn(gen, (B, Hkv, S, hd), dt),
                 randn(gen, (B, Hkv, S, hd), dt), valid) for _ in range(24)]
        b_ms, b_by = bound(B * H * hd * 2 + 2 * B * Hkv * S * hd * 2 + B * H * (hd + 1) * 4
                           + 4 * B, 4 * B * H * S * hd, dt, rate)
        device_ms, how = graph_ms(ops.decode_attention_partial, sets)
        out.update({
            f"{prefix}shape": f"q ({B}, {H}, 1, {hd}), cache shard ({B}, {Hkv}, {S}, {hd}), "
                              f"every slot visible, bf16, fp32 out and lse",
            f"{prefix}max_abs_err": max(v for k, v in errs.items() if k[:5] == (B, H, Hkv, S, hd)),
            f"{prefix}ms": time_ms(ops.decode_attention_partial, sets, 20),
            f"{prefix}device_ms": device_ms, f"{prefix}device_ms_from": how,
            f"{prefix}plain_ms": time_ms(ref.decode_attention_partial_ref, sets, 20),
            f"{prefix}library_ms": time_ms(_flash_lse, sets, 20),
            f"{prefix}library": "aten._scaled_dot_product_flash_attention (out and logsumexp)",
            f"{prefix}library_device_ms": graph_ms(_flash_lse, sets)[0],
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by})
        del sets
    return out


def flash_bound(B, Hq, Hkv, S, hd, window, rate, *, backward: bool, hdv: int | None = None,
                Skv: int | None = None, causal: bool = True) -> tuple[float, str]:
    """Causal self-attention, or with ``causal=False`` S queries over every one of
    ``Skv`` keys (default S), v of ``hdv`` (default hd) channels.  Bytes: q (and
    dq) of hd and out (and dO) of hdv over Hq heads, k (and dk) of hd and v
    (and dv) of hdv over Hkv, lse in fp32, once each; operations per visible
    (causal, in-window) pair: 2 (hd + hdv) forward (S = Q K^T, P V), 6 hd + 4
    hdv backward (S, dP, dV, dQ, dK: the least work, with S formed once; the
    kernels form S and dP on both sides, 8 hd + 6 hdv) (bf16 rate)."""
    hdv = hd if hdv is None else hdv
    Skv = S if Skv is None else Skv
    if causal:
        visible = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    else:
        visible = S * Skv
    pairs = B * Hq * visible
    q_elems, kv_elems = B * Hq * S * (hd + hdv), B * Hkv * Skv * (hd + hdv)
    if backward:
        return bound(2 * (q_elems + kv_elems) * 2 + B * Hq * S * 4, (6 * hd + 4 * hdv) * pairs,
                     torch.bfloat16, rate)
    return bound((q_elems + kv_elems) * 2 + B * Hq * S * 4, 2 * (hd + hdv) * pairs,
                 torch.bfloat16, rate)


def sdpa_backward_ms(lib, inputs, dout) -> dict:
    """SDPA's backward by backend at these inputs: ``library_default_ms`` (the
    backend SDPA picks itself), each of ``SDPA_BACKENDS`` forced with
    ``sdpa_kernel`` (ms, or why it refused the inputs), and ``library_ms``,
    the fastest that ran, with its ``library_backend``.  Each time is
    autograd's backward alone, forward + backward beside it, and the host's
    time to issue the backward (``issue_ms``): where it equals ``ms``, the
    host, not the device, set the pace."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    (default_bwd, default_issue), (default_both, _) = grad_ms(lib, inputs, dout, 5, issue=True)
    by_backend = {}
    for name in SDPA_BACKENDS:
        def forced(*args, backend=getattr(SDPBackend, name)):
            with sdpa_kernel(backend):
                return lib(*args)
        try:
            (bwd, issue), (both, _) = grad_ms(forced, inputs, dout, 5, issue=True)
        except RuntimeError as e:  # the backend does not take these inputs: no kernel ran
            by_backend[name] = f"refused: {str(e).strip().splitlines()[0][:160]}"
            continue
        by_backend[name] = {"ms": bwd, "issue_ms": issue, "fwd_bwd_ms": both}
    ran = {k: v for k, v in by_backend.items() if isinstance(v, dict)}
    best = min(ran, key=lambda k: ran[k]["ms"])
    return {"library_ms": ran[best]["ms"], "library_backend": best,
            "library_issue_ms": ran[best]["issue_ms"],
            "library_fwd_bwd_ms": ran[best]["fwd_bwd_ms"], "library_default_ms": default_bwd,
            "library_default_issue_ms": default_issue,
            "library_default_fwd_bwd_ms": default_both, "library_by_backend": by_backend}


def flash_times(gen, ops, ref, rate, B, Hq, Hkv, S, hd, window, hdv: int | None = None,
                graphs: bool = False, *, Skv: int | None = None,
                causal: bool = True) -> tuple[dict, dict]:
    """Flash forward and backward times in bf16 at one causal self-attention shape,
    or with ``causal=False`` S queries over ``Skv`` keys (default S), v of
    ``hdv`` channels (default hd), beside the plain versions', SDPA's (with a
    boolean band mask where the window bites; the backward's by backend,
    each given v of its own width: a backend that refuses it is named with
    its reason) and the bound; each also beside the CUDA-core kernels' on
    the same inputs (``simt_ms``); with ``graphs``, the forward's and the
    backward's device times by replayed CUDA graphs (``device_ms``), and
    SDPA's forward and its fastest backend's backward the same way
    (``library_device_ms``)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import flash_attention_bwd as kb

    dt = torch.bfloat16
    hdv = hd if hdv is None else hdv
    Skv = S if Skv is None else Skv
    m = dict(causal=causal, window=window)
    mask = ref.attention_mask(S, Skv, **m, q_offset=0, device="cuda")
    sets = [(randn(gen, (B, Hq, S, hd), dt), randn(gen, (B, Hkv, Skv, hd), dt),
             randn(gen, (B, Hkv, Skv, hdv), dt), randn(gen, (B, Hq, S, hdv), dt))
            for _ in range(2)]
    fwd_sets = [st[:3] for st in sets]
    saved = [(q, k, v, *kf.flash_attention_cuda(q, k, v, **m), do) for q, k, v, do in sets]

    def lib(q, k, v):
        if window:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=Hq != Hkv)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=Hq != Hkv)

    q, k, v, dout = sets[0]
    lib_bwd = sdpa_backward_ms(lib, (q, k, v), dout)
    sizes = dict(hdv=hdv, Skv=Skv, causal=causal)
    b_ms, b_by = flash_bound(B, Hq, Hkv, S, hd, window, rate, backward=False, **sizes)
    fwd = {
        "kernel_route": kf.route(*fwd_sets[0]),
        "ms": time_ms(lambda q, k, v: kf.flash_attention_cuda(q, k, v, **m), fwd_sets, 5),
        "simt_ms": time_ms(lambda q, k, v: kf.launch("simt", q, k, v, **m, q_offset=0),
                           fwd_sets, 5),
        "plain_ms": time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v, **m), fwd_sets, 3),
        "library_ms": time_ms(lib, fwd_sets, 5), "bound_ms": b_ms, "bound_by": b_by,
    }
    if graphs:
        fwd["device_ms"], fwd["device_ms_from"] = graph_ms(
            lambda q, k, v: kf.flash_attention_cuda(q, k, v, **m), fwd_sets, 4, 5)
        fwd["library_device_ms"] = graph_ms(lib, fwd_sets, 4, 5)[0]
    b_ms, b_by = flash_bound(B, Hq, Hkv, S, hd, window, rate, backward=True, **sizes)
    ms, issue_ms = time_ms(lambda *a: kb.flash_attention_bwd_cuda(*a, **m), saved, 5, issue=True)
    bwd = {
        "kernel_route": kb.route(*saved[0][:4], saved[0][5]),
        "ms": ms, "issue_ms": issue_ms,
        "simt_ms": time_ms(lambda *a: kb.launch("simt", *a, **m, q_offset=0), saved, 5),
        "plain_ms": time_ms(lambda *a: ref.flash_attention_bwd_ref(*a, **m), saved, 3),
        "fwd_bwd_ms": time_ms(lambda q, k, v, do: torch.autograd.grad(
            ops.flash_attention(q, k, v, **m), (q, k, v), do),
            [tuple(t.detach().requires_grad_() for t in st[:3]) + (st[3],) for st in sets], 5),
        **lib_bwd, "bound_ms": b_ms, "bound_by": b_by,
    }
    if graphs:
        bwd["device_ms"], bwd["device_ms_from"] = graph_ms(
            lambda *a: kb.flash_attention_bwd_cuda(*a, **m), saved, 4, 5)
        # the library's backward alone by replay: timed back to back, its
        # calls are paced by the host's time to issue them
        from torch.nn.attention import SDPBackend, sdpa_kernel

        def best(*args, backend=getattr(SDPBackend, lib_bwd["library_backend"])):
            with sdpa_kernel(backend):
                return lib(*args)
        bwd["library_device_ms"] = autograd_graph_ms(best, fwd_sets, [st[3] for st in sets], 4, 5)
    return fwd, bwd


def check_flash_at(gen, ref, shapes) -> tuple[dict, dict]:
    """The flash forward and backward kernels against the plain versions at
    ``shapes`` (``flash_shapes``' form), fp32 and bf16, k, v and dO as the
    model hands them over (transposed views): the route of each asserted (the
    tensor cores in bf16 at their widths), the backward called twice and
    compared bit for bit.  Returns the forward's and the backward's largest
    errors by shape and dtype."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import flash_attention_bwd as kb

    errs, gerrs, routes, bwd_routes = {}, {}, {}, {}
    for B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window, as_route in shapes:
        for dt in (torch.float32, torch.bfloat16):
            mask = dict(causal=causal, window=window, q_offset=Skv - Sq if causal else 0)
            q = randn(gen, (B, Hq, Sq, hd), dt)
            # k, v and dO as the model hands them over: transposed views
            k = randn(gen, (B, Skv, Hkv, hd), dt).transpose(1, 2)
            v = randn(gen, (B, Skv, Hkv, hdv), dt).transpose(1, 2)
            dout = randn(gen, (B, Sq, Hq, hdv), dt).transpose(1, 2)
            key = (B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window, str(dt)[6:])
            routes[key] = kf.route(q, k.contiguous(), v.contiguous())
            tc = dt == torch.bfloat16 and (hd, hdv) in kf.TC_WIDTHS
            if routes[key] != ("wgmma" if tc else "simt"):
                raise AssertionError(f"flash_attention {key}: route {routes[key]}")
            # as_route shapes' plain versions round P (and dS) as the route does
            p_bf16 = as_route and tc
            out, lse = kf.flash_attention_cuda(q, k, v, **mask)
            want, want_lse = ref.flash_attention_ref(q, k, v, **mask, p_bf16=p_bf16)
            tol = TOL["flash_attention"][dt]
            errs[key] = max(max_err(out, want, tol), max_err(lse, want_lse, tol))
            before = dict(kb.route_launches)
            got = kb.flash_attention_bwd_cuda(q, k, v, want, want_lse, dout, **mask)
            bwd_routes[key] = [r for r, n in kb.route_launches.items() if n != before[r]]
            if bwd_routes[key] != ["wgmma" if tc else "simt"]:
                raise AssertionError(f"flash_attention_bwd {key}: routes {bwd_routes[key]}")
            again = kb.flash_attention_bwd_cuda(q, k, v, want, want_lse, dout, **mask)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {key}: two calls differ")
            exp = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, **mask,
                                              p_bf16=p_bf16)
            gerrs[key] = max(max_err(a, b, GRAD_TOL[dt]) for a, b in zip(got, exp))
            del q, k, v, dout, out, lse, want, want_lse, got, again, exp
        if B * Hq * Sq * Skv > 2 ** 26:
            gc.collect()
            torch.cuda.empty_cache()
    print(f"[kernels] flash_attention errors {errs}")
    print(f"[kernels] flash_attention bf16 routes "
          f"{ {k[:9]: v for k, v in routes.items() if k[9] == 'bfloat16'} }")
    print(f"[kernels] flash_attention_bwd errors {gerrs}")
    print(f"[kernels] flash_attention_bwd bf16 routes "
          f"{ {k[:9]: v[0] for k, v in bwd_routes.items() if k[9] == 'bfloat16'} }; "
          f"two calls bitwise equal at every shape")
    return errs, gerrs


def check_flash(gen, ops, ref, rate):
    """Flash forward and backward against the plain versions at ``flash_shapes``:
    FLASH_SHAPES, hymba-1.5b's shapes (HYMBA_FLASH), MOE_FLASH_SHAPES (v
    narrower than q and k, MLA's (192, 128) and mixtral-8x7b's among them), a
    small ragged non-causal row and EMBEDDED_FLASH (internvl2-2b's and
    whisper-large-v3's: non-causal with neither side a whole tile), fp32 and
    bf16; the tensor-core rows of the last three against the plain versions
    with P (and dS) rounded as the route rounds them; autograd through
    ``ops.flash_attention`` against the plain backward; times at the qwen
    training shape (the rows), at hymba-1.5b's (their ``hymba`` lists), at
    deepseek-v2-lite-16b's and mixtral-8x7b's (``deepseek``, ``mixtral``) and
    at EMBEDDED_FLASH_TIMES' (``internvl2``, ``whisper_encoder``,
    ``whisper_cross``, ``whisper_decoder``) and PHI4_FLASH (``phi4``)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import flash_attention_bwd as kb

    hymba = [(B, Hq, Hkv, S, S, hd, True, w) for B, Hq, Hkv, S, hd, w in HYMBA_FLASH]
    errs, gerrs = check_flash_at(gen, ref, flash_shapes())

    # queries that see no key (lse = -inf: q_offset -8, window 4) get zero
    # gradients on the tensor-core route, not NaN: at hd 64 and at MLA's widths
    mask = dict(causal=True, window=4, q_offset=-8)
    for hd, hdv in ((64, 64), (192, 128)):
        q, k, v, dout = (randn(gen, shape, torch.bfloat16)
                         for shape in ((1, 4, 160, hd), (1, 2, 200, hd), (1, 2, 200, hdv),
                                       (1, 4, 160, hdv)))
        want, want_lse = ref.flash_attention_ref(q, k, v, **mask)
        got = kb.flash_attention_bwd_cuda(q, k, v, want, want_lse, dout, **mask)
        exp = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, **mask)
        err = max(max_err(a, b, GRAD_TOL[torch.bfloat16]) for a, b in zip(got, exp))
        if (kb.route(q, k, v, want, dout) != "wgmma" or torch.count_nonzero(got[0][:, :, :8])
                or not all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"flash_attention_bwd ({hd}, {hdv}): rows with no visible "
                                 "key are not zero")
        print(f"[kernels] flash_attention_bwd wgmma ({hd}, {hdv}), 8 rows with lse = -inf: "
              f"zero, within {err:.4e}")
        del q, k, v, dout, want, want_lse, got, exp

    # autograd through ops.flash_attention equals the plain backward: fp32 at a
    # small shape; bf16 at the training shapes, where the tensor-core forward's
    # lse feeds the backward kernel (MLA's against P rounded as the route does)
    B, H, _, S, _, hd, _, _ = FLASH_SHAPES[-1]
    dB, dH, _, dS, dhd, dhdv, _ = DEEPSEEK_FLASH
    for shapes_dt, p_bf16 in ((((2, 4, 100, 32),) * 4 + (torch.float32,), False),
                              (((B, H, S, hd),) * 4 + (torch.bfloat16,), False),
                              (((dB, dH, dS, dhd),) * 2 + ((dB, dH, dS, dhdv),) * 2
                               + (torch.bfloat16,), True)):
        dt = shapes_dt[-1]
        q, k, v, dout = (randn(gen, shape, dt) for shape in shapes_dt[:4])
        leaves = [t.requires_grad_() for t in (q, k, v)]
        before, before_bwd = dict(kf.route_launches), dict(kb.route_launches)
        auto = torch.autograd.grad(ops.flash_attention(*leaves), leaves, dout)
        took = [r for r, n in kf.route_launches.items() if n != before[r]]
        took_bwd = [r for r, n in kb.route_launches.items() if n != before_bwd[r]]
        with torch.no_grad():
            want, want_lse = ref.flash_attention_ref(q, k, v, p_bf16=p_bf16)
            plain = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, p_bf16=p_bf16)
        aerr = max(max_err(a, b, GRAD_TOL[dt]) for a, b in zip(auto, plain))
        print(f"[kernels] flash autograd q {tuple(q.shape)} v {tuple(v.shape)} {str(dt)[6:]}: "
              f"forward route {took}, backward route {took_bwd}, "
              f"gradients within {aerr:.4e} of the plain backward")
        if dt == torch.bfloat16 and (took != ["wgmma"] or took_bwd != ["wgmma"]):
            raise AssertionError(f"bf16 autograd took the routes {took} forward, "
                                 f"{took_bwd} backward")
        del q, k, v, dout, leaves, auto, want, want_lse, plain

    key = (B, H, H, S, S, hd, hd, True, 0, "bfloat16")
    fwd, bwd = flash_times(gen, ops, ref, rate, B, H, H, S, hd, 0)
    shape = f"q, k, v ({B}, {H}, {S}, {hd}) causal bf16"
    fwd = {"name": "flash_attention", "shape": shape, "max_abs_err": errs[key], **fwd,
           "hymba": []}
    bwd = {"name": "flash_attention_bwd", "shape": shape, "max_abs_err": gerrs[key], **bwd,
           "hymba": []}
    for B, Hq, Hkv, S, _, hd, _, window in hymba:
        key = (B, Hq, Hkv, S, S, hd, hd, True, window, "bfloat16")
        shape = f"q ({B}, {Hq}, {S}, {hd}), k, v ({B}, {Hkv}, {S}, {hd}), window {window} bf16"
        f, b = flash_times(gen, ops, ref, rate, B, Hq, Hkv, S, hd, window)
        fwd["hymba"].append({"shape": shape, "max_abs_err": errs[key], **f})
        bwd["hymba"].append({"shape": shape, "max_abs_err": gerrs[key], **b})
        torch.cuda.empty_cache()
    for name, (B, Hq, Hkv, S, hd, hdv, window) in (("deepseek", DEEPSEEK_FLASH),
                                                   ("mixtral", MIXTRAL_FLASH)):
        key = (B, Hq, Hkv, S, S, hd, hdv, True, window, "bfloat16")
        shape = (f"q, k ({B}, {Hq} / {Hkv}, {S}, {hd}), v ({B}, {Hkv}, {S}, {hdv}), "
                 f"window {window} bf16")
        f, b = flash_times(gen, ops, ref, rate, B, Hq, Hkv, S, hd, window, hdv, graphs=True)
        fwd[name] = {"shape": shape, "max_abs_err": errs[key], **f}
        bwd[name] = {"shape": shape, "max_abs_err": gerrs[key], **b}
        print(f"[kernels] flash at {name}'s training shape: forward {f['ms']:.4f} ms "
              f"(device {f['device_ms']:.4f}, bound {f['bound_ms']:.4f}, SDPA "
              f"{f['library_ms']:.4f}), backward {b['ms']:.4f} ms (device {b['device_ms']:.4f}, "
              f"bound {b['bound_ms']:.4f}, SDPA {b['library_backend']} {b['library_ms']:.4f})")
        gc.collect()
        torch.cuda.empty_cache()
    for name, (B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window) in (
            *((name, EMBEDDED_FLASH[i]) for name, i in EMBEDDED_FLASH_TIMES.items()),
            ("phi4", PHI4_FLASH)):
        key = (B, Hq, Hkv, Sq, Skv, hd, hdv, causal, window, "bfloat16")
        shape = (f"q ({B}, {Hq} / {Hkv}, {Sq}, {hd}), k, v ({B}, {Hkv}, {Skv}, {hdv}), "
                 f"{'causal' if causal else 'non-causal'} bf16")
        f, b = flash_times(gen, ops, ref, rate, B, Hq, Hkv, Sq, hd, window, hdv, graphs=True,
                           Skv=Skv, causal=causal)
        fwd[name] = {"shape": shape, "max_abs_err": errs[key], **f}
        bwd[name] = {"shape": shape, "max_abs_err": gerrs[key], **b}
        print(f"[kernels] flash at {name}'s shape: forward device {f['device_ms']:.4f} ms (bound "
              f"{f['bound_ms']:.4f}, SDPA {f['library_ms']:.4f}, device "
              f"{f['library_device_ms']:.4f}), backward device {b['device_ms']:.4f} (bound "
              f"{b['bound_ms']:.4f}, SDPA {b['library_backend']} {b['library_ms']:.4f}, device "
              f"{b['library_device_ms']:.4f})")
        gc.collect()
        torch.cuda.empty_cache()
    return fwd, bwd


#: (rows, D) of the rmsnorm backward checks: the qwen, hymba-1.5b and xlstm-1.3b
#: training rows and xlstm-1.3b's mLSTM output norm (8 KB rows; the "vec" body),
#: serving's rows, a small row ("vec") and a ragged one (D = 100: "block"), the
#: MoE training rows, internvl2-2b's image-prefixed rows and phi4-mini-3.8b's
#: training rows
RMSNORM_BWD_SHAPES = ((TRAIN_ROWS, 1024), (4352, 1600), (2048, 2048), (2048, 4096),
                      (SERVE["requests"], 1024), (37, 96), (37, 100), *MOE_RMSNORM,
                      INTERNVL_PREFIX_SWIGLU[:2], PHI4_RMSNORM)


def rmsnorm_bwd_host_steps(x, g, dy, reps: int = 2000) -> dict:
    """Host microseconds per call of each step of the backward wrapper's former
    host path (the card's properties, a device context, ``current_stream``,
    all on every call), alone, and of the lean path's steps, at these inputs
    (the launches run too)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm_bwd as kb

    lib = build.library()
    D, rows = x.shape[-1], x.numel() // x.shape[-1]
    dx, dgamma = torch.empty_like(x), torch.empty_like(g)
    partial = torch.empty((rows, D), dtype=torch.float32, device=x.device)
    key = (x.shape, g.shape, dy.shape, x.dtype, g.dtype, dy.dtype, x.device, g.device, dy.device)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    steps = {
        "device_properties": lambda: torch.cuda.get_device_properties(x.device),
        "device_context": lambda: _enter_exit(torch.cuda.device(x.device)),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "lean_checked_once": lambda: build.checked_once(kb._checked, key, kb._check_key, x, g, dy),
        "dy_contiguous": lambda: dy.contiguous(),
        "empty_dx_dgamma_partial": lambda: (torch.empty_like(x), torch.empty_like(g),
                                            torch.empty((rows, D), dtype=torch.float32,
                                                        device=x.device)),
        "lean_raw_stream": lambda: torch._C._cuda_getCurrentRawStream(x.device.index),
        "ctypes_launch": lambda: lib.rt_rmsnorm_bwd_vec(
            x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
            dgamma.data_ptr(), rows, D, kb._shapes(x, g, dy)["vec"], 1e-5,
            0 if x.dtype == torch.float32 else 1, stream),
        "lean_launch": lambda: kb.launch("vec", x, g, dy, 1e-5),
        "lean_wrapper": lambda: kb.rmsnorm_bwd_cuda(x, g, dy),
    }
    found = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        found[name] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    return found


def check_rmsnorm_bwd(gen, ops, ref, rate):
    """RMSNORM_BWD_SHAPES in fp32 and bf16 against the plain backward, each with
    the route it took (asserted) and two calls equal bit for bit; the ``block``
    body on the same inputs.  Times at qwen's rows (the row), hymba-1.5b's
    (``hymba_*``), the MoE training rows (MOE_RMSNORM_PREFIXES) and
    phi4-mini-3.8b's (``phi4_*``), bf16:
    host-paced ``ms`` with the host's ``issue_ms``, device time from a
    replayed CUDA graph of eight input sets (``device_ms``), the
    ``block`` body's the same way (``block_ms``), ``F.rms_norm``'s backward
    (``library_*``); at qwen's rows the wrapper's host path step by step on
    serving-size rows (``host_steps_us``)."""
    from repro_torch.kernels import rmsnorm_bwd as kb

    errs, routes = {}, {}
    for rows, D in RMSNORM_BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, g, dy = randn(gen, (rows, D), dt), randn(gen, (D,), dt), randn(gen, (rows, D), dt)
            key = (rows, D, str(dt)[6:])
            routes[key] = kb.route(x, g, dy)
            want = ("vec" if D % 8 == 0 and D * x.element_size() <= kb.VEC_MAX_ROW_BYTES
                    else "block")
            if routes[key] != want:
                raise AssertionError(f"rmsnorm_bwd {key}: route {routes[key]}, expected {want}")
            got = kb.rmsnorm_bwd_cuda(x, g, dy, 1e-5)
            again = kb.rmsnorm_bwd_cuda(x, g, dy, 1e-5)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"rmsnorm_bwd {key}: two calls differ")
            exp = ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
            errs[key] = max(max_err(a, b, GRAD_TOL[dt]) for a, b in zip(got, exp))
            errs[key + ("block",)] = max(max_err(a, b, GRAD_TOL[dt]) for a, b in
                                         zip(kb.launch("block", x, g, dy, 1e-5), exp))
    # the "vec" body's shared-memory limit belongs to its kernel instance, which
    # fp32 rows of 2048 and 1600 share: a key configured with the shorter row
    # after the longer must leave the longer one's cached launch valid
    for D in (2048, 1600, 2048):
        x, g, dy = (randn(gen, shape, torch.float32) for shape in ((5, D), (D,), (5, D)))
        got, exp = kb.rmsnorm_bwd_cuda(x, g, dy, 1e-5), ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
        errs[(5, D, "float32", "config order")] = max(
            max_err(a, b, GRAD_TOL[torch.float32]) for a, b in zip(got, exp))
    torch.cuda.synchronize()
    print(f"[kernels] rmsnorm_bwd errors {errs}")
    print(f"[kernels] rmsnorm_bwd routes {routes}; two calls equal bit for bit at every shape")
    row = {"name": "rmsnorm_bwd"}
    for prefix, (N, D) in (("", (TRAIN_ROWS, 1024)), ("hymba_", (4352, 1600)),
                           *zip(MOE_RMSNORM_PREFIXES, MOE_RMSNORM), ("phi4_", PHI4_RMSNORM)):
        dt = torch.bfloat16
        sets = [(randn(gen, (N, D), dt), randn(gen, (D,), dt), randn(gen, (N, D), dt))
                for _ in range(8)]
        x, g, dy = sets[0]
        b_ms, b_by = bound((3 * N * D + 2 * D) * 2, 8 * N * D, dt, rate)
        ms, issue = time_ms(lambda x, g, dy: kb.rmsnorm_bwd_cuda(x, g, dy, 1e-5), sets, 20,
                            issue=True)
        device_ms, how = graph_ms(lambda x, g, dy: kb.rmsnorm_bwd_cuda(x, g, dy, 1e-5), sets)
        # A call here is a few microseconds of device work: the host-paced times
        # are given beside the host's time to issue the calls.
        (lib_bwd, lib_bwd_issue), (lib_both, lib_both_issue) = grad_ms(
            lambda x, g: F.rms_norm(x, (D,), g, 1e-5), (x, g), dy, 20, issue=True)
        leaves = [(a.clone().requires_grad_(), b.clone().requires_grad_(), c)
                  for a, b, c in sets]
        both, both_issue = time_ms(lambda x, g, dy: torch.autograd.grad(
            ops.rmsnorm(x, g, eps=1e-5), (x, g), dy), leaves, 20, issue=True)
        row.update({
            f"{prefix}shape": f"x, dy ({N}, {D}) bf16", f"{prefix}kernel_route": kb.route(x, g, dy),
            f"{prefix}max_abs_err": errs[(N, D, "bfloat16")],
            f"{prefix}ms": ms, f"{prefix}issue_ms": issue,
            f"{prefix}device_ms": device_ms, f"{prefix}device_ms_from": how,
            f"{prefix}block_ms": graph_ms(lambda x, g, dy: kb.launch("block", x, g, dy, 1e-5),
                                          sets)[0],
            f"{prefix}plain_ms": time_ms(lambda x, g, dy: ref.rmsnorm_bwd_ref(x, g, dy, 1e-5),
                                         sets, 20),
            f"{prefix}library_ms": lib_bwd, f"{prefix}library_issue_ms": lib_bwd_issue,
            f"{prefix}library_device_ms": autograd_graph_ms(
                lambda x, g: F.rms_norm(x, (D,), g, 1e-5), [s[:2] for s in sets],
                [s[2] for s in sets], 24, 20),
            f"{prefix}fwd_bwd_ms": both, f"{prefix}fwd_bwd_issue_ms": both_issue,
            f"{prefix}library_fwd_bwd_ms": lib_both,
            f"{prefix}library_fwd_bwd_issue_ms": lib_both_issue,
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by,
            f"{prefix}device_share_of_bound": b_ms / device_ms,
        })
        del sets, leaves
    row["host_steps_us"] = rmsnorm_bwd_host_steps(
        *(randn(gen, s, torch.bfloat16) for s in ((SERVE["requests"], 1024), (1024,),
                                                  (SERVE["requests"], 1024))))
    print(f"[kernels] rmsnorm_bwd device ms {row['device_ms']} (qwen rows), "
          f"{row['hymba_device_ms']} (Hymba's); host steps (us a call) {row['host_steps_us']}")
    return row


#: (N, D, F) of the SwiGLU backward checks: the qwen, hymba-1.5b and xlstm-1.3b
#: training shapes, a ragged shape of 128-row tiles, serving-size rows (the
#: forward on split-K, the backward on the tensor cores) and a bf16 shape that
#: TMA refuses (D = 100: the recompute path and gate kernel), and
#: deepseek-v2-lite-16b's layer0 and shared experts, internvl2-2b's and
#: phi4-mini-3.8b's at their training shapes
SWIGLU_BWD_SHAPES = ((TRAIN_ROWS, 1024, 2816), HYMBA_SWIGLU, (2048, 2048, 2688),
                     (333, 200, 712), (20, 96, 224), (37, 100, 260), *DEEPSEEK_SWIGLU,
                     INTERNVL_SWIGLU, INTERNVL_PREFIX_SWIGLU, PHI4_SWIGLU)


def _fwd_bwd(fn, x, wg, wu, wd, dy):
    """The gradients of ``fn(x, wg, wu, wd)`` by autograd, its forward included."""
    leaves = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
    return torch.autograd.grad(fn(*leaves), leaves, dy)


def _swiglu_bwd_inputs(gen, N, D, Fd, dt):
    from repro_torch.kernels import swiglu as ks

    x, dy = randn(gen, (N, D), dt), randn(gen, (N, D), dt)
    wg, wu = randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (D, Fd), dt, D ** -0.5)
    wd = randn(gen, (Fd, D), dt, Fd ** -0.5)
    _, a, b = ks.swiglu_cuda(x, wg, wu, wd, save_ab=True)
    return x, wg, wu, wd, dy, a, b


#: the SwiGLU backward's gradients, in the order autograd returns them
SWIGLU_GRADS = ("dx", "dWg", "dWu", "dWd")


def _swiglu_bwd_f64(x, wg, wu, wd, a, b, dy):
    """The SwiGLU backward from the saved a and b, every step in fp64: a
    witness whose own error is far below the bf16 roundings that both the
    kernel and the plain version make."""
    x, wg, wu, wd, a, b, dy = (t.double() for t in (x, wg, wu, wd, a, b, dy))
    sig = torch.sigmoid(a)
    dh = dy @ wd.T
    da = dh * b * (sig * (1.0 + a * (1.0 - sig)))
    db = dh * (a * sig)
    return da @ wg.T + db @ wu.T, x.T @ da, x.T @ db, (a * sig * b).T @ dy


def _witness_err(got, witness, tol) -> tuple[float, float]:
    """The largest |got - witness|, and the largest as a share of the tolerance
    ``tol + tol |witness|`` of ``assert_close(rtol=atol=tol)``."""
    diff = (got.double() - witness).abs()
    return float(diff.max()), float((diff / (tol + tol * witness.abs())).max())


def _tol_misses(got, want, tol) -> tuple[int, float, float]:
    """Elements of ``got`` outside ``assert_close(rtol=atol=tol)`` of ``want``;
    the largest |got - want| among them and the tolerance it had."""
    diff = (got.double() - want.double()).abs()
    allowed = tol + tol * want.double().abs()
    out = diff > allowed
    if not bool(out.any()):
        return 0, 0.0, 0.0
    worst = int(torch.argmax(torch.where(out, diff - allowed, -1.0)))
    return int(out.sum()), float(diff.flatten()[worst]), float(allowed.flatten()[worst])


def check_swiglu_bwd(gen, ops, ref, rate):
    """SWIGLU_BWD_SHAPES in fp32 and bf16: the forward's saved a and b against
    the plain forward's; the gradients of ``ops.swiglu_mlp`` (which saves them)
    two calls equal bit for bit, the route asserted, and all four against the
    plain backward (on the recompute path ``ref.swiglu_bwd_ref``, on the
    tensor-core route ``ref.swiglu_bwd_saved_ref`` from the same a and b)
    within GRAD_TOL.  On the tensor-core route also: the kernel's h, da and db
    against the plain gate; each gradient, and the plain version's, against
    an fp64 witness from the same a and b (``_swiglu_bwd_f64``), where the
    kernel's largest error must be at most twice the plain version's; and
    the recompute path and gate kernel of PRs 12-17 (``simt``) against its
    plain version.  A gradient outside GRAD_TOL of the plain version passes
    only with that witness, and is printed and returned (``plain_misses``)
    with both errors.  Times at qwen's shape (the row),
    hymba-1.5b's (``hymba_*``), deepseek-v2-lite-16b's
    (DEEPSEEK_SWIGLU_PREFIXES), internvl2-2b's (``internvl2_*``) and
    phi4-mini-3.8b's (``phi4_*``), bf16, each
    from a replayed CUDA graph of two
    input sets: the backward (``device_ms``; ``ms`` event-timed back to
    back), its kernel alone (``kernel_device_ms``), the PR 12-17 path
    (``simt_ms``), autograd of three ``@`` (``library_ms``), forward and
    backward of both (``fwd_bwd_device_ms``, ``library_fwd_bwd_device_ms``)."""
    from repro_torch.kernels import swiglu_bwd as kb

    errs, routes, witness, misses = {}, {}, {}, {}
    for N, D, Fd in SWIGLU_BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, wg, wu, wd, dy, a, b = _swiglu_bwd_inputs(gen, N, D, Fd, dt)
            key = (N, D, Fd, str(dt)[6:])
            routes[key] = kb.route(x, wg, wu, wd, dy, a, b)
            want = "wgmma" if dt == torch.bfloat16 and D % 8 == 0 and Fd % 8 == 0 else "simt"
            if routes[key] != want or (a is None) != (want == "simt"):
                raise AssertionError(f"swiglu_bwd {key}: route {routes[key]}, a saved "
                                     f"{a is not None}; expected {want}")
            if a is not None:
                _, a0, b0 = ref.swiglu_fwd_ref(x, wg, wu, wd)
                errs[key + ("a, b",)] = max(max_err(a, a0, TOL["swiglu_mlp"][dt]),
                                            max_err(b, b0, TOL["swiglu_mlp"][dt]))
            leaves = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
            got = torch.autograd.grad(ops.swiglu_mlp(*leaves), leaves, dy)
            again = torch.autograd.grad(ops.swiglu_mlp(*leaves), leaves, dy)
            if not all(torch.equal(p, q) for p, q in zip(got, again)):
                raise AssertionError(f"swiglu_bwd {key}: two calls differ")
            if routes[key] == "simt":
                exp = ref.swiglu_bwd_ref(x, wg, wu, wd, dy)
                errs[key] = max(max_err(p, q, GRAD_TOL[dt]) for p, q in zip(got, exp))
            else:
                gate = kb.gate_bwd_tc(dy, wd, a, b)
                plain_gate = ref.swiglu_gate_bwd_ref(a, b, dy.float() @ wd.float().T)
                errs[key + ("h, da, db",)] = max(max_err(p, q, GRAD_TOL[dt])
                                                 for p, q in zip(gate, plain_gate))
                exp = ref.swiglu_bwd_saved_ref(x, wg, wu, wd, a, b, dy)
                wit = _swiglu_bwd_f64(x, wg, wu, wd, a, b, dy)
                for name, g, p, w in zip(SWIGLU_GRADS, got, exp, wit):
                    (k_err, k_share), (p_err, p_share) = (_witness_err(t, w, GRAD_TOL[dt])
                                                          for t in (g, p))
                    witness[key + (name,)] = (k_err, p_err, k_share, p_share)
                    if k_err > 2 * p_err or k_share > 2 * p_share:
                        raise AssertionError(f"swiglu_bwd {key} {name}: {k_err} ({k_share} of "
                                             f"GRAD_TOL) from the fp64 witness, the plain "
                                             f"version {p_err} ({p_share})")
                    n_out, worst, allowed = _tol_misses(g, p, GRAD_TOL[dt])
                    if n_out:
                        misses[key + (name,)] = {"elements": n_out, "of": g.numel(),
                                                 "abs_err": worst, "allowed": allowed,
                                                 "witness_err": k_err,
                                                 "plain_witness_err": p_err,
                                                 "witness_share_of_tol": k_share,
                                                 "plain_witness_share_of_tol": p_share}
                errs[key] = max(float((g.float() - p.float()).abs().max())
                                for g, p in zip(got, exp))
                del gate, plain_gate, wit
            if routes[key] == "wgmma":
                simt = kb.launch("simt", x, wg, wu, wd, dy)
                errs[key + ("simt",)] = max(max_err(p, q, GRAD_TOL[dt]) for p, q in
                                            zip(simt, ref.swiglu_bwd_ref(x, wg, wu, wd, dy)))
            del x, wg, wu, wd, dy, a, b, leaves, got, again, exp
    torch.cuda.synchronize()
    print(f"[kernels] swiglu_mlp_bwd errors {errs}")
    print(f"[kernels] swiglu_mlp_bwd routes {routes}; two calls equal bit for bit at every shape")
    print(f"[kernels] swiglu_mlp_bwd against the fp64 witness (kernel's and plain version's "
          f"largest |error|, then as shares of GRAD_TOL) {witness}")
    print(f"[kernels] swiglu_mlp_bwd outside GRAD_TOL of the plain version: {misses or 'none'}")
    row = {"name": "swiglu_mlp_bwd",
           "plain_misses": {" ".join(map(str, k)): v for k, v in misses.items()}}
    tgen = torch.Generator(device="cuda").manual_seed(1)     # the timed inputs, on the card
    for prefix, (N, D, Fd) in (("", SWIGLU_BWD_SHAPES[0]), ("hymba_", HYMBA_SWIGLU),
                               *zip(DEEPSEEK_SWIGLU_PREFIXES, DEEPSEEK_SWIGLU),
                               ("internvl2_", INTERNVL_SWIGLU), ("phi4_", PHI4_SWIGLU)):
        dt = torch.bfloat16
        sets = [_swiglu_bwd_inputs(tgen, N, D, Fd, dt) for _ in range(2)]
        b_ms, b_by = bound((3 * N * D + 6 * D * Fd + 2 * N * Fd) * 2,
                           12 * N * D * Fd + 10 * N * Fd, dt, rate)
        k_ms, k_by = bound((N * D + D * Fd + 5 * N * Fd) * 2, 2 * N * D * Fd + 10 * N * Fd, dt,
                           rate)
        calls, replays = 4, 5

        def gms(fn):
            return graph_ms(fn, sets, calls, replays)[0]

        row.update({
            f"{prefix}shape": f"x, dy ({N}, {D}), d_ff {Fd} bf16",
            f"{prefix}kernel_route": routes[(N, D, Fd, "bfloat16")],
            f"{prefix}max_abs_err": errs[(N, D, Fd, "bfloat16")],
            f"{prefix}ms": time_ms(kb.swiglu_bwd_cuda, sets, 5),
            f"{prefix}device_ms": gms(kb.swiglu_bwd_cuda),
            f"{prefix}kernel_device_ms": gms(lambda x, wg, wu, wd, dy, a, b:
                                             kb.gate_bwd_tc(dy, wd, a, b)),
            f"{prefix}kernel_bound_ms": k_ms, f"{prefix}kernel_bound_by": k_by,
            f"{prefix}simt_ms": gms(lambda x, wg, wu, wd, dy, a, b:
                                    kb.launch("simt", x, wg, wu, wd, dy)),
            f"{prefix}plain_ms": time_ms(lambda x, wg, wu, wd, dy, a, b:
                                         ref.swiglu_bwd_saved_ref(x, wg, wu, wd, a, b, dy),
                                         sets, 3),
            f"{prefix}library_ms": autograd_graph_ms(_swiglu_lib, [s[:4] for s in sets],
                                                     [s[4] for s in sets], calls, replays),
            f"{prefix}fwd_bwd_device_ms": gms(lambda *s: _fwd_bwd(ops.swiglu_mlp, *s[:5])),
            f"{prefix}library_fwd_bwd_device_ms": gms(lambda *s: _fwd_bwd(_swiglu_lib, *s[:5])),
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by,
        })
        del sets
        torch.cuda.empty_cache()
    print(f"[kernels] swiglu_mlp_bwd device ms: backward {row['device_ms']} / "
          f"{row['hymba_device_ms']}, kernel {row['kernel_device_ms']} / "
          f"{row['hymba_kernel_device_ms']}; forward + backward {row['fwd_bwd_device_ms']} / "
          f"{row['hymba_fwd_bwd_device_ms']} against autograd of three @ "
          f"{row['library_fwd_bwd_device_ms']} / {row['hymba_library_fwd_bwd_device_ms']}")
    return row


def rel_err(got, want, tol) -> tuple[float, float]:
    """(max |got - want|, the same over want's largest entry); the second must
    be within ``tol``."""
    got, want = got.detach().float(), want.detach().float()
    # one temporary, made absolute in place: these are full-width gradient
    # leaves on the host, whose fresh allocations cost more than the sums
    err = float(torch.sub(got, want).abs_().max())
    lo, hi = want.aminmax()
    scale = max(float(hi), -float(lo))
    if not (math.isfinite(err) and err <= tol * scale):
        raise AssertionError(f"max |diff| {err} > {tol} x max |want| {scale}")
    return err, err / max(scale, 1e-30)


def mlstm_inputs(gen, B, H, S, dqk, dv, dt, model_layout: bool = False):
    """q, k, v, i_raw, log_f as tests/test_kernels.py draws them, and a dh; with
    ``model_layout``, each a (B, H, S, .) view of a (B, S, H, .) tensor, as
    ``models.xlstm`` hands them over (and as autograd hands over dh)."""
    def draw(shape, fn):
        if not model_layout:
            return fn(shape)
        return fn((shape[0], shape[2], shape[1], *shape[3:])).transpose(1, 2)

    q, k = (draw((B, H, S, dqk), lambda s: randn(gen, s, dt)) for _ in range(2))
    v, i_raw = draw((B, H, S, dv), lambda s: randn(gen, s, dt)), draw((B, H, S),
                                                                      lambda s: randn(gen, s, dt))
    log_f = draw((B, H, S), lambda s: torch.log(torch.rand(s, generator=gen) * 0.3 + 0.7)
                 .to("cuda", dt))
    return (q, k, v, i_raw, log_f), draw((B, H, S, dv), lambda s: randn(gen, s, dt))


def mlstm_bound(B, H, S, dqk, dv, chunk, rate, *, backward: bool) -> tuple[float, str]:
    """Operations the forward needs, per (b, h): ``q k^T`` and ``S v`` over each
    chunk's causal pairs, L (L + 1) / 2 of them at 2 (dqk + dv) each; the
    read-out ``q C`` of every chunk but the first (C is 0 there) and the state
    update of every chunk but the last (its state is never read), 2 L dqk dv
    each.  Bytes: q, k, v, i, f read and h written once in bf16.  The backward
    does each product's two gradient products (twice the operations), reads
    q, k, v, i, f and dh and writes their five gradients once."""
    L = min(chunk, S)
    nc = S // L
    bht = B * H * S
    ops_fwd = B * H * (nc * L * (L + 1) * (dqk + dv) + 2 * (nc - 1) * 2 * L * dqk * dv)
    if backward:
        return bound(bht * (4 * dqk + 3 * dv + 4) * 2, 2 * ops_fwd, torch.bfloat16, rate)
    return bound(bht * (2 * dqk + 2 * dv + 2) * 2, ops_fwd, torch.bfloat16, rate)


def check_mlstm(gen, ops, ref, rate):
    """mlstm_scan and its backward against the plain versions.  The CUDA-core
    route (``simt``) at MLSTM_SHAPES, fp32 and bf16, as before: h and the
    chunk-start states C and n, then the five gradients from each side's own
    saved state.  The tensor-core route (``wgmma``, asserted) at
    MLSTM_TC_SHAPES in the model's transposed layout and contiguous, held to
    the plain versions with its roundings (``bf16_products``): h, C and n,
    then the five gradients, each backward called twice and compared bit for
    bit; the model's views through ``ops.mlstm_scan`` with no copy.  Autograd
    through ``ops.mlstm_scan`` against the plain backward.  Times at the
    training shape in bf16, in the model's layout: each kernel event-timed
    back to back (``ms``) and by CUDA-graph replay (``dev_ms``), beside the
    CUDA-core kernels on the same values (``simt_ms``, graph replay)."""
    from repro_torch.kernels import mlstm_scan as kf
    from repro_torch.kernels import mlstm_scan_bwd as kb

    bf16, f32 = torch.bfloat16, torch.float32
    errs, gerrs = {}, {}
    for B, H, S, dqk, dv, chunk in MLSTM_SHAPES:
        for dt in (f32, bf16):
            x, dh = mlstm_inputs(gen, B, H, S, dqk, dv, dt)
            L = min(chunk, S)
            key = (B, H, S, dqk, dv, chunk, str(dt)[6:])
            route = "wgmma" if dt == bf16 and L == 128 and dqk % 64 == 0 else "simt"
            if kf.route(L, *x[:3], dh) != route:
                raise AssertionError(f"mlstm_scan {key}: route {kf.route(L, *x[:3], dh)}")
            out, saved = kf.launch("simt", *x, L)
            h, C, n, m = ref.mlstm_scan_ref(*x, chunk=chunk)
            tol = MLSTM_TOL[dt]
            # the states are fp32 on both sides, whatever the inputs' type
            states = MLSTM_TOL[f32]
            errs[key] = max(rel_err(out, h, tol), rel_err(saved.C, C, states),
                            rel_err(saved.n, n, states), key=lambda e: e[1])
            got = kb.launch("simt", *x, saved, dh, L)
            want = ref.mlstm_scan_bwd_ref(*x, C, n, m, dh, chunk=chunk)
            gerrs[key] = max((rel_err(a, b, GRAD_TOL[dt]) for a, b in zip(got, want)),
                             key=lambda e: e[1])
            del x, dh, out, saved, h, C, n, m, got, want
    torch.cuda.synchronize()
    print(f"[kernels] mlstm_scan simt (h, C, n) errors, (max abs, over the largest entry) {errs}")
    print(f"[kernels] mlstm_scan_bwd simt errors (dq, dk, dv, di, df), (max abs, over the "
          f"largest entry) {gerrs}")

    tc_errs, tc_gerrs = {}, {}
    tol = MLSTM_TOL[bf16]
    for B, H, S, dqk, dv, chunk in MLSTM_TC_SHAPES:
        for layout in ("model", "contiguous"):
            x, dh = mlstm_inputs(gen, B, H, S, dqk, dv, bf16, model_layout=layout == "model")
            key = (B, H, S, dqk, dv, chunk, layout)
            if kf.route(chunk, *x[:3], dh) != "wgmma":
                raise AssertionError(f"mlstm_scan {key}: route {kf.route(chunk, *x[:3], dh)}")
            if any(a is not b for a, b in zip(kf.readable(*x, chunk), x)):
                raise AssertionError(f"mlstm_scan {key}: inputs copied")
            before, before_bwd = dict(kf.route_launches), dict(kb.route_launches)
            out, saved = kf.mlstm_scan_cuda(*x, chunk=chunk)
            if not out.transpose(1, 2).is_contiguous():
                raise AssertionError(f"mlstm_scan {key}: h is not a view of (B, S, H, dv)")
            h, C, n, m = ref.mlstm_scan_ref(*x, chunk=chunk, bf16_products=True)
            found = [rel_err(out, h, tol), rel_err(saved.n, n, MLSTM_TOL[f32])]
            if S > chunk:       # C is bf16 on the route, fp32 in the plain version
                found.append(rel_err(saved.C, C[:, :, 1:], tol))
            tc_errs[key] = max(found, key=lambda e: e[1])
            got = kb.mlstm_scan_bwd_cuda(*x, saved, dh, chunk=chunk)
            again = kb.mlstm_scan_bwd_cuda(*x, saved, dh, chunk=chunk)
            took = [r for r, c in kf.route_launches.items() if c != before[r]]
            took_bwd = [r for r, c in kb.route_launches.items() if c != before_bwd[r]]
            if took != ["wgmma"] or took_bwd != ["wgmma"]:
                raise AssertionError(f"mlstm_scan {key}: routes {took}, backward {took_bwd}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"mlstm_scan_bwd {key}: two calls differ")
            exp = ref.mlstm_scan_bwd_ref(*x, C, n, m, dh, chunk=chunk, bf16_products=True)
            tc_gerrs[key] = max((rel_err(a, b, tol) for a, b in zip(got, exp)),
                                key=lambda e: e[1])
            del x, dh, out, saved, h, C, n, m, got, again, exp
    torch.cuda.synchronize()
    print(f"[kernels] mlstm_scan wgmma (h, n, C) errors against the plain version with its "
          f"roundings, (max abs, over the largest entry) {tc_errs}")
    print(f"[kernels] mlstm_scan_bwd wgmma errors (dq, dk, dv, di, df) {tc_gerrs}; two calls "
          f"bitwise equal at every shape")

    # the model's views through ops.mlstm_scan: no copy, the tensor-core route
    # both ways, the wrappers' bits
    B, H, S, dqk, dv, chunk = MLSTM_TC_SHAPES[1]
    x, dh = mlstm_inputs(gen, B, H, S, dqk, dv, bf16, model_layout=True)
    bases = [t.transpose(1, 2).detach().requires_grad_() for t in x]
    before, before_bwd = dict(kf.route_launches), dict(kb.route_launches)
    out = ops.mlstm_scan(*(b.transpose(1, 2) for b in bases), chunk=chunk)
    auto = torch.autograd.grad(out, bases, dh)
    if (kf.route_launches["wgmma"] - before["wgmma"],
            kb.route_launches["wgmma"] - before_bwd["wgmma"]) != (1, 1):
        raise AssertionError(f"ops.mlstm_scan: routes {kf.route_launches}, {kb.route_launches}")
    want_out, saved = kf.mlstm_scan_cuda(*x, chunk=chunk)
    want = kb.mlstm_scan_bwd_cuda(*x, saved, dh, chunk=chunk)
    if not torch.equal(out, want_out) or not all(torch.equal(a.transpose(1, 2), b)
                                                 for a, b in zip(auto, want)):
        raise AssertionError("ops.mlstm_scan on the model's views differs from the wrappers")

    # autograd through ops.mlstm_scan equals the plain backward
    x, dh = mlstm_inputs(gen, 2, 2, 128, 32, 64, f32)
    leaves = [t.requires_grad_() for t in x]
    auto = torch.autograd.grad(ops.mlstm_scan(*leaves, chunk=32), leaves, dh)
    _, C, n, m = ref.mlstm_scan_ref(*x, chunk=32)
    for a, b in zip(auto, ref.mlstm_scan_bwd_ref(*x, C, n, m, dh, chunk=32)):
        rel_err(a, b, GRAD_TOL[f32])

    B, H, S, dqk, dv, chunk = MLSTM_TC_SHAPES[-1]
    sets = [mlstm_inputs(gen, B, H, S, dqk, dv, bf16, model_layout=True) for _ in range(2)]
    fwd_sets = [x for x, _ in sets]
    saved = [(*x, kf.mlstm_scan_cuda(*x, chunk=chunk)[1], dh) for x, dh in sets]
    simt_fwd = [tuple(t.contiguous() for t in x) for x in fwd_sets]
    simt_saved = [(*xc, kf.launch("simt", *xc, chunk)[1], dh.contiguous())
                  for xc, (_, dh) in zip(simt_fwd, sets)]
    plain_saved = [(*x, *ref.mlstm_scan_ref(*x, chunk=chunk, bf16_products=True)[1:], dh)
                   for x, dh in sets]
    shape = (f"q, k ({B}, {H}, {S}, {dqk}), v ({B}, {H}, {S}, {dv}), chunk {chunk} bf16, "
             f"views of (B, S, H, .) as the model's")
    key = (B, H, S, dqk, dv, chunk, "model")
    note = "no PyTorch call computes the chunked mLSTM"
    rows = []
    for name, fn, simt_fn, plain_fn, arg_sets, simt_sets, plain_sets, err, backward in (
            ("mlstm_scan", lambda *x: kf.mlstm_scan_cuda(*x, chunk=chunk),
             lambda *x: kf.launch("simt", *x, chunk),
             lambda *x: ref.mlstm_scan_ref(*x, chunk=chunk, bf16_products=True),
             fwd_sets, simt_fwd, fwd_sets, tc_errs[key], False),
            ("mlstm_scan_bwd", lambda *a: kb.mlstm_scan_bwd_cuda(*a, chunk=chunk),
             lambda *a: kb.launch("simt", *a[:6], a[6], chunk),
             lambda *a: ref.mlstm_scan_bwd_ref(*a, chunk=chunk, bf16_products=True),
             saved, simt_saved, plain_saved, tc_gerrs[key], True)):
        b_ms, b_by = mlstm_bound(B, H, S, dqk, dv, chunk, rate, backward=backward)
        dev_ms = graph_ms(fn, arg_sets, 8, 10)[0]
        rows.append({
            "name": name, "shape": shape, "kernel_route": "wgmma",
            "max_abs_err": err[0], "max_rel_err": err[1],
            "ms": time_ms(fn, arg_sets, 5), "dev_ms": dev_ms,
            "simt_ms": graph_ms(simt_fn, simt_sets, 4, 3)[0],
            "plain_ms": time_ms(plain_fn, plain_sets, 3),
            "library_ms": None, "library_note": note,
            "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / dev_ms,
        })
        torch.cuda.empty_cache()
    rows[1]["fwd_bwd_ms"] = time_ms(lambda *a: torch.autograd.grad(
        ops.mlstm_scan(*(t.transpose(1, 2) for t in a[:5]), chunk=chunk), a[:5], a[5]),
        [tuple(t.transpose(1, 2).detach().requires_grad_() for t in x) + (dh,)
         for x, dh in sets], 3)
    for r in rows:
        print(f"[kernels] {r['name']} at the training shape: {r['dev_ms']:.4f} ms by graph "
              f"replay ({r['share_of_bound']:.3f} of the {r['bound_by']} bound "
              f"{r['bound_ms']:.4f} ms), simt {r['simt_ms']:.4f} ms")
    return rows[0], rows[1]


def ssd_inputs(gen, B, S, H, N, chd, dt):
    """lf (fp32), b, x, c as tests/test_extensions.py draws them, and a dy."""
    lf = torch.log(torch.rand((B, S, H), generator=gen) * 0.3 + 0.7).cuda()
    b, c = randn(gen, (B, S, H, N), dt, 0.3), randn(gen, (B, S, H, N), dt, 0.3)
    return (lf, b, randn(gen, (B, S, H, chd), dt), c), randn(gen, (B, S, H, chd), dt)


def ssd_bound(B, S, H, N, chd, chunk, rate, *, backward: bool) -> tuple[float, str]:
    """Operations the forward needs, per (b, h): ``c b^T`` and its product with
    x over each chunk's causal pairs, L (L + 1) / 2 of them at 2 (N + chd)
    each; the read-out ``h c`` of every chunk but the first (h is 0 there) and
    the state update of every chunk but the last (its state is never read), 2
    L N chd each.  Bytes: lf (fp32), b, x, c read and y (and the fp32 h_last)
    written once.  The backward does each product's two gradient products
    (twice the operations), reads lf, b, x, c and dy and writes their four
    gradients once."""
    L = min(chunk, S)
    nc = S // L
    bsh = B * S * H
    ops_fwd = B * H * (nc * L * (L + 1) * (N + chd) + 2 * (nc - 1) * 2 * L * N * chd)
    if backward:
        return bound(bsh * (8 + (4 * N + 3 * chd) * 2), 2 * ops_fwd, torch.bfloat16, rate)
    return bound(bsh * (4 + (2 * N + 2 * chd) * 2) + B * H * chd * N * 4, ops_fwd,
                 torch.bfloat16, rate)


def check_ssd(gen, ops, ref, rate):
    """ssd_scan and its backward against the plain versions at SSD_SHAPES: y,
    h_last and the chunk-start states, then the four gradients from each
    side's own saved states; the tensor-core route (asserted wherever
    ``route`` gives it) against the plain version with ``bf16_products``, the
    CUDA-core route against the plain fp32 arithmetic; each backward called
    twice, its results equal bit for bit.  A padded sequence through
    ``models.hymba.ssd_scan`` and autograd through ``ops.ssd_scan`` against
    the plain backward; times at the training shape in bf16, each beside the
    CUDA-core kernels on the same inputs (``simt_ms``)."""
    from repro_torch.kernels import ssd_scan as kf
    from repro_torch.kernels import ssd_scan_bwd as kb
    from repro_torch.models import hymba

    errs, gerrs, routes = {}, {}, {}
    states_tol = SSD_TOL[torch.float32]       # fp32 on both sides, whatever the inputs' type
    for B, S, H, N, chd, chunk in SSD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, dy = ssd_inputs(gen, B, S, H, N, chd, dt)
            key = (B, S, H, N, chd, chunk, str(dt)[6:])
            L = min(chunk, S)
            routes[key] = kf.route(L, *x[1:], dy)
            tc = routes[key] == "wgmma"
            if tc != (dt == torch.bfloat16 and L == 128 and N % 16 == 0 and chd % 8 == 0):
                raise AssertionError(f"ssd_scan {key}: route {routes[key]}")
            before, before_bwd = dict(kf.route_launches), dict(kb.route_launches)
            y, h_last, saved = kf.ssd_scan_cuda(*x, chunk=chunk)
            want, want_h, states = ref.ssd_scan_ref(*x, chunk=chunk, bf16_products=tc)
            # h_last and the states take one bf16 operand on the tensor-core route
            st_tol = SSD_TOL[dt] if tc else states_tol
            errs[key] = max(rel_err(y, want, SSD_TOL[dt]), rel_err(h_last, want_h, st_tol),
                            rel_err(saved.states, states, st_tol), key=lambda e: e[1])
            got = kb.ssd_scan_bwd_cuda(*x, saved, dy, chunk=chunk)
            again = kb.ssd_scan_bwd_cuda(*x, saved, dy, chunk=chunk)
            took = [r for r, n in kf.route_launches.items() if n != before[r]]
            took_bwd = [r for r, n in kb.route_launches.items() if n != before_bwd[r]]
            if took != [routes[key]] or took_bwd != [routes[key]]:
                raise AssertionError(f"ssd_scan {key}: routes {took}, backward {took_bwd}")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"ssd_scan_bwd {key}: two calls differ")
            exp = ref.ssd_scan_bwd_ref(*x, states, dy, chunk=chunk, bf16_products=tc)
            gtol = SSD_TOL[dt] if tc else GRAD_TOL[dt]
            gerrs[key] = max((rel_err(a, b, gtol) for a, b in zip(got, exp)),
                             key=lambda e: e[1])
            del x, dy, y, h_last, saved, want, want_h, states, got, again, exp
    torch.cuda.synchronize()
    print(f"[kernels] ssd_scan (y, h_last, states) errors, (max abs, over the largest entry) "
          f"{errs}")
    print(f"[kernels] ssd_scan_bwd errors (dlf, db, dx, dc), (max abs, over the largest "
          f"entry) {gerrs}; two calls bitwise equal at every shape")
    print(f"[kernels] ssd_scan routes (forward and backward) "
          f"{ {k: v for k, v in routes.items() if k[6] == 'bfloat16'} }")

    # a padded sequence through the model's scan, and autograd through ops.ssd_scan,
    # against the plain forward and backward on the padded inputs
    x, dy = ssd_inputs(gen, 2, 72, 2, 16, 128, torch.float32)
    leaves = [t.requires_grad_() for t in x]
    y, h_last = hymba.ssd_scan(*leaves, chunk=32)
    auto = torch.autograd.grad(y, leaves, dy)
    padded = [torch.cat([t.detach(), t.new_zeros((t.shape[0], 24, *t.shape[2:]))], 1) for t in x]
    want, want_h, states = ref.ssd_scan_ref(*padded, chunk=32)
    rel_err(y, want[:, :72], SSD_TOL[torch.float32])
    rel_err(h_last, want_h, states_tol)
    dy_pad = torch.cat([dy, dy.new_zeros((2, 24, 2, 128))], 1)
    for a, b in zip(auto, ref.ssd_scan_bwd_ref(*padded, states, dy_pad, chunk=32)):
        rel_err(a, b[:, :72], GRAD_TOL[torch.float32])

    B, S, H, N, chd, chunk = SSD_SHAPES[-1]
    dt = torch.bfloat16
    sets = [ssd_inputs(gen, B, S, H, N, chd, dt) for _ in range(2)]
    fwd_sets = [x for x, _ in sets]
    saved = [(*x, kf.ssd_scan_cuda(*x, chunk=chunk)[2], dy) for x, dy in sets]
    plain_saved = [(*x, ref.ssd_scan_ref(*x, chunk=chunk)[2], dy) for x, dy in sets]
    shape = f"lf ({B}, {S}, {H}), b, c ({B}, {S}, {H}, {N}), x ({B}, {S}, {H}, {chd}), " \
            f"chunk {chunk} bf16"
    key = (B, S, H, N, chd, chunk, "bfloat16")
    note = "no PyTorch call computes the SSD chunked scan"
    b_ms, b_by = ssd_bound(B, S, H, N, chd, chunk, rate, backward=False)
    fwd = {
        "name": "ssd_scan", "shape": shape, "kernel_route": routes[key],
        "max_abs_err": errs[key][0], "max_rel_err": errs[key][1],
        "ms": time_ms(lambda *x: kf.ssd_scan_cuda(*x, chunk=chunk), fwd_sets, 5),
        "simt_ms": time_ms(lambda *x: kf.launch("simt", *x, chunk), fwd_sets, 5),
        "plain_ms": time_ms(lambda *x: ref.ssd_scan_ref(*x, chunk=chunk), fwd_sets, 3),
        "library_ms": None, "library_note": note,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    b_ms, b_by = ssd_bound(B, S, H, N, chd, chunk, rate, backward=True)
    ms, issue_ms = time_ms(lambda *a: kb.ssd_scan_bwd_cuda(*a, chunk=chunk), saved, 5, issue=True)
    bwd = {
        "name": "ssd_scan_bwd", "shape": shape, "kernel_route": routes[key],
        "max_abs_err": gerrs[key][0], "max_rel_err": gerrs[key][1],
        "ms": ms, "issue_ms": issue_ms,
        "simt_ms": time_ms(lambda *a: kb.launch("simt", *a[:4], a[4], a[5], chunk), saved, 5),
        "plain_ms": time_ms(lambda *a: ref.ssd_scan_bwd_ref(*a, chunk=chunk), plain_saved, 3),
        "fwd_bwd_ms": time_ms(lambda *a: torch.autograd.grad(
            ops.ssd_scan(*a[:4], chunk=chunk)[0], a[:4], a[4]),
            [tuple(t.detach().requires_grad_() for t in x) + (dy,) for x, dy in sets], 5),
        "library_ms": None, "library_note": note,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    return fwd, bwd


def phase_full_width() -> None:
    """qwen1.5-0.5b in fp32: one decode_step on the card against the CPU."""
    from repro_torch.configs import ARCHS

    decode_step_vs_cpu(dataclasses.replace(ARCHS[ARCH], dtype="float32"), "fp32")


def models_on_both(cfg, seed: int) -> tuple:
    """``cfg``'s model on the CPU and on the card, and the weights of one draw
    from ``seed`` on each (``weights_on_both``)."""
    from repro_torch.models import build_model

    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    return (cpu, gpu, *weights_on_both(gpu, seed))


def decode_step_vs_cpu(cfg, label: str, models: tuple | None = None) -> None:
    """One ``decode_step`` of the dense ``cfg`` at index 100 of a random cache of
    CACHE_LEN slots, on the card against the same weights and cache on the CPU:
    the logits and the cache within 2e-3, the same argmax.  ``models`` (as
    ``models_on_both`` gives them) saves a draw; by default seed 0's."""
    from repro_torch.models import params as PM

    cpu, gpu, p_cpu, p_gpu = models or models_on_both(cfg, 0)
    gen = torch.Generator().manual_seed(0)
    B, index = SERVE["requests"], 100
    c_cpu = PM.tree_map(lambda t: torch.randn(t.shape, generator=gen),
                        cpu.cache_layout(B, CACHE_LEN))
    c_gpu = PM.tree_map(lambda t: t.to("cuda"), c_cpu)
    toks = torch.randint(0, cfg.vocab, (B, 1), generator=gen)
    want, _ = cpu.decode_step(p_cpu, {"tokens": toks, "cache": c_cpu, "index": index})
    got, _ = gpu.decode_step(p_gpu, {"tokens": toks.cuda(), "cache": c_gpu, "index": index})
    got = got.cpu()
    if got.shape != (B, 1, cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"logits of shape {tuple(got.shape)} or not finite")
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError("greedy tokens differ between the card and the CPU")
    for name in ("k", "v"):
        torch.testing.assert_close(c_gpu["layers"][name].cpu(), c_cpu["layers"][name],
                                   rtol=2e-3, atol=2e-3)
    err = float((got - want).abs().max())
    print(f"[full-width] {cfg.arch} {label} decode_step B={B} index={index}: max |logit diff| "
          f"{err:.3e}, argmax equal")


def weights_on_both(gpu, seed: int):
    """(CPU parameters, card parameters) of one draw from ``seed``: drawn on the
    card, where a full-width model's billion draws take milliseconds (seconds
    on the host), and copied to the CPU."""
    from repro_torch.models import params as PM

    p_gpu = gpu.init_params(torch.Generator(device="cuda").manual_seed(seed))
    return PM.tree_map(lambda t: t.cpu(), p_gpu), p_gpu


def _grad_tensors(model, params, batch) -> list:
    """``[loss, *every gradient leaf]`` of ``model.loss`` at ``params``, as tensors."""
    from repro_torch.models import params as PM

    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(leaves, batch)
    return [loss.detach(), *torch.autograd.grad(loss, PM.tree_leaves(leaves))]


def _loss_and_grads(model, params, batch):
    loss, *grads = _grad_tensors(model, params, batch)
    return float(loss), grads


def phase_full_width_grad() -> None:
    """qwen1.5-0.5b at full width in fp32, cut to 2 layers: loss and every
    gradient leaf on the card against the CPU.  Batch (2, 200): no tile
    divides 200, so the kernels' ragged tails run."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models import params as PM

    cfg = dataclasses.replace(ARCHS[ARCH], dtype="float32", n_layers=2)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(1)
    p_cpu, p_gpu = weights_on_both(gpu, 1)
    toks = torch.randint(0, cfg.vocab, (2, 201), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, g_cpu = _loss_and_grads(cpu, p_cpu, batch)
    got, g_gpu = _loss_and_grads(gpu, p_gpu, {k: t.cuda() for k, t in batch.items()})
    if not (math.isfinite(got) and abs(got - want) <= 2e-3):
        raise AssertionError(f"{cfg.n_layers}-layer fp32 loss: card {got} cpu {want}")
    worst = 0.0
    for a, b in zip(g_gpu, g_cpu):
        scale = float(b.abs().max())
        diff = float((a.cpu() - b).abs().max())
        if not diff <= 2e-3 * scale:
            raise AssertionError(f"gradient leaf {tuple(b.shape)}: max diff {diff} > "
                                 f"2e-3 x {scale}")
        worst = max(worst, diff / scale)
    print(f"[full-width] fp32 {cfg.n_layers}-layer loss card {got:.6f} cpu {want:.6f}; "
          f"{len(g_cpu)} "
          f"gradient leaves, worst max |diff| / max |grad| {worst:.3e}")


def embeddings(cfg, B: int, frames: int, gen, device="cpu", dtype=torch.float32) -> dict:
    """The batch entry a VLM's or an encoder-decoder's ``loss`` and ``prefill``
    take beside the tokens, drawn from ``gen``: ``img_emb`` (B,
    n_image_tokens, d_model) or ``enc_emb`` (B, ``frames``, d_model); none
    for the other families."""
    if cfg.vlm is not None:
        shape = (B, cfg.vlm.n_image_tokens, cfg.d_model)
    elif cfg.encdec is not None:
        shape = (B, frames, cfg.d_model)
    else:
        return {}
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return {"img_emb" if cfg.vlm is not None else "enc_emb": x.to(device=device, dtype=dtype)}


def full_width_vs_cpu(cfg, seed: int, seq: int, label: str, *, frames: int = 0,
                      models: tuple | None = None) -> None:
    """``loss``, every gradient leaf and ``prefill`` of ``cfg`` (fp32) on a (1,
    ``seq``) batch on the card against the same weights on the CPU: the loss
    within 2e-3, each leaf within 2e-3 of its largest entry, the logits within
    2e-3 (absolute and relative), the same argmax.  A VLM's batch holds its
    image embeddings, an encoder-decoder's ``frames`` frame embeddings
    (``embeddings``).  ``models`` (as ``models_on_both`` gives them) saves a
    draw; by default ``seed``'s."""
    cpu, gpu, p_cpu, p_gpu = models or models_on_both(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (1, seq + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], **embeddings(cfg, 1, frames, gen)}
    on_card = {k: t.cuda() for k, t in batch.items()}
    want, g_cpu = _loss_and_grads(cpu, p_cpu, batch)
    got, g_gpu = _loss_and_grads(gpu, p_gpu, on_card)
    if not (math.isfinite(got) and abs(got - want) <= 2e-3):
        raise AssertionError(f"{label} loss: card {got} cpu {want}")
    worst = max(rel_err(a.cpu(), b, 2e-3)[1] for a, b in zip(g_gpu, g_cpu))
    l_cpu = cpu.prefill(p_cpu, {k: t for k, t in batch.items() if k != "labels"})
    l_gpu = gpu.prefill(p_gpu, {k: t for k, t in on_card.items() if k != "labels"}).cpu()
    if l_gpu.shape != (1, 1, cfg.vocab) or not torch.isfinite(l_gpu).all():
        raise AssertionError(f"prefill logits of shape {tuple(l_gpu.shape)} or not finite")
    torch.testing.assert_close(l_gpu, l_cpu, rtol=2e-3, atol=2e-3)
    _, logit_rel = rel_err(l_gpu, l_cpu, 2e-3)
    if not torch.equal(l_gpu.argmax(-1), l_cpu.argmax(-1)):
        raise AssertionError("prefill argmax differs between the card and the CPU")
    print(f"[full-width] {label} loss card {got:.6f} cpu {want:.6f}; {len(g_cpu)} gradient "
          f"leaves, worst max |diff| / max |grad| {worst:.3e}; prefill max |logit diff| / max "
          f"|logit| {logit_rel:.3e}, argmax equal")


def phase_xlstm_full_width() -> None:
    """xlstm-1.3b at full width in fp32, cut to 8 layers (one group: 7 mLSTM
    blocks and 1 sLSTM block), on a (1, 256) batch: two chunks of 128, so
    that the carried state is crossed."""
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[XLSTM], dtype="float32", n_layers=8)
    full_width_vs_cpu(cfg, 2, 256, "fp32 8-layer xLSTM")


def phase_hymba_full_width() -> None:
    """hymba-1.5b at full width in fp32 on a (1, 384) batch.  Cuts: 4 layers
    (global layers 0 and 3, so one run of 2 sliding-window blocks), and a
    window of 256 instead of 1024, so that the window bites at 384 + 128 meta
    positions (4 chunks of 128, so that the carried state is crossed); the
    CPU side then takes seconds."""
    from repro_torch.configs import ARCHS

    full = ARCHS[HYMBA]
    cfg = dataclasses.replace(full, dtype="float32", n_layers=4, hybrid=dataclasses.replace(
        full.hybrid, global_layers=(0, 3), sliding_window=256))
    full_width_vs_cpu(cfg, 3, 384, "fp32 4-layer Hymba")


def phase_qwen3_full_width() -> None:
    """qwen3-4b at full width in fp32, cut to 2 layers, one draw of weights:
    one ``decode_step`` against the CPU, then ``loss``, every gradient leaf and ``prefill`` on a
    (1, 200) batch (hd 128 and q_norm / k_norm on every head)."""
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[QWEN3], dtype="float32", n_layers=2)
    models = models_on_both(cfg, 4)
    decode_step_vs_cpu(cfg, "fp32 2-layer", models)
    full_width_vs_cpu(cfg, 4, 200, "fp32 2-layer qwen3-4b", models=models)


#: the phi configs' fp32 checks against the CPU: 1 layer (4 until the tensor-
#: parallel phase joined the script, then 2; their CPU side sets the time)
PHI_CHECK_LAYERS = 1


def phase_phi_full_width() -> None:
    """phi4-mini-3.8b and phi3-medium-14b at full width in fp32, cut to
    PHI_CHECK_LAYERS layers, as qwen3-4b's: one ``decode_step`` against the
    CPU (hd 128, groups of 3 and 4), then ``loss``, every gradient leaf and
    ``prefill`` on a (1, 200) batch; each model freed before the next."""
    from repro_torch.configs import ARCHS

    n = PHI_CHECK_LAYERS
    for arch, seed in ((PHI4, 5), (PHI3, 6)):
        cfg = dataclasses.replace(ARCHS[arch], dtype="float32", n_layers=n)
        models = models_on_both(cfg, seed)
        decode_step_vs_cpu(cfg, f"fp32 {n}-layer", models)
        full_width_vs_cpu(cfg, seed, 200, f"fp32 {n}-layer {arch}", models=models)
        del models
        gc.collect()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_routes():
    """Record the decisions of every ``layers.moe_route`` call (``moe_block``
    routes through it), in call order."""
    from repro_torch.models import layers

    seen = []
    route = layers.moe_route

    def call(*args, **kwargs):
        seen.append(route(*args, **kwargs))
        return seen[-1]

    layers.moe_route = call
    try:
        yield seen
    finally:
        layers.moe_route = route


@contextlib.contextmanager
def replayed_routes(choices: list):
    """Route every ``layers.moe_route`` call through the next of ``choices``
    (each an (N, k) expert choice, in call order): the experts another device
    chose, this device's probabilities for them."""
    from repro_torch.models import layers

    route = layers.moe_route
    pending = list(choices)

    def call(*args, **kwargs):
        return route(*args, **kwargs, choice=pending.pop(0))

    layers.moe_route = call
    try:
        yield pending
    finally:
        layers.moe_route = route


def on_both_routed(on_cpu, on_card, label: str):
    """``(on_cpu(), on_card(), near-ties)``: both runs with every MoE layer's
    routing recorded and compared (``routing_differences``).  Where the
    routing parts ways at a near-tie, the CPU runs again with the card's
    expert choice replayed through ``moe_route`` (``replayed_routes``), so
    what follows is compared on the same routing; the near-ties are printed
    and returned."""
    with recorded_routes() as seen:
        want = on_cpu()
        n_cpu = len(seen)
        got = on_card()
    ties = routing_differences(seen[:n_cpu], seen[n_cpu:])
    if ties:
        print(f"[full-width] {label}: routing parts ways at near-ties {ties}; the CPU runs "
              "again with the card's experts")
        with replayed_routes([r.idx.cpu() for r in seen[n_cpu:]]) as left:
            want = on_cpu()
        if left:
            raise AssertionError(f"{label}: {len(left)} of the card's routes not replayed")
    return want, got, ties


def moe_full_width_vs_cpu(cfg, seed: int, seq: int, label: str) -> list:
    """``full_width_vs_cpu`` for a model with routed experts: ``loss``, every
    gradient leaf and ``prefill`` of ``cfg`` (fp32) on a (1, ``seq``) batch on
    the card against the same weights on the CPU, each within 2e-3 (of its
    largest entry for the gradients), the routing of every MoE layer compared
    first (``on_both_routed``).  Returns the near-ties."""
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    p_cpu, p_gpu = weights_on_both(gpu, seed)
    toks = torch.randint(0, cfg.vocab, (1, seq + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    on_card = {k: t.cuda() for k, t in batch.items()}
    (want, g_cpu), (got, g_gpu), ties = on_both_routed(
        lambda: _loss_and_grads(cpu, p_cpu, batch), lambda: _loss_and_grads(gpu, p_gpu, on_card),
        f"{label} loss")
    if not (math.isfinite(got) and abs(got - want) <= 2e-3):
        raise AssertionError(f"{label} loss: card {got} cpu {want}")
    worst = max(rel_err(a.cpu(), b, 2e-3)[1] for a, b in zip(g_gpu, g_cpu))
    with torch.no_grad():
        l_cpu, l_gpu, pre_ties = on_both_routed(
            lambda: cpu.prefill(p_cpu, {"tokens": batch["tokens"]}),
            lambda: gpu.prefill(p_gpu, {"tokens": on_card["tokens"]}).cpu(), f"{label} prefill")
    if l_gpu.shape != (1, 1, cfg.vocab) or not torch.isfinite(l_gpu).all():
        raise AssertionError(f"prefill logits of shape {tuple(l_gpu.shape)} or not finite")
    torch.testing.assert_close(l_gpu, l_cpu, rtol=2e-3, atol=2e-3)
    _, logit_rel = rel_err(l_gpu, l_cpu, 2e-3)
    if not torch.equal(l_gpu.argmax(-1), l_cpu.argmax(-1)):
        raise AssertionError(f"{label} prefill argmax differs between the card and the CPU")
    ties = [{"run": "loss", **t} for t in ties] + [{"run": "prefill", **t} for t in pre_ties]
    print(f"[full-width] {label} loss card {got:.6f} cpu {want:.6f}; {len(g_cpu)} gradient "
          f"leaves, worst max |diff| / max |grad| {worst:.3e}; prefill max |logit diff| / max "
          f"|logit| {logit_rel:.3e}, argmax equal; {cfg.n_layers - (cfg.moe.first_dense or 0)} "
          f"MoE layers' routing compared in each, {len(ties)} near-ties; "
          f"{time.perf_counter() - t0:.1f} s")
    return ties


def phase_moe_full_width() -> dict:
    """deepseek-v2-lite-16b at full width in fp32, cut to 2 layers (layer0 and 1
    MoE layer; 3 until the tensor-parallel phase joined the script), and mixtral-8x7b cut to 1 layer (2 until the tensor-parallel
    phase joined the script) and a window of 64 (so that it bites at 256
    positions), each on a (1, 256) batch: ``loss``, every gradient leaf and
    ``prefill`` against the CPU.  Returns the near-ties."""
    from repro_torch.configs import ARCHS

    ties = {"deepseek_loss_prefill": moe_full_width_vs_cpu(
        dataclasses.replace(ARCHS[DEEPSEEK], dtype="float32", n_layers=2), 11, 256,
        "fp32 2-layer deepseek")}
    gc.collect()
    torch.cuda.empty_cache()
    ties["mixtral_loss_prefill"] = moe_full_width_vs_cpu(
        dataclasses.replace(ARCHS[MIXTRAL], dtype="float32", n_layers=1, sliding_window=64),
        12, 256, "fp32 1-layer mixtral, window 64")
    gc.collect()
    torch.cuda.empty_cache()
    return ties


def routing_differences(on_cpu: list, on_card: list) -> list:
    """Compare one decode step's routing on the CPU and on the card, MoE layer by
    layer: each token's set of experts, then which of them kept a slot (the
    slots follow from these).  At the first layer where the sets differ, every
    expert in or out of a token's set on one device only must lie, on both
    devices, within ``NEAR_TIE`` of the token's k-th router probability (so
    the k-th and (k+1)-th do too), else raise; that layer's near-ties are
    returned, each with the gap of its k-th and (k+1)-th probabilities on
    both devices, and the later layers, whose inputs then differ, are not
    compared.  [] when the routing agrees everywhere."""
    if len(on_cpu) != len(on_card):
        raise AssertionError(f"{len(on_cpu)} routed layers on the CPU, {len(on_card)} on the card")
    for layer, (a, b) in enumerate(zip(on_cpu, on_card)):
        idx = [r.idx.cpu() for r in (a, b)]
        differ = (idx[0].sort(-1).values != idx[1].sort(-1).values).any(-1)
        if not differ.any():
            kept = [(i * 2 + r.keep.cpu()).sort(-1).values for i, r in zip(idx, (a, b))]
            if not torch.equal(*kept):
                raise AssertionError(f"routed layer {layer}: the same experts, other drops")
            continue
        k = idx[0].shape[1]
        ties = []
        for t in differ.nonzero().flatten().tolist():
            swapped = set(idx[0][t].tolist()) ^ set(idx[1][t].tolist())
            off, gaps = [], []
            for r in (a, b):
                p = r.probs[t].cpu()
                top = p.sort(descending=True).values
                off.append(max(float((p[e] - top[k - 1]).abs()) for e in swapped))
                gaps.append(float(top[k - 1] - top[k]))
            if not max(off) <= NEAR_TIE:
                raise AssertionError(
                    f"routed layer {layer}, token {t}: experts {idx[0][t].tolist()} on the CPU, "
                    f"{idx[1][t].tolist()} on the card, {max(off)} from the k-th probability "
                    "(not a near-tie)")
            ties.append({"layer": layer, "token": t, "gap_cpu": gaps[0], "gap_card": gaps[1]})
        return ties
    return []


def decode_steps_vs_cpu(cfg, seed: int, B: int, cache_len: int, start: int, steps: int,
                        label: str, *, random_cache: bool):
    """``steps`` decode steps of ``cfg`` (fp32) from index ``start``, on the card
    and on the CPU with the same weights and the same cache (random, or the
    model's zeros): the logits within 2e-3 at every step, the same argmax,
    and every cache leaf at the end within 2e-3 of its largest entry.  With
    routed experts, the routing of every MoE layer and step is compared
    first (``routing_differences``): a step whose routing parts ways at a
    near-tie is printed and counted, its logits are not compared, and the
    CPU takes the card's cache after it.  Returns the card's model,
    parameters, the tokens fed, its last logits and the near-ties."""
    from repro_torch.models import build_model
    from repro_torch.models import params as PM

    t0 = time.perf_counter()
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    p_cpu, p_gpu = weights_on_both(gpu, seed)
    c_cpu = (PM.tree_map(lambda i: torch.randn(i.shape, generator=gen),
                         cpu.cache_layout(B, cache_len))
             if random_cache else cpu.init_cache(B, cache_len))
    c_gpu = PM.tree_map(lambda t: t.to("cuda"), c_cpu)
    toks = torch.randint(0, cfg.vocab, (B, steps), generator=gen)
    worst, near_ties, routed = 0.0, [], 0
    for t in range(steps):
        batch = {"tokens": toks[:, t:t + 1], "cache": c_cpu, "index": start + t}
        with recorded_routes() as routes:
            want, _ = cpu.decode_step(p_cpu, batch)
            n_cpu = len(routes)
            got, _ = gpu.decode_step(p_gpu, {**batch, "tokens": toks[:, t:t + 1].cuda(),
                                             "cache": c_gpu})
        got_cpu = got.cpu()
        if got.shape != (B, 1, cfg.vocab) or not torch.isfinite(got_cpu).all():
            raise AssertionError(f"{label}: logits of shape {tuple(got.shape)} or not finite")
        routed += n_cpu
        ties = routing_differences(routes[:n_cpu], routes[n_cpu:])
        if ties:
            print(f"[full-width] {label} step {t}: routing parts ways at near-ties {ties}")
            near_ties += [{"step": t, **tie} for tie in ties]
            for a, b in zip(PM.tree_leaves(c_cpu), PM.tree_leaves(c_gpu)):
                a.copy_(b.cpu())
            continue
        torch.testing.assert_close(got_cpu, want, rtol=2e-3, atol=2e-3)
        if not torch.equal(got_cpu.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"{label} step {t}: greedy tokens differ from the CPU's")
        worst = max(worst, float((got_cpu - want).abs().max()))
    leaf_rel = max(rel_err(a.cpu(), b, 2e-3)[1]
                   for a, b in zip(PM.tree_leaves(c_gpu), PM.tree_leaves(c_cpu)))
    routing = (f"; routing of {routed} MoE layer calls compared, {len(near_ties)} near-ties"
               if cfg.moe else "")
    print(f"[full-width] {label}: {steps} decode steps from index {start}, max |logit diff| "
          f"{worst:.3e}, argmax equal; cache leaves max |diff| / max |leaf| {leaf_rel:.3e}"
          f"{routing}; {time.perf_counter() - t0:.1f} s")
    return gpu, p_gpu, toks, got, near_ties


def phase_hymba_decode_full_width() -> None:
    """hymba-1.5b at full width in fp32, cut to 4 layers (global layers 0 and 3)
    and a window of 64: 64 decode steps (96 until the tensor-parallel phase
    joined the script) of 2 requests from index 128 (the meta
    offset) on a random cache of 192 slots, so the ring of 64 slots wraps."""
    from repro_torch.configs import ARCHS

    full = ARCHS[HYMBA]
    cfg = dataclasses.replace(full, dtype="float32", n_layers=4, hybrid=dataclasses.replace(
        full.hybrid, global_layers=(0, 3), sliding_window=64))
    start = full.hybrid.meta_tokens
    decode_steps_vs_cpu(cfg, 5, 2, start + 64, start, 64, "fp32 4-layer Hymba",
                        random_cache=True)


def phase_xlstm_decode_full_width() -> None:
    """xlstm-1.3b at full width in fp32, cut to 8 layers: 32 decode steps of 2
    requests from the zero state against the CPU, and the last step's logits
    within 2e-3 of the card's ``prefill`` of the same 32 tokens."""
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[XLSTM], dtype="float32", n_layers=8)
    gpu, params, toks, last, _ = decode_steps_vs_cpu(cfg, 6, 2, 32, 0, 32, "fp32 8-layer xLSTM",
                                                     random_cache=False)
    pre = gpu.prefill(params, {"tokens": toks.cuda()})
    torch.testing.assert_close(last, pre, rtol=2e-3, atol=2e-3)
    print(f"[full-width] fp32 8-layer xLSTM: decode after 32 tokens within "
          f"{float((last - pre).abs().max()):.3e} of the card's prefill")


def phase_deepseek_decode_full_width() -> dict:
    """deepseek-v2-lite-16b at full width in fp32, cut to 2 layers (layer0 and 1
    MoE layer; 3 until the tensor-parallel phase joined the script): 16 decode steps of 8 requests from a zero cache at index 0,
    and 16 from a random latent cache at index 100; the routing of every MoE
    layer and step against the CPU.  Returns the near-ties of each."""
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[DEEPSEEK], dtype="float32", n_layers=2)
    zero = decode_steps_vs_cpu(cfg, 8, SERVE["requests"], CACHE_LEN, 0, 16,
                               "fp32 2-layer deepseek, zero cache", random_cache=False)[-1]
    rand = decode_steps_vs_cpu(cfg, 9, SERVE["requests"], CACHE_LEN, 100, 16,
                               "fp32 2-layer deepseek, random latent cache",
                               random_cache=True)[-1]
    return {"deepseek_zero_cache": zero, "deepseek_random_cache": rand}


def phase_mixtral_decode_full_width() -> dict:
    """mixtral-8x7b at full width in fp32, cut to 1 layer and a window of 64:
    16 decode steps of 8 requests from index 116 on a random cache, across
    the end of the ring of 64 slots (decode attention at G 4, hd 128); the
    routing of every step against the CPU.  Returns the near-ties.  Cut from
    96 steps and 2 layers, then 32 steps from index 100, to keep the script's
    time."""
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[MIXTRAL], dtype="float32", n_layers=1, sliding_window=64)
    ties = decode_steps_vs_cpu(cfg, 10, SERVE["requests"], CACHE_LEN, 116, 16,
                               "fp32 1-layer mixtral, window 64", random_cache=True)[-1]
    return {"mixtral_ring": ties}


def phase_internvl2_full_width() -> None:
    """internvl2-2b at full width in fp32, cut to 2 layers: ``loss``, every
    gradient leaf and the image-prefixed ``prefill`` on 256 image and 200
    text positions against the CPU (its vocabulary of 92553 is no multiple
    of 8: only ``@`` and the embedding gather touch ``lm_head`` and ``embed``)."""
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS[INTERNVL], dtype="float32", n_layers=2)
    full_width_vs_cpu(cfg, 15, 200, "fp32 2-layer internvl2-2b")


def whisper_cut() -> "object":
    """whisper-large-v3 in fp32 at full width, cut to 1 encoder and 1 decoder layer
    (2 and 2 until the tensor-parallel phase joined the script)."""
    from repro_torch.configs import ARCHS

    full = ARCHS[WHISPER]
    return dataclasses.replace(full, dtype="float32", n_layers=1, encdec=dataclasses.replace(
        full.encdec, n_encoder_layers=1))


def fill_cross_cache(model, params, cache, enc_out) -> None:
    """Write every decoder layer's cross K and V of ``enc_out`` into ``cache``
    through the model's own ``_qkv``, as ``prefill``'s cross attention forms
    them (a harness step: the package has no such API, JAX neither)."""
    from repro_torch.models import params as PM

    with torch.no_grad():
        for i, p in enumerate(PM.unstack(params["dec_layers"])):
            _, k, v = model._qkv(p["cross_attn"], enc_out, enc_out)
            cache["layers"]["cross_k"][i].copy_(k)
            cache["layers"]["cross_v"][i].copy_(v)


def phase_whisper_full_width() -> None:
    """whisper-large-v3 at full width in fp32, cut to 1 + 1 layers, on its 30 s
    window: ``loss``, every gradient leaf and ``prefill`` on 1 x (1500
    frames, 448 tokens) against the CPU; then ``encode`` of 2 requests' 1500
    frames within 2e-3 of the CPU's (of its largest entry), each device's
    cross cache filled from its own encoder output, and 8 ``decode_step``s
    on both: the logits within 2e-3 at every step, the same argmax, every
    cache leaf within 2e-3 of its largest entry."""
    from repro_torch.models import build_model
    from repro_torch.models import params as PM

    t0 = time.perf_counter()
    cfg = whisper_cut()
    full_width_vs_cpu(cfg, 16, WHISPER_TOKENS, "fp32 1+1-layer whisper", frames=WHISPER_FRAMES)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(17)
    p_cpu, p_gpu = weights_on_both(gpu, 17)
    B, steps = 2, 8
    enc = embeddings(cfg, B, WHISPER_FRAMES, gen)["enc_emb"]
    with torch.no_grad():
        e_cpu, e_gpu = cpu.encode(p_cpu, enc), gpu.encode(p_gpu, enc.cuda())
    _, enc_rel = rel_err(e_gpu.cpu(), e_cpu, 2e-3)
    c_cpu, c_gpu = cpu.init_cache(B, 16, WHISPER_FRAMES), gpu.init_cache(B, 16, WHISPER_FRAMES)
    fill_cross_cache(cpu, p_cpu, c_cpu, e_cpu)
    fill_cross_cache(gpu, p_gpu, c_gpu, e_gpu)
    toks = torch.randint(0, cfg.vocab, (B, steps), generator=gen)
    worst = 0.0
    for t in range(steps):
        want, _ = cpu.decode_step(p_cpu, {"tokens": toks[:, t:t + 1], "cache": c_cpu, "index": t})
        got, _ = gpu.decode_step(p_gpu, {"tokens": toks[:, t:t + 1].cuda(), "cache": c_gpu,
                                         "index": t})
        got = got.cpu()
        if got.shape != (B, 1, cfg.vocab) or not torch.isfinite(got).all():
            raise AssertionError(f"whisper decode step {t}: logits {tuple(got.shape)} or not "
                                 "finite")
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError(f"whisper decode step {t}: greedy tokens differ from the CPU's")
        worst = max(worst, float((got - want).abs().max()))
    leaf_rel = max(rel_err(a.cpu(), b, 2e-3)[1]
                   for a, b in zip(PM.tree_leaves(c_gpu), PM.tree_leaves(c_cpu)))
    print(f"[full-width] fp32 1+1-layer whisper: encode of {B} x {WHISPER_FRAMES} frames within "
          f"{enc_rel:.3e} of its largest entry; {steps} decode steps over the filled cross cache, "
          f"max |logit diff| {worst:.3e}, argmax equal; cache leaves {leaf_rel:.3e}; "
          f"{time.perf_counter() - t0:.1f} s")


def mla_prefill_small_vs_cpu() -> None:
    """deepseek-v2-lite-16b's smoke config (q and k of 48, v of 32) in fp32:
    ``prefill`` on the card, through the flash kernel (``simt``), equal to
    the CPU's with the same weights, within 1e-4 (routing compared first)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models import build_model

    cfg = dataclasses.replace(ARCHS[DEEPSEEK].smoke(), dtype="float32")
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    p_cpu, p_gpu = weights_on_both(gpu, 13)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(13))
    before = dict(kf.route_launches)
    with torch.no_grad():
        want, got, ties = on_both_routed(
            lambda: cpu.prefill(p_cpu, {"tokens": toks}),
            lambda: gpu.prefill(p_gpu, {"tokens": toks.cuda()}).cpu(), "small fp32 MLA prefill")
    took = {r: n - before[r] for r, n in kf.route_launches.items() if n != before[r]}
    if took != {"simt": cfg.n_layers}:
        raise AssertionError(f"small fp32 MLA prefill: flash launches by route {took}")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    print(f"[serve] {DEEPSEEK} small fp32 prefill on the card (flash {took}) within "
          f"{float((got - want).abs().max()):.3e} of the CPU's; {len(ties)} near-ties")


def serve_small_vs_cpu(arch: str) -> None:
    """``arch``'s smoke config in fp32 through ``launch.serve.main`` (4 prompts
    of 16 tokens, 8 new), on the card and on the CPU: one seed names one
    model on both, so the greedy tokens must be equal."""
    from repro_torch.launch import serve

    small = ["--arch", arch, "--requests", "4", "--prompt-len", "16", "--new-tokens", "8",
             "--dtype", "float32"]
    on_cpu = serve.main(small + ["--device", "cpu"])["tokens"]
    on_gpu = serve.main(small + ["--device", "cuda"])["tokens"]
    if not (on_cpu == on_gpu).all():
        raise AssertionError(f"small fp32 {arch} serve: card {on_gpu.tolist()} != cpu "
                             f"{on_cpu.tolist()}")
    print(f"[serve] small fp32 {arch} serve: card tokens equal the CPU's")


def serve_run(kernel_modules, run: str) -> dict:
    """One of ``SERVE_RUNS`` in bf16 at full config through
    ``launch.serve.main``, with the launch counts set to 0 just before and
    checked just after (launches per decode step times the steps, the routes
    of ``SERVE_ROUTES``), every kernel launched at a shape its checks cover
    (``launched_shapes``), no valid_len tensor made by the decode-attention
    wrapper, the tokens in the config's vocabulary, and the run's peak device
    memory."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.launch import serve

    arch, requests, prompt_len, new_tokens, per_step = SERVE_RUNS[run]
    # the model hands every layer one int32 (B,) valid_len made once a step: the
    # wrapper then never makes one (no allocation, no fill launch a layer)
    made = []
    vector = kd.valid_len_vector
    kd.valid_len_vector = lambda *a: made.append(a[1:]) or vector(*a)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernel_modules)
    t0 = time.perf_counter()
    try:
        with launched_shapes() as shapes:
            res = serve.main(["--arch", arch, "--full-config", "--device", "cuda",
                              "--dtype", "bfloat16", "--requests", str(requests),
                              "--prompt-len", str(prompt_len), "--new-tokens", str(new_tokens),
                              "--init-on", "device"])
    finally:
        kd.valid_len_vector = vector
    seconds = time.perf_counter() - t0
    counts, routes = read_counts(kernel_modules)
    peak = torch.cuda.max_memory_allocated()
    check_launched(shapes, run)
    for module, n in counts.items():
        if n != per_step.get(module, 0) * res["steps"]:
            raise AssertionError(f"{module}: {n} launches in the {run} run, expected "
                                 f"{per_step.get(module, 0)} x {res['steps']} steps")
    check_routes(routes, counts, SERVE_ROUTES, run)
    if made:
        raise AssertionError(f"decode_attention made {len(made)} valid_len tensors in the "
                             f"{run} run; the model passes one a step")
    toks, vocab = res["tokens"], ARCHS[arch].vocab
    if toks.shape != (requests, new_tokens):
        raise AssertionError(f"{run}: served tokens of shape {toks.shape}")
    if toks.min() < 0 or toks.max() >= vocab:
        raise AssertionError(f"{run}: served tokens outside the vocabulary of {vocab}")
    print(f"[{run}] {arch}: launches {counts}, by route {routes}; {res['tokens_per_s']:.1f} "
          f"tok/s, {res['ms_per_step']:.3f} ms per decode step, peak {peak / 2**30:.3f} GiB; "
          f"{seconds:.1f} s with the weight draws on the card")
    return {"arch": arch, "requests": requests, "prompt_len": prompt_len,
            "new_tokens": new_tokens, "counts": counts, "routes": routes,
            "shapes": {k: sorted(v) for k, v in shapes.items()}, "steps": res["steps"],
            "tokens_per_s": res["tokens_per_s"], "ms_per_step": res["ms_per_step"],
            "peak_memory_bytes": peak, "seconds": seconds}


#: decode after ``encode`` against ``prefill`` in bf16: the last logits within this
#: share of the largest prefill logit (the bf16 gradient tolerance, GRAD_TOL, for
#: a chain of 32 layers of kernels that round in other places: decode attention
#: keeps P in fp32, the flash tensor-core route rounds it to bf16)
BF16_LOGIT_TOL = 5e-2


def card_model(arch: str):
    """(model, parameters) of ``arch`` at full config in bf16, the weights of
    seed 0 drawn on the card."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model

    model = build_model(ARCHS[arch], device="cuda")
    return model, model.init_params(torch.Generator(device="cuda").manual_seed(0))


def counted(kernel_modules, fn):
    """``(fn(), launches by module, launches by route, seconds)``: the counts set
    to 0 just before and read just after, the card synchronized around ``fn``."""
    reset_counts(kernel_modules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (out, *read_counts(kernel_modules), seconds)


def expect_counts(counts: dict, want: dict, what: str) -> None:
    for module, n in counts.items():
        if n != want.get(module, 0):
            raise AssertionError(f"{what}: {module} launched {n} times, expected "
                                 f"{want.get(module, 0)}")


def internvl2_prefill(kernel_modules) -> dict:
    """internvl2-2b in bf16 at full width and depth: ``prefill`` of 2 requests of
    128 tokens behind 256 image positions (2 x 384) through the flash kernel,
    with one prefill's launches counted (flash on the tensor cores), every
    shape checked; its logits finite, and other image embeddings moving
    them."""
    model, params = card_model(INTERNVL)
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 128), generator=gen, device="cuda")
    img = embeddings(cfg, 2, 0, gen, "cuda", model.dtype)["img_emb"]
    with launched_shapes() as shapes:
        logits, counts, routes, seconds = counted(
            kernel_modules, lambda: model.prefill(params, {"tokens": toks, "img_emb": img}))
        other = model.prefill(params, {"tokens": toks, "img_emb": img + 1})
    check_launched(shapes, "internvl2 prefill")
    expect_counts(counts, {"flash_attention": 24, "rmsnorm": 49, "swiglu": 24},
                  "internvl2 prefill")
    check_routes(routes, counts, {"flash_attention": "wgmma"}, "internvl2 prefill")
    if logits.shape != (2, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"internvl2 prefill logits {tuple(logits.shape)} or not finite")
    moved = float((other - logits).abs().max())
    if not moved > 0:
        raise AssertionError("internvl2 prefill: other image embeddings left the logits as "
                             "they were")
    print(f"[serve_internvl2] image-prefixed prefill 2 x (256 + 128) bf16: launches {counts}; "
          f"{seconds * 1e3:.1f} ms; other images move the logits by up to {moved:.3f}")
    return {"prefill_shape": "2 x (256 image + 128 text) positions", "prefill_counts": counts,
            "prefill_ms": seconds * 1e3, "prefill_image_moves_logits_by": moved}


def whisper_encoded_decode(kernel_modules) -> dict:
    """whisper-large-v3 in bf16 at full width and depth, outside the engine:
    ``encode`` of 8 requests' 1500 frames (32 flash launches on the tensor
    cores), the cross cache filled from it (``fill_cross_cache``), 32
    ``decode_step``s over it (64 decode-attention launches a step, all on
    ``split``, the wrapper making no valid_len tensor), then ``prefill`` of the
    same 32 tokens over the same frames (96 flash launches): the last decode
    logits within BF16_LOGIT_TOL of the largest prefill logit.  Every shape
    checked; the times of each part."""
    from repro_torch.kernels import decode_attention as kd

    model, params = card_model(WHISPER)
    cfg = model.cfg
    B, steps = SERVE["requests"], SERVE["new_tokens"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    enc_emb = embeddings(cfg, B, WHISPER_FRAMES, gen, "cuda", model.dtype)["enc_emb"]
    toks = torch.randint(0, cfg.vocab, (B, steps), generator=gen, device="cuda")
    cache = model.init_cache(B, CACHE_LEN, WHISPER_FRAMES)
    made = []
    vector = kd.valid_len_vector
    kd.valid_len_vector = lambda *a: made.append(a[1:]) or vector(*a)

    def decode():
        for t in range(steps):
            logits, _ = model.decode_step(params, {"tokens": toks[:, t:t + 1], "cache": cache,
                                                   "index": t})
        return logits

    try:
        with launched_shapes() as shapes, torch.no_grad():
            enc, enc_counts, enc_routes, enc_s = counted(
                kernel_modules, lambda: model.encode(params, enc_emb))
            fill_cross_cache(model, params, cache, enc)
            last, dec_counts, dec_routes, dec_s = counted(kernel_modules, decode)
            pre, pre_counts, pre_routes, pre_s = counted(
                kernel_modules, lambda: model.prefill(params, {"tokens": toks,
                                                               "enc_emb": enc_emb}))
    finally:
        kd.valid_len_vector = vector
    check_launched(shapes, "whisper encode and decode")
    expect_counts(enc_counts, {"flash_attention": 32}, "whisper encode")
    expect_counts(dec_counts, {"decode_attention": 2 * 32 * steps}, "whisper decode")
    expect_counts(pre_counts, {"flash_attention": 3 * 32}, "whisper prefill")
    check_routes(enc_routes, enc_counts, {"flash_attention": "wgmma"}, "whisper encode")
    check_routes(dec_routes, dec_counts, {"decode_attention": "split"}, "whisper decode")
    check_routes(pre_routes, pre_counts, {"flash_attention": "wgmma"}, "whisper prefill")
    if made:
        raise AssertionError(f"decode_attention made {len(made)} valid_len tensors in Whisper's "
                             "decode; the model passes two a step")
    if not (torch.isfinite(enc).all() and torch.isfinite(last).all()):
        raise AssertionError("whisper: encoder output or decode logits not finite")
    err, rel = rel_err(last, pre, BF16_LOGIT_TOL)
    agree = int((last.argmax(-1) == pre.argmax(-1)).sum())
    print(f"[serve_whisper] encode {B} x {WHISPER_FRAMES} frames {enc_s * 1e3:.1f} ms; "
          f"{steps} decode steps over the filled cross cache {dec_s / steps * 1e3:.3f} ms a step; "
          f"prefill {pre_s * 1e3:.1f} ms; last logits within {err:.4f} ({rel:.4f} of the largest) "
          f"of prefill's, argmax equal in {agree} of {B}")
    return {"encode_shape": f"{B} x {WHISPER_FRAMES} frames", "encode_ms": enc_s * 1e3,
            "encode_counts": enc_counts, "filled_decode_ms_per_step": dec_s / steps * 1e3,
            "filled_decode_counts": dec_counts, "prefill_ms": pre_s * 1e3,
            "decode_vs_prefill_max_abs_err": err, "decode_vs_prefill_rel_err": rel,
            "decode_vs_prefill_argmax_equal": agree}


def mlstm_decode_times(rate: float) -> dict:
    """Device ms of one plain mLSTM update (``models.xlstm.mlstm_decode``) at
    xlstm-1.3b's serving shape (8 requests, 4 heads, dqk 512, dv 1024, fp32
    state, bf16 q, k, v and gates, as the model hands them) by CUDA-graph replay over 6 states (384 MiB of C, so
    the L2 cache is cold as in the model's walk over its layers), its bound
    (C read and written once) and the 42 calls of a decode step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.xlstm import mlstm_decode

    cfg = ARCHS[XLSTM]
    model = build_model(cfg, device="cuda")
    B, H, dqk, dv = SERVE_RUNS["serve_xlstm"][1], model.H, model.dqk, model.dv
    gen = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    sets = [(randn(gen, (B, H, dqk), bf), randn(gen, (B, H, dqk), bf),
             randn(gen, (B, H, dv), bf), randn(gen, (B, H), bf),
             (-torch.rand((B, H), generator=gen)).to("cuda", bf),
             (torch.zeros((B, H, dqk, dv), device="cuda"), torch.zeros((B, H, dqk), device="cuda"),
              torch.zeros((B, H), device="cuda"))) for _ in range(6)]
    ms, how = graph_ms(mlstm_decode, sets)
    blocks = cfg.n_layers - cfg.n_layers // cfg.ssm.slstm_every
    b_ms, b_by = bound(2 * B * H * dqk * dv * 4, 4 * B * H * dqk * dv, torch.float32, rate)
    return {"mlstm_decode_shape": f"C ({B}, {H}, {dqk}, {dv}) fp32",
            "mlstm_decode_device_ms": ms, "mlstm_decode_device_ms_from": how,
            "mlstm_decode_bound_ms": b_ms, "mlstm_decode_bound_by": b_by,
            "mlstm_decode_calls_per_step": blocks,
            "mlstm_decode_device_ms_per_step": ms * blocks}


#: the smoke configs served in fp32 on the card and on the CPU, token for token
SMALL_SERVES = (ARCH, HYMBA, XLSTM, DEEPSEEK, MIXTRAL, INTERNVL, WHISPER)


def phase_serve(kernel_modules, rate: float, runs=tuple(SERVE_RUNS), small=SMALL_SERVES) -> dict:
    """deepseek's small fp32 prefill (MLA through the flash kernel) and the
    ``small`` fp32 serves against the CPU, then the ``runs`` of ``SERVE_RUNS``;
    xlstm-1.3b's also with the plain mLSTM update's device time,
    internvl2-2b's with its image-prefixed prefill, whisper-large-v3's with
    decoding after ``encode``."""
    if DEEPSEEK in small:
        mla_prefill_small_vs_cpu()
    for arch in small:
        serve_small_vs_cpu(arch)
    runs = {run: serve_run(kernel_modules, run) for run in runs}
    for run, extra in (("serve_internvl2", internvl2_prefill),
                       ("serve_whisper", whisper_encoded_decode)):
        if run in runs:
            gc.collect()
            torch.cuda.empty_cache()
            runs[run].update(extra(kernel_modules))
    if "serve_xlstm" not in runs:
        return runs
    runs["serve_xlstm"].update(mlstm_decode_times(rate))
    print(f"[serve_xlstm] plain mLSTM update: {runs['serve_xlstm']['mlstm_decode_device_ms']} "
          f"ms a call by graph replay, bound {runs['serve_xlstm']['mlstm_decode_bound_ms']}")
    return runs


def phase_train(kernel_modules) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    reset_counts(kernel_modules)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as data_root:
        res = train.main(["--full-config", "--device", "cuda", "--dtype", "bfloat16",
                          "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
                          "--steps", str(TRAIN["steps"]), "--ckpt-dir", ckpt_dir,
                          "--data-root", data_root])
        counts, routes = read_counts(kernel_modules)
        ckpt_bytes = sum(p.stat().st_size for p in Path(ckpt_dir).rglob("*") if p.is_file())
        corpus = check_train_corpus(res, data_root, ARCHS[ARCH].vocab)
    peak = torch.cuda.max_memory_allocated()
    if res["restarts"]:
        raise AssertionError(f"the train run restarted {res['restarts']} times")
    losses = res["losses"]
    if len(losses) != TRAIN["steps"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    for name, per_step in TRAIN_PER_STEP.items():
        if counts[name] != per_step * TRAIN["steps"]:
            raise AssertionError(f"{name}: {counts[name]} launches in the train run, expected "
                                 f"{per_step} x {TRAIN['steps']} steps")
    check_routes(routes, counts, TRAIN_ROUTES, "train")
    step_ms = statistics.median(res["step_ms"][1:])
    tokens_per_s = TRAIN_ROWS / (step_ms / 1e3)
    load_ms = statistics.median(res["load_ms"][1:])
    print(f"[train] launches {counts}, by route {routes}; losses {losses}; median step "
          f"{step_ms:.3f} ms over "
          f"steps 2-{TRAIN['steps']}, {tokens_per_s:.1f} tokens/s, peak "
          f"{peak / 2**30:.3f} GiB; final checkpoint {ckpt_bytes / 2**30:.3f} GiB in "
          f"{res['ckpt_seconds']:.2f} s; corpus {corpus['corpus_bytes']} B on disk in "
          f"{corpus['chunk_files']} chunk files, striped in {res['materialize_seconds']:.3f} s; "
          f"loader {load_ms:.3f} ms a step (median), {load_ms / step_ms:.4f} of the median step")

    # the compute plane: one counted step at the run's batch on fresh weights,
    # held to its meta count and roofline; Hoard's scenario at qwen's step
    cfg = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    params, opt = init_train_state(model, torch.Generator().manual_seed(0), opt_cfg)
    rng = np.random.default_rng(0)
    full = {name: torch.as_tensor(rng.integers(0, cfg.vocab, (TRAIN["batch"], TRAIN["seq"])))
            .cuda() for name in ("tokens", "labels")}
    dry = dryrun_check(model, params, opt, full, opt_cfg, "train", res["step_ms"], TRAIN["seq"])
    remat = remat_check(kernel_modules, params, full)
    del full
    scenario = scenario_check(step_ms / 1e3)

    # tests/test_train.py::test_loss_decreases_on_fixed_batch at full width
    batch = {name: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 64))).cuda()
             for name in ("tokens", "labels")}
    step = make_train_step(model, opt_cfg)
    fixed = []
    for _ in range(8):
        params, opt, metrics = step(params, opt, batch)
        fixed.append(float(metrics["loss"]))
    if not fixed[-1] < fixed[0] - 0.05:
        raise AssertionError(f"fixed-batch losses did not fall by 0.05: {fixed}")
    print(f"[train] fixed batch (4, 64), 8 steps: loss {fixed[0]:.4f} -> {fixed[-1]:.4f}")
    return {"counts": counts, "routes": routes, "steps": TRAIN["steps"], "batch": TRAIN["batch"],
            "seq": TRAIN["seq"], "losses": losses, "step_ms": res["step_ms"],
            "median_step_ms": step_ms, "tokens_per_s": tokens_per_s,
            "peak_memory_bytes": peak, "ckpt_bytes": ckpt_bytes,
            "ckpt_seconds": res["ckpt_seconds"], "fixed_batch_losses": fixed,
            "load_ms": res["load_ms"], "median_load_ms": load_ms,
            "load_share_of_step": load_ms / step_ms,
            "materialize_seconds": res["materialize_seconds"], **corpus,
            "dryrun": dry, "scenario": scenario, "remat": remat}


def remat_check(kernel_modules, params, batch) -> dict:
    """qwen1.5-0.5b's train cell (24 layers, bf16, ``batch``) under each of
    ``REMAT_POLICIES`` and then ``"none"`` again, from the same ``params``:
    after an untimed warm-up, one loss and every gradient, the launches
    counted (``train_launches`` at the policy, the backward's included), the
    host ms of the loss and its gradients (ending in a synchronize),
    ``max_memory_allocated`` above what was allocated before, and the step
    counter's peak of the same work on meta.  The loss and every gradient must
    be equal bit for bit across the policies: no kernel uses atomics.  A
    tensor that the two ``"none"`` runs already give in other bits (a library
    op not reproducible from call to call) is held to GRAD_TOL instead, and
    printed."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.roofline import count as C

    runs, out = {}, {}
    for policy in (*REMAT_POLICIES, "none_again"):
        cfg = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16",
                                  remat=policy.removesuffix("_again"))
        model = build_model(cfg, device="cuda")
        _grad_tensors(model, params, batch)          # a warm-up, untimed
        gc.collect()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runs[policy], counts, _, seconds = counted(
            kernel_modules, lambda: _grad_tensors(model, params, batch))
        peak = torch.cuda.max_memory_allocated() - start
        expect_counts(counts, train_launches(*QWEN_BLOCKS, remat=cfg.remat), f"remat {policy}")
        meta = build_model(cfg, device="meta")
        _, mc = C.count(lambda p, b: _grad_tensors(meta, p, b),
                        PM.abstract(meta.layout(), cfg.dtype),
                        {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                         for k, v in batch.items()})
        out[policy] = {"ms": seconds * 1e3, "peak_above_start_bytes": peak,
                       "meta_peak_above_start_bytes": mc["peak_above_start_bytes"],
                       "meta_matmul_flops": mc["matmul_flops"],
                       "calls": {k: v for k, v in counts.items() if v}}
        print(f"[remat] qwen train cell {tuple(batch['tokens'].shape)}, remat {policy}: loss "
              f"and gradients {seconds * 1e3:.3f} ms, peak {peak / 2**30:.3f} GiB above the "
              f"start (meta {mc['peak_above_start_bytes'] / 2**30:.3f}), launches "
              f"{out[policy]['calls']}")
    names = ["loss", *(f"grad {i}" for i in range(len(runs["none"]) - 1))]
    unreproducible = {}
    for policy in ("dots", "full"):
        for name, got, want, again in zip(names, runs[policy], runs["none"], runs["none_again"]):
            if torch.equal(got, want):
                continue
            if torch.equal(again, want):
                raise AssertionError(f"remat {policy}: {name} differs from none's, which two "
                                     "none runs give bit for bit")
            err = rel_err(got.float(), want.float(), GRAD_TOL[torch.bfloat16])
            unreproducible[f"{policy} {name}"] = err
    print(f"[remat] loss {float(runs['none'][0]):.6f} and {len(names) - 1} gradient leaves "
          f"equal bit for bit across {REMAT_POLICIES}"
          + (f" but for tensors that two none runs give in other bits, held to GRAD_TOL: "
             f"{unreproducible}" if unreproducible else ""))
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "not_reproducible_call_to_call": unreproducible}


def check_train_corpus(res: dict, data_root: str, vocab: int) -> dict:
    """The corpus a ``launch.train`` run striped under ``data_root``: every
    chunk file of its manifest on ``node0..node3``, each with the manifest's
    CRC and the seeded chunk's bytes, and every batch the run read equal to
    the seeded corpus's rows at its item ids (by CRC-32 of the token bytes)."""
    from repro_torch.data import TokenDatasetSpec, chunk_payload, read_items
    from repro_torch.launch import train

    root = Path(data_root)
    manifest = json.loads((root / "train-corpus.manifest.json").read_text())
    spec = TokenDatasetSpec("train-corpus", n_sequences=manifest["n_items"],
                            seq_len=TRAIN["seq"], vocab=vocab, seed=0)
    ipc = manifest["items_per_chunk"]
    if ipc != train.ITEMS_PER_CHUNK or manifest["node_ids"] != [0, 1, 2, 3]:
        raise AssertionError(f"corpus striped at {ipc} items a chunk over {manifest['node_ids']}")
    files = sorted(root.glob("node*/train-corpus/chunk_*"))
    want = {root / f"node{nid}" / "train-corpus" / f"chunk_{c:06d}"
            for c, nodes in enumerate(manifest["chunk_nodes"]) for nid in nodes}
    if set(files) != want or len(manifest["chunk_nodes"]) * ipc != spec.n_sequences:
        raise AssertionError(f"chunk files {len(files)} on disk, the manifest names {len(want)}")
    for f in files:
        c = int(f.name.split("_")[1])
        blob = f.read_bytes()
        if zlib.crc32(blob) != manifest["chunk_crc"][c] or \
                blob != chunk_payload(spec, c, ipc).tobytes():
            raise AssertionError(f"{f.relative_to(root)}: CRC or bytes differ from the manifest")
    if not len(res["batch_ids"]) == len(res["batch_crc32"]) == TRAIN["steps"]:
        raise AssertionError(f"{len(res['batch_ids'])} batches recorded, {TRAIN['steps']} steps")
    for step, (ids, crc) in enumerate(zip(res["batch_ids"], res["batch_crc32"])):
        if zlib.crc32(read_items(spec, ids, items_per_chunk=ipc).tobytes()) != crc:
            raise AssertionError(f"train step {step} read other rows than items {ids}")
    return {"corpus_bytes": sum(f.stat().st_size for f in files), "chunk_files": len(files)}


def corpus_batches(spec, batch: int, data_root: str):
    """``launch.train``'s batches over ``spec``: the corpus striped under
    ``data_root`` as the launcher stripes it, read back as node 0 through the
    stripe store by its ``TokenLoader``."""
    from repro_torch.data import TokenLoader
    from repro_torch.launch import train

    topo, store, _ = train.stripe_corpus(spec, data_root, items_per_chunk=train.ITEMS_PER_CHUNK)
    return iter(TokenLoader(store, spec, topo.nodes[0], batch=batch))


def train_full_depth(arch: str, shape: dict, per_step: dict, kernel_modules, tag: str,
                     want_routes: dict, dryrun: bool = True):
    """An architecture on the card.  First ``launch.train.main`` at its smoke
    config (seq 64, 2 steps, its checkpoint in a temporary directory under
    ``build/``), so the launcher's path runs on the card.  Then the full model
    in bf16 at full width and depth (``shape["layers"]`` cuts the depth where
    given), ``shape``'s batch x seq from the launcher's corpus striped under
    ``build/`` and read through the stripe store (``corpus_batches``), AdamW
    as the launcher sets it, parameters drawn on a CUDA generator,
    ``shape``'s steps of ``make_train_step`` with the launch counts set to 0 just before and
    checked against ``per_step`` just after, and the routes of ``want_routes``'
    modules checked to have taken every launch; the peak memory of those steps
    and of one more loss and gradient alone; then 8 steps on a fixed (2, 128)
    batch, whose loss must fall by 0.05.  Tokens are the batch's text tokens.
    With ``dryrun``, one counted step after the timed ones (``dryrun_check``).
    Returns ``(model, params, result)``."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenDatasetSpec
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as smoke_root:
        res = train.main(["--arch", arch, "--device", "cuda", "--steps", "2", "--batch", "2",
                          "--seq", "64", "--ckpt-dir", ckpt_dir, "--data-root", smoke_root])
        if not (Path(ckpt_dir) / "step_000002" / "_COMMITTED").is_file():
            raise AssertionError(f"the {arch} launcher wrote no final checkpoint")
    if res["restarts"] or not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"{arch} launcher: {res['restarts']} restarts, losses {res['losses']}")
    print(f"[{tag}] launcher at the smoke config on the card: losses {res['losses']}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, steps = shape["batch"], shape["seq"], shape["steps"]
    cfg = ARCHS[arch]
    if "layers" in shape:
        cfg = dataclasses.replace(cfg, n_layers=shape["layers"])
    model = build_model(cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    t0 = time.perf_counter()
    params, opt = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = TokenDatasetSpec("train-corpus", n_sequences=max(256, B * 32), seq_len=S,
                            vocab=model.cfg.vocab, seed=0)
    data_root = tempfile.TemporaryDirectory(dir=ROOT / "build")
    it = corpus_batches(spec, B, data_root.name)
    step = make_train_step(model, opt_cfg)
    reset_counts(kernel_modules)
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        toks, labels = next(it)
        batch = {"tokens": torch.from_numpy(toks).long().cuda(),
                 "labels": torch.from_numpy(labels).long().cuda()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))      # waits for the step to finish
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts, routes = read_counts(kernel_modules)
    peak = torch.cuda.max_memory_allocated()
    data_root.cleanup()
    dry = (dryrun_check(model, params, opt, batch, opt_cfg, tag, step_ms, S) if dryrun
           else None)
    # one more loss and its gradients on the last batch, no update: the peak of
    # the parameters, the optimizer state and what the model saves for its
    # backward (the scans' state among it), apart from the update's temporaries
    torch.cuda.reset_peak_memory_stats()
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    grads = torch.autograd.grad(model.loss(leaves, batch)[0], PM.tree_leaves(leaves),
                                allow_unused=True)
    grad_peak = torch.cuda.max_memory_allocated()
    del leaves, grads
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} train losses {losses}")
    for name, n in per_step.items():
        if counts[name] != n * steps:
            raise AssertionError(f"{name}: {counts[name]} launches in the {arch} train run, "
                                 f"expected {n} x {steps} steps")
    check_routes(routes, counts, want_routes, tag)
    median = statistics.median(step_ms[1:])
    tokens_per_s = B * S / (median / 1e3)
    print(f"[{tag}] launches {counts}, by route {routes}; losses {losses}; step ms "
          f"{step_ms}; median "
          f"{median:.3f} ms over steps 2-{steps}, {tokens_per_s:.1f} tokens/s, peak "
          f"{peak / 2**30:.3f} GiB (loss and gradients alone {grad_peak / 2**30:.3f}); init "
          f"{init_s:.2f} s")

    rng = np.random.default_rng(0)
    fixed_batch = {name: torch.as_tensor(rng.integers(0, model.cfg.vocab, (2, 128))).cuda()
                   for name in ("tokens", "labels")}
    fixed_step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2))
    fixed = []
    for _ in range(8):
        params, opt, metrics = fixed_step(params, opt, fixed_batch)
        fixed.append(float(metrics["loss"]))
    if not fixed[-1] < fixed[0] - 0.05:
        raise AssertionError(f"fixed-batch losses did not fall by 0.05: {fixed}")
    print(f"[{tag}] fixed batch (2, 128), 8 steps: loss {fixed[0]:.4f} -> {fixed[-1]:.4f}")
    return model, params, {
        "counts": counts, "routes": routes, "steps": steps, "batch": B, "seq": S,
        "n_layers": cfg.n_layers, "parameters": sum(t.numel() for t in PM.tree_leaves(params)),
        "tokens_per_step": B * S,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median,
        "tokens_per_s": tokens_per_s, "peak_memory_bytes": peak,
        "grad_peak_memory_bytes": grad_peak, "init_seconds": init_s,
        "fixed_batch_losses": fixed, "launcher_smoke_losses": res["losses"], "dryrun": dry}


def phase_train_xlstm(kernel_modules) -> dict:
    """xlstm-1.3b: ``train_full_depth`` at batch 4 x 512 and 8 of its 48 layers
    (``XLSTM_TRAIN``), then one mLSTM and one sLSTM block timed.  Cut: the
    launcher's final checkpoint, 41 GB at full size, is not written at full
    depth; no counted step (``dryrun_check``): its sLSTM loop, 246033
    launches at full depth, takes minutes to count on the meta device."""
    model, params, res = train_full_depth(XLSTM, XLSTM_TRAIN, XLSTM_PER_STEP, kernel_modules,
                                          "train_xlstm", XLSTM_ROUTES, dryrun=False)
    blocks = xlstm_block_ms(model, params, res["batch"], res["seq"])
    print(f"[train_xlstm] one block forward + backward at ({res['batch']}, {res['seq']}): "
          f"{blocks}")
    return {**res, **blocks}


def phase_train_hymba(kernel_modules) -> dict:
    """hymba-1.5b: ``train_full_depth`` at batch 2 x 2048 (32 layers, 1.66 B
    parameters).  Each step holds 4096 text tokens; the 128 meta tokens of a
    sequence are not counted.  Cut: the launcher's final checkpoint, 23 GB at
    this size, is not written at full depth."""
    res = train_full_depth(HYMBA, HYMBA_TRAIN, HYMBA_PER_STEP, kernel_modules, "train_hymba",
                           HYMBA_ROUTES)[2]
    return {**res, "tokens_counted": "text tokens only, not the 128 meta tokens a sequence"}


def phase_train_deepseek(kernel_modules) -> dict:
    """deepseek-v2-lite-16b: ``train_full_depth`` at 4 layers (layer0 and 3 MoE
    layers, 2.25 B parameters), batch 2 x 2048, every flash launch (MLA's
    (192, 128)) on the tensor cores.  Cut: the depth (the full model's AdamW
    state does not fit one card); no checkpoint at this size."""
    return train_full_depth(DEEPSEEK, DEEPSEEK_TRAIN, DEEPSEEK_PER_STEP, kernel_modules,
                            "train_deepseek", TRAIN_ROUTES)[2]


def phase_train_mixtral(kernel_modules) -> dict:
    """mixtral-8x7b: ``train_full_depth`` at 2 layers (3.16 B parameters), one
    sequence of 8192 (the window of 4096 binds).  Cut: the depth (93 GB of
    bf16 weights alone at 32 layers); no checkpoint at this size."""
    return train_full_depth(MIXTRAL, MIXTRAL_TRAIN, MIXTRAL_PER_STEP, kernel_modules,
                            "train_mixtral", TRAIN_ROUTES)[2]


def phase_train_phi4(kernel_modules) -> dict:
    """phi4-mini-3.8b: ``train_full_depth`` at full width and depth (32 layers,
    4.45 B parameters) on 2 x 1024 (``PHI4_TRAIN``), every layer rematerialised
    under the config's ``"dots"``, the routes as qwen's.  Cut: the launcher's
    final checkpoint (62 GB of state) is not written at full width.  The
    caching allocator makes its new segments expandable for this phase: at a
    72.4 GiB peak on a 79.2 GiB card, fixed segments split by the steps left
    6.8 GiB reserved but no free block for the update's 2.3 GiB fp32 copy of
    the embedding's gradient (an out-of-memory error in the whole run)."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return train_full_depth(PHI4, PHI4_TRAIN, PHI4_PER_STEP, kernel_modules, "train_phi4",
                                TRAIN_ROUTES)[2]
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def train_embedded(arch: str, shape: dict, per_step: dict, kernel_modules, tag: str,
                   want_routes: dict) -> dict:
    """A family whose ``loss`` takes embeddings beside the tokens (internvl2-2b's
    image, whisper-large-v3's frames) in bf16 at full width and depth.  First
    ``launch.train.main`` must refuse it, naming the missing entry.  Then
    ``shape``'s batch x seq text tokens from the launcher's corpus, striped
    and read through the stripe store (``corpus_batches``), the embeddings
    drawn each step from a seeded CUDA generator (``embeddings``: 256 image
    positions, or ``shape["frames"]`` frames), parameters drawn on a CUDA generator,
    ``shape``'s steps of ``make_train_step`` with the launch counts set to 0
    just before and checked against ``per_step`` just after, the routes of
    ``want_routes``' modules, and every shape launched one the kernel checks
    cover (``launched_shapes``); the peak memory of those steps; then 8 steps
    on a fixed batch (internvl2-2b: 2 x (256 + 128); Whisper: the run's first
    batch), whose loss must fall by 0.05.  Tokens are the batch's text
    tokens."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenDatasetSpec
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = ARCHS[arch]
    needed = train.NEEDS_EMBEDDINGS[cfg.family]
    try:
        train.main(["--arch", arch, "--full-config", "--device", "cuda", "--steps", "1"])
    except SystemExit as e:
        if needed not in str(e):
            raise AssertionError(f"the launcher refused {arch} without naming {needed}: {e}")
    else:
        raise AssertionError(f"the launcher trained {arch} without {needed}")
    print(f"[{tag}] launch.train refuses {arch}: its loss needs {needed}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, steps, frames = shape["batch"], shape["seq"], shape["steps"], shape.get("frames", 0)
    model = build_model(cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    t0 = time.perf_counter()
    params, opt = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = TokenDatasetSpec("train-corpus", n_sequences=max(256, B * 32), seq_len=S,
                            vocab=cfg.vocab, seed=0)
    (ROOT / "build").mkdir(exist_ok=True)
    data_root = tempfile.TemporaryDirectory(dir=ROOT / "build")
    it = corpus_batches(spec, B, data_root.name)
    gen = torch.Generator(device="cuda").manual_seed(3)
    step = make_train_step(model, opt_cfg)
    losses, step_ms, batches = [], [], []
    with launched_shapes() as shapes:
        reset_counts(kernel_modules)
        for _ in range(steps):
            t0 = time.perf_counter()
            toks, labels = next(it)
            batch = {"tokens": torch.from_numpy(toks).long().cuda(),
                     "labels": torch.from_numpy(labels).long().cuda(),
                     **embeddings(cfg, B, frames, gen, "cuda", model.dtype)}
            batches.append(batch)
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))      # waits for the step to finish
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts, routes = read_counts(kernel_modules)
        peak = torch.cuda.max_memory_allocated()
        data_root.cleanup()
        dry = dryrun_check(model, params, opt, batch, opt_cfg, tag, step_ms, dryrun_seq(cfg, S))
        if cfg.vlm is not None:
            rng = np.random.default_rng(0)
            fixed_batch = {name: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 128))).cuda()
                           for name in ("tokens", "labels")}
            fixed_batch.update(embeddings(cfg, 2, 0, gen, "cuda", model.dtype))
        else:
            fixed_batch = batches[0]
        fixed_step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2))
        fixed = []
        for _ in range(8):
            params, opt, metrics = fixed_step(params, opt, fixed_batch)
            fixed.append(float(metrics["loss"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} train losses {losses}")
    for name, n in per_step.items():
        if counts[name] != n * steps:
            raise AssertionError(f"{name}: {counts[name]} launches in the {arch} train run, "
                                 f"expected {n} x {steps} steps")
    check_routes(routes, counts, want_routes, tag)
    check_launched(shapes, tag)
    if not fixed[-1] < fixed[0] - 0.05:
        raise AssertionError(f"{arch} fixed-batch losses did not fall by 0.05: {fixed}")
    median = statistics.median(step_ms[1:])
    tokens_per_s = B * S / (median / 1e3)
    n_params = sum(t.numel() for t in PM.tree_leaves(params))
    print(f"[{tag}] {n_params / 1e9:.3f} B parameters; launches {counts}, by route {routes}; "
          f"flash shapes {sorted(shapes['flash_attention'])}; losses {losses}; step ms "
          f"{step_ms}; median {median:.3f} ms over steps 2-{steps}, {tokens_per_s:.1f} text "
          f"tokens/s, peak {peak / 2**30:.3f} GiB; init {init_s:.2f} s; fixed batch, 8 steps: "
          f"loss {fixed[0]:.4f} -> {fixed[-1]:.4f}")
    return {"counts": counts, "routes": routes, "steps": steps, "batch": B, "seq": S,
            "frames": frames, "n_layers": cfg.n_layers, "parameters": n_params,
            "tokens_per_step": B * S, "tokens_counted": "text tokens only",
            "shapes": {k: sorted(v) for k, v in shapes.items()},
            "losses": losses, "step_ms": step_ms, "median_step_ms": median,
            "tokens_per_s": tokens_per_s, "peak_memory_bytes": peak, "init_seconds": init_s,
            "fixed_batch_losses": fixed, "dryrun": dry}


def phase_train_internvl2(kernel_modules) -> dict:
    """internvl2-2b: ``train_embedded`` at 2 x (256 image + 1792 text) positions
    (24 layers, 1.89 B parameters), the routes as qwen's.  No checkpoint."""
    return train_embedded(INTERNVL, INTERNVL_TRAIN, INTERNVL_PER_STEP, kernel_modules,
                          "train_internvl2", TRAIN_ROUTES)


def phase_train_whisper(kernel_modules) -> dict:
    """whisper-large-v3: ``train_embedded`` at 4 x (1500 frames, 448 tokens) (32
    + 32 layers, 1.58 B parameters), every flash forward and backward (the
    encoder's, the decoder's causal one, cross attention) on the tensor
    cores.  No checkpoint."""
    return train_embedded(WHISPER, WHISPER_TRAIN, WHISPER_PER_STEP, kernel_modules,
                          "train_whisper", WHISPER_ROUTES)


#: phase_hoard's compute-plane store: one batch of qwen1.5-0.5b's training rows
HOARD_TOKENS = dict(batch=TRAIN["batch"], seq=TRAIN["seq"], items_per_chunk=2,
                    items_per_file=4, steps=2)
#: phase_hoard's checkpoint dataset: 2 slot files of 80 items of 4 MiB, one item
#: a chunk, so a byte range reads each chunk file once
HOARD_CKPT = dict(item_bytes=4 << 20, items_per_chunk=1, items_per_file=80, slots=2)
#: qwen1.5-0.5b's full-width embedding, bf16, in phase_hoard's checkpoint
QWEN_EMBED = (151936, 1024)


def hoard_compute_plane(kernel_modules, root: Path) -> dict:
    """(a) 8 x 512 int32 records of qwen1.5-0.5b's tokens striped into a
    materialised store (2 items a chunk over 4 nodes, 4 items a shard file),
    read as node 0 by ``FileDataset.read_item_bytes`` through HoardFS in the
    ``TokenLoader``'s order, the clock drained, decoded on the card by
    ``token_batch_from_bytes``: the batch must equal the loader's rows.  Then
    two bf16 steps of ``make_train_step`` at full width and depth, the launch
    counts set to 0 just before and equal to ``TRAIN_PER_STEP`` a step just
    after, every launch on ``TRAIN_ROUTES``' route."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import build_cluster
    from repro_torch.data import TokenDatasetSpec, TokenLoader, materialize_token_dataset
    from repro_torch.fs import FileDataset, HoardFS, MetadataService
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train import token_batch_from_bytes

    B, S, steps = HOARD_TOKENS["batch"], HOARD_TOKENS["seq"], HOARD_TOKENS["steps"]
    cfg = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16")
    spec = TokenDatasetSpec("hoard-tokens", n_sequences=B, seq_len=S, vocab=cfg.vocab, seed=0)
    clock, topo, store, cache, _ = build_cluster()
    store.root = str(root)
    materialize_token_dataset(store, cache, spec, topo.nodes[:4],
                              items_per_chunk=HOARD_TOKENS["items_per_chunk"])
    fs = HoardFS(clock, topo, cache, MetadataService(store), topo.nodes[0])
    fs.meta.set_items_per_file(spec.dataset_id, HOARD_TOKENS["items_per_file"])
    loader = TokenLoader(store, spec, topo.nodes[0], batch=B)
    toks, labels = next(iter(loader))
    ds = FileDataset(fs, f"/hoard/{spec.dataset_id}")
    t0 = time.perf_counter()
    results = ds.read_item_bytes(loader.last_ids)
    clock.run()
    payloads = [r.data for r in results]
    read_ms = (time.perf_counter() - t0) * 1e3
    ds.close()
    batch = token_batch_from_bytes(payloads, S, cfg.vocab, device="cuda")
    for name, want in (("tokens", toks), ("labels", labels)):
        if batch[name].device.type != "cuda" or \
                not torch.equal(batch[name].cpu(), torch.from_numpy(want).long()):
            raise AssertionError(f"HoardFS batch {name} differ from the TokenLoader's rows")

    model = build_model(cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    params, opt = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt_cfg)
    step = make_train_step(model, opt_cfg)
    losses = []
    reset_counts(kernel_modules)
    for _ in range(steps):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    counts, routes = read_counts(kernel_modules)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"HoardFS-fed losses {losses}")
    for name, n in TRAIN_PER_STEP.items():
        if counts[name] != n * steps:
            raise AssertionError(f"{name}: {counts[name]} launches in the HoardFS-fed steps, "
                                 f"expected {n} x {steps}")
    check_routes(routes, counts, TRAIN_ROUTES, "hoard")
    print(f"[hoard] (a) {B} x {S} records read through HoardFS in {read_ms:.3f} ms (simulated "
          f"clock {clock.now:.6f} s), equal to the TokenLoader's rows; {steps} bf16 steps at "
          f"full width: losses {losses}, launches {counts}")
    return {"counts": counts, "routes": routes, "losses": losses, "hoardfs_read_ms": read_ms,
            "sim_clock_s": clock.now}


def hoard_checkpoint(root: Path) -> dict:
    """(b) ``HoardCheckpointManager`` save and restore on the card: the smoke
    qwen1.5-0.5b's bf16 train state (params, fp32 master and moments) and the
    full-width (151936, 1024) bf16 embedding, through a dataset of
    ``HOARD_CKPT``'s geometry.  Every restored leaf must equal the saved one
    bit for bit, in its dtype, on ``cuda``."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import DatasetSpec, build_cluster
    from repro_torch.fs import HoardFS, MetadataService
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train import AdamWConfig, HoardCheckpointManager, SamplerState
    from repro_torch.train import init_train_state

    geo = HOARD_CKPT
    clock, topo, store, cache, _ = build_cluster()
    store.root = str(root)
    t0 = time.perf_counter()
    cache.register(DatasetSpec("ckpt", "nfs://store/ckpt", geo["items_per_file"] * geo["slots"],
                               geo["item_bytes"]))
    cache.admit("ckpt", topo.nodes[:4], materialize=True, items_per_chunk=geo["items_per_chunk"])
    cache.mark_filled("ckpt")
    admit_s = time.perf_counter() - t0
    meta = MetadataService(store)
    meta.set_items_per_file("ckpt", geo["items_per_file"])
    mgr = HoardCheckpointManager(HoardFS(clock, topo, cache, meta, topo.nodes[0]), "ckpt")

    smoke = build_model(dataclasses.replace(ARCHS[ARCH].smoke(), dtype="bfloat16"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params, opt = init_train_state(smoke, gen, AdamWConfig())
    params = {"smoke": params, "qwen_embed": torch.randn(QWEN_EMBED, generator=gen,
                                                         device="cuda", dtype=torch.bfloat16)}
    tree = {"params": params, "opt": opt}
    leaves = PM.tree_leaves(tree)
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = mgr.save(3, params, opt, sampler=SamplerState(0, 3, 0))
    save_s = time.perf_counter() - t0
    if path is None or mgr.latest_step() != 3:
        raise AssertionError(f"HoardFS checkpoint not committed: {path}")
    template = PM.tree_map(torch.empty_like, tree)
    t0 = time.perf_counter()
    step, p, o, sampler = mgr.restore(template=template, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = PM.tree_leaves({"params": p, "opt": o})
    if step != 3 or sampler != SamplerState(0, 3, 0) or len(got) != len(leaves):
        raise AssertionError(f"restored step {step}, sampler {sampler}, {len(got)} leaves")
    for g, w in zip(got, leaves):
        if g.device.type != "cuda" or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"a restored {tuple(w.shape)} {w.dtype} leaf differs")
    res = {"ckpt_state_bytes": state_bytes, "ckpt_leaves": len(leaves),
           "ckpt_geometry": geo, "ckpt_admit_seconds": admit_s,
           "ckpt_save_seconds": save_s, "ckpt_restore_seconds": restore_s,
           "ckpt_save_mb_per_s": state_bytes / save_s / 1e6,
           "ckpt_restore_mb_per_s": state_bytes / restore_s / 1e6}
    print(f"[hoard] (b) HoardFS checkpoint of {state_bytes / 1e6:.1f} MB ({len(leaves)} leaves, "
          f"bf16 and fp32) in slots of {geo['items_per_file']} x {geo['item_bytes']} B, "
          f"{geo['items_per_chunk']} item a chunk: save {save_s:.3f} s "
          f"({res['ckpt_save_mb_per_s']:.1f} MB/s), restore to cuda {restore_s:.3f} s "
          f"({res['ckpt_restore_mb_per_s']:.1f} MB/s), bit for bit; not the 6.5 GB full "
          f"state: HoardFS reads and writes it item by item in Python, each item's whole "
          f"chunk file read and CRC-checked, and holds host copies of it several times over")
    return res


def hoard_repair(root: Path, vocab: int) -> dict:
    """(c) Replica repair on this machine's disk: a corpus at replication 2,
    one byte of node 0's replica of chunk 0 flipped; reading chunk 0's items
    as node 0 returns the seeded corpus's bytes, counts one repair, and
    rewrites the replica with its original bytes."""
    from repro_torch.core import build_cluster
    from repro_torch.data import TokenDatasetSpec, materialize_token_dataset, read_item

    ipc = 16
    clock, topo, store, cache, _ = build_cluster(replication=2)
    store.root = str(root)
    spec = TokenDatasetSpec("repair-corpus", n_sequences=64, seq_len=TRAIN["seq"], vocab=vocab,
                            seed=0)
    materialize_token_dataset(store, cache, spec, topo.nodes[:4], items_per_chunk=ipc)
    if store.manifests[spec.dataset_id].chunk_nodes[0] != [0, 1]:
        raise AssertionError("chunk 0 not on nodes 0 and 1")
    path = root / "node0" / spec.dataset_id / "chunk_000000"
    original = path.read_bytes()
    flipped = bytearray(original)
    flipped[100] ^= 0xFF
    path.write_bytes(bytes(flipped))
    for i in range(ipc):
        if store.read_item(spec.dataset_id, i, topo.nodes[0]) != \
                read_item(spec, i, items_per_chunk=ipc):
            raise AssertionError(f"item {i} read as node 0 differs from the corpus")
    if store.corruption_repairs != 1 or path.read_bytes() != original:
        raise AssertionError(f"{store.corruption_repairs} repairs; replica healed: "
                             f"{path.read_bytes() == original}")
    print("[hoard] (c) a flipped byte in node 0's replica of chunk 0: reads as node 0 equal "
          "the corpus, 1 repair, the replica rewritten with its original bytes")
    return {"corruption_repairs": store.corruption_repairs}


def phase_hoard(kernel_modules) -> dict:
    """The Hoard data plane on the card: (a) the compute-plane path at full
    width (``hoard_compute_plane``), (b) checkpoints through HoardFS
    (``hoard_checkpoint``), (c) replica repair (``hoard_repair``), their files
    in a temporary directory under ``build/``."""
    from repro_torch.configs import ARCHS

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        res = hoard_compute_plane(kernel_modules, Path(root) / "tokens")
        gc.collect()
        torch.cuda.empty_cache()
        res.update(hoard_checkpoint(Path(root) / "ckpt"))
        res.update(hoard_repair(Path(root) / "repair", ARCHS[ARCH].vocab))
    return res


def only_hoard(gen, ops, ref, rate) -> list:
    from repro_torch.kernels import KERNEL_MODULES

    return [{"hoard": phase_hoard(KERNEL_MODULES)}]


# ------------------------------------------------------------------- multi
#: phase_multi: 4 gloo ranks sharing the card, mesh pod 2 x data 2 x model 1,
#: qwen1.5-0.5b in bf16 at full width on the train phase's batch, cut to 4 of
#: its 24 layers (phase_tp runs it at full depth)
MULTI = dict(pods=2, data=2, batch=TRAIN["batch"], seq=TRAIN["seq"], steps=3, layers=4,
             collective_timeout=300.0, world_timeout=420.0)
#: kernel launches per training step of that cut (2 norms, one attention and
#: one SwiGLU a layer; the final norm)
MULTI_PER_STEP = train_launches({"rmsnorm": 2 * MULTI["layers"], "swiglu": MULTI["layers"],
                                 "flash_attention": MULTI["layers"]}, {"rmsnorm": 1})
#: flash decoding over a data 1 x model 4 view of the same ranks: qwen1.5-0.5b's
#: decode shape over one 32768-slot cache, 8192 slots a rank
MULTI_DECODE = dict(B=8, S=32768, valids=(1, 130, 8193, 32768))
#: JAX's bound on the compressed sync, of each leaf's largest entry
#: (tests/test_elastic.py:109-110)
COMPRESS_TOL = 0.02


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def _clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _crc(t: torch.Tensor) -> int:
    return zlib.crc32(_leaf_bytes(t).cpu().numpy())


def _decode_inputs(dtype) -> tuple:
    """q (B, 16, 1, 64) and the K and V caches (B, 16, S, 64) of qwen1.5-0.5b's
    decode shape (``MULTI_DECODE``), drawn in fp32 on a seeded CUDA generator
    and cast: the same on every process of the card."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[ARCH]
    B, S = MULTI_DECODE["B"], MULTI_DECODE["S"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for shape in (
        (B, cfg.n_heads, 1, cfg.resolved_head_dim),
        (B, cfg.n_kv_heads, S, cfg.resolved_head_dim),
        (B, cfg.n_kv_heads, S, cfg.resolved_head_dim)))
    return q, k, v


def _multi_step_counts(kernel_modules, rec: dict, what: str) -> None:
    counts, routes = read_counts(kernel_modules)
    expect_counts(counts, MULTI_PER_STEP, what)
    check_routes(routes, counts, TRAIN_ROUTES, what)
    rec["counts"].append(counts)


def multi_rank(rank: int, world: int, init: str, work: str, tokens, labels) -> dict:
    """One of ``phase_multi``'s ranks: (a) 3 steps with the plain sync, the
    first in its parts and checked, (b) the compressed sync of step 1's
    gradients and one compressed step, (c) the ZeRO state saved and restored
    at data 4 over the same ranks, (d) flash decoding over model 4."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import KERNEL_MODULES, build
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import NamedSharding
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.serve import make_flash_decode
    from repro_torch.train import (AdamWConfig, CheckpointManager, DataParallelStep,
                                   adamw_update, compress_int8, decompress_int8, init_opt_state,
                                   zero_shardings)
    from repro_torch.train.sync import _mean

    build.library()                  # the parent's build, found by its digest
    timeout = MULTI["collective_timeout"]
    first = {} if torch.distributed.is_initialized() else dict(init_method=init, rank=rank)
    mesh = make_test_mesh(data=MULTI["data"], model=1, pods=MULTI["pods"], backend="gloo",
                          timeout=timeout, **first)
    say = (lambda msg: print(f"[multi r0] {msg}", flush=True)) if rank == 0 else (lambda _: None)
    cfg = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16", n_layers=MULTI["layers"])
    model = build_model(cfg, model_axis=1, mesh=mesh, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = {"tokens": torch.from_numpy(tokens).long().cuda(),
             "labels": torch.from_numpy(labels).long().cuda()}
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    step = DataParallelStep(model, opt_cfg, mesh)
    step_c = DataParallelStep(model, opt_cfg, mesh, compress=True)
    opt = step.init_opt_state(params)
    rec = {"rank": rank, "coords": mesh.coords, "losses": [], "step_ms": [], "sync_ms": [],
           "update_ms": [], "gather_ms": [], "counts": []}
    torch.cuda.reset_peak_memory_stats()

    # (a) step 1 in its parts
    before = PM.tree_map(lambda t: t.clone(), params)
    reset_counts(KERNEL_MODULES)
    t0 = _clock()
    loss, _, grads = step.grads(params, batch)
    t1 = _clock()
    synced = step.sync(grads)
    t2 = _clock()
    params, opt, metrics = step.update(synced, opt, params)
    t3 = _clock()
    _multi_step_counts(KERNEL_MODULES, rec, f"multi rank {rank} step 1")
    rec["losses"].append(float(step.mean_over_ranks(loss)))
    rec["step_ms"].append((t3 - t0) * 1e3)
    rec["sync_ms"].append((t2 - t1) * 1e3)
    rec["update_ms"].append(step.times["update_ms"])
    rec["gather_ms"].append(step.times["gather_ms"])
    say(f"step 1 {rec['step_ms'][0]:.1f} ms, sync {rec['sync_ms'][0]:.1f} ms")

    # the synced gradient against the parent's gradient of the whole batch
    ref_grads = torch.load(Path(work) / "ref_grads.pt", map_location="cpu", mmap=True)
    worst = 0.0
    for g, r in zip(PM.tree_leaves(synced), PM.tree_leaves(ref_grads)):
        r = r.cuda()
        err = float((g.float() - r.float()).abs().max() / r.float().abs().max())
        worst = max(worst, err)
    del ref_grads
    if not worst <= GRAD_TOL[torch.bfloat16]:
        raise AssertionError(f"rank {rank}: synced gradient {worst} of the largest entry from "
                             "the single-process gradient")
    rec["grad_err_vs_single_process"] = worst

    # (b) the compressed sync of the same gradients: JAX's bound, and the
    # residual gf - deq exactly
    synced_c = step_c.sync(grads)
    ratio, residual, exact = 0.0, 0.0, True
    for g, gc_, s, e in zip(PM.tree_leaves(grads), PM.tree_leaves(synced_c),
                            PM.tree_leaves(synced), PM.tree_leaves(step_c.errors)):
        ratio = max(ratio, float((gc_ - s.float()).abs().max() / s.float().abs().max()))
        gf = _mean(g, mesh, "data")
        q, scale, new_e = compress_int8(gf, torch.zeros_like(e))
        exact &= bool(torch.equal(new_e, e)) and bool(
            torch.equal(e, gf.float() - decompress_int8(q, scale)))
        residual += float(e.abs().sum())
    if not (ratio <= COMPRESS_TOL and residual > 0 and exact):
        raise AssertionError(f"rank {rank}: compressed sync {ratio} of the largest entry, "
                             f"residual {residual}, equal to gf - deq: {exact}")
    rec.update(compressed_vs_plain=ratio, residual=residual)
    del grads, synced_c

    # the ZeRO-1 update against adamw_update on the same gradient, one rank at a time
    for turn in range(mesh.size):
        if turn == rank:
            full = init_opt_state(before, opt_cfg)
            before, full, ref_m = adamw_update(synced, full, before, opt_cfg)
            same_p = all(torch.equal(a, b) for a, b in zip(PM.tree_leaves(params),
                                                           PM.tree_leaves(before)))
            same_s = all(torch.equal(shard, sh.shard(f)) for key in ("master", "mu", "nu")
                         for shard, f, sh in zip(PM.tree_leaves(opt[key]),
                                                 PM.tree_leaves(full[key]),
                                                 PM.tree_leaves(step.shardings[key])))
            same_n = bool(torch.equal(ref_m["grad_norm"], metrics["grad_norm"]))
            if not (same_p and same_s and same_n):
                raise AssertionError(f"rank {rank}: ZeRO-1 update differs from adamw_update "
                                     f"(params {same_p}, state shards {same_s}, norm {same_n})")
            del full
            gc.collect()
            torch.cuda.empty_cache()
        mesh.barrier()
    del before, synced
    # every rank's parameters equal rank 0's, bit for bit
    for p in PM.tree_leaves(params):
        mine = _leaf_bytes(p)
        theirs = mine.clone()
        torch.distributed.broadcast(theirs, src=0)
        if not torch.equal(mine, theirs):
            raise AssertionError(f"rank {rank}: parameters differ from rank 0's after the gather")
    rec["sharded_leaves"] = sum(s.shape != p.shape for s, p in
                                zip(PM.tree_leaves(opt["mu"]), PM.tree_leaves(params)))
    rec["peak_gib_checks"] = torch.cuda.max_memory_allocated() / 2**30
    say("step 1 checked: gradient, compressed sync, ZeRO update, equal parameters")

    # (a) steps 2 and 3 whole
    torch.cuda.reset_peak_memory_stats()
    for i in range(2, MULTI["steps"] + 1):
        reset_counts(KERNEL_MODULES)
        t0 = _clock()
        params, opt, metrics = step(params, opt, batch)
        rec["losses"].append(float(metrics["loss"]))
        rec["step_ms"].append((_clock() - t0) * 1e3)
        for key in ("sync_ms", "update_ms", "gather_ms"):
            rec[key].append(step.times[key])
        _multi_step_counts(KERNEL_MODULES, rec, f"multi rank {rank} step {i}")
    rec["peak_gib_steps"] = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"rank {rank}: losses {rec['losses']}")
    say(f"steps {rec['step_ms']} ms, losses {rec['losses']}")

    # (c) the ZeRO state saved, restored at data 4 over the same ranks
    whole = PM.tree_map(lambda _: None, params)
    ckpt = CheckpointManager(str(Path(work) / "ckpt"), keep=1)
    t0 = time.perf_counter()
    ckpt.save(MULTI["steps"], params, opt, shardings={"params": whole, "opt": step.shardings},
              mesh_shape=dict(mesh.shape))
    rec["save_s"] = time.perf_counter() - t0
    wide = make_test_mesh(data=4, model=1, pods=1, backend="gloo", timeout=timeout)
    wide_sh = {"params": whole, "opt": zero_shardings(model.layout(), wide, opt_cfg)}
    t0 = time.perf_counter()
    _, p_b, o_b, _ = ckpt.restore(template={"params": params, "opt": opt}, shardings=wide_sh)
    rec["restore_s"] = time.perf_counter() - t0
    crcs = []
    saved_sh = {"params": whole, "opt": step.shardings}
    for mine, sh, got, wsh in zip(PM.tree_leaves({"params": params, "opt": opt}),
                                  PM.tree_leaves(saved_sh), PM.tree_leaves({"params": p_b,
                                                                             "opt": o_b}),
                                  PM.tree_leaves(wide_sh)):
        full = mine if sh is None else sh.gather(mine)
        if not torch.equal(got, full if wsh is None else wsh.shard(full)):
            raise AssertionError(f"rank {rank}: a leaf restored at data 4 differs from its "
                                 "slice of the saved state")
        if rank == 0:
            crcs.append(_crc(full))
    rec["crcs"] = crcs
    del p_b, o_b
    say(f"saved in {rec['save_s']:.2f} s, restored at data 4 in {rec['restore_s']:.2f} s")

    # (b) one whole step with the compressed sync
    reset_counts(KERNEL_MODULES)
    t0 = _clock()
    params, opt, metrics = step_c(params, opt, batch)
    rec["compressed_step"] = {"loss": float(metrics["loss"]), "ms": (_clock() - t0) * 1e3,
                              **step_c.times}
    _multi_step_counts(KERNEL_MODULES, rec, f"multi rank {rank} compressed step")
    if not math.isfinite(rec["compressed_step"]["loss"]):
        raise AssertionError(f"rank {rank}: compressed step loss {rec['compressed_step']}")
    del params, opt, step, step_c
    gc.collect()
    torch.cuda.empty_cache()

    # (d) flash decoding over the model axis of a data 1 x model 4 view
    tall = make_test_mesh(data=1, model=4, backend="gloo", timeout=timeout)
    fn = make_flash_decode(tall)
    cut = NamedSharding(tall, PM.P(None, None, "model", None))
    rec["decode"] = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = _decode_inputs(dt)
        ks, vs = cut.shard(k), cut.shard(v)
        del k, v
        outs, ms = [], []
        for valid in MULTI_DECODE["valids"]:
            t0 = _clock()
            out = fn(q, ks, vs, valid)
            ms.append((_clock() - t0) * 1e3)
            outs.append(out.float().cpu().numpy())
        rec["decode"][str(dt)] = {"outs": outs, "ms": ms, "slots": ks.shape[2]}
        del q, ks, vs
    say(f"flash decoding ms {[rec['decode'][d]['ms'] for d in rec['decode']]}")
    return rec


def multi_parts(kernel_modules):
    """``phase_multi`` in the form ``run_worlds`` drives: yields its rank job,
    is sent the ranks' results and the world's seconds, returns its result.

    4 ranks on the card over ``gloo`` (``multi_rank``), mesh pod 2 x data 2
    x model 1: qwen1.5-0.5b in bf16 at full width and ``MULTI``'s depth, the
    train phase's batch (8 x 512, read through the stripe store), 2 rows a
    rank.  The
    parent computes the whole batch's gradient in one process for the ranks
    to hold theirs against, restores their checkpoint onto the one device
    (every leaf's CRC equal to the gathered leaf's), and holds their flash
    decoding against the decode-attention kernel on the whole cache."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenDatasetSpec
    from repro_torch.kernels import ops, ref
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train import CheckpointManager
    from repro_torch.train.step import _grads

    cfg = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16", n_layers=MULTI["layers"])
    B, S = MULTI["batch"], MULTI["seq"]
    spec = TokenDatasetSpec("train-corpus", n_sequences=max(256, B * 32), seq_len=S,
                            vocab=cfg.vocab, seed=0)
    (ROOT / "build").mkdir(exist_ok=True)
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as data_root:
        tokens, labels = next(corpus_batches(spec, B, data_root))
        model = build_model(cfg, device="cuda")
        params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
        batch = {"tokens": torch.from_numpy(tokens).long().cuda(),
                 "labels": torch.from_numpy(labels).long().cuda()}
        _, _, grads = _grads(model, params, batch)
        torch.save(PM.tree_map(lambda g: g.cpu(), grads), Path(work) / "ref_grads.pt")
        layout = model.layout()
        del model, params, batch, grads
        gc.collect()
        torch.cuda.empty_cache()

        ranks, world_s = yield multi_rank, (work, tokens, labels), MULTI["world_timeout"]

        # (c) the same checkpoint whole onto the one device
        empty = lambda _: torch.empty(0, device="cuda")
        template = {"params": PM.tree_map(empty, layout),
                    "opt": {"count": torch.empty(0, device="cuda"),
                            **{k: PM.tree_map(empty, layout) for k in ("master", "mu", "nu")}}}
        t0 = time.perf_counter()
        at, p, o, _ = CheckpointManager(str(Path(work) / "ckpt")).restore(template=template)
        one_device_s = time.perf_counter() - t0
        crcs = [_crc(t) for t in PM.tree_leaves({"params": p, "opt": o})]
        if at != MULTI["steps"] or crcs != ranks[0]["crcs"]:
            raise AssertionError(f"restored onto one device at step {at}: "
                                 f"{sum(a != b for a, b in zip(crcs, ranks[0]['crcs']))} leaves "
                                 "differ from the gathered state")
        del p, o

    # (d) each rank's flash decoding against the decode-attention kernel
    decode = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = _decode_inputs(dt)
        errs, kernel_errs = [], []
        for i, valid in enumerate(MULTI_DECODE["valids"]):
            want = ops.decode_attention(q, k, v, valid)
            kernel_errs.append(max_err(want, ref.decode_attention_ref(q, k, v, valid),
                                       TOL["decode_attention"][dt]))
            for r in ranks:
                got = torch.from_numpy(r["decode"][str(dt)]["outs"][i]).cuda()
                errs.append(max_err(got, want.float(), TOL["decode_attention"][dt]))
        decode[str(dt)] = {"max_abs_err_vs_kernel": max(errs),
                           "kernel_max_abs_err_vs_plain": max(kernel_errs),
                           "ms": [r["decode"][str(dt)]["ms"] for r in ranks],
                           "slots_a_rank": ranks[0]["decode"][str(dt)]["slots"]}
        del q, k, v

    counts = {m: sum(c[m] for r in ranks for c in r["counts"]) for m in ranks[0]["counts"][0]}
    res = {"card": card_line(), "ranks": 4, "mesh": {"pod": 2, "data": 2, "model": 1},
           "backend": "gloo", "n_layers": cfg.n_layers, "batch": B, "seq": S,
           "rows_a_rank": B // 4,
           "counts": counts, "counted_steps_a_rank": len(ranks[0]["counts"]),
           "step_ms": [r["step_ms"] for r in ranks], "sync_ms": [r["sync_ms"] for r in ranks],
           "update_ms": [r["update_ms"] for r in ranks],
           "gather_ms": [r["gather_ms"] for r in ranks], "losses": ranks[0]["losses"],
           "compressed_step": [r["compressed_step"] for r in ranks],
           "peak_gib_a_rank_steps": [r["peak_gib_steps"] for r in ranks],
           "peak_gib_a_rank_with_checks": [r["peak_gib_checks"] for r in ranks],
           "grad_err_vs_single_process": [r["grad_err_vs_single_process"] for r in ranks],
           "compressed_vs_plain": [r["compressed_vs_plain"] for r in ranks],
           "residual": [r["residual"] for r in ranks],
           "sharded_leaves": ranks[0]["sharded_leaves"],
           "save_s": ranks[0]["save_s"], "restore_data4_s": [r["restore_s"] for r in ranks],
           "restore_one_device_s": one_device_s, "checkpoint_leaves": len(crcs),
           "world_s": world_s, "phase_s": time.perf_counter() - phase_t0, "decode": decode}
    print(f"[multi] {res['card']}; step ms {res['step_ms']}; sync ms {res['sync_ms']}; "
          f"gather ms {res['gather_ms']}; peak GiB a rank {res['peak_gib_a_rank_steps']}; "
          f"world {world_s:.1f} s")
    return res


def phase_multi(kernel_modules) -> dict:
    """``multi_parts`` alone in its world."""
    return run_worlds({"multi": multi_parts(kernel_modules)})["multi"]


def only_multi(gen, ops, ref, rate) -> list:
    from repro_torch.kernels import KERNEL_MODULES

    return [{"multi": phase_multi(KERNEL_MODULES)}]


def worlds_rank(rank: int, world: int, init: str, jobs: dict) -> dict:
    """One rank of the phases that share a spawned world (``run_worlds``):
    each phase's rank body in turn, by name, the card's cache emptied
    between them."""
    out = {}
    for name, (fn, args) in jobs.items():
        out[name] = fn(rank, world, init, *args)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_worlds(parts: dict) -> dict:
    """Run the 4-rank phases ``parts`` (name -> a generator such as
    ``multi_parts``) in one spawned world: each phase's parent side up to its
    rank job, then one ``mesh.run_ranks`` of ``worlds_rank`` over the jobs
    (a timeout of the phases' timeouts summed), then each phase's parent
    side with its ranks' results.  One world spares each further phase its
    ranks' start: the processes, the card's contexts, the kernels' library
    and the first step's imports.  Returns each phase's result by name."""
    from repro_torch.launch.mesh import run_ranks

    jobs = {name: next(part) for name, part in parts.items()}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as where:
        t0 = time.perf_counter()
        ranks = run_ranks(worlds_rank, 4, {name: (fn, args) for name, (fn, args, _) in
                                           jobs.items()},
                          init_method=f"file://{where}/rendezvous",
                          timeout=sum(timeout for _, _, timeout in jobs.values()))
        world_s = time.perf_counter() - t0
    out = {}
    for name, part in parts.items():
        try:
            part.send(([r[name] for r in ranks], world_s))
        except StopIteration as done:
            out[name] = done.value
        else:
            raise RuntimeError(f"phase {name} took more than one world")
    return out


# --------------------------------------------------------------------- tp
#: phase_tp: 4 gloo ranks sharing the card, tensor parallelism over the model
#: axis: qwen1.5-0.5b at full width and depth on the train phase's batch,
#: (data, model, steps) meshes; deepseek-v2-lite-16b at DEEPSEEK_TRAIN's 4
#: layers and batch over data 2 x model 2 (experts over the model axis, MoE
#: over the data axis), one step
TP = dict(qwen=((2, 2, 3), (1, 4, 1)), deepseek=(2, 2, 1), collective_timeout=300.0,
          world_timeout=600.0)
#: a rank's loss (the mean over its data ranks) against the single-process
#: step's on the same batch, bf16 (the products' partial sums are rounded in
#: another order), and the MoE aux loss relative to the single-process
#: step's: about 5x and 4x the largest gaps read on the H100 (loss 1.9e-4 for
#: qwen1.5-0.5b at data 2 x model 2, 1.4e-4 at data 1 x model 4, 4.8e-6 for
#: deepseek-v2-lite-16b; aux 4.7e-5 relative)
TP_LOSS_TOL = 1e-3
TP_AUX_TOL = 2e-4
#: the shard shapes of phase_tp's runs: rmsnorm (rows, D); SwiGLU (rows, D,
#: F / model): qwen's at model 2 and 4, deepseek's layer0 and shared experts
#: at model 2 and 4; flash (B, Hq, Hkv, S, hd, hdv): qwen's 8 and 4 heads a
#: rank, MLA's 8 and 4
TP_RMSNORM = ((2048, 1024), (2048, 2048), (2048, 512))
TP_SWIGLU = ((2048, 1024, 1408), (4096, 1024, 704), (2048, 2048, 5472), (2048, 2048, 2736),
             (2048, 2048, 1408), (2048, 2048, 704))
TP_FLASH = ((4, 8, 8, 512, 64, 64), (8, 4, 4, 512, 64, 64), (1, 8, 8, 2048, 192, 128),
            (1, 4, 4, 2048, 192, 128))
#: phase_tp's serving over the model axis: qwen1.5-0.5b at full width and depth
#: over each of TP["qwen"]'s meshes and deepseek-v2-lite-16b at DEEPSEEK_TRAIN's
#: 4 layers over TP["deepseek"]'s, bf16, weights of seed 0 (the single process's):
#: 8 requests, one prefill of the 16-token prompt, then the prompt and 16 greedy
#: tokens of the single process fed through decode_step (teacher-forced), into a
#: cache of 32 slots (16 a rank at model 2, 8 at model 4; every rank's slots
#: fill in turn).  A decode step of 4 gloo ranks on one card takes 146-694 ms
#: (qwen 1 x 4 the most), so the steps are what the script's time allows
TP_SERVE = dict(requests=8, prompt=16, new=16, cache=32)
#: launches a TP decode step a rank: qwen 2 norms a layer and the final one, the
#: SwiGLU on F / model and the partial decode attention (route split) a layer;
#: deepseek layer0's and the 3 MoE layers' 3 norms (kv_ln among them), layer0's
#: SwiGLU and the shared experts' (MLA's attention: plain products)
TP_SERVE_PER_STEP = {"qwen": {"rmsnorm": 2 * 24 + 1, "swiglu": 24, "decode_attention": 24},
                     "deepseek": {"rmsnorm": 3 * 4 + 1, "swiglu": 4}}
TP_SERVE_ROUTES = {"decode_attention": "split"}
#: the largest gap of a TP rank's logits from the single process's on the card
#: (teacher-forced, bf16), relative to the single process's largest logit:
#: about 2x the largest read on the H100 (0.0240 qwen 2 x 2, 0.0226 1 x 4,
#: 0.0167 deepseek over 49 steps of a prompt of 32); a merge that drops or
#: double-counts a rank's slots moves the logits by a whole part of their size
TP_LOGIT_TOL = 0.05
#: the shard shapes of phase_tp's serving: rmsnorm (rows, D) and SwiGLU (rows, D,
#: F / model) of the decode steps (4 or 8 rows a rank) and the prefills (64 or
#: 128 rows); flash (B, Hq, Hkv, S, hd, hdv) of the prefills; the decode
#: kernel's partial mode (B, Hq, Hkv, slots a rank, hd) at qwen's 2 x 2 and 1 x 4
TP_SERVE_RMSNORM = ((4, 1024), (8, 1024), (64, 1024), (128, 1024), (4, 2048), (4, 512),
                    (64, 2048), (64, 512))
TP_SERVE_SWIGLU = ((4, 1024, 1408), (8, 1024, 704), (64, 1024, 1408), (128, 1024, 704),
                   (4, 2048, 5472), (4, 2048, 1408), (64, 2048, 5472), (64, 2048, 1408))
TP_SERVE_FLASH = ((4, 8, 8, 16, 64, 64), (8, 4, 4, 16, 64, 64), (4, 8, 8, 16, 192, 128))
TP_PARTIAL = ((4, 16, 16, 16, 64), (8, 16, 16, 8, 64))


def tp_flash_shapes() -> list:
    """TP_FLASH and TP_SERVE_FLASH in ``flash_shapes``' form (causal, no
    window; MLA's widths held to the plain versions rounded as the tensor-core
    route rounds)."""
    return [(B, Hq, Hkv, S, S, hd, hdv, True, 0, (hd, hdv) != (64, 64))
            for B, Hq, Hkv, S, hd, hdv in (*TP_FLASH, *TP_SERVE_FLASH)]


def check_tp_kernels(gen, ops, ref, rate) -> dict:
    """The shard shapes of phase_tp (TP_RMSNORM, TP_SWIGLU, TP_FLASH) in bf16:
    the forward within ``TOL`` of the plain version, the gradients of the
    wrapper (its backward kernel) within ``GRAD_TOL`` of the plain backward's
    largest entry, each route recorded; flash also in fp32 with its routes
    asserted (``check_flash_at``).  Times by CUDA events beside the plain
    version's, the library call's (``F.rms_norm``, three ``@``, SDPA) and the
    bound.  Returns each kernel's rows by shape."""
    from repro_torch.kernels import rmsnorm as kr
    from repro_torch.kernels import rmsnorm_bwd as krb
    from repro_torch.kernels import swiglu as ks
    from repro_torch.kernels import swiglu_bwd as ksb

    dt = torch.bfloat16
    out = {k: [] for k in ("rmsnorm", "rmsnorm_bwd", "swiglu_mlp", "swiglu_mlp_bwd",
                           "flash_attention", "flash_attention_bwd")}
    for rows, D in TP_RMSNORM:
        sets = [(randn(gen, (rows, D), dt), randn(gen, (D,), dt), randn(gen, (rows, D), dt))
                for _ in range(2)]
        x, g, dy = sets[0]
        err = max_err(ops.rmsnorm(x, g), ref.rmsnorm_ref(x, g), TOL["rmsnorm"][dt])
        leaves = [x.clone().requires_grad_(), g.clone().requires_grad_()]
        got = torch.autograd.grad(ops.rmsnorm(*leaves), leaves, dy)
        gerr = max(rel_err(a, b, GRAD_TOL[dt])[1]
                   for a, b in zip(got, ref.rmsnorm_bwd_ref(x, g, dy)))
        fwd_sets = [s[:2] for s in sets]
        b_ms, b_by = bound((2 * rows * D + D) * 2, 4 * rows * D, dt, rate)
        out["rmsnorm"].append({
            "shape": [rows, D], "route": kr.route(x, g), "max_abs_err": err,
            "ms": time_ms(ops.rmsnorm, fwd_sets, 20), "plain_ms": time_ms(ref.rmsnorm_ref,
                                                                          fwd_sets, 10),
            "library_ms": time_ms(lambda x, g: F.rms_norm(x, (D,), g, 1e-5), fwd_sets, 20),
            "bound_ms": b_ms, "bound_by": b_by})
        b_ms, b_by = bound((3 * rows * D + 2 * D) * 2, 8 * rows * D, dt, rate)
        bwd, both = grad_ms(ops.rmsnorm, (x, g), dy, 10)
        out["rmsnorm_bwd"].append({
            "shape": [rows, D], "route": krb.route(x, g, dy), "max_rel_err": gerr, "ms": bwd,
            "fwd_bwd_ms": both, "plain_ms": time_ms(ref.rmsnorm_bwd_ref, sets, 10),
            "library_fwd_bwd_ms": grad_ms(lambda x, g: F.rms_norm(x, (D,), g, 1e-5), (x, g),
                                          dy, 10)[1],
            "bound_ms": b_ms, "bound_by": b_by})
        del sets, x, g, dy, leaves, got
    for N, D, Fd in TP_SWIGLU:
        sets = [(randn(gen, (N, D), dt), randn(gen, (D, Fd), dt, D ** -0.5),
                 randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (Fd, D), dt, Fd ** -0.5))
                for _ in range(2)]
        x, wg, wu, wd = sets[0]
        dy = randn(gen, (N, D), dt)
        err = max_err(ops.swiglu_mlp(*sets[0]), ref.swiglu_ref(*sets[0]), TOL["swiglu_mlp"][dt])
        leaves = [t.clone().requires_grad_() for t in sets[0]]
        before = dict(ksb.route_launches)
        got = torch.autograd.grad(ops.swiglu_mlp(*leaves), leaves, dy)
        bwd_route = [r for r, n in ksb.route_launches.items() if n != before[r]]
        gerr = max(rel_err(a, b, GRAD_TOL[dt])[1]
                   for a, b in zip(got, ref.swiglu_bwd_ref(x, wg, wu, wd, dy)))
        b_ms, b_by = bound((2 * N * D + 3 * D * Fd) * 2, 6 * N * D * Fd + 4 * N * Fd, dt, rate)
        out["swiglu_mlp"].append({
            "shape": [N, D, Fd], "route": ks.route(*sets[0]), "max_abs_err": err,
            "ms": time_ms(ops.swiglu_mlp, sets, 5), "plain_ms": time_ms(ref.swiglu_ref, sets, 3),
            "library_ms": time_ms(_swiglu_lib, sets, 5), "bound_ms": b_ms, "bound_by": b_by})
        b_ms, b_by = bound((3 * N * D + 6 * D * Fd) * 2, 12 * N * D * Fd + 8 * N * Fd, dt, rate)
        bwd, both = grad_ms(ops.swiglu_mlp, sets[0], dy, 5)
        out["swiglu_mlp_bwd"].append({
            "shape": [N, D, Fd], "route": bwd_route, "max_rel_err": gerr, "ms": bwd,
            "fwd_bwd_ms": both,
            "plain_ms": time_ms(lambda *a: ref.swiglu_bwd_ref(*a, dy), sets, 3),
            "library_fwd_bwd_ms": grad_ms(_swiglu_lib, sets[0], dy, 5)[1],
            "bound_ms": b_ms, "bound_by": b_by})
        del sets, x, wg, wu, wd, dy, leaves, got
    for rows, D in TP_SERVE_RMSNORM:
        sets = [(randn(gen, (rows, D), dt), randn(gen, (D,), dt)) for _ in range(8)]
        b_ms, b_by = bound((2 * rows * D + D) * 2, 4 * rows * D, dt, rate)
        out["rmsnorm"].append({
            "shape": [rows, D], "serving": True, "route": kr.route(*sets[0]),
            "max_abs_err": max_err(ops.rmsnorm(*sets[0]), ref.rmsnorm_ref(*sets[0]),
                                   TOL["rmsnorm"][dt]),
            "ms": time_ms(ops.rmsnorm, sets, 10), "plain_ms": time_ms(ref.rmsnorm_ref, sets, 5),
            "library_ms": time_ms(lambda x, g: F.rms_norm(x, (D,), g, 1e-5), sets, 10),
            "bound_ms": b_ms, "bound_by": b_by})
    for N, D, Fd in TP_SERVE_SWIGLU:
        sets = [(randn(gen, (N, D), dt), randn(gen, (D, Fd), dt, D ** -0.5),
                 randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (Fd, D), dt, Fd ** -0.5))
                for _ in range(4)]
        b_ms, b_by = bound((2 * N * D + 3 * D * Fd) * 2, 6 * N * D * Fd + 4 * N * Fd, dt, rate)
        out["swiglu_mlp"].append({
            "shape": [N, D, Fd], "serving": True, "route": ks.route(*sets[0]),
            "max_abs_err": max_err(ops.swiglu_mlp(*sets[0]), ref.swiglu_ref(*sets[0]),
                                   TOL["swiglu_mlp"][dt]),
            "ms": time_ms(ops.swiglu_mlp, sets, 5), "plain_ms": time_ms(ref.swiglu_ref, sets, 3),
            "library_ms": time_ms(_swiglu_lib, sets, 5), "bound_ms": b_ms, "bound_by": b_by})
        del sets
    errs, gerrs = check_flash_at(gen, ref, tp_flash_shapes())
    for B, Hq, Hkv, S, hd, hdv in TP_FLASH:
        fwd, bwd = flash_times(gen, ops, ref, rate, B, Hq, Hkv, S, hd, 0, hdv=hdv)
        key = (B, Hq, Hkv, S, S, hd, hdv, True, 0, "bfloat16")
        out["flash_attention"].append({"shape": [B, Hq, Hkv, S, hd, hdv],
                                       "max_abs_err": errs[key], **fwd})
        out["flash_attention_bwd"].append({"shape": [B, Hq, Hkv, S, hd, hdv],
                                           "max_abs_err": gerrs[key], **bwd})
    for B, Hq, Hkv, S, hd, hdv in TP_SERVE_FLASH:
        out["flash_attention"].append({
            "shape": [B, Hq, Hkv, S, hd, hdv], "serving": True,
            "max_abs_err": errs[(B, Hq, Hkv, S, S, hd, hdv, True, 0, "bfloat16")]})
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tp] shard-shape kernel checks {json.dumps(out)}")
    return out


def tp_checked_shapes() -> dict:
    """``checked_shapes`` and phase_tp's shard shapes."""
    covered = checked_shapes()
    covered["rmsnorm"] |= set(TP_RMSNORM) | set(TP_SERVE_RMSNORM)
    covered["swiglu_mlp"] |= set(TP_SWIGLU) | set(TP_SERVE_SWIGLU)
    covered["flash_attention"] |= {flash_key(*s[:9], 0) for s in tp_flash_shapes()}
    covered["decode_attention_partial"] = set(TP_PARTIAL)
    return covered


@contextlib.contextmanager
def tp_routes(choices: list | None):
    """Record every ``layers.moe_route`` call; with ``choices``, route each
    through the next one (``replayed_routes``' replay)."""
    from repro_torch.models import layers

    route, seen = layers.moe_route, []
    pending = None if choices is None else list(choices)

    def call(*args, **kwargs):
        if pending is not None:
            kwargs["choice"] = pending.pop(0)
        seen.append(route(*args, **kwargs))
        return seen[-1]

    layers.moe_route = call
    try:
        yield seen, pending
    finally:
        layers.moe_route = route


def rank_local_aux(routes) -> float:
    """The aux loss of ``routes`` (``MoERoute`` s, summed over the layers)
    from the means of this rank's rows alone: what a port that ignores the
    data axis would report (the parent averages it over the data ranks)."""
    total = 0.0
    for r in routes:
        counts = torch.zeros_like(r.probs).scatter_(1, r.idx, 1.0)
        E, k = r.probs.shape[-1], r.idx.shape[1]
        total += float(E * (r.probs.mean(0) * counts.mean(0) / k).sum())
    return total


def _tp_ref_errors(synced, layout, mesh, path: Path) -> float:
    """The largest error of this rank's synced gradient shards against their
    slices of the single-process gradient at ``path``, each over the whole
    leaf's largest entry (the gathered gradient's check, shard by shard)."""
    from repro_torch.parallel import NamedSharding
    from repro_torch.models import params as PM

    ref_grads = torch.load(path, map_location="cpu", mmap=True)
    worst = 0.0
    for g, r, info in zip(PM.tree_leaves(synced), PM.tree_leaves(ref_grads),
                          PM.tree_leaves(layout)):
        part = r[NamedSharding(mesh, PM.keep_axes(info.spec, ("model",))).index(r.shape)]
        scale = float(r.float().abs().max())
        err = float((g.float() - part.cuda().float()).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def tp_run(kernel_modules, mesh, cfg, batch: dict, steps: int, work: str, tag: str,
           per_step: dict, choices=None, keep: bool = False) -> dict:
    """One model on ``mesh`` (``tp_rank``): ``steps`` steps of
    ``make_train_step(model, opt_cfg, mesh)``, the first in its parts, the
    launch counts and routes checked a step, every launch at a checked shape;
    after step 1 the synced gradient and the loss against the parent's
    single-process step (``ref_<tag>.pt``, ``ref_<tag>.json``); with
    ``choices`` each MoE layer routed through the parent's experts (the
    rank's own routing of the same rows compared first); at the end every
    replicated leaf bit-equal across the ranks.  With ``keep`` the result
    holds ``(model, step, params, opt)`` as ``state``."""
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train import AdamWConfig, make_train_step

    model = build_model(cfg, model_axis=mesh.shape["model"], mesh=mesh, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    layout = model.layout()
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=10), mesh)
    opt = step.init_opt_state(params)
    want = json.loads((Path(work) / f"ref_{tag}.json").read_text())
    rows = step.rows(batch)
    rec = {"coords": dict(mesh.coords), "losses": [], "step_ms": [], "tp_ms": [], "sync_ms": [],
           "update_ms": [], "gather_ms": [], "counts": [], "shapes": {}}
    L = cfg.n_layers - (1 if cfg.moe is not None and cfg.moe.first_dense else 0)
    if choices is not None:
        # the rank's own routing of its rows, against the parent's
        with torch.no_grad(), tp_routes(None) as (seen, _), model.rows_split(step.dp_axes):
            model.loss(params, rows)
        # as sets of experts: an order swapped inside the top k routes the same
        gaps, differ = [], 0
        for own, theirs in zip(seen[:L], choices[:L]):
            moved = (own.idx.sort(-1).values.cpu() != theirs.sort(-1).values).any(-1)
            differ += int(moved.sum())
            if moved.any():
                top = own.probs.sort(-1, descending=True).values.cpu()
                k = own.idx.shape[1]
                gaps.append(float((top[moved, k - 1] - top[moved, k]).max()))
        rec["own_routing"] = {"tokens_differing": differ, "tokens": L * own.idx.shape[0],
                              "largest_kth_gap": max(gaps, default=0)}
        del seen
    torch.cuda.reset_peak_memory_stats()
    mesh.timed = True
    for i in range(steps):
        reset_counts(kernel_modules)
        mesh.spent.clear()
        with launched_shapes() as shapes, tp_routes(choices if i == 0 else None) as (seen,
                                                                                   pending):
            t0 = _clock()
            if i == 0:
                loss, metrics, grads = step.grads(params, batch)
                t1 = _clock()
                synced = step.sync(grads)
                t2 = _clock()
                del grads
                params, opt, m = step.update(synced, opt, params)
                m = {**m, **{k: step.mean_over_ranks(v) for k, v in metrics.items()},
                     "loss": step.mean_over_ranks(loss)}
                times = {"sync_ms": (t2 - t1) * 1e3, **step.times}
            else:
                params, opt, m = step(params, opt, batch)
                times = step.times
            rec["step_ms"].append((_clock() - t0) * 1e3)
        if pending:
            raise AssertionError(f"{tag} rank {mesh.rank}: {len(pending)} routes not replayed")
        counts, routes = read_counts(kernel_modules)
        expect_counts(counts, per_step, f"{tag} rank {mesh.rank} step {i + 1}")
        check_routes(routes, counts, TRAIN_ROUTES, f"{tag} rank {mesh.rank} step {i + 1}")
        rec["counts"].append(counts)
        for kernel, seen_shapes in shapes.items():
            rec["shapes"].setdefault(kernel, set()).update(seen_shapes)
        rec["losses"].append(float(m["loss"]))
        rec["tp_ms"].append(mesh.spent.get(("model",), 0.0) * 1e3)
        for key in ("sync_ms", "update_ms", "gather_ms"):
            rec[key].append(times[key])
        if i == 0:
            rec["grad_err_vs_single_process"] = _tp_ref_errors(synced, layout, mesh,
                                                               Path(work) / f"ref_{tag}.pt")
            del synced
            if not rec["grad_err_vs_single_process"] <= GRAD_TOL[torch.bfloat16]:
                raise AssertionError(f"{tag} rank {mesh.rank}: gradient "
                                     f"{rec['grad_err_vs_single_process']} of the largest "
                                     "entry from the single-process gradient")
            if not abs(rec["losses"][0] - want["loss"]) <= TP_LOSS_TOL:
                raise AssertionError(f"{tag} rank {mesh.rank}: loss {rec['losses'][0]}, the "
                                     f"single process {want['loss']}")
            if cfg.moe is not None:
                rec["aux"] = float(m["aux"])
                rec["dropped"] = [int((~r.keep).sum()) for r in seen[:L]]
                rec["aux_rank_local"] = rank_local_aux(seen[:L])
                if not abs(rec["aux"] - want["aux"]) <= TP_AUX_TOL * abs(want["aux"]):
                    raise AssertionError(f"{tag} rank {mesh.rank}: aux {rec['aux']}, the "
                                         f"single process {want['aux']}")
        del seen
    mesh.timed = False
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in rec["losses"]):
        raise AssertionError(f"{tag} rank {mesh.rank}: losses {rec['losses']}")
    # every replicated leaf equal on every rank, bit for bit
    shs = PM.tree_leaves(step.param_shardings())
    crcs = torch.tensor([_crc(t) for t, sh in zip(PM.tree_leaves(params), shs)
                         if "model" not in sh.axes()], dtype=torch.int64)
    every = mesh.all_gather(crcs, mesh.axis_names)
    if not all(torch.equal(c, crcs) for c in every):
        raise AssertionError(f"{tag} rank {mesh.rank}: replicated leaves differ across ranks")
    rec["replicated_leaves"] = len(crcs)
    rec["sharded_leaves"] = len(shs) - len(crcs)
    if keep:
        rec["state"] = (model, step, params, opt)
    del params, opt, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tp_checkpoint(state: tuple, tall, cfg, work: str) -> dict:
    """The ZeRO + TP state of a ``tp_run`` saved whole (every rank gathers,
    rank 0 writes) and restored at the mesh ``tall`` (data 1 x model 4) on
    the same ranks: every restored shard equal to its slice of the gathered
    leaf.  Returns the seconds and, on rank 0, every gathered leaf's CRC."""
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train import AdamWConfig, CheckpointManager, make_train_step

    model, step, params, opt = state
    sh = {"params": step.param_shardings(), "opt": step.shardings}
    ckpt = CheckpointManager(str(Path(work) / "ckpt"), keep=1)
    t0 = time.perf_counter()
    ckpt.save(int(opt["count"]), params, opt, shardings=sh, mesh_shape=dict(step.mesh.shape))
    save_s = time.perf_counter() - t0
    tall_step = make_train_step(build_model(cfg, model_axis=tall.shape["model"], mesh=tall,
                                            device="cuda"), AdamWConfig(), tall)
    tall_sh = {"params": tall_step.param_shardings(), "opt": tall_step.shardings}
    t0 = time.perf_counter()
    _, p_b, o_b, _ = ckpt.restore(template={"params": params, "opt": opt}, shardings=tall_sh)
    restore_s = time.perf_counter() - t0
    crcs = []
    for mine, s, got, ts in zip(PM.tree_leaves({"params": params, "opt": opt}),
                                PM.tree_leaves(sh), PM.tree_leaves({"params": p_b, "opt": o_b}),
                                PM.tree_leaves(tall_sh)):
        whole = s.gather(mine)
        if not torch.equal(got, ts.shard(whole)):
            raise AssertionError(f"rank {step.mesh.rank}: a leaf restored at data 1 x model 4 "
                                 "differs from its slice of the saved state")
        if step.mesh.rank == 0:
            crcs.append(_crc(whole))
    return {"step": int(opt["count"]), "save_s": save_s, "restore_s": restore_s, "crcs": crcs,
            "sharded_opt_leaves": sum("model" in s.axes() and "data" in s.axes()
                                      for s in PM.tree_leaves(sh["opt"]["mu"]))}


def tp_serve_run(kernel_modules, mesh, cfg, work: str, tag: str, per_step: dict) -> dict:
    """Serving over the model axis on one rank (``tp_rank``): the model built
    over ``mesh`` with the single process's weights (seed 0), one ``prefill`` of
    this rank's rows of the prompts, then the single process's tokens fed
    through ``decode_step`` (teacher-forced: a flipped token does not
    cascade) from an empty cache of TP_SERVE["cache"] slots, inside
    ``rows_split`` over ``data``; an MoE layer routed through the single
    process's experts (``serve_<tag>.pt``).  Each decode step's launches and
    routes checked (``per_step``); each step's logits against the single
    process's: the largest gap relative to its largest logit (within
    TP_LOGIT_TOL) and the greedy tokens equal, but where the single
    process's top two lie within that step's gap (counted).  Host times of
    the prefill and of each decode step (a synchronize around it) and the
    ``model`` axis's collectives inside them (``Mesh.timed``): one card's
    ``gloo`` ranks, not a deployment's."""
    from repro_torch.models import build_model

    ref_run = torch.load(Path(work) / f"serve_{tag}.pt", map_location="cpu", mmap=True)
    model = build_model(cfg, model_axis=mesh.shape["model"], mesh=mesh, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    tokens = ref_run["tokens"].cuda()
    B, L = tokens.shape
    n = B // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
    choices = None
    if ref_run["routes"]:
        choices = []
        for c in ref_run["routes"]:
            part = c.shape[0] // mesh.shape["data"]
            choices.append(c[mesh.coords["data"] * part:(mesh.coords["data"] + 1) * part])
    rec = {"coords": dict(mesh.coords), "gaps": [], "near_ties": 0, "tokens_compared": 0,
           "decode_ms": [], "decode_tp_ms": [], "counts": [], "shapes": {}}

    def compare(logits, want, what):
        want = want.cuda()
        top = float(want.abs().max())
        gap = float((logits - want).abs().max())
        rec["gaps"].append(gap / top)
        if not gap / top <= TP_LOGIT_TOL:
            raise AssertionError(f"{tag} rank {mesh.rank} {what}: logits {gap / top} of the "
                                 f"largest logit from the single process's")
        mine, theirs = logits.argmax(-1), want.argmax(-1)
        rec["tokens_compared"] += mine.numel()
        for i in (mine != theirs).nonzero().tolist():
            two = want[tuple(i)].topk(2).values
            if float(two[0] - two[1]) > gap:
                raise AssertionError(f"{tag} rank {mesh.rank} {what}: greedy token "
                                     f"{int(mine[tuple(i)])}, the single process "
                                     f"{int(theirs[tuple(i)])}, whose top two lie "
                                     f"{float(two[0] - two[1])} apart (gap {gap})")
            rec["near_ties"] += 1

    axes = ("data",) if mesh.shape["data"] > 1 else ()
    mesh.timed = True
    with model.rows_split(axes), tp_routes(choices) as (_, pending), \
            launched_shapes() as shapes:
        mesh.spent.clear()
        t0 = _clock()
        logits = model.prefill(params, {"tokens": tokens[rows, :TP_SERVE["prompt"]]})
        rec["prefill_ms"] = (_clock() - t0) * 1e3
        rec["prefill_tp_ms"] = mesh.spent.get(("model",), 0.0) * 1e3
        compare(logits[:, 0], ref_run["prefill"][rows], "prefill")
        cache = model.init_cache(B, TP_SERVE["cache"])
        for t in range(L):
            reset_counts(kernel_modules)
            mesh.spent.clear()
            t0 = _clock()
            logits, cache = model.decode_step(params, {"tokens": tokens[rows, t:t + 1],
                                                       "cache": cache, "index": t})
            rec["decode_ms"].append((_clock() - t0) * 1e3)
            rec["decode_tp_ms"].append(mesh.spent.get(("model",), 0.0) * 1e3)
            counts, routes = read_counts(kernel_modules)
            expect_counts(counts, per_step, f"{tag} serve rank {mesh.rank} step {t}")
            check_routes(routes, counts, TP_SERVE_ROUTES, f"{tag} serve rank {mesh.rank} step {t}")
            rec["counts"].append(counts)
            compare(logits[:, 0], ref_run["logits"][t, rows], f"step {t}")
    mesh.timed = False
    if pending:
        raise AssertionError(f"{tag} serve rank {mesh.rank}: {len(pending)} routes not replayed")
    rec["shapes"] = {k: set(v) for k, v in shapes.items()}
    top = cache["layers"]
    rec["cache_slots_a_rank"] = top["c_kv" if cfg.mla is not None else "k"].shape[
        2 if cfg.mla is not None else 3]
    del params, cache, model, top
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def tp_serve_reference(cfg, work: Path, tag: str) -> None:
    """The single process's serving run that the ranks are held to: the weights
    of seed 0 on the card, TP_SERVE's prompts (seeded), one ``prefill`` and
    the prompt then greedy tokens through ``decode_step``; every step's fp32
    logits, the token sequence and (for an MoE model) every ``moe_route``
    call's experts, written under ``work``.  Returns its decode ms a step."""
    from repro_torch.models import build_model

    model = build_model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    B, P, N = TP_SERVE["requests"], TP_SERVE["prompt"], TP_SERVE["new"]
    rng = np.random.default_rng(7)
    tokens = torch.zeros((B, P + N), dtype=torch.int64, device="cuda")
    tokens[:, :P] = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).cuda()
    steps, times = [], []
    with tp_routes(None) as (seen, _):
        prefill = model.prefill(params, {"tokens": tokens[:, :P]})[:, 0].cpu()
        cache = model.init_cache(B, TP_SERVE["cache"])
        for t in range(P + N):
            t0 = _clock()
            logits, cache = model.decode_step(params, {"tokens": tokens[:, t:t + 1],
                                                       "cache": cache, "index": t})
            times.append((_clock() - t0) * 1e3)
            if P <= t + 1 < P + N:
                tokens[:, t + 1] = logits[:, 0].argmax(-1)
            steps.append(logits[:, 0].cpu())
        routes = [r.idx.cpu() for r in seen]
    torch.save({"tokens": tokens.cpu(), "prefill": prefill, "logits": torch.stack(steps),
                "routes": routes}, work / f"serve_{tag}.pt")
    del model, params, cache, seen
    gc.collect()
    torch.cuda.empty_cache()
    return statistics.median(times[1:])


def tp_rank(rank: int, world: int, init: str, work: str, batches: dict) -> dict:
    """One of ``phase_tp``'s ranks: qwen1.5-0.5b over each of TP["qwen"]'s
    meshes, then deepseek-v2-lite-16b at 4 layers over data 2 x model 2,
    its MoE layers routed through the parent's experts (``tp_run``)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import KERNEL_MODULES, build
    from repro_torch.launch.mesh import make_test_mesh

    build.library()                  # the parent's build, found by its digest
    kw = dict(backend="gloo", timeout=TP["collective_timeout"])
    first = {} if torch.distributed.is_initialized() else dict(init_method=init, rank=rank)
    say = (lambda msg: print(f"[tp r0] {msg}", flush=True)) if rank == 0 else (lambda _: None)
    out = {"rank": rank}
    qwen = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16")
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in batches["qwen"].items()}
    state = None
    out["serve"] = {}
    for data, model, steps in TP["qwen"]:
        mesh = make_test_mesh(data=data, model=model, **kw, **first)
        first = {}
        tag = f"qwen_{data}x{model}"
        out[tag] = tp_run(KERNEL_MODULES, mesh, qwen, batch, steps, work, "qwen", TRAIN_PER_STEP,
                          keep=state is None)
        state = state or out[tag].pop("state")
        say(f"{tag}: steps {out[tag]['step_ms']} ms, TP {out[tag]['tp_ms']} ms, losses "
            f"{out[tag]['losses']}, peak {out[tag]['peak_gib']:.2f} GiB")
        serve_rank(out["serve"], tag, mesh, qwen, work, "qwen", say)
    # the first mesh's ZeRO + TP state, restored over the last (data 1 x model 4)
    out["checkpoint"] = tp_checkpoint(state, mesh, qwen, work)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    say(f"checkpoint saved in {out['checkpoint']['save_s']:.2f} s, restored at data 1 x model "
        f"4 in {out['checkpoint']['restore_s']:.2f} s")
    data, model, steps = TP["deepseek"]
    mesh = make_test_mesh(data=data, model=model, **kw)
    cfg = dataclasses.replace(ARCHS[DEEPSEEK], dtype="bfloat16",
                              n_layers=DEEPSEEK_TRAIN["layers"])
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in batches["deepseek"].items()}
    n = batch["tokens"].numel() // data
    part = slice(mesh.coords["data"] * n, (mesh.coords["data"] + 1) * n)
    choices = [c[part] for c in torch.load(Path(work) / "routes_deepseek.pt")]
    tag = f"deepseek_{data}x{model}"
    out[tag] = tp_run(KERNEL_MODULES, mesh, cfg, batch, steps, work, "deepseek",
                      DEEPSEEK_PER_STEP, choices)
    say(f"{tag}: steps {out[tag]['step_ms']} ms, TP {out[tag]['tp_ms']} ms, losses "
        f"{out[tag]['losses']}, peak {out[tag]['peak_gib']:.2f} GiB")
    serve_rank(out["serve"], tag, mesh, cfg, work, "deepseek", say)
    return out


def serve_rank(runs: dict, tag: str, mesh, cfg, work: str, ref_tag: str, say) -> None:
    """``tp_serve_run`` on ``mesh`` into ``runs[tag]``, reported by rank 0."""
    from repro_torch.kernels import KERNEL_MODULES

    t0 = time.perf_counter()
    rec = runs[tag] = tp_serve_run(KERNEL_MODULES, mesh, cfg, work, ref_tag,
                                   TP_SERVE_PER_STEP[ref_tag])
    rec["run_s"] = time.perf_counter() - t0
    say(f"serve {tag}: prefill {rec['prefill_ms']:.1f} ms (TP {rec['prefill_tp_ms']:.1f}), "
        f"decode median {statistics.median(rec['decode_ms'][1:]):.1f} ms a step (TP "
        f"{statistics.median(rec['decode_tp_ms'][1:]):.1f}), largest logit gap "
        f"{max(rec['gaps']):.3e}, near-ties {rec['near_ties']} of {rec['tokens_compared']}, "
        f"{rec['run_s']:.1f} s (one card's gloo ranks)")


def tp_reference(cfg, batch: dict, work: Path, tag: str) -> None:
    """The single-process step's loss, aux, gradient and (for an MoE model)
    every ``moe_route`` call's experts and each MoE layer's dropped pairs, on
    the whole batch, written under ``work`` for the ranks."""
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train.step import _grads

    model = build_model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    with tp_routes(None) as (seen, _):
        loss, metrics, grads = _grads(model, params, batch)
    torch.save(PM.tree_map(lambda g: g.cpu(), grads), work / f"ref_{tag}.pt")
    L = cfg.n_layers - (1 if cfg.moe is not None and cfg.moe.first_dense else 0)
    if seen:
        torch.save([r.idx.cpu() for r in seen], work / f"routes_{tag}.pt")
    (work / f"ref_{tag}.json").write_text(json.dumps({
        "loss": float(loss), "aux": float(metrics["aux"]),
        "dropped": [int((~r.keep).sum()) for r in seen[:L]]}))
    del model, params, grads, seen
    gc.collect()
    torch.cuda.empty_cache()


def tp_parts(kernel_modules, gen=None, ops=None, ref=None, rate=None):
    """``phase_tp`` in the form ``run_worlds`` drives (as ``multi_parts``).

    4 ranks on the card over ``gloo`` (``tp_rank``), tensor parallelism:
    qwen1.5-0.5b in bf16 at full width and depth on the train phase's batch
    (8 x 512, read through the stripe store) over data 2 x model 2 (3 steps)
    and data 1 x model 4 (one step), the first mesh's ZeRO + TP state saved and
    restored at the second (``tp_checkpoint``) and onto the one device here
    (every leaf's CRC equal), then deepseek-v2-lite-16b at 4 layers on
    DEEPSEEK_TRAIN's batch (2 x 2048, its own corpus) over data 2 x model 2,
    one step: experts over the model axis, MoE over the data axis, every MoE
    layer routed through the single-process step's experts (the ranks' own
    routing compared and reported).  The parent first checks the kernels at
    the shard shapes (``check_tp_kernels``, with ``gen``, ``ops``, ``ref``
    and ``rate``) and takes each model's single-process step on the whole
    batch (``tp_reference``); the dropped pairs summed over the data ranks
    must equal its, and every launch of the ranks lie at a checked shape."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenDatasetSpec
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.train import CheckpointManager

    phase_t0 = time.perf_counter()
    kernel_rows = check_tp_kernels(gen, ops, ref, rate) if gen is not None else None
    qwen = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16")
    deepseek = dataclasses.replace(ARCHS[DEEPSEEK], dtype="bfloat16",
                                   n_layers=DEEPSEEK_TRAIN["layers"])
    (ROOT / "build").mkdir(exist_ok=True)
    batches, serve_ref_ms = {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as data_root:
        for name, cfg, (B, S) in (("qwen", qwen, (TRAIN["batch"], TRAIN["seq"])),
                                  ("deepseek", deepseek, (DEEPSEEK_TRAIN["batch"],
                                                          DEEPSEEK_TRAIN["seq"]))):
            spec = TokenDatasetSpec(f"tp-{name}", n_sequences=max(256, B * 32), seq_len=S,
                                    vocab=cfg.vocab, seed=0)
            tokens, labels = next(corpus_batches(spec, B, str(Path(data_root) / name)))
            batches[name] = {"tokens": tokens, "labels": labels}
            t0 = time.perf_counter()
            tp_reference(cfg, {k: torch.from_numpy(v).long().cuda()
                               for k, v in batches[name].items()}, Path(work), name)
            print(f"[tp] {name} single-process reference in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            t0 = time.perf_counter()
            serve_ref_ms[name] = tp_serve_reference(cfg, Path(work), name)
            print(f"[tp] {name} single-process serving reference in "
                  f"{time.perf_counter() - t0:.1f} s ({serve_ref_ms[name]:.1f} ms a decode step)",
                  flush=True)
        want = json.loads((Path(work) / "ref_deepseek.json").read_text())
        qwen_loss = json.loads((Path(work) / "ref_qwen.json").read_text())["loss"]
        ranks, world_s = yield tp_rank, (work, batches), TP["world_timeout"]
        # the checkpoint of the qwen data 2 x model 2 state whole onto the one device
        empty = lambda _: torch.empty(0, device="cuda")
        layout = build_model(qwen, device="meta").layout()
        template = {"params": PM.tree_map(empty, layout),
                    "opt": {"count": torch.empty(0, device="cuda"),
                            **{k: PM.tree_map(empty, layout) for k in ("master", "mu", "nu")}}}
        t0 = time.perf_counter()
        at, p, o, _ = CheckpointManager(str(Path(work) / "ckpt")).restore(template=template)
        one_device_s = time.perf_counter() - t0
        saved = ranks[0]["checkpoint"]
        crcs = [_crc(t) for t in PM.tree_leaves({"params": p, "opt": o})]
        if at != saved["step"] or crcs != saved["crcs"]:
            raise AssertionError(f"tp: restored onto one device at step {at}: "
                                 f"{sum(a != b for a, b in zip(crcs, saved['crcs']))} leaves "
                                 "differ from the gathered state")
        del p, o

    covered = tp_checked_shapes()
    runs = [k for k in ranks[0] if k not in ("rank", "checkpoint", "serve")]
    for r in ranks:
        for run in [r[k] for k in runs] + list(r["serve"].values()):
            for kernel, seen in run["shapes"].items():
                if not seen <= covered[kernel]:
                    raise AssertionError(f"tp {run['coords']}: {kernel} launched at "
                                         f"{sorted(seen - covered[kernel])}, which no kernel "
                                         "check covers")
    ds = [r for r in ranks if r["deepseek_2x2"]["coords"]["model"] == 0]
    dropped = [sum(r["deepseek_2x2"]["dropped"][i] for r in ds)
               for i in range(len(want["dropped"]))]
    if dropped != want["dropped"]:
        raise AssertionError(f"tp deepseek: dropped pairs {dropped} by layer over the data "
                             f"ranks, the single process {want['dropped']}")
    aux_local = statistics.fmean(r["deepseek_2x2"]["aux_rank_local"] for r in ds)
    if not abs(aux_local - want["aux"]) > TP_AUX_TOL * abs(want["aux"]):
        raise AssertionError(f"tp deepseek: the aux of rank-local means {aux_local} lies within "
                             f"TP_AUX_TOL of the single process's {want['aux']}: the aux check "
                             "cannot see a routing that ignores the data axis")
    counts = {m: sum(c[m] for r in ranks for run in runs for c in r[run]["counts"])
              for m in ranks[0][runs[0]]["counts"][0]}
    res = {"card": card_line(), "ranks": 4, "backend": "gloo", "counts": counts,
           "counted_steps_a_rank": sum(len(ranks[0][run]["counts"]) for run in runs),
           "world_s": world_s, "phase_s": time.perf_counter() - phase_t0,
           "dropped_by_layer": dropped, "aux_single_process": want["aux"],
           "aux_rank_local_means": aux_local,
           "aux_gaps_relative": {"global": abs(ranks[0]["deepseek_2x2"]["aux"] - want["aux"])
                                 / abs(want["aux"]),
                                 "rank_local": abs(aux_local - want["aux"]) / abs(want["aux"]),
                                 "limit": TP_AUX_TOL},
           "loss_single_process": {"qwen": qwen_loss, "deepseek": want["loss"]},
           "checkpoint": {"step": saved["step"], "leaves": len(saved["crcs"]),
                          "sharded_opt_leaves": saved["sharded_opt_leaves"],
                          "save_s": saved["save_s"],
                          "restore_data1_model4_s": [r["checkpoint"]["restore_s"]
                                                     for r in ranks],
                          "restore_one_device_s": one_device_s}}
    for run in runs:
        per = [r[run] for r in ranks]
        res[run] = {
            "mesh": {a: max(p["coords"][a] for p in per) + 1 for a in per[0]["coords"]},
            **{k: [p[k] for p in per] for k in ("step_ms", "tp_ms", "sync_ms", "update_ms",
                                                 "gather_ms", "peak_gib",
                                                 "grad_err_vs_single_process")},
            "losses": per[0]["losses"], "counts_a_step": per[0]["counts"][0],
            "replicated_leaves": per[0]["replicated_leaves"],
            "sharded_leaves": per[0]["sharded_leaves"]}
        for k in ("aux", "aux_rank_local", "own_routing"):
            if k in per[0]:
                res[run][k] = [p[k] for p in per]
    res["serve"] = tp_serve_summary(ranks, serve_ref_ms)
    if kernel_rows is not None:
        res["kernel_rows"] = kernel_rows
    print(f"[tp] {res['card']}; " + "; ".join(
        f"{run}: step ms {res[run]['step_ms']}, TP all-reduce ms {res[run]['tp_ms']}, sync ms "
        f"{res[run]['sync_ms']}, update ms {res[run]['update_ms']}, gather ms "
        f"{res[run]['gather_ms']}, peak GiB a rank {res[run]['peak_gib']}" for run in runs)
        + f"; world {world_s:.1f} s", flush=True)
    print(f"[tp] deepseek aux {ranks[0]['deepseek_2x2']['aux']}, the single process "
          f"{want['aux']}, of rank-local means {aux_local} (relative gaps "
          f"{res['aux_gaps_relative']})", flush=True)
    return res


def tp_serve_summary(ranks: list, ref_ms: dict) -> dict:
    """The serving runs of ``tp_rank`` across the ranks: each run's mesh, logit
    gaps against the single process (the largest a step over the ranks) and
    the limit, greedy tokens compared and near-ties, host ms of the prefill and
    of each decode step (median from the second) with the ``model`` axis's
    collectives inside them, a rank's launches a decode step; one card shared
    by 4 ``gloo`` ranks, so the times are not a deployment's."""
    out = {"note": "host ms on one card shared by 4 gloo ranks: collectives through host "
                   "memory, not a deployment's", "logit_gap_limit": TP_LOGIT_TOL,
           "single_process_decode_ms": ref_ms,
           "launches": {m: sum(c[m] for r in ranks for run in r["serve"].values()
                               for c in run["counts"])
                        for m in next(iter(ranks[0]["serve"].values()))["counts"][0]}}
    for tag in ranks[0]["serve"]:
        per = [r["serve"][tag] for r in ranks]
        out[tag] = {
            "mesh": {a: max(p["coords"][a] for p in per) + 1 for a in per[0]["coords"]},
            "cache_slots_a_rank": per[0]["cache_slots_a_rank"],
            "largest_logit_gap": max(max(p["gaps"]) for p in per),
            "logit_gap_by_step": [max(g) for g in zip(*(p["gaps"] for p in per))],
            "tokens_compared": sum(p["tokens_compared"] for p in per),
            "near_ties": sum(p["near_ties"] for p in per),
            "prefill_ms": [p["prefill_ms"] for p in per],
            "prefill_tp_ms": [p["prefill_tp_ms"] for p in per],
            "decode_ms_median": [statistics.median(p["decode_ms"][1:]) for p in per],
            "decode_tp_ms_median": [statistics.median(p["decode_tp_ms"][1:]) for p in per],
            "decode_steps": len(per[0]["decode_ms"]), "counts_a_step": per[0]["counts"][0],
            "run_s": [p["run_s"] for p in per]}
        print(f"[tp] serve {tag} {json.dumps(out[tag])}", flush=True)
    return out


def phase_tp(kernel_modules, gen=None, ops=None, ref=None, rate=None) -> dict:
    """``tp_parts`` alone in its world."""
    return run_worlds({"tp": tp_parts(kernel_modules, gen, ops, ref, rate)})["tp"]


def only_tp(gen, ops, ref, rate) -> list:
    from repro_torch.kernels import KERNEL_MODULES

    return [{"tp": phase_tp(KERNEL_MODULES, gen, ops, ref, rate)}]


def xlstm_block_ms(model, params, B, S) -> dict:
    """Host milliseconds (ending in a synchronize) of one mLSTM and one sLSTM
    block's forward and backward at the training shape, median of 3 after a
    warm-up: what 42 and 6 of them take of a step."""
    from repro_torch.models import params as PM

    mlstm, slstm = model._group_params(params)[0]
    out = {}
    for name, block, p in (("mlstm", model._mlstm_block, mlstm[0]),
                           ("slstm", model._slstm_block, slstm)):
        leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), p)
        x = torch.randn((B, S, model.cfg.d_model), device="cuda", dtype=model.dtype,
                        requires_grad=True)
        dy = torch.randn_like(x)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.autograd.grad(block(leaves, x), [x, *PM.tree_leaves(leaves)], dy)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_block_fwd_bwd_ms"] = statistics.median(times[1:])
    return out


# ----------------------------------------------------------- compute plane
#: (b): the meta live-bytes peak of a step within this share of the card's
DRYRUN_TOL = 0.10
#: D of the RMSNorm backward's rows on the train paths (kv_ln 512, qwen 1024,
#: Hymba 1600, 2048, phi4-mini-3.8b 3072, mixtral 4096), whose ``"vec"`` launch
#: shape the meta route takes from the H100 table
VEC_CONFIG_D = (512, 1024, 1600, 2048, 2560, 3072, 4096)
#: the scenario of ``tests/test_compute_plane.py``'s ``CAL``: 1024 items of 1 KiB,
#: 128 a step; the compute priced by qwen's measured step at 8 sequences a step
SCENARIO = dict(dataset_items=1024, item_bytes=1024, batch_items=128, epochs=2, n_jobs=2,
                items_per_step=TRAIN["batch"])


def check_h100_values() -> dict:
    """The card's values that the meta route reads from the package's H100
    table: ``build.H100_SXM`` against ``torch.cuda.get_device_properties``,
    and ``rmsnorm_bwd.vec_config_h100`` against the card's own
    ``rt_rmsnorm_bwd_vec_config`` at every train path's row length."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm_bwd as kb

    props = torch.cuda.get_device_properties(0)
    card = {"sm_count": props.multi_processor_count,
            "shared_memory_per_sm": getattr(props, "shared_memory_per_multiprocessor", None),
            "shared_memory_per_block_optin": getattr(props, "shared_memory_per_block_optin",
                                                     None)}
    wrong = {k: (v, build.H100_SXM[k]) for k, v in card.items()
             if v is not None and v != build.H100_SXM[k]}
    vec = {}
    for dt in (torch.bfloat16, torch.float32):
        for D in VEC_CONFIG_D:
            if D * dt.itemsize > kb.VEC_MAX_ROW_BYTES:
                continue
            warps, per_sm = ctypes.c_int(), ctypes.c_int()
            build.check(build.library().rt_rmsnorm_bwd_vec_config(
                D, kb.DTYPES[dt], ctypes.byref(warps), ctypes.byref(per_sm)),
                "rt_rmsnorm_bwd_vec_config")
            got, want = (warps.value, per_sm.value), kb.vec_config_h100(D, dt)
            vec[f"{D}_{str(dt)[6:]}"] = got
            if got[0] != want[0] or min(got[1], kb.VEC_MAX_BLOCKS_PER_SM) != \
                    min(want[1], kb.VEC_MAX_BLOCKS_PER_SM):
                wrong[f"vec_config {D} {dt}"] = (got, want)
    if wrong:
        raise AssertionError(f"the H100 table of the meta route differs from the card: {wrong}")
    unread = [k for k, v in card.items() if v is None]
    print(f"[dryrun] H100 table = the card's: {card} (not read by this torch: {unread}); "
          f"RMSNorm backward vec (warps, blocks an SM) {vec}")
    return {"card": card, "unread": unread, "vec_config": vec}


def dryrun_check(model, params, opt, batch: dict, opt_cfg, tag: str, step_ms: list,
                 seq_len: int) -> dict:
    """One counted train step on the card (``train.step_costs``, after the
    phase's timed steps, the peak reset just before it) and the same model,
    batch shapes and dtypes counted on the meta device with no weights.
    (a) FLOPs, traffic and every kernel's entries equal exactly; (b) the
    meta live-bytes peak within ``DRYRUN_TOL`` of ``max_memory_allocated``
    over the counted step; (c) the median timed step (steps 2 on) no faster
    than ``analytic_cell`` on mesh 1x1 at (batch, ``seq_len``) at the H100
    constants.  Raises on any of the three."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.models import params as PM
    from repro_torch.roofline.table import analytic_cell
    from repro_torch.train import step_costs

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    card = step_costs(model, batch, opt_cfg=opt_cfg, params=params, opt_state=opt)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    measured = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    meta = step_costs(build_model(model.cfg, device="meta"),
                      {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                       for k, v in batch.items()}, opt_cfg=opt_cfg)
    meta_s = time.perf_counter() - t0
    differ = [k for k in ("flops", "traffic_bytes", "kernels") if card[k] != meta[k]]
    if differ:
        raise AssertionError(f"[{tag}] (a) the card's count differs from meta's in {differ}: "
                             f"card {[card[k] for k in differ]}, "
                             f"meta {[meta[k] for k in differ]}")
    peak_err = (meta["peak_bytes"] - measured) / measured
    if abs(peak_err) > DRYRUN_TOL:
        raise AssertionError(f"[{tag}] (b) meta peak {meta['peak_bytes']} B against the card's "
                             f"{measured} B: {peak_err:+.4f}, beyond {DRYRUN_TOL}")
    B = batch["tokens"].shape[0]
    cell = analytic_cell(model.cfg, ShapeConfig(tag, seq_len, B, "train"), "1x1",
                         n_params=PM.param_count(model.layout()))
    median_s = statistics.median(step_ms[1:]) / 1e3
    ratio = median_s / cell.step_time_s
    if ratio < 1.0:
        raise AssertionError(f"[{tag}] (c) the measured step {median_s} s is faster than its "
                             f"roofline {cell.step_time_s} s: a count is wrong")
    calls = {k: v["calls"] for k, v in card["kernels"].items()}
    print(f"[dryrun] {tag}: (a) card = meta: {card['flops']:.6e} FLOPs ({card['matmul_flops']} "
          f"matmul), {card['traffic_bytes']:.6e} B, kernel calls {calls}; (b) meta peak "
          f"{meta['peak_bytes'] / 2**30:.3f} GiB, card {measured / 2**30:.3f} GiB "
          f"({peak_err:+.4f}; at the start meta {meta['start_bytes'] / 2**30:.3f}, card "
          f"{start / 2**30:.3f}; the card's own tracked peak {card['peak_bytes'] / 2**30:.3f}); "
          f"(c) median step {median_s * 1e3:.3f} ms = {ratio:.3f} x its roofline "
          f"{cell.step_time_s * 1e3:.3f} ms ({cell.bottleneck}: compute "
          f"{cell.compute_s * 1e3:.3f}, memory {cell.memory_s * 1e3:.3f} ms); counted in "
          f"{card_s:.2f} s on the card, {meta_s:.2f} s on meta")
    return {"flops": card["flops"], "traffic_bytes": card["traffic_bytes"],
            "matmul_flops": card["matmul_flops"], "kernel_calls": calls,
            "meta_peak_bytes": meta["peak_bytes"], "card_peak_bytes": measured,
            "peak_rel_err": peak_err, "meta_start_bytes": meta["start_bytes"],
            "card_start_bytes": start, "card_tracked_peak_bytes": card["peak_bytes"],
            "median_step_s": median_s, "roofline": cell.to_dict(),
            "step_over_roofline": ratio, "card_count_s": card_s, "meta_count_s": meta_s}


def scenario_check(step_s: float) -> dict:
    """Hoard's question with a step measured on this card: ``run_scenario`` on
    the cut workload with the ``hoard`` and ``posix`` backends, the compute
    priced by ``RooflineCompute(step_s=qwen's median step, items_per_step=8)``;
    each job's epoch times and its compute and I/O stall shares."""
    from repro_torch.core import PAPER, RooflineCompute, ScenarioConfig, run_scenario

    s = SCENARIO
    cal = dataclasses.replace(PAPER, dataset_bytes=float(s["dataset_items"] * s["item_bytes"]),
                              dataset_items=s["dataset_items"], batch_items=s["batch_items"])
    compute = RooflineCompute(arch=ARCH, shape=f"{TRAIN['batch']}x{TRAIN['seq']}",
                              mesh="1x1", step_s=step_s, items_per_step=s["items_per_step"])
    out = {}
    for backend in ("hoard", "posix"):
        res = run_scenario(ScenarioConfig(backend=backend, epochs=s["epochs"],
                                          n_jobs=s["n_jobs"], cal=cal, fill="prepopulated",
                                          mdr=0.5, compute=compute))
        jobs = []
        for job in res.jobs:
            total = sum(job.stall_breakdown.values())
            if not (job.epoch_times and total > 0):
                raise AssertionError(f"scenario {backend}: a job ran no epoch")
            compute_share = job.stall_breakdown.get("compute", 0.0) / total
            jobs.append({"epoch_times": job.epoch_times, "compute_share": compute_share,
                         "io_stall_share": 1.0 - compute_share,
                         "stall_breakdown": job.stall_breakdown})
            print(f"[scenario] {backend} {job.job_id}: epochs "
                  f"{job.epoch_times} s, compute {compute_share:.4f}, I/O stall "
                  f"{1.0 - compute_share:.4f} of the accounted time")
        out[backend] = jobs
    return {"step_s": step_s, **SCENARIO, "backends": out}


#: --only dryrun's cells: (tag, arch, batch, text tokens, layers, frames), the phases' sizes
DRYRUN_CELLS = (("train", ARCH, TRAIN["batch"], TRAIN["seq"], None, 0),
                ("train_hymba", HYMBA, HYMBA_TRAIN["batch"], HYMBA_TRAIN["seq"], None, 0),
                ("train_deepseek", DEEPSEEK, DEEPSEEK_TRAIN["batch"], DEEPSEEK_TRAIN["seq"],
                 DEEPSEEK_TRAIN["layers"], 0),
                ("train_mixtral", MIXTRAL, MIXTRAL_TRAIN["batch"], MIXTRAL_TRAIN["seq"],
                 MIXTRAL_TRAIN["layers"], 0),
                ("train_internvl2", INTERNVL, INTERNVL_TRAIN["batch"], INTERNVL_TRAIN["seq"],
                 None, 0),
                ("train_whisper", WHISPER, WHISPER_TRAIN["batch"], WHISPER_TRAIN["seq"], None,
                 WHISPER_TRAIN["frames"]))


def dryrun_seq(cfg, text: int) -> int:
    """The positions a train cell's roofline prices: the text tokens and a
    VLM's image prefix; Whisper's decoder tokens (its 1500 frames are not
    priced, so the roofline stays a floor)."""
    return text + (cfg.vlm.n_image_tokens if cfg.vlm is not None else 0)


def only_dryrun(gen, ops, ref, rate) -> list:
    """The H100 table, then each train cell at its phase's size: parameters
    drawn on the card, 3 steps of ``make_train_step`` on a random batch timed,
    ``dryrun_check``; then ``scenario_check`` with qwen's step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    rows = [{"h100_table": check_h100_values()}]
    qwen_s = None
    for tag, arch, B, S, layers, frames in DRYRUN_CELLS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = ARCHS[arch] if layers is None else dataclasses.replace(ARCHS[arch],
                                                                     n_layers=layers)
        model = build_model(cfg, device="cuda")
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
        params, opt = init_train_state(model, torch.Generator(device="cuda").manual_seed(0),
                                       opt_cfg)
        g = torch.Generator(device="cuda").manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g, device="cuda")
                 for k in ("tokens", "labels")}
        batch.update(embeddings(cfg, B, frames, g, "cuda", model.dtype))
        step = make_train_step(model, opt_cfg)
        step_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            float(metrics["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append({tag: dryrun_check(model, params, opt, batch, opt_cfg, tag, step_ms,
                                       dryrun_seq(cfg, S))})
        if tag == "train":
            qwen_s = statistics.median(step_ms[1:]) / 1e3
        del model, params, opt, batch, metrics, step
    rows.append({"scenario": scenario_check(qwen_s)})
    return rows


#: kernel -> (what it replaces, source)
REPLACES = {
    "rmsnorm": ("src/repro/kernels/rmsnorm.py:19", "csrc/rmsnorm.cu"),
    "swiglu_mlp": ("src/repro/kernels/swiglu.py:20", "csrc/swiglu.cu"),
    "decode_attention": ("src/repro/kernels/decode_attention.py:30", "csrc/decode_attention.cu"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:33", "csrc/flash_attention.cu"),
    "flash_attention_bwd": ("XLA autodiff of src/repro/models/layers.py:101 "
                            "blockwise_attention", "csrc/flash_attention_bwd.cu"),
    "rmsnorm_bwd": ("XLA autodiff of src/repro/models/layers.py:31 rms_norm",
                    "csrc/rmsnorm_bwd.cu"),
    "swiglu_mlp_bwd": ("XLA autodiff of src/repro/models/layers.py:240 swiglu",
                       "csrc/swiglu_bwd.cu"),
    "mlstm_scan": ("src/repro/kernels/mlstm_scan.py:25", "csrc/mlstm_scan.cu"),
    "mlstm_scan_bwd": ("XLA autodiff of src/repro/models/xlstm.py:36 mlstm_chunked",
                       "csrc/mlstm_scan_bwd.cu"),
    "ssd_scan": ("src/repro/kernels/ssd_scan.py:27", "csrc/ssd_scan.cu"),
    "ssd_scan_bwd": ("XLA autodiff of src/repro/models/hymba.py:126 ssd_scan",
                     "csrc/ssd_scan_bwd.cu"),
}
MODULE_OF = {"rmsnorm": "rmsnorm", "swiglu_mlp": "swiglu", "decode_attention": "decode_attention",
             "flash_attention": "flash_attention", "flash_attention_bwd": "flash_attention_bwd",
             "rmsnorm_bwd": "rmsnorm_bwd", "swiglu_mlp_bwd": "swiglu_bwd",
             "mlstm_scan": "mlstm_scan", "mlstm_scan_bwd": "mlstm_scan_bwd",
             "ssd_scan": "ssd_scan", "ssd_scan_bwd": "ssd_scan_bwd"}
#: the run whose launches a row reports as ``launches``: its slice's main path
MAIN_RUN = {"rmsnorm": "serve", "swiglu_mlp": "serve", "decode_attention": "serve",
            "flash_attention": "train", "flash_attention_bwd": "train", "rmsnorm_bwd": "train",
            "swiglu_mlp_bwd": "train", "mlstm_scan": "train_xlstm",
            "mlstm_scan_bwd": "train_xlstm", "ssd_scan": "train_hymba",
            "ssd_scan_bwd": "train_hymba"}


def decode_phases() -> dict:
    """The fp32 decode checks of the served models against the CPU; returns the
    MoE checks' near-ties by check."""
    phase_qwen3_full_width()
    phase_phi_full_width()
    phase_hymba_decode_full_width()
    phase_xlstm_decode_full_width()
    near_ties = phase_deepseek_decode_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    near_ties.update(phase_mixtral_decode_full_width())
    gc.collect()
    torch.cuda.empty_cache()
    return near_ties


def only_serve(gen, ops, ref, rate) -> list:
    from repro_torch.kernels import KERNEL_MODULES

    near_ties = decode_phases()
    runs = phase_serve(KERNEL_MODULES, rate)
    runs["serve_deepseek"]["fp32_check_near_ties"] = near_ties
    return [{run: res} for run, res in runs.items()]


def only_embedded(gen, ops, ref, rate) -> list:
    """The flash checks at the two families' shapes, their fp32 checks against
    the CPU, their serve runs and their training runs."""
    from repro_torch.kernels import KERNEL_MODULES

    check_flash_at(gen, ref, [(*s, True) for s in (RAGGED_CROSS_FLASH, *EMBEDDED_FLASH)])
    phase_internvl2_full_width()
    phase_whisper_full_width()
    runs = phase_serve(KERNEL_MODULES, rate, ("serve_internvl2", "serve_whisper"),
                       (INTERNVL, WHISPER))
    for run, phase in (("train_internvl2", phase_train_internvl2),
                       ("train_whisper", phase_train_whisper)):
        gc.collect()
        torch.cuda.empty_cache()
        runs[run] = phase(KERNEL_MODULES)
    return [{run: res} for run, res in runs.items()]


def only_phi(gen, ops, ref, rate) -> list:
    """The phi configs: their fp32 checks against the CPU, their serve runs and
    phi4-mini-3.8b's training run."""
    from repro_torch.kernels import KERNEL_MODULES

    phase_phi_full_width()
    runs = phase_serve(KERNEL_MODULES, rate, ("serve_phi4", "serve_phi3"), ())
    gc.collect()
    torch.cuda.empty_cache()
    runs["train_phi4"] = phase_train_phi4(KERNEL_MODULES)
    return [{run: res} for run, res in runs.items()]


def only_remat(gen, ops, ref, rate) -> list:
    """``remat_check`` on qwen1.5-0.5b's train cell: weights of seed 0 and a
    random 8 x 512 batch drawn on the card."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import KERNEL_MODULES
    from repro_torch.models import build_model

    cfg = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16")
    params = build_model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN["batch"], TRAIN["seq"]), generator=g,
                              device="cuda") for k in ("tokens", "labels")}
    return [{"remat": remat_check(KERNEL_MODULES, params, batch)}]


#: checks that ``--only NAME`` runs alone after the card and the build phases,
#: printing their rows and no result line
ONLY = {"mlstm": check_mlstm, "ssd": check_ssd,
        "decode": lambda *a: (check_decode_attention(*a),), "flash": check_flash,
        "serve": only_serve, "embedded": only_embedded, "hoard": only_hoard,
        "multi": only_multi, "dryrun": only_dryrun, "phi": only_phi, "remat": only_remat,
        "tp": only_tp}


def main(argv: list[str]) -> None:
    name, _ = phase_card()
    rate = memory_rate(name)
    t0 = time.perf_counter()
    phase_build()

    from repro_torch.kernels import KERNEL_MODULES, ops, ref

    gen = torch.Generator().manual_seed(0)
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or argv[1] not in ONLY:
            raise SystemExit(f"usage: chip_smoke.py [--only {{{','.join(ONLY)}}}]")
        for row in ONLY[argv[1]](gen, ops, ref, rate):
            print(json.dumps(row))
        print(f"[only] {argv[1]} done at {time.perf_counter() - t0:.1f} s")
        return
    rows = {}
    for names, check in ((("rmsnorm",), check_rmsnorm), (("swiglu_mlp",), check_swiglu),
                         (("decode_attention",), check_decode_attention),
                         (("flash_attention", "flash_attention_bwd"), check_flash),
                         (("rmsnorm_bwd",), check_rmsnorm_bwd),
                         (("swiglu_mlp_bwd",), check_swiglu_bwd),
                         (("mlstm_scan", "mlstm_scan_bwd"), check_mlstm),
                         (("ssd_scan", "ssd_scan_bwd"), check_ssd)):
        found = check(gen, ops, ref, rate)
        rows.update(zip(names, found if len(names) > 1 else (found,)))
        torch.cuda.synchronize()
        print(f"[kernels] {check.__name__} done at {time.perf_counter() - t0:.1f} s")
    h100 = check_h100_values()
    for phase in (phase_full_width, phase_full_width_grad, phase_xlstm_full_width,
                  phase_hymba_full_width, phase_internvl2_full_width, phase_whisper_full_width):
        phase()
        print(f"[full-width] {phase.__name__} done at {time.perf_counter() - t0:.1f} s")
    moe_ties = phase_moe_full_width()
    print(f"[full-width] phase_moe_full_width done at {time.perf_counter() - t0:.1f} s")
    near_ties = decode_phases()
    print(f"[full-width] done at {time.perf_counter() - t0:.1f} s")
    runs = phase_serve(KERNEL_MODULES, rate)
    runs["serve_deepseek"]["fp32_check_near_ties"] = near_ties
    print(f"[serve] done at {time.perf_counter() - t0:.1f} s")
    for run, phase in (("train", phase_train), ("hoard", phase_hoard),
                       ("train_xlstm", phase_train_xlstm),
                       ("train_hymba", phase_train_hymba), ("train_deepseek", phase_train_deepseek),
                       ("train_mixtral", phase_train_mixtral),
                       ("train_internvl2", phase_train_internvl2),
                       ("train_whisper", phase_train_whisper),
                       ("train_phi4", phase_train_phi4)):
        gc.collect()
        torch.cuda.empty_cache()
        runs[run] = phase(KERNEL_MODULES)
        print(f"[{run}] done at {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # phases 11 and 13 share one world of 4 ranks
    runs.update(run_worlds({"multi": multi_parts(KERNEL_MODULES),
                            "tp": tp_parts(KERNEL_MODULES, gen, ops, ref, rate)}))
    for kernel, shard_rows in runs["tp"].pop("kernel_rows").items():
        rows[kernel]["tp_shapes"] = shard_rows
    print(f"[multi, tp] done at {time.perf_counter() - t0:.1f} s")
    runs["train_deepseek"]["fp32_check_near_ties"] = moe_ties["deepseek_loss_prefill"]
    runs["train_mixtral"]["fp32_check_near_ties"] = moe_ties["mixtral_loss_prefill"]
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")

    for row in rows.values():
        replaces, src = REPLACES[row["name"]]
        module = MODULE_OF[row["name"]]
        main_run = MAIN_RUN[row["name"]]
        for run, res in runs.items():
            if run != main_run:
                row[f"{run}_launches"] = res["counts"][module]
        row["tp_serve_launches"] = runs["tp"]["serve"]["launches"][module]
        row.update(route="cuda", source=f"src/repro_torch/kernels/{src}", replaces=replaces,
                   launches=runs[main_run]["counts"][module], launches_from=main_run)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for run, res in runs.items():
        print(json.dumps({run: res}))
    print(json.dumps({"h100_table": h100}))
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: v for k, v in r.items() if k not in keys}}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
