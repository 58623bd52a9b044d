#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. card: the card's name and power limit from ``nvidia-smi``; TF32 off.
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, fp32
   and bf16: the serving kernels at the qwen1.5-0.5b serving shapes and a
   small shape, rmsnorm also at the qwen and hymba-1.5b training shapes and
   a ragged one (both its routes asserted; its device time from a replayed
   CUDA graph, its host path step by step); swiglu_mlp at the
   serving, qwen training and hymba-1.5b training shapes and at ragged
   shapes that reach each of its three routes (``SWIGLU_SHAPES``); flash
   attention forward and backward at the five sweep shapes of
   ``tests/test_kernels.py``, their window and ragged rows again at hd 64
   (the tensor-core route), a GQA shape (G 8, hd 128), causal queries
   behind a longer cache (q_offset 256) and the training shape, each
   backward called twice and its two results compared bit for bit, and
   queries that see no key (zero gradients on the tensor-core route);
   autograd through ``ops.flash_attention`` against the plain backward, in
   bf16 at the training shape through the tensor-core forward; the RMSNorm
   backward (``RMSNORM_BWD_SHAPES``) and the SwiGLU backward through
   ``ops.swiglu_mlp``, whose forward saves a = x Wg and b = x Wu
   (``SWIGLU_BWD_SHAPES``), at the qwen, hymba-1.5b and xlstm-1.3b training
   shapes and ragged ones, fp32 and bf16, each called twice and compared bit
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
   Also the mLSTM forward and backward (xlstm-1.3b's core) at the sweep of
   ``tests/test_kernels.py:130-141`` and the training shape, fp32 and bf16;
   the SSD scan forward and backward (hymba-1.5b's core) at the sweep of
   ``tests/test_extensions.py:19-30``, a chunk shorter than its length, a
   padded sequence (through ``models.hymba.ssd_scan``), the smoke shape,
   four shapes of chunk 128 and the training shape, fp32 and bf16, the
   tensor-core route asserted in bf16 at chunk 128 and held to the plain
   version with its bf16 roundings, each backward called twice and compared
   bit for bit, and timed beside the CUDA-core kernels; flash attention
   forward and backward at hymba-1.5b's training shapes (25 query heads
   over 5, 2176 positions, window 1024 and 0).
4. full width: qwen1.5-0.5b in fp32, one ``decode_step`` on the card against
   the same weights on the CPU; then, cut to 4 layers, ``loss`` and every
   gradient leaf on a (2, 200) batch against the CPU; then xlstm-1.3b in
   fp32 cut to 8 layers (7 mLSTM + 1 sLSTM), ``loss``, every gradient leaf
   and ``prefill`` on a (1, 256) batch against the CPU; then hymba-1.5b in
   fp32 cut to 4 layers and a window of 256, the same on a (1, 384) batch.
5. serve: a small fp32 serve on the card against the CPU, token for token;
   then qwen1.5-0.5b in bf16 through ``repro_torch.launch.serve.main``
   (8 requests, prompt 128, 32 new tokens) with the kernels' launch counts
   set to 0 just before and read just after; every swiglu_mlp launch must
   have taken the split-K tensor-core route, every rmsnorm the ``vec`` body.
6. train: qwen1.5-0.5b in bf16, full width and depth, through
   ``repro_torch.launch.train.main`` (batch 8, seq 512, 6 steps, a final
   checkpoint in a temporary directory under ``build/``), with the launch
   counts set to 0 just before and checked per step just after, every
   swiglu_mlp and flash_attention launch (forward and backward) on the
   tensor-core route and every rmsnorm (forward and backward) on ``vec``;
   then 8 steps on one fixed batch, whose loss must fall by 0.05.
7. train xLSTM: ``launch.train.main`` for xlstm-1.3b at its smoke config on
   the card, with a checkpoint; then xlstm-1.3b in bf16 at full width and
   depth (48 layers), batch 4 x seq 512 from the launcher's corpus, 4 steps
   of ``make_train_step`` with the launch counts set to 0 just before and
   checked per step just after (the routes as qwen's: the SwiGLU forward and
   backward on the tensor cores, every rmsnorm on ``vec``), and 8 steps on a
   fixed (2, 128) batch.
8. train Hymba: the same for hymba-1.5b: ``launch.train.main`` at its smoke
   config with a checkpoint, then the full model in bf16 (32 layers), batch
   2 x seq 2048 from the launcher's corpus, 4 steps with the launch counts
   checked per step (and the routes, as qwen's, and every SSD scan forward
   and backward on the tensor cores), and 8 steps on a fixed
   (2, 128) batch.
9. output: one ``{"serve": ...}``, ``{"train": ...}``, ``{"train_xlstm":
   ...}``, ``{"train_hymba": ...}`` and ``{"kernels": [...]}`` line, then
   the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
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
#: (N, D, F): the serving and the qwen training shape, ragged shapes that reach
#: the split-K route (20 rows) and the 128-row route (333 rows) with D and F no
#: multiple of the tiles, a bf16 shape that TMA refuses (D = 100, not a multiple
#: of 8: the CUDA-core route), and hymba-1.5b's training shape
SWIGLU_SHAPES = ((SERVE["requests"], 1024, 2816), (TRAIN_ROWS, 1024, 2816), (20, 96, 224),
                 (333, 200, 712), (37, 100, 260), HYMBA_SWIGLU)
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
#: kernel launches per training step of qwen1.5-0.5b (24 layers)
TRAIN_PER_STEP = {"rmsnorm": 2 * 24 + 1, "rmsnorm_bwd": 2 * 24 + 1, "swiglu": 24,
                  "swiglu_bwd": 24, "flash_attention": 24, "flash_attention_bwd": 24,
                  "decode_attention": 0}
#: the route every launch of these modules must take in the bf16 runs: the
#: tensor cores at training rows (qwen and Hymba; xLSTM has only SwiGLU), with
#: split-K at serving's 8 rows, the SwiGLU backward too; every rmsnorm forward
#: and backward on the one-warp-a-row body
TRAIN_ROUTES = {"swiglu": "wgmma", "flash_attention": "wgmma", "flash_attention_bwd": "wgmma",
                "rmsnorm": "vec", "swiglu_bwd": "wgmma", "rmsnorm_bwd": "vec"}
SERVE_ROUTES = {"swiglu": "wgmma_split_k", "rmsnorm": "vec"}
XLSTM = "xlstm-1.3b"
XLSTM_TRAIN = dict(batch=4, seq=512, steps=4)
#: kernel launches per training step of xlstm-1.3b (42 mLSTM blocks: 2 norms and
#: one scan each; 6 sLSTM blocks: 3 norms and one SwiGLU each; the final norm)
XLSTM_PER_STEP = {"rmsnorm": 2 * 42 + 3 * 6 + 1, "rmsnorm_bwd": 2 * 42 + 3 * 6 + 1,
                  "swiglu": 6, "swiglu_bwd": 6, "mlstm_scan": 42, "mlstm_scan_bwd": 42,
                  "flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0}
XLSTM_ROUTES = {"swiglu": "wgmma", "rmsnorm": "vec", "swiglu_bwd": "wgmma", "rmsnorm_bwd": "vec"}
#: (B, H, S, dqk, dv, chunk): the sweep of tests/test_kernels.py:130-141, then the
#: training shape of xlstm-1.3b (dqk 512, dv 1024, chunk 128)
MLSTM_SHAPES = tuple((2, 2, 256, dqk, dv, chunk) for chunk in (32, 64, 128)
                     for dqk, dv in ((16, 32), (32, 32))) + ((4, 4, 512, 512, 1024, 128),)
#: mLSTM outputs and gradients, relative to the largest entry (entries grow with
#: dqk): tests/test_kernels.py:154 in fp32, one bf16 rounding in bf16
MLSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
HYMBA = "hymba-1.5b"
HYMBA_TRAIN = dict(batch=2, seq=2048, steps=4)
#: kernel launches per training step of hymba-1.5b (32 blocks: 4 norms, one
#: attention, one scan and one SwiGLU each; the final norm)
HYMBA_PER_STEP = {"rmsnorm": 4 * 32 + 1, "rmsnorm_bwd": 4 * 32 + 1, "swiglu": 32,
                  "swiglu_bwd": 32, "flash_attention": 32, "flash_attention_bwd": 32,
                  "ssd_scan": 32, "ssd_scan_bwd": 32, "mlstm_scan": 0, "mlstm_scan_bwd": 0,
                  "decode_attention": 0}
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
    return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)


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


# ------------------------------------------------------------------ phases
def phase_card() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
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
#: training rows (the "vec" route), then a small row and a ragged one (D = 100:
#: the "block" route)
RMSNORM_SHAPES = ((SERVE["requests"], 1024), (TRAIN_ROWS, 1024), (4352, 1600), (37, 96),
                  (37, 100))


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


def check_rmsnorm(gen, ops, ref, rate):
    """RMSNORM_SHAPES in fp32 and bf16, each check with the route it took; times
    at the serving shape (the row), the qwen training shape (``train_*``) and
    hymba-1.5b's (``hymba_*``): host-paced ``ms`` with the host's ``issue_ms``,
    ``device_ms`` from a replayed CUDA graph, the ``block`` body on the same inputs
    (``block_ms``, device), ``F.rms_norm``'s host-paced and device times.  At
    the serving shape also the autograd Function that training calls, beside
    the direct call that ``ops.rmsnorm`` makes when no gradient is needed,
    and each step of the wrapper's host path (``host_steps_us``)."""
    from repro_torch.kernels import rmsnorm as kr

    errs, routes = {}, {}
    for rows, D in RMSNORM_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, g = randn(gen, (rows, D), dt), randn(gen, (D,), dt)
            routes[(rows, D, dt)] = kr.route(x, g)
            if routes[(rows, D, dt)] != ("vec" if D % 8 == 0 else "block"):
                raise AssertionError(f"rmsnorm {(rows, D, dt)}: route {routes[(rows, D, dt)]}")
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
                                   ("hymba_", RMSNORM_SHAPES[2], 8)):
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


def check_swiglu(gen, ops, ref, rate):
    """SWIGLU_SHAPES in fp32 and bf16, each bf16 check with the route it took;
    times at the serving shape (the row), the qwen training shape (its
    ``train_*`` keys) and hymba-1.5b's (``hymba_*``), each beside the
    CUDA-core kernel's on the same inputs (``simt_ms``)."""
    from repro_torch.kernels import swiglu as ks

    errs, routes = {}, {}
    for N, D, Fd in SWIGLU_SHAPES:
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
    row = {"name": "swiglu_mlp"}
    for prefix, (N, D, Fd), n_sets, rounds in (("", SWIGLU_SHAPES[0], 24, 5),
                                               ("train_", SWIGLU_SHAPES[1], 2, 3),
                                               ("hymba_", HYMBA_SWIGLU, 2, 3)):
        dt = torch.bfloat16
        sets = [(randn(gen, (N, D), dt), randn(gen, (D, Fd), dt, D ** -0.5),
                 randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (Fd, D), dt, Fd ** -0.5))
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
        del sets
    return row


def _sdpa(q, k, v, valid):
    S = k.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] < valid[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          enable_gqa=q.shape[1] != k.shape[1])


def check_decode_attention(gen, ops, ref, rate):
    errs = {}
    shapes = ((SERVE["requests"], 16, CACHE_LEN, 64), (2, 2, 100, 32), (1, 2, 700, 128))
    for B, Hkv, S, hd in shapes:
        for G in (1, 2) if hd <= 64 else (8,):
            for window in (0, 64):
                for dt in (torch.float32, torch.bfloat16):
                    q = randn(gen, (B, Hkv * G, 1, hd), dt)
                    k, v = randn(gen, (B, Hkv, S, hd), dt), randn(gen, (B, Hkv, S, hd), dt)
                    valid = torch.randint(1, S + 1, (B,), generator=gen).to(torch.int32)
                    valid[0] = S
                    if B > 1:
                        valid[-1] = S + 40    # past the cache: the window ends past it too
                    valid = valid.cuda()
                    got = ops.decode_attention(q, k, v, valid, window=window)
                    want = ref.decode_attention_ref(q, k, v, valid, window=window)
                    errs[(B, Hkv, G, S, hd, window, dt)] = max_err(
                        got, want, TOL["decode_attention"][dt])
    print(f"[kernels] decode_attention errors {errs}")
    B, H, S, hd, dt = SERVE["requests"], 16, CACHE_LEN, 64, torch.bfloat16
    valid = torch.full((B,), VALID, dtype=torch.int32, device="cuda")
    sets = [(randn(gen, (B, H, 1, hd), dt), randn(gen, (B, H, S, hd), dt),
             randn(gen, (B, H, S, hd), dt), valid) for _ in range(24)]
    q, k, v, _ = sets[0]
    err = max_err(ops.decode_attention(q, k, v, valid), ref.decode_attention_ref(q, k, v, valid),
                  TOL["decode_attention"][dt])
    b_ms, b_by = bound((2 * B * H * hd + 2 * B * H * VALID * hd) * 2 + 4 * B,
                       4 * B * H * VALID * hd, dt, rate)
    return {
        "name": "decode_attention",
        "shape": f"q ({B}, {H}, 1, {hd}), cache ({B}, {H}, {S}, {hd}), valid {VALID}, bf16",
        "max_abs_err": err,
        "ms": time_ms(ops.decode_attention, sets, 20),
        "plain_ms": time_ms(ref.decode_attention_ref, sets, 20),
        "library_ms": time_ms(_sdpa, sets, 20),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def flash_bound(B, Hq, Hkv, S, hd, window, rate, *, backward: bool) -> tuple[float, str]:
    """Causal self-attention.  Bytes: q, out (and dO, dq) over Hq heads, k, v (and
    dk, dv) over Hkv, lse in fp32, once each; operations: 4 hd per visible (causal,
    in-window) pair forward, 10 hd backward (bf16 rate)."""
    visible = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    pairs = B * Hq * visible
    q_elems, kv_elems = B * Hq * S * hd, B * Hkv * S * hd
    if backward:
        return bound(4 * (q_elems + kv_elems) * 2 + B * Hq * S * 4, 10 * hd * pairs,
                     torch.bfloat16, rate)
    return bound(2 * (q_elems + kv_elems) * 2 + B * Hq * S * 4, 4 * hd * pairs,
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


def flash_times(gen, ops, ref, rate, B, Hq, Hkv, S, hd, window) -> tuple[dict, dict]:
    """Flash forward and backward times in bf16 at one causal self-attention shape,
    beside the plain versions', SDPA's (with a boolean band mask where the
    window bites; the backward's by backend) and the bound; each also beside
    the CUDA-core kernels' on the same inputs (``simt_ms``)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import flash_attention_bwd as kb

    dt = torch.bfloat16
    mask = ref.attention_mask(S, S, causal=True, window=window, q_offset=0, device="cuda")
    sets = [(randn(gen, (B, Hq, S, hd), dt), randn(gen, (B, Hkv, S, hd), dt),
             randn(gen, (B, Hkv, S, hd), dt), randn(gen, (B, Hq, S, hd), dt)) for _ in range(2)]
    fwd_sets = [st[:3] for st in sets]
    saved = [(q, k, v, *kf.flash_attention_cuda(q, k, v, window=window), do)
             for q, k, v, do in sets]

    def lib(q, k, v):
        if window:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=Hq != Hkv)
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=Hq != Hkv)

    q, k, v, dout = sets[0]
    lib_bwd = sdpa_backward_ms(lib, (q, k, v), dout)
    b_ms, b_by = flash_bound(B, Hq, Hkv, S, hd, window, rate, backward=False)
    fwd = {
        "kernel_route": kf.route(*fwd_sets[0]),
        "ms": time_ms(lambda q, k, v: kf.flash_attention_cuda(q, k, v, window=window),
                      fwd_sets, 5),
        "simt_ms": time_ms(lambda q, k, v: kf.launch("simt", q, k, v, causal=True,
                                                     window=window, q_offset=0), fwd_sets, 5),
        "plain_ms": time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v, window=window),
                            fwd_sets, 3),
        "library_ms": time_ms(lib, fwd_sets, 5), "bound_ms": b_ms, "bound_by": b_by,
    }
    b_ms, b_by = flash_bound(B, Hq, Hkv, S, hd, window, rate, backward=True)
    ms, issue_ms = time_ms(lambda *a: kb.flash_attention_bwd_cuda(*a, window=window), saved, 5,
                           issue=True)
    bwd = {
        "kernel_route": kb.route(*saved[0][:4], saved[0][5]),
        "ms": ms, "issue_ms": issue_ms,
        "simt_ms": time_ms(lambda *a: kb.launch("simt", *a, causal=True, window=window,
                                                q_offset=0), saved, 5),
        "plain_ms": time_ms(lambda *a: ref.flash_attention_bwd_ref(*a, window=window), saved, 3),
        "fwd_bwd_ms": time_ms(lambda q, k, v, do: torch.autograd.grad(
            ops.flash_attention(q, k, v, window=window), (q, k, v), do),
            [tuple(t.detach().requires_grad_() for t in st[:3]) + (st[3],) for st in sets], 5),
        **lib_bwd, "bound_ms": b_ms, "bound_by": b_by,
    }
    return fwd, bwd


def check_flash(gen, ops, ref, rate):
    """Flash forward and backward against the plain versions at FLASH_SHAPES and
    hymba-1.5b's shapes (HYMBA_FLASH), fp32 and bf16; autograd through
    ``ops.flash_attention`` against the plain backward; times at the qwen
    training shape (the rows) and at hymba-1.5b's (their ``hymba`` lists)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import flash_attention_bwd as kb

    errs, gerrs, routes, bwd_routes = {}, {}, {}, {}
    hymba = [(B, Hq, Hkv, S, S, hd, True, w) for B, Hq, Hkv, S, hd, w in HYMBA_FLASH]
    for B, Hq, Hkv, Sq, Skv, hd, causal, window in FLASH_SHAPES + tuple(hymba):
        for dt in (torch.float32, torch.bfloat16):
            mask = dict(causal=causal, window=window, q_offset=Skv - Sq if causal else 0)
            q = randn(gen, (B, Hq, Sq, hd), dt)
            # k, v and dO as the model hands them over: transposed views
            k = randn(gen, (B, Skv, Hkv, hd), dt).transpose(1, 2)
            v = randn(gen, (B, Skv, Hkv, hd), dt).transpose(1, 2)
            dout = randn(gen, (B, Sq, Hq, hd), dt).transpose(1, 2)
            out, lse = kf.flash_attention_cuda(q, k, v, **mask)
            want, want_lse = ref.flash_attention_ref(q, k, v, **mask)
            tol = TOL["flash_attention"][dt]
            key = (B, Hq, Hkv, Sq, Skv, hd, causal, window, str(dt)[6:])
            routes[key] = kf.route(q, k.contiguous(), v.contiguous())
            errs[key] = max(max_err(out, want, tol), max_err(lse, want_lse, tol))
            tc = dt == torch.bfloat16 and hd in kf.TC_HEAD_DIMS
            if routes[key] != ("wgmma" if tc else "simt"):
                raise AssertionError(f"flash_attention {key}: route {routes[key]}")
            before = dict(kb.route_launches)
            got = kb.flash_attention_bwd_cuda(q, k, v, want, want_lse, dout, **mask)
            bwd_routes[key] = [r for r, n in kb.route_launches.items() if n != before[r]]
            if bwd_routes[key] != ["wgmma" if tc else "simt"]:
                raise AssertionError(f"flash_attention_bwd {key}: routes {bwd_routes[key]}")
            again = kb.flash_attention_bwd_cuda(q, k, v, want, want_lse, dout, **mask)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {key}: two calls differ")
            exp = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, **mask)
            gerrs[key] = max(max_err(a, b, GRAD_TOL[dt]) for a, b in zip(got, exp))
            del q, k, v, dout, out, lse, want, want_lse, got, again, exp
    print(f"[kernels] flash_attention errors {errs}")
    print(f"[kernels] flash_attention bf16 routes "
          f"{ {k[:8]: v for k, v in routes.items() if k[8] == 'bfloat16'} }")
    print(f"[kernels] flash_attention_bwd errors {gerrs}")
    print(f"[kernels] flash_attention_bwd bf16 routes "
          f"{ {k[:8]: v[0] for k, v in bwd_routes.items() if k[8] == 'bfloat16'} }; "
          f"two calls bitwise equal at every shape")

    # queries that see no key (lse = -inf: q_offset -8, window 4) get zero
    # gradients on the tensor-core route, not NaN
    mask = dict(causal=True, window=4, q_offset=-8)
    q, k, v, dout = (randn(gen, shape, torch.bfloat16)
                     for shape in ((1, 4, 160, 64), (1, 2, 200, 64), (1, 2, 200, 64),
                                   (1, 4, 160, 64)))
    want, want_lse = ref.flash_attention_ref(q, k, v, **mask)
    got = kb.flash_attention_bwd_cuda(q, k, v, want, want_lse, dout, **mask)
    exp = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, **mask)
    err = max(max_err(a, b, GRAD_TOL[torch.bfloat16]) for a, b in zip(got, exp))
    if (kb.route(q, k, v, want, dout) != "wgmma" or torch.count_nonzero(got[0][:, :, :8])
            or not all(torch.isfinite(g).all() for g in got)):
        raise AssertionError("flash_attention_bwd: rows with no visible key are not zero")
    print(f"[kernels] flash_attention_bwd wgmma, 8 rows with lse = -inf: zero, within {err:.4e}")
    del q, k, v, dout, want, want_lse, got, exp

    # autograd through ops.flash_attention equals the plain backward: fp32 at a
    # small shape; bf16 at the training shape, where the tensor-core forward's
    # lse feeds the backward kernel
    B, H, _, S, _, hd, _, _ = FLASH_SHAPES[-1]
    for shape, dt in (((2, 4, 100, 32), torch.float32), ((B, H, S, hd), torch.bfloat16)):
        q, k, v, dout = (randn(gen, shape, dt) for _ in range(4))
        leaves = [t.requires_grad_() for t in (q, k, v)]
        before, before_bwd = dict(kf.route_launches), dict(kb.route_launches)
        auto = torch.autograd.grad(ops.flash_attention(*leaves), leaves, dout)
        took = [r for r, n in kf.route_launches.items() if n != before[r]]
        took_bwd = [r for r, n in kb.route_launches.items() if n != before_bwd[r]]
        with torch.no_grad():
            want, want_lse = ref.flash_attention_ref(q, k, v)
            plain = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout)
        aerr = max(max_err(a, b, GRAD_TOL[dt]) for a, b in zip(auto, plain))
        print(f"[kernels] flash autograd {shape} {str(dt)[6:]}: forward route {took}, "
              f"backward route {took_bwd}, "
              f"gradients within {aerr:.4e} of the plain backward")
        if dt == torch.bfloat16 and (took != ["wgmma"] or took_bwd != ["wgmma"]):
            raise AssertionError(f"bf16 autograd took the routes {took} forward, "
                                 f"{took_bwd} backward")
        del q, k, v, dout, leaves, auto, want, want_lse, plain

    B, H, _, S, _, hd, _, _ = FLASH_SHAPES[-1]
    key = (B, H, H, S, S, hd, True, 0, "bfloat16")
    fwd, bwd = flash_times(gen, ops, ref, rate, B, H, H, S, hd, 0)
    shape = f"q, k, v ({B}, {H}, {S}, {hd}) causal bf16"
    fwd = {"name": "flash_attention", "shape": shape, "max_abs_err": errs[key], **fwd,
           "hymba": []}
    bwd = {"name": "flash_attention_bwd", "shape": shape, "max_abs_err": gerrs[key], **bwd,
           "hymba": []}
    for B, Hq, Hkv, S, _, hd, _, window in hymba:
        key = (B, Hq, Hkv, S, S, hd, True, window, "bfloat16")
        shape = f"q ({B}, {Hq}, {S}, {hd}), k, v ({B}, {Hkv}, {S}, {hd}), window {window} bf16"
        f, b = flash_times(gen, ops, ref, rate, B, Hq, Hkv, S, hd, window)
        fwd["hymba"].append({"shape": shape, "max_abs_err": errs[key], **f})
        bwd["hymba"].append({"shape": shape, "max_abs_err": gerrs[key], **b})
        torch.cuda.empty_cache()
    return fwd, bwd


#: (rows, D) of the rmsnorm backward checks: the qwen, hymba-1.5b and xlstm-1.3b
#: training rows and xlstm-1.3b's mLSTM output norm (8 KB rows; the "vec" body),
#: serving's rows, a small row ("vec") and a ragged one (D = 100: "block")
RMSNORM_BWD_SHAPES = ((TRAIN_ROWS, 1024), (4352, 1600), (2048, 2048), (2048, 4096),
                      (SERVE["requests"], 1024), (37, 96), (37, 100))


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
    body on the same inputs.  Times at qwen's rows (the row) and hymba-1.5b's
    (``hymba_*``), bf16: host-paced ``ms`` with the host's ``issue_ms``, device
    time from a replayed CUDA graph of eight input sets (``device_ms``), the
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
    torch.cuda.synchronize()
    print(f"[kernels] rmsnorm_bwd errors {errs}")
    print(f"[kernels] rmsnorm_bwd routes {routes}; two calls equal bit for bit at every shape")
    row = {"name": "rmsnorm_bwd"}
    for prefix, (N, D) in (("", (TRAIN_ROWS, 1024)), ("hymba_", (4352, 1600))):
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
#: TMA refuses (D = 100: the recompute path and gate kernel)
SWIGLU_BWD_SHAPES = ((TRAIN_ROWS, 1024, 2816), HYMBA_SWIGLU, (2048, 2048, 2688),
                     (333, 200, 712), (20, 96, 224), (37, 100, 260))


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
    with both errors.  Times at qwen's shape (the row) and
    hymba-1.5b's (``hymba_*``), bf16, each from a replayed CUDA graph of two
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
    for prefix, (N, D, Fd) in (("", SWIGLU_BWD_SHAPES[0]), ("hymba_", HYMBA_SWIGLU)):
        dt = torch.bfloat16
        sets = [_swiglu_bwd_inputs(gen, N, D, Fd, dt) for _ in range(2)]
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
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (math.isfinite(err) and err <= tol * scale):
        raise AssertionError(f"max |diff| {err} > {tol} x max |want| {scale}")
    return err, err / max(scale, 1e-30)


def mlstm_inputs(gen, B, H, S, dqk, dv, dt):
    """q, k, v, i_raw, log_f as tests/test_kernels.py draws them, and a dh."""
    q, k = randn(gen, (B, H, S, dqk), dt), randn(gen, (B, H, S, dqk), dt)
    v, i_raw = randn(gen, (B, H, S, dv), dt), randn(gen, (B, H, S), dt)
    log_f = torch.log(torch.rand((B, H, S), generator=gen) * 0.3 + 0.7).to("cuda", dt)
    return (q, k, v, i_raw, log_f), randn(gen, (B, H, S, dv), dt)


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
    """mlstm_scan and its backward against the plain versions at MLSTM_SHAPES:
    h and the chunk-start states C and n, then the five gradients from each
    side's own saved state; autograd through ``ops.mlstm_scan`` against the
    plain backward; times at the training shape in bf16."""
    from repro_torch.kernels import mlstm_scan as kf
    from repro_torch.kernels import mlstm_scan_bwd as kb

    errs, gerrs = {}, {}
    for B, H, S, dqk, dv, chunk in MLSTM_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, dh = mlstm_inputs(gen, B, H, S, dqk, dv, dt)
            out, saved = kf.mlstm_scan_cuda(*x, chunk=chunk)
            h, C, n, m = ref.mlstm_scan_ref(*x, chunk=chunk)
            tol = MLSTM_TOL[dt]
            key = (B, H, S, dqk, dv, chunk, str(dt)[6:])
            # the states are fp32 on both sides, whatever the inputs' type
            states = MLSTM_TOL[torch.float32]
            errs[key] = max(rel_err(out, h, tol), rel_err(saved.C, C, states),
                            rel_err(saved.n, n, states), key=lambda e: e[1])
            got = kb.mlstm_scan_bwd_cuda(*x, saved, dh, chunk=chunk)
            want = ref.mlstm_scan_bwd_ref(*x, C, n, m, dh, chunk=chunk)
            gerrs[key] = max((rel_err(a, b, GRAD_TOL[dt]) for a, b in zip(got, want)),
                             key=lambda e: e[1])
    torch.cuda.synchronize()
    print(f"[kernels] mlstm_scan (h, C, n) errors, (max abs, over the largest entry) {errs}")
    print(f"[kernels] mlstm_scan_bwd errors (dq, dk, dv, di, df), (max abs, over the "
          f"largest entry) {gerrs}")

    # autograd through ops.mlstm_scan equals the plain backward
    x, dh = mlstm_inputs(gen, 2, 2, 128, 32, 64, torch.float32)
    leaves = [t.requires_grad_() for t in x]
    auto = torch.autograd.grad(ops.mlstm_scan(*leaves, chunk=32), leaves, dh)
    _, C, n, m = ref.mlstm_scan_ref(*x, chunk=32)
    for a, b in zip(auto, ref.mlstm_scan_bwd_ref(*x, C, n, m, dh, chunk=32)):
        rel_err(a, b, GRAD_TOL[torch.float32])

    B, H, S, dqk, dv, chunk = MLSTM_SHAPES[-1]
    dt = torch.bfloat16
    sets = [mlstm_inputs(gen, B, H, S, dqk, dv, dt) for _ in range(2)]
    fwd_sets = [x for x, _ in sets]
    saved = [(*x, kf.mlstm_scan_cuda(*x, chunk=chunk)[1], dh) for x, dh in sets]
    plain_saved = [(*x, *ref.mlstm_scan_ref(*x, chunk=chunk)[1:], dh) for x, dh in sets]
    shape = f"q, k ({B}, {H}, {S}, {dqk}), v ({B}, {H}, {S}, {dv}), chunk {chunk} bf16"
    key = (B, H, S, dqk, dv, chunk, "bfloat16")
    note = "no PyTorch call computes the chunked mLSTM"
    b_ms, b_by = mlstm_bound(B, H, S, dqk, dv, chunk, rate, backward=False)
    fwd = {
        "name": "mlstm_scan", "shape": shape, "max_abs_err": errs[key][0],
        "max_rel_err": errs[key][1],
        "ms": time_ms(lambda *x: kf.mlstm_scan_cuda(*x, chunk=chunk), fwd_sets, 5),
        "plain_ms": time_ms(lambda *x: ref.mlstm_scan_ref(*x, chunk=chunk), fwd_sets, 3),
        "library_ms": None, "library_note": note,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    b_ms, b_by = mlstm_bound(B, H, S, dqk, dv, chunk, rate, backward=True)
    bwd = {
        "name": "mlstm_scan_bwd", "shape": shape, "max_abs_err": gerrs[key][0],
        "max_rel_err": gerrs[key][1],
        "ms": time_ms(lambda *a: kb.mlstm_scan_bwd_cuda(*a, chunk=chunk), saved, 3),
        "plain_ms": time_ms(lambda *a: ref.mlstm_scan_bwd_ref(*a, chunk=chunk), plain_saved, 3),
        "fwd_bwd_ms": time_ms(lambda *a: torch.autograd.grad(
            ops.mlstm_scan(*a[:5], chunk=chunk), a[:5], a[5]),
            [tuple(t.detach().requires_grad_() for t in x) + (dh,) for x, dh in sets], 3),
        "library_ms": None, "library_note": note,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    return fwd, bwd


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
    from repro_torch.models import build_model
    from repro_torch.models import params as PM

    cfg = dataclasses.replace(ARCHS[ARCH], dtype="float32")
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(0)
    p_cpu = cpu.init_params(gen)
    p_gpu = PM.tree_map(lambda t: t.to("cuda"), p_cpu)
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
    print(f"[full-width] fp32 decode_step B={B} index={index}: max |logit diff| {err:.3e}, "
          f"argmax equal")


def _loss_and_grads(model, params, batch):
    from repro_torch.models import params as PM

    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, PM.tree_leaves(leaves))
    return float(loss.detach()), grads


def phase_full_width_grad() -> None:
    """qwen1.5-0.5b at full width in fp32, cut to 4 layers: loss and every
    gradient leaf on the card against the CPU.  Batch (2, 200): no tile
    divides 200, so the kernels' ragged tails run."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models import params as PM

    cfg = dataclasses.replace(ARCHS[ARCH], dtype="float32", n_layers=4)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(1)
    p_cpu = cpu.init_params(gen)
    p_gpu = PM.tree_map(lambda t: t.to("cuda"), p_cpu)
    toks = torch.randint(0, cfg.vocab, (2, 201), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, g_cpu = _loss_and_grads(cpu, p_cpu, batch)
    got, g_gpu = _loss_and_grads(gpu, p_gpu, {k: t.cuda() for k, t in batch.items()})
    if not (math.isfinite(got) and abs(got - want) <= 2e-3):
        raise AssertionError(f"4-layer fp32 loss: card {got} cpu {want}")
    worst = 0.0
    for a, b in zip(g_gpu, g_cpu):
        scale = float(b.abs().max())
        diff = float((a.cpu() - b).abs().max())
        if not diff <= 2e-3 * scale:
            raise AssertionError(f"gradient leaf {tuple(b.shape)}: max diff {diff} > "
                                 f"2e-3 x {scale}")
        worst = max(worst, diff / scale)
    print(f"[full-width] fp32 4-layer loss card {got:.6f} cpu {want:.6f}; {len(g_cpu)} "
          f"gradient leaves, worst max |diff| / max |grad| {worst:.3e}")


def full_width_vs_cpu(cfg, seed: int, seq: int, label: str) -> None:
    """``loss``, every gradient leaf and ``prefill`` of ``cfg`` (fp32) on a (1,
    ``seq``) batch on the card against the same weights on the CPU: the loss
    within 2e-3, each leaf within 2e-3 of its largest entry, the logits within
    2e-3 (absolute and relative), the same argmax."""
    from repro_torch.models import build_model
    from repro_torch.models import params as PM

    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    p_cpu = cpu.init_params(gen)
    p_gpu = PM.tree_map(lambda t: t.to("cuda"), p_cpu)
    toks = torch.randint(0, cfg.vocab, (1, seq + 1), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, g_cpu = _loss_and_grads(cpu, p_cpu, batch)
    got, g_gpu = _loss_and_grads(gpu, p_gpu, {k: t.cuda() for k, t in batch.items()})
    if not (math.isfinite(got) and abs(got - want) <= 2e-3):
        raise AssertionError(f"{label} loss: card {got} cpu {want}")
    worst = max(rel_err(a.cpu(), b, 2e-3)[1] for a, b in zip(g_gpu, g_cpu))
    l_cpu = cpu.prefill(p_cpu, {"tokens": batch["tokens"]})
    l_gpu = gpu.prefill(p_gpu, {"tokens": batch["tokens"].cuda()}).cpu()
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


def phase_serve(kernel_modules) -> dict:
    from repro_torch.launch import serve

    small = ["--requests", "4", "--prompt-len", "16", "--new-tokens", "8", "--dtype", "float32"]
    on_cpu = serve.main(small + ["--device", "cpu"])["tokens"]
    on_gpu = serve.main(small + ["--device", "cuda"])["tokens"]
    if not (on_cpu == on_gpu).all():
        raise AssertionError(f"small fp32 serve: card {on_gpu.tolist()} != cpu {on_cpu.tolist()}")
    print("[serve] small fp32 serve: card tokens equal the CPU's")

    reset_counts(kernel_modules)
    res = serve.main(["--full-config", "--device", "cuda", "--dtype", "bfloat16",
                      "--requests", str(SERVE["requests"]),
                      "--prompt-len", str(SERVE["prompt_len"]),
                      "--new-tokens", str(SERVE["new_tokens"])])
    counts, routes = read_counts(kernel_modules)
    check_routes(routes, counts, SERVE_ROUTES, "serve")
    toks = res["tokens"]
    if toks.shape != (SERVE["requests"], SERVE["new_tokens"]):
        raise AssertionError(f"served tokens of shape {toks.shape}")
    if toks.min() < 0 or toks.max() >= 151936:
        raise AssertionError("served tokens outside the vocabulary")
    print(f"[serve] launches {counts}, by route {routes}; {res['tokens_per_s']:.1f} tok/s, "
          f"{res['ms_per_step']:.3f} ms per decode step")
    return {"counts": counts, "routes": routes, "steps": res["steps"],
            "tokens_per_s": res["tokens_per_s"],
            "ms_per_step": res["ms_per_step"]}


def phase_train(kernel_modules) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    reset_counts(kernel_modules)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        res = train.main(["--full-config", "--device", "cuda", "--dtype", "bfloat16",
                          "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
                          "--steps", str(TRAIN["steps"]), "--ckpt-dir", ckpt_dir])
        ckpt_bytes = sum(p.stat().st_size for p in Path(ckpt_dir).rglob("*") if p.is_file())
    counts, routes = read_counts(kernel_modules)
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
    print(f"[train] launches {counts}, by route {routes}; losses {losses}; median step "
          f"{step_ms:.3f} ms over "
          f"steps 2-{TRAIN['steps']}, {tokens_per_s:.1f} tokens/s, peak "
          f"{peak / 2**30:.3f} GiB; final checkpoint {ckpt_bytes / 2**30:.3f} GiB in "
          f"{res['ckpt_seconds']:.2f} s")

    # tests/test_train.py::test_loss_decreases_on_fixed_batch at full width
    cfg = dataclasses.replace(ARCHS[ARCH], dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    params, opt = init_train_state(model, torch.Generator().manual_seed(0), opt_cfg)
    rng = np.random.default_rng(0)
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
            "ckpt_seconds": res["ckpt_seconds"], "fixed_batch_losses": fixed}


def train_full_depth(arch: str, shape: dict, per_step: dict, kernel_modules, tag: str,
                     want_routes: dict):
    """An architecture on the card.  First ``launch.train.main`` at its smoke
    config (seq 64, 2 steps, its checkpoint in a temporary directory under
    ``build/``), so the launcher's path runs on the card.  Then the full model
    in bf16 at full width and depth, ``shape``'s batch x seq from the
    launcher's corpus (``TokenDatasetSpec``, ``TokenLoader``, AdamW as the
    launcher sets it), parameters drawn on a CUDA generator, ``shape``'s steps
    of ``make_train_step`` with the launch counts set to 0 just before and
    checked against ``per_step`` just after, and the routes of ``want_routes``'
    modules checked to have taken every launch; then 8 steps on a fixed (2, 128)
    batch, whose loss must fall by 0.05.  Tokens are the batch's text tokens.
    Returns ``(model, params, result)``."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenDatasetSpec, TokenLoader
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        res = train.main(["--arch", arch, "--device", "cuda", "--steps", "2", "--batch", "2",
                          "--seq", "64", "--ckpt-dir", ckpt_dir])
        if not (Path(ckpt_dir) / "step_000002" / "_COMMITTED").is_file():
            raise AssertionError(f"the {arch} launcher wrote no final checkpoint")
    if res["restarts"] or not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"{arch} launcher: {res['restarts']} restarts, losses {res['losses']}")
    print(f"[{tag}] launcher at the smoke config on the card: losses {res['losses']}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, steps = shape["batch"], shape["seq"], shape["steps"]
    model = build_model(ARCHS[arch], device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    t0 = time.perf_counter()
    params, opt = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = TokenDatasetSpec("train-corpus", n_sequences=max(256, B * 32), seq_len=S,
                            vocab=model.cfg.vocab, seed=0)
    it = iter(TokenLoader(spec, batch=B, items_per_chunk=train.ITEMS_PER_CHUNK))
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
          f"{peak / 2**30:.3f} GiB; init {init_s:.2f} s")

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
        "tokens_per_step": B * S,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median,
        "tokens_per_s": tokens_per_s, "peak_memory_bytes": peak, "init_seconds": init_s,
        "fixed_batch_losses": fixed, "launcher_smoke_losses": res["losses"]}


def phase_train_xlstm(kernel_modules) -> dict:
    """xlstm-1.3b: ``train_full_depth`` at batch 4 x 512, then one mLSTM and one
    sLSTM block timed.  Cut: the launcher's final checkpoint, 41 GB at this
    size, is not written at full depth."""
    model, params, res = train_full_depth(XLSTM, XLSTM_TRAIN, XLSTM_PER_STEP, kernel_modules,
                                          "train_xlstm", XLSTM_ROUTES)
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


#: kernel -> (what it replaces, source, launches per serving decode step)
REPLACES = {
    "rmsnorm": ("src/repro/kernels/rmsnorm.py:19", "csrc/rmsnorm.cu", 2 * 24 + 1),
    "swiglu_mlp": ("src/repro/kernels/swiglu.py:20", "csrc/swiglu.cu", 24),
    "decode_attention": ("src/repro/kernels/decode_attention.py:30",
                         "csrc/decode_attention.cu", 24),
    "flash_attention": ("src/repro/kernels/flash_attention.py:33",
                        "csrc/flash_attention.cu", 0),
    "flash_attention_bwd": ("XLA autodiff of src/repro/models/layers.py:101 "
                            "blockwise_attention", "csrc/flash_attention_bwd.cu", 0),
    "rmsnorm_bwd": ("XLA autodiff of src/repro/models/layers.py:31 rms_norm",
                    "csrc/rmsnorm_bwd.cu", 0),
    "swiglu_mlp_bwd": ("XLA autodiff of src/repro/models/layers.py:240 swiglu",
                       "csrc/swiglu_bwd.cu", 0),
    "mlstm_scan": ("src/repro/kernels/mlstm_scan.py:25", "csrc/mlstm_scan.cu", 0),
    "mlstm_scan_bwd": ("XLA autodiff of src/repro/models/xlstm.py:36 mlstm_chunked",
                       "csrc/mlstm_scan_bwd.cu", 0),
    "ssd_scan": ("src/repro/kernels/ssd_scan.py:27", "csrc/ssd_scan.cu", 0),
    "ssd_scan_bwd": ("XLA autodiff of src/repro/models/hymba.py:126 ssd_scan",
                     "csrc/ssd_scan_bwd.cu", 0),
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


def main() -> None:
    name, _ = phase_card()
    rate = memory_rate(name)
    t0 = time.perf_counter()
    phase_build()

    from repro_torch.kernels import KERNEL_MODULES, ops, ref

    gen = torch.Generator().manual_seed(0)
    rows = {"rmsnorm": check_rmsnorm(gen, ops, ref, rate),
            "swiglu_mlp": check_swiglu(gen, ops, ref, rate)}
    rows["decode_attention"] = check_decode_attention(gen, ops, ref, rate)
    rows["flash_attention"], rows["flash_attention_bwd"] = check_flash(gen, ops, ref, rate)
    rows["rmsnorm_bwd"] = check_rmsnorm_bwd(gen, ops, ref, rate)
    rows["swiglu_mlp_bwd"] = check_swiglu_bwd(gen, ops, ref, rate)
    rows["mlstm_scan"], rows["mlstm_scan_bwd"] = check_mlstm(gen, ops, ref, rate)
    rows["ssd_scan"], rows["ssd_scan_bwd"] = check_ssd(gen, ops, ref, rate)
    torch.cuda.synchronize()
    print(f"[kernels] done at {time.perf_counter() - t0:.1f} s")
    phase_full_width()
    phase_full_width_grad()
    phase_xlstm_full_width()
    phase_hymba_full_width()
    print(f"[full-width] done at {time.perf_counter() - t0:.1f} s")
    runs = {"serve": phase_serve(KERNEL_MODULES)}
    runs["train"] = phase_train(KERNEL_MODULES)
    gc.collect()
    torch.cuda.empty_cache()
    runs["train_xlstm"] = phase_train_xlstm(KERNEL_MODULES)
    gc.collect()
    torch.cuda.empty_cache()
    runs["train_hymba"] = phase_train_hymba(KERNEL_MODULES)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")

    served = runs["serve"]
    for row in rows.values():
        replaces, src, per_step = REPLACES[row["name"]]
        module = MODULE_OF[row["name"]]
        if served["counts"][module] != per_step * served["steps"]:
            raise AssertionError(f"{row['name']}: {served['counts'][module]} launches in the "
                                 f"serve run, expected {per_step} x {served['steps']} steps")
        main_run = MAIN_RUN[row["name"]]
        for run, res in runs.items():
            if run != main_run:
                row[f"{run}_launches"] = res["counts"][module]
        row.update(route="cuda", source=f"src/repro_torch/kernels/{src}", replaces=replaces,
                   launches=runs[main_run]["counts"][module], launches_from=main_run)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"serve": {k: served[k] for k in ("tokens_per_s", "ms_per_step", "steps")}}))
    for run in ("train", "train_xlstm", "train_hymba"):
        print(json.dumps({run: runs[run]}))
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: v for k, v in r.items() if k not in keys}}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
