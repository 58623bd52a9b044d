#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. card: the card's name and power limit from ``nvidia-smi``; TF32 off.
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, fp32
   and bf16: the serving kernels at the qwen1.5-0.5b serving shapes and a
   small shape, rmsnorm and swiglu_mlp also at the training shape; flash
   attention forward and backward at the five sweep shapes of
   ``tests/test_kernels.py``, a GQA shape (G 8, hd 128) and the training
   shape; the RMSNorm and SwiGLU backward at the training shape
   and a small one.  Then each kernel's time beside its plain version's,
   one PyTorch library call's, and its bound from bytes and operations.
   Also the mLSTM forward and backward (xlstm-1.3b's core) at the sweep of
   ``tests/test_kernels.py:130-141`` and the training shape, fp32 and bf16.
4. full width: qwen1.5-0.5b in fp32, one ``decode_step`` on the card against
   the same weights on the CPU; then, cut to 4 layers, ``loss`` and every
   gradient leaf on a (2, 200) batch against the CPU; then xlstm-1.3b in
   fp32 cut to 8 layers (7 mLSTM + 1 sLSTM), ``loss``, every gradient leaf
   and ``prefill`` on a (1, 256) batch against the CPU.
5. serve: a small fp32 serve on the card against the CPU, token for token;
   then qwen1.5-0.5b in bf16 through ``repro_torch.launch.serve.main``
   (8 requests, prompt 128, 32 new tokens) with the kernels' launch counts
   set to 0 just before and read just after.
6. train: qwen1.5-0.5b in bf16, full width and depth, through
   ``repro_torch.launch.train.main`` (batch 8, seq 512, 6 steps, a final
   checkpoint in a temporary directory under ``build/``), with the launch
   counts set to 0 just before and checked per step just after; then 8
   steps on one fixed batch, whose loss must fall by 0.05.
7. train xLSTM: ``launch.train.main`` for xlstm-1.3b at its smoke config on
   the card, with a checkpoint; then xlstm-1.3b in bf16 at full width and
   depth (48 layers), batch 4 x seq 512 from the launcher's corpus, 4 steps
   of ``make_train_step`` with the launch counts set to 0 just before and
   checked per step just after, and 8 steps on a fixed (2, 128) batch.
8. output: one ``{"serve": ...}``, ``{"train": ...}``, ``{"train_xlstm":
   ...}`` and ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
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
TOL = {  # tests/test_kernels.py
    "rmsnorm": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "swiglu_mlp": {torch.float32: 1e-4, torch.bfloat16: 5e-2},
    "decode_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "flash_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
}
#: gradients: fp32 sums in another order; bf16 outputs rounded once
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
#: (B, Hq, Hkv, Sq, Skv, hd, causal, window): the sweep of tests/test_kernels.py:32-36,
#: then GQA with G 8 and hd 128, then the training shape
FLASH_SHAPES = (
    (1, 2, 2, 128, 128, 32, True, 0),
    (2, 4, 2, 256, 256, 64, True, 0),
    (1, 8, 2, 192, 192, 32, True, 64),
    (2, 2, 2, 128, 256, 64, False, 0),
    (1, 4, 4, 100, 100, 16, True, 0),
    (1, 16, 2, 300, 300, 128, True, 0),
    (TRAIN["batch"], 16, 16, TRAIN["seq"], TRAIN["seq"], 64, True, 0),
)
#: kernel launches per training step of qwen1.5-0.5b (24 layers)
TRAIN_PER_STEP = {"rmsnorm": 2 * 24 + 1, "rmsnorm_bwd": 2 * 24 + 1, "swiglu": 24,
                  "swiglu_bwd": 24, "flash_attention": 24, "flash_attention_bwd": 24,
                  "decode_attention": 0}
XLSTM = "xlstm-1.3b"
XLSTM_TRAIN = dict(batch=4, seq=512, steps=4)
#: kernel launches per training step of xlstm-1.3b (42 mLSTM blocks: 2 norms and
#: one scan each; 6 sLSTM blocks: 3 norms and one SwiGLU each; the final norm)
XLSTM_PER_STEP = {"rmsnorm": 2 * 42 + 3 * 6 + 1, "rmsnorm_bwd": 2 * 42 + 3 * 6 + 1,
                  "swiglu": 6, "swiglu_bwd": 6, "mlstm_scan": 42, "mlstm_scan_bwd": 42,
                  "flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0}
#: (B, H, S, dqk, dv, chunk): the sweep of tests/test_kernels.py:130-141, then the
#: training shape of xlstm-1.3b (dqk 512, dv 1024, chunk 128)
MLSTM_SHAPES = tuple((2, 2, 256, dqk, dv, chunk) for chunk in (32, 64, 128)
                     for dqk, dv in ((16, 32), (32, 32))) + ((4, 4, 512, 512, 1024, 128),)
#: mLSTM outputs and gradients, relative to the largest entry (entries grow with
#: dqk): tests/test_kernels.py:154 in fp32, one bf16 rounding in bf16
MLSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
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


def check_rmsnorm(gen, ops, ref, rate):
    """The serving shape, the training shape and a small one; the row times the
    serving shape, its ``train_*`` keys the training shape.  At the serving
    shape also the autograd Function that training calls, beside the direct
    call that ``ops.rmsnorm`` makes when no gradient is needed, each with the
    host's time to issue it."""
    errs = {}
    for rows, D in ((SERVE["requests"], 1024), (TRAIN_ROWS, 1024), (37, 96)):
        for dt in (torch.float32, torch.bfloat16):
            x, g = randn(gen, (rows, D), dt), randn(gen, (D,), dt)
            got = ops.rmsnorm(x, g, eps=1e-5)
            errs[(rows, D, dt)] = max_err(got, ref.rmsnorm_ref(x, g, 1e-5),
                                          TOL["rmsnorm"][dt])
    print(f"[kernels] rmsnorm errors {errs}")
    row = {"name": "rmsnorm"}
    for prefix, N, n_sets in (("", SERVE["requests"], 24), ("train_", TRAIN_ROWS, 8)):
        D, dt = 1024, torch.bfloat16
        sets = [(randn(gen, (N, D), dt), randn(gen, (D,), dt)) for _ in range(n_sets)]
        b_ms, b_by = bound((2 * N * D + D) * 2, 4 * N * D, dt, rate)
        ms, issue = time_ms(lambda x, g: ops.rmsnorm(x, g, eps=1e-5), sets, 20, issue=True)
        row.update({
            f"{prefix}shape": f"x ({N}, {D}) bf16",
            f"{prefix}max_abs_err": errs[(N, D, dt)],
            f"{prefix}ms": ms, f"{prefix}issue_ms": issue,
            f"{prefix}plain_ms": time_ms(lambda x, g: ref.rmsnorm_ref(x, g, 1e-5), sets, 20),
            f"{prefix}library_ms": time_ms(lambda x, g: F.rms_norm(x, (D,), g, 1e-5), sets, 20),
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by,
        })
        if not prefix:
            row["function_ms"], row["function_issue_ms"] = time_ms(
                lambda x, g: ops.RMSNorm.apply(x, g, 1e-5), sets, 20, issue=True)
    return row


def _swiglu_lib(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def check_swiglu(gen, ops, ref, rate):
    """The serving shape, the training shape and a small one; the row times the
    serving shape, its ``train_*`` keys the training shape."""
    errs = {}
    for N, D, Fd in ((SERVE["requests"], 1024, 2816), (TRAIN_ROWS, 1024, 2816), (20, 96, 224)):
        for dt in (torch.float32, torch.bfloat16):
            x = randn(gen, (N, D), dt)
            wg, wu = randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (D, Fd), dt, D ** -0.5)
            wd = randn(gen, (Fd, D), dt, Fd ** -0.5)
            got = ops.swiglu_mlp(x, wg, wu, wd)
            errs[(N, D, Fd, dt)] = max_err(got, ref.swiglu_ref(x, wg, wu, wd),
                                           TOL["swiglu_mlp"][dt])
    print(f"[kernels] swiglu_mlp errors {errs}")
    row = {"name": "swiglu_mlp"}
    for prefix, N, n_sets, rounds in (("", SERVE["requests"], 24, 5), ("train_", TRAIN_ROWS, 2, 3)):
        D, Fd, dt = 1024, 2816, torch.bfloat16
        sets = [(randn(gen, (N, D), dt), randn(gen, (D, Fd), dt, D ** -0.5),
                 randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (Fd, D), dt, Fd ** -0.5))
                for _ in range(n_sets)]
        b_ms, b_by = bound((2 * N * D + 3 * D * Fd) * 2, 6 * N * D * Fd + 4 * N * Fd, dt, rate)
        row.update({
            f"{prefix}shape": f"x ({N}, {D}), d_ff {Fd} bf16",
            f"{prefix}max_abs_err": errs[(N, D, Fd, dt)],
            f"{prefix}ms": time_ms(ops.swiglu_mlp, sets, rounds),
            f"{prefix}plain_ms": time_ms(ref.swiglu_ref, sets, rounds),
            f"{prefix}library_ms": time_ms(_swiglu_lib, sets, rounds),
            f"{prefix}bound_ms": b_ms, f"{prefix}bound_by": b_by,
        })
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


def flash_bound(B, H, S, hd, causal, rate, *, backward: bool) -> tuple[float, str]:
    """Bytes: q, k, v, out (and dO, dq, dk, dv) once, lse in fp32; operations:
    4 hd per visible pair forward, 10 hd backward (bf16 rate)."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    elems = B * H * S * hd
    if backward:
        return bound(8 * elems * 2 + 2 * B * H * S * 4, 10 * hd * pairs, torch.bfloat16, rate)
    return bound(4 * elems * 2 + B * H * S * 4, 4 * hd * pairs, torch.bfloat16, rate)


def check_flash(gen, ops, ref, rate):
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import flash_attention_bwd as kb

    errs, gerrs = {}, {}
    for B, Hq, Hkv, Sq, Skv, hd, causal, window in FLASH_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            mask = dict(causal=causal, window=window)
            q = randn(gen, (B, Hq, Sq, hd), dt)
            # k, v and dO as the model hands them over: transposed views
            k = randn(gen, (B, Skv, Hkv, hd), dt).transpose(1, 2)
            v = randn(gen, (B, Skv, Hkv, hd), dt).transpose(1, 2)
            dout = randn(gen, (B, Sq, Hq, hd), dt).transpose(1, 2)
            out, lse = kf.flash_attention_cuda(q, k, v, **mask)
            want, want_lse = ref.flash_attention_ref(q, k, v, **mask)
            tol = TOL["flash_attention"][dt]
            key = (B, Hq, Hkv, Sq, Skv, hd, causal, window, str(dt)[6:])
            errs[key] = max(max_err(out, want, tol), max_err(lse, want_lse, tol))
            got = kb.flash_attention_bwd_cuda(q, k, v, want, want_lse, dout, **mask)
            exp = ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout, **mask)
            gerrs[key] = max(max_err(a, b, GRAD_TOL[dt]) for a, b in zip(got, exp))
    print(f"[kernels] flash_attention errors {errs}")
    print(f"[kernels] flash_attention_bwd errors {gerrs}")

    # autograd through ops.flash_attention equals the plain backward
    q, k, v, dout = (randn(gen, (2, 4, 100, 32), torch.float32) for _ in range(4))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(ops.flash_attention(*leaves), leaves, dout)
    want, want_lse = ref.flash_attention_ref(q, k, v)
    for a, b in zip(auto, ref.flash_attention_bwd_ref(q, k, v, want, want_lse, dout)):
        max_err(a, b, GRAD_TOL[torch.float32])

    B, H, _, S, _, hd, causal, _ = FLASH_SHAPES[-1]
    dt = torch.bfloat16
    sets = [tuple(randn(gen, (B, H, S, hd), dt) for _ in range(4)) for _ in range(2)]
    fwd_sets = [s[:3] for s in sets]
    saved = [(q, k, v, *kf.flash_attention_cuda(q, k, v), do) for q, k, v, do in sets]
    shape = f"q, k, v ({B}, {H}, {S}, {hd}) causal bf16"
    key = (B, H, H, S, S, hd, causal, 0, "bfloat16")
    b_ms, b_by = flash_bound(B, H, S, hd, causal, rate, backward=False)
    fwd = {
        "name": "flash_attention", "shape": shape, "max_abs_err": errs[key],
        "ms": time_ms(lambda q, k, v: kf.flash_attention_cuda(q, k, v), fwd_sets, 5),
        "plain_ms": time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v), fwd_sets, 3),
        "library_ms": time_ms(
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True), fwd_sets, 5),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    q, k, v, dout = sets[0]
    lib_bwd, lib_both = grad_ms(
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True), (q, k, v),
        dout, 5)
    b_ms, b_by = flash_bound(B, H, S, hd, causal, rate, backward=True)
    bwd = {
        "name": "flash_attention_bwd", "shape": shape, "max_abs_err": gerrs[key],
        "ms": time_ms(kb.flash_attention_bwd_cuda, saved, 5),
        "plain_ms": time_ms(ref.flash_attention_bwd_ref, saved, 3),
        "library_ms": lib_bwd,
        "fwd_bwd_ms": time_ms(lambda q, k, v, do: torch.autograd.grad(
            ops.flash_attention(q, k, v), (q, k, v), do),
            [tuple(t.detach().requires_grad_() for t in s[:3]) + (s[3],) for s in sets], 5),
        "library_fwd_bwd_ms": lib_both,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    return fwd, bwd


def check_rmsnorm_bwd(gen, ops, ref, rate):
    from repro_torch.kernels import rmsnorm_bwd as kb

    errs = {}
    for rows, D in ((TRAIN_ROWS, 1024), (37, 96), (SERVE["requests"], 1024)):
        for dt in (torch.float32, torch.bfloat16):
            x, g, dy = randn(gen, (rows, D), dt), randn(gen, (D,), dt), randn(gen, (rows, D), dt)
            got = kb.rmsnorm_bwd_cuda(x, g, dy, 1e-5)
            exp = ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
            errs[(rows, D, str(dt)[6:])] = max(max_err(a, b, GRAD_TOL[dt])
                                               for a, b in zip(got, exp))
    print(f"[kernels] rmsnorm_bwd errors {errs}")
    N, D, dt = TRAIN_ROWS, 1024, torch.bfloat16
    sets = [(randn(gen, (N, D), dt), randn(gen, (D,), dt), randn(gen, (N, D), dt))
            for _ in range(8)]
    x, g, dy = sets[0]
    # A call here is a few microseconds of device work: each time is given
    # beside the host's time to issue the calls, which sets the pace when equal.
    (lib_bwd, lib_bwd_issue), (lib_both, lib_both_issue) = grad_ms(
        lambda x, g: F.rms_norm(x, (D,), g, 1e-5), (x, g), dy, 20, issue=True)
    leaves = [(x.requires_grad_(), g.requires_grad_(), dy) for x, g, dy in
              ((a.clone(), b.clone(), c) for a, b, c in sets)]
    ms, issue = time_ms(lambda x, g, dy: kb.rmsnorm_bwd_cuda(x, g, dy, 1e-5), sets, 20,
                        issue=True)
    both, both_issue = time_ms(lambda x, g, dy: torch.autograd.grad(
        ops.rmsnorm(x, g, eps=1e-5), (x, g), dy), leaves, 20, issue=True)
    b_ms, b_by = bound((3 * N * D + 2 * D) * 2, 8 * N * D, dt, rate)
    return {
        "name": "rmsnorm_bwd", "shape": f"x, dy ({N}, {D}) bf16",
        "max_abs_err": errs[(N, D, "bfloat16")],
        "ms": ms, "issue_ms": issue,
        "plain_ms": time_ms(lambda x, g, dy: ref.rmsnorm_bwd_ref(x, g, dy, 1e-5), sets, 20),
        "library_ms": lib_bwd, "library_issue_ms": lib_bwd_issue,
        "fwd_bwd_ms": both, "fwd_bwd_issue_ms": both_issue,
        "library_fwd_bwd_ms": lib_both, "library_fwd_bwd_issue_ms": lib_both_issue,
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_swiglu_bwd(gen, ops, ref, rate):
    from repro_torch.kernels import swiglu_bwd as kb

    errs = {}
    for N, D, Fd in ((TRAIN_ROWS, 1024, 2816), (20, 96, 224)):
        for dt in (torch.float32, torch.bfloat16):
            x, dy = randn(gen, (N, D), dt), randn(gen, (N, D), dt)
            wg, wu = randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (D, Fd), dt, D ** -0.5)
            wd = randn(gen, (Fd, D), dt, Fd ** -0.5)
            got = kb.swiglu_bwd_cuda(x, wg, wu, wd, dy)
            exp = ref.swiglu_bwd_ref(x, wg, wu, wd, dy)
            errs[(N, D, Fd, str(dt)[6:])] = max(max_err(a, b, GRAD_TOL[dt])
                                                for a, b in zip(got, exp))
    print(f"[kernels] swiglu_mlp_bwd errors {errs}")
    N, D, Fd, dt = TRAIN_ROWS, 1024, 2816, torch.bfloat16
    sets = [(randn(gen, (N, D), dt), randn(gen, (D, Fd), dt, D ** -0.5),
             randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (Fd, D), dt, Fd ** -0.5),
             randn(gen, (N, D), dt)) for _ in range(2)]
    lib_bwd, lib_both = grad_ms(_swiglu_lib, sets[0][:4], sets[0][4], 5)
    leaves = [tuple(t.clone().requires_grad_() for t in s[:4]) + (s[4],) for s in sets]
    b_ms, b_by = bound((3 * N * D + 6 * D * Fd) * 2, 16 * N * D * Fd + 10 * N * Fd, dt, rate)
    bwd = {
        "name": "swiglu_mlp_bwd", "shape": f"x, dy ({N}, {D}), d_ff {Fd} bf16",
        "max_abs_err": errs[(N, D, Fd, "bfloat16")],
        "ms": time_ms(kb.swiglu_bwd_cuda, sets, 5),
        "plain_ms": time_ms(ref.swiglu_bwd_ref, sets, 5),
        "library_ms": lib_bwd,
        "fwd_bwd_ms": time_ms(lambda x, wg, wu, wd, dy: torch.autograd.grad(
            ops.swiglu_mlp(x, wg, wu, wd), (x, wg, wu, wd), dy), leaves, 3),
        "library_fwd_bwd_ms": lib_both,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    return bwd


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


def phase_xlstm_full_width() -> None:
    """xlstm-1.3b at full width in fp32, cut to 8 layers (one group: 7 mLSTM
    blocks and 1 sLSTM block): ``loss``, every gradient leaf and ``prefill``
    on a (1, 256) batch, two chunks of 128 so that the carried state is
    crossed, on the card against the CPU."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models import params as PM

    cfg = dataclasses.replace(ARCHS[XLSTM], dtype="float32", n_layers=8)
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    gen = torch.Generator().manual_seed(2)
    p_cpu = cpu.init_params(gen)
    p_gpu = PM.tree_map(lambda t: t.to("cuda"), p_cpu)
    toks = torch.randint(0, cfg.vocab, (1, 257), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want, g_cpu = _loss_and_grads(cpu, p_cpu, batch)
    got, g_gpu = _loss_and_grads(gpu, p_gpu, {k: t.cuda() for k, t in batch.items()})
    if not (math.isfinite(got) and abs(got - want) <= 2e-3):
        raise AssertionError(f"8-layer fp32 xLSTM loss: card {got} cpu {want}")
    worst = max(rel_err(a.cpu(), b, 2e-3)[1] for a, b in zip(g_gpu, g_cpu))
    l_cpu = cpu.prefill(p_cpu, {"tokens": batch["tokens"]})
    l_gpu = gpu.prefill(p_gpu, {"tokens": batch["tokens"].cuda()}).cpu()
    if l_gpu.shape != (1, 1, cfg.vocab) or not torch.isfinite(l_gpu).all():
        raise AssertionError(f"prefill logits of shape {tuple(l_gpu.shape)} or not finite")
    torch.testing.assert_close(l_gpu, l_cpu, rtol=2e-3, atol=2e-3)
    if not torch.equal(l_gpu.argmax(-1), l_cpu.argmax(-1)):
        raise AssertionError("prefill argmax differs between the card and the CPU")
    print(f"[full-width] fp32 8-layer xLSTM loss card {got:.6f} cpu {want:.6f}; "
          f"{len(g_cpu)} gradient leaves, worst max |diff| / max |grad| {worst:.3e}; prefill "
          f"max |logit diff| {float((l_gpu - l_cpu).abs().max()):.3e}, argmax equal")


def phase_serve(kernel_modules) -> dict:
    from repro_torch.launch import serve

    small = ["--requests", "4", "--prompt-len", "16", "--new-tokens", "8", "--dtype", "float32"]
    on_cpu = serve.main(small + ["--device", "cpu"])["tokens"]
    on_gpu = serve.main(small + ["--device", "cuda"])["tokens"]
    if not (on_cpu == on_gpu).all():
        raise AssertionError(f"small fp32 serve: card {on_gpu.tolist()} != cpu {on_cpu.tolist()}")
    print("[serve] small fp32 serve: card tokens equal the CPU's")

    for m in kernel_modules:
        m.launches = 0
    res = serve.main(["--full-config", "--device", "cuda", "--dtype", "bfloat16",
                      "--requests", str(SERVE["requests"]),
                      "--prompt-len", str(SERVE["prompt_len"]),
                      "--new-tokens", str(SERVE["new_tokens"])])
    counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernel_modules}
    toks = res["tokens"]
    if toks.shape != (SERVE["requests"], SERVE["new_tokens"]):
        raise AssertionError(f"served tokens of shape {toks.shape}")
    if toks.min() < 0 or toks.max() >= 151936:
        raise AssertionError("served tokens outside the vocabulary")
    print(f"[serve] launches {counts}; {res['tokens_per_s']:.1f} tok/s, "
          f"{res['ms_per_step']:.3f} ms per decode step")
    return {"counts": counts, "steps": res["steps"], "tokens_per_s": res["tokens_per_s"],
            "ms_per_step": res["ms_per_step"]}


def phase_train(kernel_modules) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    for m in kernel_modules:
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        res = train.main(["--full-config", "--device", "cuda", "--dtype", "bfloat16",
                          "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
                          "--steps", str(TRAIN["steps"]), "--ckpt-dir", ckpt_dir])
        ckpt_bytes = sum(p.stat().st_size for p in Path(ckpt_dir).rglob("*") if p.is_file())
    counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernel_modules}
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
    step_ms = statistics.median(res["step_ms"][1:])
    tokens_per_s = TRAIN_ROWS / (step_ms / 1e3)
    print(f"[train] launches {counts}; losses {losses}; median step {step_ms:.3f} ms over "
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
    return {"counts": counts, "steps": TRAIN["steps"], "batch": TRAIN["batch"],
            "seq": TRAIN["seq"], "losses": losses, "step_ms": res["step_ms"],
            "median_step_ms": step_ms, "tokens_per_s": tokens_per_s,
            "peak_memory_bytes": peak, "ckpt_bytes": ckpt_bytes,
            "ckpt_seconds": res["ckpt_seconds"], "fixed_batch_losses": fixed}


def phase_train_xlstm(kernel_modules) -> dict:
    """xlstm-1.3b on the card.  First ``launch.train.main`` at the smoke config
    (seq 64, 2 steps, its checkpoint in a temporary directory under
    ``build/``), so the launcher's path runs on the card.  Then the full
    model in bf16 at full width and depth, batch 4 x 512 from the launcher's
    corpus (``TokenDatasetSpec``, ``TokenLoader``, AdamW as the launcher sets
    it), parameters drawn on a CUDA generator, 4 steps of ``make_train_step``
    with the launch counts set to 0 just before and checked per step just
    after; then 8 steps on a fixed (2, 128) batch, whose loss must fall by
    0.05.  Cut: the launcher's final checkpoint, 41 GB at this size, is not
    written at full depth."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenDatasetSpec, TokenLoader
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt_dir:
        res = train.main(["--arch", XLSTM, "--device", "cuda", "--steps", "2", "--batch", "2",
                          "--seq", "64", "--ckpt-dir", ckpt_dir])
        if not (Path(ckpt_dir) / "step_000002" / "_COMMITTED").is_file():
            raise AssertionError("the xLSTM launcher wrote no final checkpoint")
    if res["restarts"] or not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"xLSTM launcher: {res['restarts']} restarts, losses {res['losses']}")
    print(f"[train_xlstm] launcher at the smoke config on the card: losses {res['losses']}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    B, S, steps = XLSTM_TRAIN["batch"], XLSTM_TRAIN["seq"], XLSTM_TRAIN["steps"]
    model = build_model(ARCHS[XLSTM], device="cuda")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10)
    t0 = time.perf_counter()
    params, opt = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = TokenDatasetSpec("train-corpus", n_sequences=max(256, B * 32), seq_len=S,
                            vocab=model.cfg.vocab, seed=0)
    it = iter(TokenLoader(spec, batch=B, items_per_chunk=train.ITEMS_PER_CHUNK))
    step = make_train_step(model, opt_cfg)
    for m in kernel_modules:
        m.launches = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        toks, labels = next(it)
        batch = {"tokens": torch.from_numpy(toks).long().cuda(),
                 "labels": torch.from_numpy(labels).long().cuda()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))      # waits for the step to finish
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernel_modules}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"xLSTM train losses {losses}")
    for name, per_step in XLSTM_PER_STEP.items():
        if counts[name] != per_step * steps:
            raise AssertionError(f"{name}: {counts[name]} launches in the xLSTM train run, "
                                 f"expected {per_step} x {steps} steps")
    median = statistics.median(step_ms[1:])
    tokens_per_s = B * S / (median / 1e3)
    print(f"[train_xlstm] launches {counts}; losses {losses}; step ms {step_ms}; median "
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
    print(f"[train_xlstm] fixed batch (2, 128), 8 steps: loss {fixed[0]:.4f} -> {fixed[-1]:.4f}")
    blocks = xlstm_block_ms(model, params, B, S)
    print(f"[train_xlstm] one block forward + backward at ({B}, {S}): {blocks}")
    return {"counts": counts, "steps": steps, "batch": B, "seq": S, "losses": losses,
            "step_ms": step_ms, "median_step_ms": median, "tokens_per_s": tokens_per_s,
            "peak_memory_bytes": peak, "init_seconds": init_s, "fixed_batch_losses": fixed,
            "launcher_smoke_losses": res["losses"], **blocks}


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
}
MODULE_OF = {"rmsnorm": "rmsnorm", "swiglu_mlp": "swiglu", "decode_attention": "decode_attention",
             "flash_attention": "flash_attention", "flash_attention_bwd": "flash_attention_bwd",
             "rmsnorm_bwd": "rmsnorm_bwd", "swiglu_mlp_bwd": "swiglu_bwd",
             "mlstm_scan": "mlstm_scan", "mlstm_scan_bwd": "mlstm_scan_bwd"}
#: the run whose launches a row reports as ``launches``: its slice's main path
MAIN_RUN = {"rmsnorm": "serve", "swiglu_mlp": "serve", "decode_attention": "serve",
            "flash_attention": "train", "flash_attention_bwd": "train", "rmsnorm_bwd": "train",
            "swiglu_mlp_bwd": "train", "mlstm_scan": "train_xlstm",
            "mlstm_scan_bwd": "train_xlstm"}


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
    torch.cuda.synchronize()
    print(f"[kernels] done at {time.perf_counter() - t0:.1f} s")
    phase_full_width()
    phase_full_width_grad()
    phase_xlstm_full_width()
    print(f"[full-width] done at {time.perf_counter() - t0:.1f} s")
    runs = {"serve": phase_serve(KERNEL_MODULES)}
    runs["train"] = phase_train(KERNEL_MODULES)
    gc.collect()
    torch.cuda.empty_cache()
    runs["train_xlstm"] = phase_train_xlstm(KERNEL_MODULES)
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
    for run in ("train", "train_xlstm"):
        print(json.dumps({run: {k: v for k, v in runs[run].items() if k != "counts"}}))
    print(json.dumps({"kernels": [{**{k: r[k] for k in keys},
                                   **{k: v for k, v in r.items() if k not in keys}}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
