#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. card: the card's name and power limit from ``nvidia-smi``; TF32 off.
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, at the
   qwen1.5-0.5b serving shapes and a small shape, fp32 and bf16; then its
   time beside its plain version's, one PyTorch library call's, and its
   bound from bytes and operations.
4. full width: qwen1.5-0.5b in fp32, one ``decode_step`` on the card against
   the same weights on the CPU.
5. serve: a small fp32 serve on the card against the CPU, token for token;
   then qwen1.5-0.5b in bf16 through ``repro_torch.launch.serve.main``
   (8 requests, prompt 128, 32 new tokens) with the kernels' launch counts
   set to 0 just before and read just after.
6. output: one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen1.5-0.5b"
SERVE = dict(requests=8, prompt_len=128, new_tokens=32)
CACHE_LEN = SERVE["prompt_len"] + SERVE["new_tokens"] + 8      # as launch/serve.py sizes it
VALID = SERVE["prompt_len"] + SERVE["new_tokens"]              # visible positions, last step
TOL = {  # tests/test_kernels.py
    "rmsnorm": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
    "swiglu_mlp": {torch.float32: 1e-4, torch.bfloat16: 5e-2},
    "decode_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
}
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


def time_ms(fn, arg_sets, rounds: int) -> float:
    """Milliseconds per call, CUDA events around back-to-back calls that cycle
    through ``arg_sets`` (distinct weights keep the L2 cache cold, as in the
    model's walk over its layers)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for args in arg_sets:
            fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (rounds * len(arg_sets))


def max_err(got, want, tol) -> float:
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return float((got.float() - want.float()).abs().max())


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
    errs = {}
    for rows, D in ((SERVE["requests"], 1024), (37, 96)):
        for dt in (torch.float32, torch.bfloat16):
            x, g = randn(gen, (rows, D), dt), randn(gen, (D,), dt)
            got = ops.rmsnorm(x, g, eps=1e-5)
            errs[(rows, D, dt)] = max_err(got, ref.rmsnorm_ref(x, g, 1e-5),
                                          TOL["rmsnorm"][dt])
    print(f"[kernels] rmsnorm errors {errs}")
    N, D, dt = SERVE["requests"], 1024, torch.bfloat16
    sets = [(randn(gen, (N, D), dt), randn(gen, (D,), dt)) for _ in range(24)]
    esize = 2
    b_ms, b_by = bound((2 * N * D + D) * esize, 4 * N * D, dt, rate)
    return {
        "name": "rmsnorm", "shape": f"x ({N}, {D}) bf16",
        "max_abs_err": errs[(N, D, dt)],
        "ms": time_ms(lambda x, g: ops.rmsnorm(x, g, eps=1e-5), sets, 20),
        "plain_ms": time_ms(lambda x, g: ref.rmsnorm_ref(x, g, 1e-5), sets, 20),
        "library_ms": time_ms(lambda x, g: F.rms_norm(x, (D,), g, 1e-5), sets, 20),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check_swiglu(gen, ops, ref, rate):
    errs = {}
    for N, D, Fd in ((SERVE["requests"], 1024, 2816), (20, 96, 224)):
        for dt in (torch.float32, torch.bfloat16):
            x = randn(gen, (N, D), dt)
            wg, wu = randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (D, Fd), dt, D ** -0.5)
            wd = randn(gen, (Fd, D), dt, Fd ** -0.5)
            got = ops.swiglu_mlp(x, wg, wu, wd)
            errs[(N, D, Fd, dt)] = max_err(got, ref.swiglu_ref(x, wg, wu, wd),
                                           TOL["swiglu_mlp"][dt])
    print(f"[kernels] swiglu_mlp errors {errs}")
    N, D, Fd, dt = SERVE["requests"], 1024, 2816, torch.bfloat16
    sets = [(randn(gen, (N, D), dt), randn(gen, (D, Fd), dt, D ** -0.5),
             randn(gen, (D, Fd), dt, D ** -0.5), randn(gen, (Fd, D), dt, Fd ** -0.5))
            for _ in range(24)]
    b_ms, b_by = bound((2 * N * D + 3 * D * Fd) * 2, 6 * N * D * Fd + 4 * N * Fd, dt, rate)
    return {
        "name": "swiglu_mlp", "shape": f"x ({N}, {D}), d_ff {Fd} bf16",
        "max_abs_err": errs[(N, D, Fd, dt)],
        "ms": time_ms(ops.swiglu_mlp, sets, 5),
        "plain_ms": time_ms(ref.swiglu_ref, sets, 5),
        "library_ms": time_ms(lambda x, wg, wu, wd: (F.silu(x @ wg) * (x @ wu)) @ wd, sets, 5),
        "bound_ms": b_ms, "bound_by": b_by,
    }


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


REPLACES = {
    "rmsnorm": ("src/repro/kernels/rmsnorm.py:19", "csrc/rmsnorm.cu", 2 * 24 + 1),
    "swiglu_mlp": ("src/repro/kernels/swiglu.py:20", "csrc/swiglu.cu", 24),
    "decode_attention": ("src/repro/kernels/decode_attention.py:30",
                         "csrc/decode_attention.cu", 24),
}
MODULE_OF = {"rmsnorm": "rmsnorm", "swiglu_mlp": "swiglu", "decode_attention": "decode_attention"}


def main() -> None:
    name, _ = phase_card()
    rate = memory_rate(name)
    t0 = time.perf_counter()
    phase_build()

    from repro_torch.kernels import KERNEL_MODULES, ops, ref

    gen = torch.Generator().manual_seed(0)
    rows = [check_rmsnorm(gen, ops, ref, rate), check_swiglu(gen, ops, ref, rate),
            check_decode_attention(gen, ops, ref, rate)]
    torch.cuda.synchronize()
    phase_full_width()
    served = phase_serve(KERNEL_MODULES)

    for row in rows:
        replaces, src, per_step = REPLACES[row["name"]]
        launches = served["counts"][MODULE_OF[row["name"]]]
        if launches != per_step * served["steps"]:
            raise AssertionError(f"{row['name']}: {launches} launches in the serve run, "
                                 f"expected {per_step} x {served['steps']} steps")
        row.update(route="cuda", source=f"src/repro_torch/kernels/{src}", replaces=replaces,
                   launches=launches)
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"serve": {k: served[k] for k in ("tokens_per_s", "ms_per_step", "steps")}}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
