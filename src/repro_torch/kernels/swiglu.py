"""SwiGLU MLP on the card: the wrapper of ``csrc/swiglu.cu``.

Replaces the Pallas TPU kernel ``_swiglu_kernel`` / ``swiglu_mlp``
(``src/repro/kernels/swiglu.py``).  What bounds it on the H100 at decode:
device memory, for the three weight matrices read once (3 * D * F * bytes;
17.3 MB a layer for qwen1.5-0.5b in bf16), far above its 6 * N * D * F
operations at N = 8 rows.  Its design: two launches of one kernel template,
``h = silu(x @ Wg) * (x @ Wu)`` into an (N, F) scratch buffer in x's dtype,
then ``y = h @ Wd``, each with fp32 sums; every block owns 32 output columns
and 8 rows, so each weight is read once per 8 rows.  The TPU kernel keeps h
on chip; the round trip here (N * F * bytes, 45 KB at N = 8) is what a fused
kernel would save.
"""

from __future__ import annotations

import torch

from . import build

#: wrapper calls that launched the kernels since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(x, w_gate, w_up, w_down) -> None:
    """Raise unless the kernels take these arguments."""
    if x.dtype not in DTYPES:
        raise TypeError(f"swiglu: unsupported dtype {x.dtype}")
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if w.dtype != x.dtype:
            raise TypeError(f"swiglu: {name} is {w.dtype}, x is {x.dtype}")
        if not w.is_contiguous():
            raise ValueError(f"swiglu: {name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("swiglu: x must be contiguous")
    D = x.shape[-1]
    F = w_gate.shape[-1]
    if w_gate.shape != (D, F) or w_up.shape != (D, F) or w_down.shape != (F, D):
        raise ValueError(
            f"swiglu: weights {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
            f"{tuple(w_down.shape)} do not match x {tuple(x.shape)}"
        )
    if (x.numel() // max(1, D) + 7) // 8 > 65535:
        raise ValueError("swiglu: too many rows for one launch")


def swiglu_cuda(x, w_gate, w_up, w_down) -> torch.Tensor:
    """Launch the kernels on CUDA tensors; x: (..., D), Wg/Wu: (D, F), Wd: (F, D)."""
    global launches
    tensors = (x, w_gate, w_up, w_down)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"swiglu: tensors on {[str(t.device) for t in tensors]}, expected one GPU")
    check_args(x, w_gate, w_up, w_down)
    lib = build.library()
    D, F = w_gate.shape
    N = x.numel() // D
    out = torch.empty_like(x)
    if N == 0:
        return out
    h = torch.empty((N, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_swiglu(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                            h.data_ptr(), out.data_ptr(), N, D, F, DTYPES[x.dtype], stream)
    build.check(err, "rt_swiglu")
    launches += 1
    return out

