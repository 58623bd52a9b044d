"""SwiGLU MLP on the card: the wrapper of ``csrc/swiglu.cu``.

Replaces the Pallas TPU kernel ``_swiglu_kernel`` / ``swiglu_mlp``
(``src/repro/kernels/swiglu.py``).  Two products on one stream, each with
fp32 sums: ``h = silu(x @ Wg) * (x @ Wu)`` into an (N, F) buffer in x's
dtype, then ``y = h @ Wd``.  The TPU kernel keeps h in VMEM beside a
(block_m, D) fp32 accumulator; on the H100 that accumulator (800 KB for 128
rows at Hymba's D = 1600) does not fit a block's shared memory, so h makes
a round trip through device memory (N * F * 2 bytes, an eighth of the
bound's bytes at training rows).

:func:`route` picks the kernel from the dtype, the shape and the pointers'
alignment, nothing else:

- ``"wgmma"`` (bf16, N >= 64, D and F multiples of 8, 16-byte aligned
  pointers: TMA's rules): Hopper's tensor cores fed by TMA through a
  4-stage mbarrier ring, 128-row tiles.  Bound by operations (6 N D F at
  989 TFLOP/s: 0.072 ms at qwen's 4096 x 1024 x 2816, 0.23 ms at Hymba's
  4352 x 1600 x 5504).
- ``"wgmma_split_k"`` (the same at N < 64, serving's 8 rows): 64-row tiles
  with the contraction split over about one block per SM, fp32 partial sums
  added in a fixed order by a second kernel.  Bound by the three weight
  matrices' bytes (17.3 MB a qwen layer, 0.005 ms).
- ``"simt"`` (fp32, and bf16 that TMA cannot take): the CUDA-core kernel
  built for decode, each block 32 output columns x 8 rows.

Asked with ``save_ab`` (``ops.swiglu_mlp`` when a gradient is needed), the
tensor-core routes also write ``a = x @ Wg`` and ``b = x @ Wu`` in bf16 from
the gated product's fp32 sums, which the backward (``swiglu_bwd.py``) reads
instead of computing them again: 2 N F bf16 more held a layer.
"""

from __future__ import annotations

import torch

from . import build

#: wrapper calls that launched the kernels since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "wgmma_split_k", "simt")
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: rows from which the tensor cores take 128-row tiles without split-K (as
#: ``rt_swiglu_tc`` decides on its side)
MIN_TILE_ROWS = 64


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


def route(x, w_gate, w_up, w_down) -> str:
    """The kernel that takes these (checked) arguments, one of :data:`ROUTES`."""
    D, F = w_gate.shape
    if (x.dtype != torch.bfloat16 or D % 8 or F % 8
            or any(t.data_ptr() % 16 for t in (x, w_gate, w_up, w_down))):
        return "simt"
    return "wgmma" if x.numel() // D >= MIN_TILE_ROWS else "wgmma_split_k"


_sm_count = build.sm_count


def split_k(N: int, D: int, F: int, sms: int) -> tuple[int, int]:
    """Blocks along the contraction of the gated and the down product at N <
    64 rows: as many as make the column tiles (128 columns gated, 256 down)
    fill ``sms`` blocks, and no more than the contraction's 64-deep steps."""
    def split(cols: int, tile: int, depth: int) -> int:
        tiles = -(-cols // tile) * -(-N // 64)
        return max(1, min(-(-depth // 64), -(-sms // tiles)))

    return split(F, 128, D), split(D, 256, F)


def launch(route_name: str, x, w_gate, w_up, w_down, save_ab: bool = False):
    """Run ``route_name``'s kernels on checked CUDA tensors; the caller counts.
    Returns the output, or with ``save_ab`` ``(out, a, b)``: a and b (N, F) from
    the tensor-core routes, None from ``"simt"``."""
    D, F = w_gate.shape
    N = x.numel() // D
    out = torch.empty_like(x)
    h = torch.empty((N, F), dtype=x.dtype, device=x.device)
    a = b = None
    ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
            out.data_ptr())
    if route_name == "simt":
        build.launch("rt_swiglu", x.device, *ptrs, N, D, F, DTYPES[x.dtype])
    else:
        sg, sd = (split_k(N, D, F, _sm_count(x.device)) if route_name == "wgmma_split_k"
                  else (1, 1))
        # fp32 partial sums of split-K, used by the two products in turn
        part = torch.empty(max(2 * sg * N * F, sd * N * D) if sg * sd > 1 else 0,
                           dtype=torch.float32, device=x.device)
        if save_ab:
            a, b = (torch.empty((N, F), dtype=x.dtype, device=x.device) for _ in range(2))
        build.launch("rt_swiglu_tc", x.device, *ptrs, part.data_ptr(),
                     a.data_ptr() if save_ab else 0, b.data_ptr() if save_ab else 0,
                     N, D, F, sg, sd)
    return (out, a, b) if save_ab else out


def swiglu_cuda(x, w_gate, w_up, w_down, *, save_ab: bool = False):
    """Launch the kernels on CUDA tensors; x: (..., D), Wg/Wu: (D, F), Wd: (F, D).
    Returns the output, or with ``save_ab`` ``(out, a, b)`` as :func:`launch`.
    On meta tensors everything but the launch runs and nothing is counted."""
    global launches
    build.on_card("swiglu", x, w_gate, w_up, w_down)
    check_args(x, w_gate, w_up, w_down)
    if x.numel() == 0:
        return (torch.empty_like(x), None, None) if save_ab else torch.empty_like(x)
    name = route(x, w_gate, w_up, w_down)
    out = launch(name, x, w_gate, w_up, w_down, save_ab)
    if x.is_cuda:
        launches += 1
        route_launches[name] += 1
    return out

