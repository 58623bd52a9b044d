"""SSD chunked scan forward on the card: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_scan_kernel``
(``src/repro/kernels/ssd_scan.py``).  What bounds it on the H100: bytes, at
hymba-1.5b's training shape (B 2, S 2176, H 8, N 16, chd 400, chunk 128) 58
MB of inputs and outputs a call, 0.017 ms at 3.35 TB/s, against 2.7 GFLOP of
causal and state products.  Only the carried (chd, N) state walks the chunks
in order, one thread per state element; each chunk's own state and the
output tiles run over all (b, h, chunk) at once, reading the model's
(B, S, H, .) layout as it is.  :func:`route` picks the kernels from the
dtype, the shape and the pointers' alignment, nothing else:

- ``"wgmma"`` (bf16 b, x, c; chunk 128; N a multiple of 16 up to 64; chd a
  multiple of 8 up to 448; 16-byte aligned): three launches.  Each chunk's
  cum and own state ``x^T (w o b)``, then the state walk, then y: the Gram
  ``C B^T``, masked and decayed in registers and rounded to bf16, times x,
  plus the state read-out ``C H^T`` with H rounded to bf16, all wgmma with
  fp32 accumulators; tiles of x, b and c by TMA from the model's layout
  (``ssd.cuh``, ``tc``).  It rounds what ``ref.ssd_scan_ref(...,
  bf16_products=True)`` rounds.
- ``"simt"`` (fp32, any other shape): four launches, every product an fp32
  FMA on the CUDA cores from shared-memory tiles.

The forward writes the fp32 state at every chunk's start for the backward:
B * H * nc * chd * N * 4 bytes, 7 MB a call at the training shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .ref import ssd_chunk_len

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 3 launches on "wgmma", 4 on "simt")
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "simt")
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: the longest chunk and the widest state the kernels hold in shared memory
MAX_CHUNK = 128
MAX_STATE = 64
#: (b, h, chunk) entries of one launch: the grid's y and z extents
MAX_ENTRIES = 65535
#: the chunk and the widest chd of the tensor-core route
TC_CHUNK = 128
TC_MAX_CHD = 448


class SSDSaved(NamedTuple):
    """What the forward keeps for the backward, both fp32."""

    states: torch.Tensor   # (B, H, nc, chd, N): the state at each chunk's start
    cum: torch.Tensor      # (B, H, S): the inclusive sum of lf within each chunk


def check_args(lf, b, x, c, chunk: int) -> int:
    """Raise unless the kernels take these arguments; return the chunk length L."""
    if not all(t.is_contiguous() for t in (lf, b, x, c)):
        raise ValueError("ssd_scan: lf, b, x and c must be contiguous")
    if lf.dtype != torch.float32:
        raise TypeError(f"ssd_scan: lf must be float32, not {lf.dtype}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: unsupported dtype {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("ssd_scan: b, x and c must share a dtype")
    L = ssd_chunk_len(lf, b, x, c, chunk)
    B, S, H = lf.shape
    if L > MAX_CHUNK or b.shape[-1] > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {L} > {MAX_CHUNK} or state {b.shape[-1]} > "
                         f"{MAX_STATE}")
    if B * H * (S // L) > MAX_ENTRIES:
        raise ValueError(f"ssd_scan: {B * H * (S // L)} (b, h, chunk) entries > {MAX_ENTRIES}")
    return L


def route(L: int, b, x, c, *more) -> str:
    """The kernels that take these (checked, contiguous) arguments, one of
    :data:`ROUTES`; ``more``: further bf16 tensors the kernels read by TMA
    (the backward's dy)."""
    N, chd = b.shape[-1], x.shape[-1]
    if (x.dtype != torch.bfloat16 or L != TC_CHUNK or N == 0 or N % 16 or chd == 0
            or chd % 8 or chd > TC_MAX_CHD or any(t.data_ptr() % 16 for t in (b, x, c, *more))):
        return "simt"
    return "wgmma"


def launch(route_name: str, lf, b, x, c, L: int):
    """Run ``route_name``'s kernels on checked contiguous CUDA tensors; the caller counts."""
    B, S, H, chd = x.shape
    N = b.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h_last = torch.empty((B, H, chd, N), **f32)
    saved = SSDSaved(states=torch.empty((B, H, S // L, chd, N), **f32),
                     cum=torch.empty((B, H, S), **f32))
    ptrs = (lf.data_ptr(), b.data_ptr(), x.data_ptr(), c.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), saved.states.data_ptr(), saved.cum.data_ptr())
    if route_name == "wgmma":
        build.launch("rt_ssd_scan_tc", x.device, *ptrs, B, S, H, N, chd, L)
    else:
        build.launch("rt_ssd_scan", x.device, *ptrs, B, S, H, N, chd, L,
                     DTYPES[x.dtype])
    return y, h_last, saved


def ssd_scan_cuda(lf, b, x, c, *, chunk: int):
    """Launch the kernels on contiguous CUDA tensors; returns ``(y, h_last,
    saved)``: y (B, S, H, chd) in x's dtype, the fp32 final state (B, H, chd,
    N) and the :class:`SSDSaved` tensors the backward reads."""
    global launches
    build.on_card("ssd_scan", lf, b, x, c)
    L = check_args(lf, b, x, c, chunk)
    name = route(L, b, x, c)
    out = launch(name, lf, b, x, c, L)
    if x.is_cuda:
        launches += 1
        route_launches[name] += 1
    return out
