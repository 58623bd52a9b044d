"""SSD chunked scan forward on the card: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_scan_kernel``
(``src/repro/kernels/ssd_scan.py``).  What bounds it on the H100: bytes, at
hymba-1.5b's training shape (B 2, S 2176, H 8, N 16, chd 400, chunk 128) 58
MB of inputs and outputs a call, 0.017 ms at 3.35 TB/s, against 2.7 GFLOP of
causal and state products.  Its design: the cumulative log-decay of each
chunk in one pass; each chunk's own state and then the output tiles over all
(b, h, chunk) at once; only the carried (chd, N) state walks the chunks in
order, one thread per state element; all sums in fp32 on the CUDA cores
(tensor cores are later work).  The kernels read the model's (B, S, H, .)
layout as it is.  The forward writes the fp32 state at every chunk's start
for the backward: B * H * nc * chd * N * 4 bytes, 7 MB a call at the
training shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .flash_attention import on_one_gpu
from .ref import ssd_chunk_len

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 4 launches)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the longest chunk and the widest state the kernels hold in shared memory
MAX_CHUNK = 128
MAX_STATE = 64
#: (b, h, chunk) entries of one launch: the grid's y and z extents
MAX_ENTRIES = 65535


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


def ssd_scan_cuda(lf, b, x, c, *, chunk: int):
    """Launch the kernels on contiguous CUDA tensors; returns ``(y, h_last,
    saved)``: y (B, S, H, chd) in x's dtype, the fp32 final state (B, H, chd,
    N) and the :class:`SSDSaved` tensors the backward reads."""
    global launches
    on_one_gpu("ssd_scan", lf, b, x, c)
    L = check_args(lf, b, x, c, chunk)
    lib = build.library()
    B, S, H, chd = x.shape
    N = b.shape[-1]
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h_last = torch.empty((B, H, chd, N), **f32)
    saved = SSDSaved(states=torch.empty((B, H, S // L, chd, N), **f32),
                     cum=torch.empty((B, H, S), **f32))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_ssd_scan(
            lf.data_ptr(), b.data_ptr(), x.data_ptr(), c.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), saved.states.data_ptr(), saved.cum.data_ptr(),
            B, S, H, N, chd, L, DTYPES[x.dtype], stream,
        )
    build.check(err, "rt_ssd_scan")
    launches += 1
    return y, h_last, saved
