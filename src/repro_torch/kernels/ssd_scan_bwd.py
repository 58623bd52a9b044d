"""SSD chunked scan backward on the card: the wrapper of ``csrc/ssd_scan_bwd.cu``.

The Pallas ssd_scan kernel is forward only; the JAX package's training path
differentiates ``repro.models.hymba.ssd_scan`` with XLA.  This is the
explicit backward of the port's forward, ``ref.ssd_scan_bwd_ref`` on the
card: the gradient of the carried state walked over the chunks in reverse,
one thread per state element; dx in 64 x 64 tiles over all (b, h, chunk) at
once; db, dc and dlf in one block per chunk, which holds the whole chunk's
(L, L) weights so that every sum stays in the block; no atomics.  What
bounds it on the H100: bytes, 88 MB a call at the training shape (0.026 ms
at 3.35 TB/s), against 5.4 GFLOP of products, run here in fp32 on the CUDA
cores.  It allocates B * H * nc * chd * N * 4 bytes of scratch for the
carried gradient (7 MB at the training shape), freed when it returns.
"""

from __future__ import annotations

import torch

from . import build
from .flash_attention import on_one_gpu
from .ssd_scan import DTYPES, SSDSaved, check_args

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 4 launches)
launches = 0


def ssd_scan_bwd_cuda(lf, b, x, c, saved: SSDSaved, dy, *, chunk: int):
    """Launch the kernels on CUDA tensors; returns ``(dlf, db, dx, dc)`` in the
    inputs' dtypes.  ``dy`` may be a strided view or of another float type; it
    is copied to a contiguous tensor of x's dtype."""
    global launches
    on_one_gpu("ssd_scan_bwd", lf, b, x, c, dy, *saved)
    L = check_args(lf, b, x, c, chunk)
    B, S, H, chd = x.shape
    N = b.shape[-1]
    if dy.shape != x.shape:
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    want = SSDSaved(states=(B, H, S // L, chd, N), cum=(B, H, S))
    for name, t, shape in zip(SSDSaved._fields, saved, want):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd: saved {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected contiguous float32 {shape}")
    dy = dy.to(x.dtype).contiguous()
    lib = build.library()
    grads = (torch.empty_like(lf), torch.empty_like(b), torch.empty_like(x), torch.empty_like(c))
    dhend = torch.empty_like(saved.states)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_ssd_scan_bwd(
            *(t.data_ptr() for t in (b, x, c, dy, saved.states, saved.cum)),
            *(t.data_ptr() for t in grads), dhend.data_ptr(),
            B, S, H, N, chd, L, DTYPES[x.dtype], stream,
        )
    build.check(err, "rt_ssd_scan_bwd")
    launches += 1
    return grads
