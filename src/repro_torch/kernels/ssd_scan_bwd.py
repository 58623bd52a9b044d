"""SSD chunked scan backward on the card: the wrapper of ``csrc/ssd_scan_bwd.cu``.

The Pallas ssd_scan kernel is forward only; the JAX package's training path
differentiates ``repro.models.hymba.ssd_scan`` with XLA.  This is the
explicit backward of the port's forward, ``ref.ssd_scan_bwd_ref`` on the
card: each chunk's ``sum_t exp(cum_t) dy_t c_t^T``, then the gradient of the
carried state walked over the chunks in reverse, one thread per state
element, then dx over all (b, h, chunk) at once, then db, dc and dlf in one
block per chunk, every sum inside the block in a fixed order: no atomics, so
two calls on the same inputs give the same bits.  What bounds it on the
H100: bytes, 88 MB a call at hymba-1.5b's training shape (0.026 ms at 3.35
TB/s), against 5.4 GFLOP of products.  The route is the forward's
(:func:`ssd_scan.route`, with dy among the tensors read by TMA):

- ``"wgmma"``: the products on the tensor cores, rounding what
  ``ref.ssd_scan_bwd_ref(..., bf16_products=True)`` rounds: dx as the
  forward's y with b and c swapped; ``A = dy x^T`` and ``A^T = x dy^T`` as
  two products over chd, then ``dc = A b`` and ``db = A^T c`` with A
  rounded to bf16 (``csrc/ssd_scan_bwd.cu``, ``ssd_tc_bwd_dbc_kernel``).
- ``"simt"``: fp32 FMAs on the CUDA cores.

It allocates B * H * nc * chd * N * 4 bytes of scratch for the carried
gradient (7 MB at the training shape), freed when it returns.
"""

from __future__ import annotations

import torch

from . import build
from . import ssd_scan as _fwd
from .flash_attention import on_one_gpu
from .ssd_scan import DTYPES, ROUTES, SSDSaved, check_args

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 4 launches on either route)
launches = 0
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)


def launch(route_name: str, lf, b, x, c, saved: SSDSaved, dy, L: int):
    """Run ``route_name``'s kernels on checked contiguous CUDA tensors (dy in
    x's dtype); the caller counts.  Returns ``(dlf, db, dx, dc)``."""
    lib = build.library()
    B, S, H, chd = x.shape
    N = b.shape[-1]
    grads = (torch.empty_like(lf), torch.empty_like(b), torch.empty_like(x), torch.empty_like(c))
    dhend = torch.empty_like(saved.states)
    ptrs = (*(t.data_ptr() for t in (b, x, c, dy, saved.states, saved.cum)),
            *(t.data_ptr() for t in grads), dhend.data_ptr())
    if route_name == "wgmma":
        build.launch(lib.rt_ssd_scan_bwd_tc, "rt_ssd_scan_bwd_tc", x.device, *ptrs,
                     B, S, H, N, chd, L)
    else:
        build.launch(lib.rt_ssd_scan_bwd, "rt_ssd_scan_bwd", x.device, *ptrs,
                     B, S, H, N, chd, L, DTYPES[x.dtype])
    return grads


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
    name = _fwd.route(L, b, x, c, dy)
    grads = launch(name, lf, b, x, c, saved, dy, L)
    launches += 1
    route_launches[name] += 1
    return grads
