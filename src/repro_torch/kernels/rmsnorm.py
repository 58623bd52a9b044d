"""Row RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm``
(``src/repro/kernels/rmsnorm.py``).  What bounds it on the H100: device
memory, at 2 * D * bytes per row (read x, write y) plus gamma once.  At decode
shapes (8 rows of D = 1024) that is a few kilobytes, so a launch costs more
than the work: the kernel is launch-bound there, and the cure is fewer
launches (fusing the norm into its neighbours, CUDA graphs), not a faster
body.  Its design: one block per row, the sum of squares reduced in fp32 by
warp shuffles, then the scale by gamma in fp32 and one cast, the Pallas order.
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(x: torch.Tensor, gamma: torch.Tensor) -> None:
    """Raise unless the kernel takes these arguments."""
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtype {x.dtype}")
    if gamma.dtype != x.dtype:
        raise TypeError(f"rmsnorm: gamma is {gamma.dtype}, x is {x.dtype}")
    if x.ndim < 1 or gamma.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: gamma {tuple(gamma.shape)} does not match x {tuple(x.shape)}")
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
    if x.numel() // max(1, x.shape[-1]) >= 2**31:
        raise ValueError("rmsnorm: too many rows for one launch")


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; x: (..., D), gamma: (D,)."""
    global launches
    if not (x.is_cuda and gamma.is_cuda and x.device == gamma.device):
        raise ValueError(f"rmsnorm: tensors on {x.device} and {gamma.device}, expected one GPU")
    check_args(x, gamma)
    lib = build.library()
    out = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_rmsnorm(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), rows, D,
                             float(eps), DTYPES[x.dtype], stream)
    build.check(err, "rt_rmsnorm")
    launches += 1
    return out

