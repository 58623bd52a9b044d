"""Row RMSNorm backward on the card: the wrapper of ``csrc/rmsnorm_bwd.cu``.

The Pallas rmsnorm kernel is forward only; the JAX package's training path
differentiates ``repro.models.layers.rms_norm`` with XLA.  What bounds it on
the H100: device memory, at 3 * D * bytes per row (read x and dy, write dx)
plus fp32 partial sums of dgamma.  Its design: one block per run of rows,
dx row by row with fp32 block sums; dgamma as one fp32 partial row per
block, summed over the blocks in order by a second launch, so it is the same
from run to run (no atomics).
"""

from __future__ import annotations

import torch

from . import build
from .rmsnorm import DTYPES, check_args

#: wrapper calls that launched the kernels since the count was last set to 0
launches = 0

#: blocks of the first launch per SM of the card
BLOCKS_PER_SM = 2
#: dgamma's partial row lives in shared memory: D fp32 values within 48 KB
MAX_D = 12288


def rmsnorm_bwd_cuda(x, gamma, dy, eps: float = 1e-5):
    """Launch the kernels on CUDA tensors; x, dy: (..., D); returns ``(dx, dgamma)``."""
    global launches
    if not (all(t.is_cuda for t in (x, gamma, dy)) and x.device == gamma.device == dy.device):
        raise ValueError(f"rmsnorm_bwd: tensors on {x.device}, {gamma.device} and {dy.device}, "
                         "expected one GPU")
    check_args(x, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    dy = dy.contiguous()
    D = x.shape[-1]
    if D > MAX_D:
        raise ValueError(f"rmsnorm_bwd: D {D} > {MAX_D}")
    lib = build.library()
    rows = x.numel() // D if D else 0
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    if rows == 0:
        return dx, dgamma.zero_()
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_block = -(-rows // (BLOCKS_PER_SM * n_sm))
    n_blocks = -(-rows // per_block)
    partial = torch.empty((n_blocks, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_rmsnorm_bwd(x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                 partial.data_ptr(), dgamma.data_ptr(), rows, D, per_block,
                                 n_blocks, float(eps), DTYPES[x.dtype], stream)
    build.check(err, "rt_rmsnorm_bwd")
    launches += 1
    return dx, dgamma
