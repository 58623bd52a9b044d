"""Row RMSNorm backward on the card: the wrapper of ``csrc/rmsnorm_bwd.cu``.

The Pallas rmsnorm kernel is forward only; the JAX package's training path
differentiates ``repro.models.layers.rms_norm`` with XLA.  What bounds it on
the H100: device memory, at 3 * D * bytes per row (read x and dy, write dx)
plus fp32 partial rows of dgamma.  dgamma is one fp32 partial row per block,
summed over the blocks in a fixed order by a second launch, so it is the
same from run to run (no atomics).  :func:`route` picks the body from the
dtype, D and the pointers' alignment, nothing else:

- ``"vec"`` (D a multiple of 8, a row of at most :data:`VEC_MAX_ROW_BYTES`,
  16-byte aligned x, gamma and dy): one warp a row, x and dy read once by
  TMA bulk copies, both row sums by warp shuffles alone, each lane's dgamma
  columns summed in registers over its warp's rows; as many blocks as the
  card holds at once, at most :data:`VEC_MAX_BLOCKS_PER_SM` an SM.
- ``"block"`` (any other D up to :data:`MAX_D`): one block of 256 threads per
  run of rows, the row sums across the block through shared memory, the row
  read twice.

The host path is the forward's lean one: the checks that depend only on
shapes, dtypes and devices run once per such key (``build.checked_once``),
contiguity and alignment on every call, and the launch takes PyTorch's raw
stream handle without a device context (``build.launch``).  The launch
shape (blocks, and so the partial rows of dgamma) is worked out here, once
per key, from the cached SM count and, for ``"vec"``, the kernel's own
warps a block and occupancy (``rt_rmsnorm_bwd_vec_config``, which also
raises its shared-memory limit on that device).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .rmsnorm import DTYPES, check_args

#: wrapper calls that launched the kernels since the count was last set to 0
launches = 0

ROUTES = ("vec", "block")
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: blocks of the ``"block"`` body per SM of the card
BLOCKS_PER_SM = 2
#: the ``"block"`` body's dgamma partial row lives in shared memory: D fp32
#: values within 48 KB
MAX_D = 12288
#: the longest row of the ``"vec"`` body, in bytes: a lane's dgamma sums in
#: registers (128 at 8 KB of bf16: xlstm-1.3b's mLSTM output norm, D = 4096)
VEC_MAX_ROW_BYTES = 8192
#: at most this many ``"vec"`` blocks an SM, each writing a partial row; the
#: launch takes as many as the kernel's shared memory lets fit, up to this
#: (one at hymba-1.5b's rows, two at qwen1.5-0.5b's)
VEC_MAX_BLOCKS_PER_SM = 2
#: (shapes, dtypes, devices of x, gamma, dy) -> {route: launch shape} of the
#: routes that D allows; filled on first sight
_checked: dict = {}


_sm_count = build.sm_count


def _vec_row(x: torch.Tensor) -> bool:
    """Whether the ``"vec"`` body holds a row of x: D a multiple of 8, at most
    :data:`VEC_MAX_ROW_BYTES`."""
    D = x.shape[-1]
    return D % 8 == 0 and 0 < D * x.element_size() <= VEC_MAX_ROW_BYTES


#: rows of x and of dy in flight a warp of the ``"vec"`` body (``kVecStages``)
VEC_STAGES = 3


def vec_config_h100(D: int, dtype: torch.dtype) -> tuple[int, int]:
    """``(warps a block, blocks an SM)`` of the ``"vec"`` body at row length D,
    as ``rt_rmsnorm_bwd_vec_config`` finds them on an H100 SXM: the kernel
    instance's warps (``kVecWarps``), and as many blocks as its shared memory
    (``vec_smem``, its barriers and the block's reserved kilobyte) lets fit in
    :data:`build.H100_SXM`'s (registers and threads allow more).  The meta
    route's; ``chip_smoke.py`` holds it against the card's."""
    size = torch.empty((), dtype=dtype, device="meta").element_size()
    per_lane = -(-(D // (16 // size)) // 32)
    vec = next(v for v in (1, 2, 4, 8, 16) if per_lane <= v)
    warps = 4 if vec * 32 * 16 > 4096 else 8
    smem = warps * VEC_STAGES * 2 * D * size
    block = smem + warps * VEC_STAGES * 8 + build.H100_SXM["reserved_shared_memory_per_block"]
    return warps, build.H100_SXM["shared_memory_per_sm"] // block


def _vec_blocks(x: torch.Tensor, rows: int, sms: int) -> int:
    """Blocks of the ``"vec"`` body for ``rows`` rows of x's D and dtype: one
    row a warp at most, no more than the card holds at once (the kernel's own
    occupancy, capped at :data:`VEC_MAX_BLOCKS_PER_SM` an SM).  Raises the
    kernel's shared-memory limit on x's device; on the meta device, the
    H100's (:func:`vec_config_h100`)."""
    if x.device.type == "meta":
        warps, per_sm = vec_config_h100(x.shape[-1], x.dtype)
        return min(-(-rows // warps), min(per_sm, VEC_MAX_BLOCKS_PER_SM) * sms)
    warps, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(x.device):
        build.check(build.library().rt_rmsnorm_bwd_vec_config(
            x.shape[-1], DTYPES[x.dtype], ctypes.byref(warps), ctypes.byref(per_sm)),
            "rt_rmsnorm_bwd_vec_config")
    return min(-(-rows // warps.value), min(per_sm.value, VEC_MAX_BLOCKS_PER_SM) * sms)


def _check_key(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor) -> dict:
    """Raise unless one GPU, :func:`check_args` and the kernels take the
    arguments; the launch shape of each route D allows: ``{"block":
    (rows a block, blocks)}``, and ``"vec"``'s blocks where :func:`_vec_row`."""
    build.on_card("rmsnorm_bwd", x, gamma, dy)
    check_args(x, gamma)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"rmsnorm_bwd: dy {tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[-1] > MAX_D:
        raise ValueError(f"rmsnorm_bwd: D {x.shape[-1]} > {MAX_D}")
    rows = max(1, x.numel() // x.shape[-1])
    sms = _sm_count(x.device)
    per_block = -(-rows // (BLOCKS_PER_SM * sms))
    shapes = {"block": (per_block, -(-rows // per_block))}
    if _vec_row(x):
        shapes["vec"] = _vec_blocks(x, rows, sms)
    return shapes


def _shapes(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor) -> dict:
    return build.checked_once(_checked, (x.shape, gamma.shape, dy.shape, x.dtype, gamma.dtype,
                                         dy.dtype, x.device, gamma.device, dy.device),
                              _check_key, x, gamma, dy)


def route(x: torch.Tensor, gamma: torch.Tensor, dy: torch.Tensor) -> str:
    """The body that takes these (checked, contiguous) arguments, one of :data:`ROUTES`."""
    return ("vec" if _vec_row(x) and not (x.data_ptr() | gamma.data_ptr() | dy.data_ptr()) % 16
            else "block")


def launch(route_name: str, x, gamma, dy, eps: float, shapes: dict | None = None):
    """Run ``route_name``'s body on checked contiguous CUDA tensors with at least
    one row, at the launch shape ``shapes`` (:func:`_check_key`'s, looked up
    when not given); the caller counts.  Returns ``(dx, dgamma)``."""
    D = x.shape[-1]
    rows = x.numel() // D
    shape = (shapes or _shapes(x, gamma, dy))[route_name]
    if route_name == "vec":
        n_blocks, c_name, extra = shape, "rt_rmsnorm_bwd_vec", ()
    else:
        (per_block, n_blocks), extra = shape, (shape[0],)
        c_name = "rt_rmsnorm_bwd"
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    partial = torch.empty((n_blocks, D), dtype=torch.float32, device=x.device)
    build.launch(c_name, x.device, x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), partial.data_ptr(), dgamma.data_ptr(), rows, D, *extra, n_blocks,
                 eps, DTYPES[x.dtype])
    return dx, dgamma


def rmsnorm_bwd_cuda(x, gamma, dy, eps: float = 1e-5):
    """Launch the kernels on CUDA tensors; x, dy: (..., D); returns ``(dx, dgamma)``."""
    global launches
    shapes = _shapes(x, gamma, dy)
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm_bwd: x and gamma must be contiguous")
    if x.numel() == 0:
        return torch.empty_like(x), torch.zeros_like(gamma)
    dy = dy.contiguous()
    name = route(x, gamma, dy)
    out = launch(name, x, gamma, dy, eps, shapes)
    if x.is_cuda:
        launches += 1
        route_launches[name] += 1
    return out
