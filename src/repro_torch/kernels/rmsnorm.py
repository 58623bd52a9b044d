"""Row RMSNorm on the card: the wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm``
(``src/repro/kernels/rmsnorm.py``).  What bounds it on the H100: device
memory, at 2 * D * bytes per row (read x, write y) plus gamma once.  At decode
shapes (8 rows of D = 1024) that is a few kilobytes, so the host's time to
issue the launch costs more than the work.  Hence a lean wrapper: the checks
that depend only on shapes, dtypes and devices run once per such key
(``build.checked_once``), contiguity and alignment on every call, and the
launch takes PyTorch's raw stream handle without a device context
(``build.launch``).  :func:`route` picks the body from the dtype, D and the
pointers' alignment, nothing else:

- ``"vec"`` (D a multiple of 8, a row of at most 16 KB, 16-byte aligned x
  and gamma): one warp a row, four rows a block; the row read once into
  registers with 16-byte loads, the sum of squares reduced by warp shuffles
  alone, the scaled row written with 16-byte stores.
- ``"block"`` (any other D): one block of 256 threads a row, the sum reduced
  across the block through shared memory, the row read twice.

Both keep the Pallas order: the sum of squares in fp32, then
``x * rsqrt(mean + eps) * gamma`` in fp32, then one cast.
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("vec", "block")
#: kernel launches by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: the longest row the "vec" body holds in registers, in bytes
VEC_MAX_ROW_BYTES = 16384
#: (x shape, gamma shape, dtypes, devices) -> whether D suits "vec"; filled on first sight
_checked: dict = {}


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


def _vec_row(x: torch.Tensor) -> bool:
    """Whether the ``"vec"`` body holds a row of x: D a multiple of 8, at most
    :data:`VEC_MAX_ROW_BYTES`."""
    D = x.shape[-1]
    return D % 8 == 0 and 0 < D * x.element_size() <= VEC_MAX_ROW_BYTES


def _check_key(x: torch.Tensor, gamma: torch.Tensor) -> bool:
    """Raise unless one GPU and :func:`check_args` take the arguments; :func:`_vec_row`."""
    if not (x.is_cuda and gamma.is_cuda and x.device == gamma.device):
        raise ValueError(f"rmsnorm: tensors on {x.device} and {gamma.device}, expected one GPU")
    check_args(x, gamma)
    return _vec_row(x)


def route(x: torch.Tensor, gamma: torch.Tensor) -> str:
    """The body that takes these (checked, contiguous) arguments, one of :data:`ROUTES`."""
    return "vec" if _vec_row(x) and not (x.data_ptr() | gamma.data_ptr()) % 16 else "block"


def launch(route_name: str, x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Run ``route_name``'s body on checked contiguous CUDA tensors with at least
    one row; the caller counts."""
    out = torch.empty_like(x)
    D = x.shape[-1]
    lib = build.library()
    fn, c_name = ((lib.rt_rmsnorm_vec, "rt_rmsnorm_vec") if route_name == "vec"
                  else (lib.rt_rmsnorm, "rt_rmsnorm"))
    build.launch(fn, c_name, x.device, x.data_ptr(), gamma.data_ptr(), out.data_ptr(),
                 x.numel() // D, D, eps, DTYPES[x.dtype])
    return out


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; x: (..., D), gamma: (D,)."""
    global launches
    vec = build.checked_once(_checked, (x.shape, gamma.shape, x.dtype, gamma.dtype, x.device,
                                        gamma.device), _check_key, x, gamma)
    if not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous")
    if x.numel() == 0:
        return torch.empty_like(x)
    name = "vec" if vec and not (x.data_ptr() | gamma.data_ptr()) % 16 else "block"
    out = launch(name, x, gamma, eps)
    launches += 1
    route_launches[name] += 1
    return out
