"""SwiGLU MLP backward on the card: ``csrc/swiglu_bwd.cu`` with ``torch.matmul``
products around it.

The Pallas swiglu kernel is forward only; the JAX package's training path
differentiates ``repro.models.layers.swiglu`` with XLA, whose autodiff keeps
``a = x Wg`` and ``b = x Wu`` from the forward and leaves the products to
XLA's dots.  The port does the same: the forward's tensor-core kernel saves
a and b (``swiglu.launch(..., save_ab=True)``), the weight gradients and dx
are ``torch.matmul`` (:func:`repro_torch.kernels.ref.swiglu_bwd_products`, dx
as one ``addmm``), and the hand-written kernel is everything between them.
:func:`route` picks it from the dtype, the shape, the pointers' alignment and
whether a and b were saved, nothing else:

- ``"wgmma"`` (bf16, D and F multiples of 8, 16-byte aligned pointers, a
  and b saved): ``dh = dy Wd^T`` on the tensor cores with the gate in its
  epilogue, so dh never reaches memory; five products and one kernel in all.
  Bound by bytes (a, b read; h, da, db written); the whole backward by the
  10 N D F operations of its products (0.12 ms at qwen's 4096 x 1024 x 2816).
- ``"simt"`` (fp32, and bf16 that TMA cannot take): a and b computed again
  (the forward's tensor-core routes alone save them), ``dh`` by
  ``torch.matmul``, then the CUDA-core gate kernel over the six N x F arrays
  (:func:`repro_torch.kernels.ref.swiglu_bwd`).

The host path is lean, as the rmsnorm wrappers': ``build.launch`` takes
PyTorch's raw stream handle without a device context.
"""

from __future__ import annotations

import torch

from . import build
from .ref import swiglu_bwd, swiglu_bwd_products
from .swiglu import DTYPES, check_args

#: wrapper calls that launched a kernel since the count was last set to 0
launches = 0

ROUTES = ("wgmma", "simt")
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: most blocks of 256 threads per SM of the card for the gate kernel; its
#: grid-stride loop covers the rest
BLOCKS_PER_SM = 16


_sm_count = build.sm_count


def route(x, w_gate, w_up, w_down, dy, a, b) -> str:
    """The kernel that takes these (checked) arguments, one of :data:`ROUTES`."""
    D, F = w_gate.shape
    if (a is None or x.dtype != torch.bfloat16 or D % 8 or F % 8
            or any(t.data_ptr() % 16 for t in (x, w_gate, w_up, w_down, dy, a, b))):
        return "simt"
    return "wgmma"


def gate_bwd_cuda(a, b, dh):
    """The gate kernel alone on same-shaped contiguous CUDA tensors: ``(h, da, db)``."""
    h, da, db = torch.empty_like(a), torch.empty_like(a), torch.empty_like(a)
    if a.numel():
        build.launch(build.library().rt_swiglu_gate_bwd, "rt_swiglu_gate_bwd", a.device,
                     a.data_ptr(), b.data_ptr(), dh.data_ptr(), h.data_ptr(), da.data_ptr(),
                     db.data_ptr(), a.numel(), BLOCKS_PER_SM * _sm_count(a.device),
                     DTYPES[a.dtype])
    return h, da, db


def gate_bwd_tc(dy2, w_down, a, b):
    """dh = dy Wd^T and the gate in one tensor-core kernel on checked, aligned
    bf16 CUDA tensors with at least one row: ``(h, da, db)``."""
    N, F = a.shape
    h, da, db = torch.empty_like(a), torch.empty_like(a), torch.empty_like(a)
    build.launch(build.library().rt_swiglu_bwd_tc, "rt_swiglu_bwd_tc", a.device,
                 dy2.data_ptr(), w_down.data_ptr(), a.data_ptr(), b.data_ptr(), h.data_ptr(),
                 da.data_ptr(), db.data_ptr(), N, dy2.shape[1], F, _sm_count(a.device))
    return h, da, db


def launch(route_name: str, x, w_gate, w_up, w_down, dy, a=None, b=None):
    """Run ``route_name``'s backward on checked contiguous CUDA tensors with at
    least one row; the caller counts.  ``"simt"`` computes a and b again, saved
    or not.  Returns ``(dx, dWg, dWu, dWd)``."""
    if route_name == "wgmma":
        h, da, db = gate_bwd_tc(dy.reshape(-1, x.shape[-1]), w_down, a, b)
        return swiglu_bwd_products(x, w_gate, w_up, dy, h, da, db)
    return swiglu_bwd(x, w_gate, w_up, w_down, dy, gate_bwd_cuda)


def swiglu_bwd_cuda(x, w_gate, w_up, w_down, dy, a=None, b=None):
    """The backward on CUDA tensors; a, b: the forward's saved (N, F) ``x @ Wg``
    and ``x @ Wu``, or None.  Returns ``(dx, dWg, dWu, dWd)``."""
    global launches
    tensors = (x, w_gate, w_up, w_down, dy) + tuple(t for t in (a, b) if t is not None)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"swiglu_bwd: tensors on {[str(t.device) for t in tensors]}, "
                         "expected one GPU")
    check_args(x, w_gate, w_up, w_down)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"swiglu_bwd: dy {tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    if (a is None) != (b is None):
        raise ValueError("swiglu_bwd: a and b are saved together or not at all")
    D, F = w_gate.shape
    if a is not None:
        want = (x.numel() // D, F)
        for name, t in (("a", a), ("b", b)):
            if t.shape != want or t.dtype != x.dtype or not t.is_contiguous():
                raise ValueError(f"swiglu_bwd: {name} {tuple(t.shape)} {t.dtype} for x "
                                 f"{tuple(x.shape)} {x.dtype}: expected contiguous {want}")
    if x.numel() == 0:
        return (torch.zeros_like(x), torch.zeros_like(w_gate), torch.zeros_like(w_up),
                torch.zeros_like(w_down))
    dy = dy.contiguous()
    name = route(x, w_gate, w_up, w_down, dy, a, b)
    grads = launch(name, x, w_gate, w_up, w_down, dy, a, b)
    launches += 1
    route_launches[name] += 1
    return grads
