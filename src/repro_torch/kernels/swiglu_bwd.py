"""SwiGLU MLP backward on the card: ``torch.matmul`` products around
``csrc/swiglu_bwd.cu``.

The Pallas swiglu kernel is forward only; the JAX package's training path
differentiates ``repro.models.layers.swiglu`` with XLA, whose products are
XLA dots.  The port leaves the same products to ``torch.matmul``
(:func:`repro_torch.kernels.ref.swiglu_bwd`): ``a = x Wg`` and ``b = x Wu``
recomputed from the saved x, ``dh = dy Wd^T``, then the weight gradients
and dx.  The hand-written kernel is the elementwise gate between them: from
(a, b, dh) it writes ``h = silu(a) b``, ``da`` and ``db`` in one pass, fp32
inside and one cast.  What bounds the whole backward on the H100: at the
training shape (4096 rows) the 16 * N * D * F operations of its products;
the gate itself is bound by bytes (six N x F arrays).
"""

from __future__ import annotations

import torch

from . import build
from .ref import swiglu_bwd
from .swiglu import DTYPES, check_args

#: kernel launches since the count was last set to 0
launches = 0

#: most blocks of 256 threads per SM of the card; the grid-stride loop covers the rest
BLOCKS_PER_SM = 16


def swiglu_gate_bwd_cuda(a, b, dh):
    """Launch the gate kernel on CUDA tensors; returns ``(h, da, db)``."""
    global launches
    if not (all(t.is_cuda for t in (a, b, dh)) and a.device == b.device == dh.device):
        raise ValueError(f"swiglu_bwd: tensors on {a.device}, {b.device} and {dh.device}, "
                         "expected one GPU")
    if a.dtype not in DTYPES or b.dtype != a.dtype or dh.dtype != a.dtype:
        raise TypeError(f"swiglu_bwd: dtypes {a.dtype}, {b.dtype}, {dh.dtype}")
    if b.shape != a.shape or dh.shape != a.shape:
        raise ValueError(f"swiglu_bwd: shapes {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(dh.shape)}")
    a, b, dh = a.contiguous(), b.contiguous(), dh.contiguous()
    lib = build.library()
    h, da, db = torch.empty_like(a), torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return h, da, db
    max_blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(a.device).multi_processor_count
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_swiglu_gate_bwd(a.data_ptr(), b.data_ptr(), dh.data_ptr(), h.data_ptr(),
                                     da.data_ptr(), db.data_ptr(), a.numel(), max_blocks,
                                     DTYPES[a.dtype], stream)
    build.check(err, "rt_swiglu_gate_bwd")
    launches += 1
    return h, da, db


def swiglu_bwd_cuda(x, w_gate, w_up, w_down, dy):
    """The backward on CUDA tensors; returns ``(dx, dWg, dWu, dWd)``."""
    tensors = (x, w_gate, w_up, w_down, dy)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"swiglu_bwd: tensors on {[str(t.device) for t in tensors]}, "
                         "expected one GPU")
    check_args(x, w_gate, w_up, w_down)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"swiglu_bwd: dy {tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    return swiglu_bwd(x, w_gate, w_up, w_down, dy.contiguous(), swiglu_gate_bwd_cuda)
