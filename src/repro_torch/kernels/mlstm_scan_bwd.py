"""Chunked mLSTM backward on the card: the wrapper of ``csrc/mlstm_scan_bwd.cu``.

The Pallas mlstm_scan kernel is forward only; the JAX package's training
path differentiates ``repro.models.xlstm.mlstm_chunked`` with XLA.  This is
the explicit backward of the port's forward, ``ref.mlstm_scan_bwd_ref`` on
the card: the stabilizer m held constant (it drops out of h), the
gradient of the carried state walked over the chunks in reverse in tiles,
the products within a chunk over all (b, h, chunk) at once, and no atomics:
two calls on the same inputs give the same bits.  What bounds it on the
H100: operations, twice the forward's (29.0 GFLOP a call at the training
shape, 0.029 ms at the bf16 tensor-core rate).  The route is the forward's,
told by the type of what it saved:

- ``"wgmma"`` (:class:`MLSTMTcSaved`): six launches, every product on the
  tensor cores, rounding what ``ref.mlstm_scan_bwd_ref(...,
  bf16_products=True)`` rounds.  dh is read in the layout it comes in (the
  transpose of the model's (B, S, H * dv) gradient) and the gradients are
  (B, H, S, .) views of (B, S, H, .) tensors.  Scratch: the carried dC in
  bf16 (48 MB at the training shape), scale dP and S / g in bf16 (2 MB
  each) and a few fp32 rows, freed when it returns.
- ``"simt"`` (:class:`MLSTMSaved`): 13 launches of fp32 FMAs on the CUDA
  cores, with 64 x 64 tiles; about 260 MB of fp32 scratch at the training
  shape.
"""

from __future__ import annotations

import torch

from . import build
from .flash_attention import on_one_gpu
from .mlstm_scan import (DTYPES, ROUTES, MLSTMSaved, MLSTMTcSaved, _tma_rows, check_args,
                         route, strides)

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 6 launches on "wgmma", 13 on "simt")
launches = 0
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)

#: output rows and columns of one tile, as in ``csrc/mlstm.cuh``
TILE = 64
#: output columns of a tensor-core block, as in ``csrc/mlstm_tc.cuh``
TC_TILE = 128


def _saved_shapes(saved, B, H, S, dqk, dv, L):
    nc = S // L
    if isinstance(saved, MLSTMTcSaved):
        bf16, f32 = torch.bfloat16, torch.float32
        return MLSTMTcSaved(h=((B, H, S, dv), bf16), gates=((5, B, H, S), f32),
                            decay=((B, H, nc), f32), C=((B, H, nc - 1, dqk, dv), bf16),
                            n=((B, H, nc, dqk), f32), den=((B, H, S), f32),
                            qn=((B, H, S), f32))
    f32 = torch.float32
    return MLSTMSaved(hf=((B, H, S, dv), f32), gates=((4, B, H, S), f32),
                      decay=((B, H, nc), f32), scores=((B, H, nc, L, L), f32),
                      C=((B, H, nc, dqk, dv), f32), n=((B, H, nc, dqk), f32),
                      den=((B, H, S), f32))


def _check_saved(saved, B, H, S, dqk, dv, L) -> None:
    for name, t, (shape, dtype) in zip(saved._fields, saved,
                                       _saved_shapes(saved, B, H, S, dqk, dv, L)):
        # the tensor-core route's h is a view of its (B, S, H, dv) output
        lies = t.transpose(1, 2) if name == "h" else t
        if t.shape != shape or t.dtype != dtype or not lies.is_contiguous():
            raise ValueError(f"mlstm_scan_bwd: saved {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected {dtype} {shape} as the forward writes it")


def launch(route_name: str, q, k, v, i_raw, log_f, saved, dh, L: int):
    """Run ``route_name``'s kernels on checked CUDA tensors (dh in q's dtype,
    in a layout the route reads); the caller counts.  Returns ``(dq, dk, dv,
    di, df)``."""
    lib = build.library()
    B, H, S, dqk = q.shape
    dv = v.shape[-1]
    nc = S // L
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale = float(dqk ** -0.5)
    if route_name == "wgmma":
        bf16 = dict(dtype=torch.bfloat16, device=dev)
        grads = tuple(torch.empty((B, S, H, *rest), **bf16).transpose(1, 2)
                      for rest in ((dqk,), (dqk,), (dv,), (), ()))
        BH = B * H
        nti = -(-dqk // TC_TILE)
        scratch = (
            torch.empty((4, BH, S), **f32),                         # g, dden, row factors
            torch.empty((BH, nc - 1, dqk, dv), **bf16),             # dC at chunk ends
            torch.empty((BH, nc, dqk), **f32),                      # dn at chunk ends
            torch.empty((BH, nc, nti * -(-dv // TC_TILE)), **f32),  # ddecay partials
            torch.empty((BH, nc, L, L), **bf16),                    # scale dP
            torch.empty((BH, nc, L, L), **bf16),                    # S / g
            torch.empty((BH, S), **f32),                            # row sums of dlogD
            torch.empty((BH, S), **f32),                            # column sums of dlogD
            torch.empty((BH, S, nti), **f32),                       # d inter partials
            torch.empty((BH, S, nti), **f32),                       # dw partials
        )
        build.launch(lib.rt_mlstm_scan_bwd_tc, "rt_mlstm_scan_bwd_tc", dev,
                     *(t.data_ptr() for t in (q, k, v, dh, *saved, *grads, *scratch)),
                     strides(q, k, v, dh), B, H, S, dqk, dv, scale)
        return grads
    grads = tuple(torch.empty_like(t) for t in (q, k, v, i_raw, log_f))
    tiles_m, tiles_n = -(-dqk // TILE), -(-dv // TILE)
    row = (B, H, S)
    scratch = (
        torch.empty((B, H, S, dv), **f32),                  # dnum
        torch.empty(row, **f32),                            # dden
        torch.empty((B, H, nc, L, L), **f32),               # dP
        torch.empty(row, **f32),                            # row sums of dlogD
        torch.empty(row, **f32),                            # column sums of dlogD
        torch.empty((B, H, nc, dqk, dv), **f32),            # dC of each chunk's end
        torch.empty((B, H, nc, dqk), **f32),                # dn of each chunk's end
        torch.empty((B, H, nc, tiles_m * (tiles_n + 1)), **f32),  # ddecay partials
        torch.empty((B, H, S, dqk), **f32),                 # dP k
        torch.empty((B, H, S, dqk), **f32),                 # dnum C^T
        torch.empty((B, H, S, dqk), **f32),                 # scale dP^T q
        torch.empty((B, H, S, dqk), **f32),                 # v dC^T
        torch.empty((B, H, S, dv), **f32),                  # S^T dnum
        torch.empty(row, **f32),                            # dlog_inter
        torch.empty(row, **f32),                            # dlogw
    )
    build.launch(lib.rt_mlstm_scan_bwd, "rt_mlstm_scan_bwd", dev,
                 *(t.data_ptr() for t in (q, k, v, i_raw, dh, *saved)),
                 *(t.data_ptr() for t in grads), *(t.data_ptr() for t in scratch),
                 B * H, S, L, dqk, dv, scale, DTYPES[q.dtype])
    return grads


def mlstm_scan_bwd_cuda(q, k, v, i_raw, log_f, saved, dh, *, chunk: int):
    """Launch the kernels on CUDA tensors; returns ``(dq, dk, dv, di, df)`` in
    the inputs' dtype.  ``saved`` is what :func:`mlstm_scan.mlstm_scan_cuda`
    returned for these inputs, and picks the route.  ``dh`` may be a strided
    view (autograd hands over the transpose of the model's (B, S, H * dv)
    gradient) or of another float type: the tensor-core route reads it as it
    lies where TMA can, anything else is copied to a contiguous tensor of q's
    dtype."""
    global launches
    on_one_gpu("mlstm_scan_bwd", q, k, v, i_raw, log_f, dh, *saved)
    L = check_args(q, k, v, i_raw, log_f, chunk)
    B, H, S, dqk = q.shape
    dv = v.shape[-1]
    if dh.shape != v.shape:
        raise ValueError(f"mlstm_scan_bwd: dh {tuple(dh.shape)} for v {tuple(v.shape)}")
    if not isinstance(saved, (MLSTMTcSaved, MLSTMSaved)):
        raise TypeError(f"mlstm_scan_bwd: saved {type(saved).__name__}, expected what "
                        "mlstm_scan_cuda saves")
    _check_saved(saved, B, H, S, dqk, dv, L)
    name = "wgmma" if isinstance(saved, MLSTMTcSaved) else "simt"
    dh = dh.to(q.dtype)
    if name == "simt" or not _tma_rows(dh):
        dh = dh.contiguous()
    if name == "wgmma" and route(L, q, k, v, dh) != "wgmma":
        raise ValueError("mlstm_scan_bwd: the tensor-core route's saved state for inputs "
                         "it does not take")
    grads = launch(name, q, k, v, i_raw, log_f, saved, dh, L)
    launches += 1
    route_launches[name] += 1
    return grads
