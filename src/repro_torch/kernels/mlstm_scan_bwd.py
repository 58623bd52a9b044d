"""Chunked mLSTM backward on the card: the wrapper of ``csrc/mlstm_scan_bwd.cu``.

The Pallas mlstm_scan kernel is forward only; the JAX package's training
path differentiates ``repro.models.xlstm.mlstm_chunked`` with XLA.  This is
the explicit backward of the port's forward, ``ref.mlstm_scan_bwd_ref`` on
the card: the stabilizer m held constant (it drops out of h), the
gradient of the carried state walked over the chunks in reverse in 64 x 64
tiles, the products within a chunk over all (b, h, chunk) at once, and no
atomics.  What bounds it on the H100: operations, twice the forward's (29.0
GFLOP a call at the training shape, 0.029 ms at the bf16 tensor-core rate),
run here in fp32 on the CUDA cores.
It allocates B * H * nc * dqk * dv * 4 bytes of scratch for the carried
gradient (128 MB at the training shape) and about as much again for the
per-row products, freed when it returns.
"""

from __future__ import annotations

import torch

from . import build
from .flash_attention import on_one_gpu
from .mlstm_scan import DTYPES, MLSTMSaved, check_args

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 13 launches)
launches = 0

#: output rows and columns of one tile, as in ``csrc/mlstm.cuh``
TILE = 64


def mlstm_scan_bwd_cuda(q, k, v, i_raw, log_f, saved: MLSTMSaved, dh, *, chunk: int):
    """Launch the kernels on CUDA tensors; returns ``(dq, dk, dv, di, df)`` in the
    inputs' dtype.  ``dh`` may be a strided view (autograd hands over the
    transpose of the model's (B, S, H * dv) gradient); it is copied to a
    contiguous tensor."""
    global launches
    on_one_gpu("mlstm_scan_bwd", q, k, v, i_raw, log_f, dh, *saved)
    L = check_args(q, k, v, i_raw, log_f, chunk)
    B, H, S, dqk = q.shape
    dv = v.shape[-1]
    nc = S // L
    if dh.shape != v.shape:
        raise ValueError(f"mlstm_scan_bwd: dh {tuple(dh.shape)} for v {tuple(v.shape)}")
    want = MLSTMSaved(hf=(B, H, S, dv), gates=(4, B, H, S), decay=(B, H, nc),
                      scores=(B, H, nc, L, L), C=(B, H, nc, dqk, dv), n=(B, H, nc, dqk),
                      den=(B, H, S))
    for name, t, shape in zip(MLSTMSaved._fields, saved, want):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"mlstm_scan_bwd: saved {name} {tuple(t.shape)} {t.dtype}, "
                             f"expected contiguous float32 {shape}")
    dh = dh.to(q.dtype).contiguous()
    lib = build.library()
    f32 = dict(dtype=torch.float32, device=q.device)
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
             torch.empty_like(i_raw), torch.empty_like(log_f))
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_mlstm_scan_bwd(
            *(t.data_ptr() for t in (q, k, v, i_raw, dh, saved.hf, saved.gates, saved.decay,
                                     saved.scores, saved.C, saved.n, saved.den)),
            *(t.data_ptr() for t in grads), *(t.data_ptr() for t in scratch),
            B * H, S, L, dqk, dv, float(dqk ** -0.5), DTYPES[q.dtype], stream,
        )
    build.check(err, "rt_mlstm_scan_bwd")
    launches += 1
    return grads
