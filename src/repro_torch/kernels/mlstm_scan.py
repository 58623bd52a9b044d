"""Chunked mLSTM forward on the card: the wrapper of ``csrc/mlstm_scan.cu``.

Replaces the Pallas TPU kernel ``_mlstm_kernel`` / ``mlstm_scan``
(``src/repro/kernels/mlstm_scan.py``).  What bounds it on the H100:
bytes, at the training shape of xlstm-1.3b (B 4, H 4, S 512, dqk 512, dv
1024, chunk 128) 50 MB of inputs and output a call, 0.015 ms at 3.35 TB/s,
against 14.5 GFLOP of causal and state products, 0.0147 ms at the bf16
tensor-core rate.  Its design: the gates of each (b, h)
in one sequential pass; the within-chunk products over all (b, h, chunk) at
once; the carried state (C, n) as 64 x 64 tiles, each walking its chunks in
order; all sums in fp32 on the CUDA cores (tensor cores are later work).
The forward writes the fp32 state at every chunk's start for the backward:
B * H * nc * dqk * dv * 4 bytes, 128 MB a call at the training shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .flash_attention import on_one_gpu
from .ref import mlstm_chunk_len

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 8 launches)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: batch entries (b, h, chunk) of one product launch: the grid's z extent
MAX_ENTRIES = 65535


class MLSTMSaved(NamedTuple):
    """What the forward keeps for the backward, all fp32."""

    hf: torch.Tensor       # (B, H, S, dv) h before its cast (the output itself when fp32)
    gates: torch.Tensor    # (4, B, H, S): b, m_t, inter, w
    decay: torch.Tensor    # (B, H, nc)
    scores: torch.Tensor   # (B, H, nc, L, L): S = (q k^T) D
    C: torch.Tensor        # (B, H, nc, dqk, dv) at each chunk's start
    n: torch.Tensor        # (B, H, nc, dqk) at each chunk's start
    den: torch.Tensor      # (B, H, S)


def check_args(q, k, v, i_raw, log_f, chunk: int) -> int:
    """Raise unless the kernel takes these arguments; return the chunk length L."""
    if not all(t.is_contiguous() for t in (q, k, v, i_raw, log_f)):
        raise ValueError("mlstm_scan: q, k, v, i_raw and log_f must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"mlstm_scan: unsupported dtype {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, i_raw, log_f)):
        raise TypeError("mlstm_scan: q, k, v, i_raw and log_f must share a dtype")
    L = mlstm_chunk_len(q, k, v, i_raw, log_f, chunk)
    entries = q.shape[0] * q.shape[1] * (q.shape[2] // L)
    if entries > MAX_ENTRIES:
        raise ValueError(f"mlstm_scan: {entries} (b, h, chunk) entries > {MAX_ENTRIES}")
    return L


def mlstm_scan_cuda(q, k, v, i_raw, log_f, *, chunk: int):
    """Launch the kernels on contiguous CUDA tensors; returns ``(h, saved)``: h
    (B, H, S, dv) in v's dtype and the :class:`MLSTMSaved` tensors the
    backward reads."""
    global launches
    on_one_gpu("mlstm_scan", q, k, v, i_raw, log_f)
    L = check_args(q, k, v, i_raw, log_f, chunk)
    lib = build.library()
    B, H, S, dqk = q.shape
    dv = v.shape[-1]
    nc = S // L
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty_like(v)
    saved = MLSTMSaved(
        hf=out if v.dtype == torch.float32 else torch.empty(v.shape, **f32),
        gates=torch.empty((4, B, H, S), **f32),
        decay=torch.empty((B, H, nc), **f32),
        scores=torch.empty((B, H, nc, L, L), **f32),
        C=torch.empty((B, H, nc, dqk, dv), **f32),
        n=torch.empty((B, H, nc, dqk), **f32),
        den=torch.empty((B, H, S), **f32),
    )
    num = torch.empty((B, H, S, dv), **f32)
    hf = 0 if saved.hf is out else saved.hf.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_mlstm_scan(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(), log_f.data_ptr(),
            out.data_ptr(), hf, saved.gates.data_ptr(), saved.decay.data_ptr(),
            saved.scores.data_ptr(), saved.C.data_ptr(), saved.n.data_ptr(), num.data_ptr(),
            saved.den.data_ptr(), B * H, S, L, dqk, dv, float(dqk ** -0.5), DTYPES[q.dtype],
            stream,
        )
    build.check(err, "rt_mlstm_scan")
    launches += 1
    return out, saved
