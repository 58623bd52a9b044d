"""Chunked mLSTM forward on the card: the wrapper of ``csrc/mlstm_scan.cu``.

Replaces the Pallas TPU kernel ``_mlstm_kernel`` / ``mlstm_scan``
(``src/repro/kernels/mlstm_scan.py``).  What bounds it on the H100:
bytes, at the training shape of xlstm-1.3b (B 4, H 4, S 512, dqk 512, dv
1024, chunk 128) 50 MB of inputs and output a call, 0.015 ms at 3.35 TB/s,
against 14.5 GFLOP of causal and state products, 0.0147 ms at the bf16
tensor-core rate.  Only the carried state (C, n) walks the chunks in order;
the gates, the states' tiles and the outputs run over many blocks at once.
:func:`route` picks the kernels from the dtype, the shape, the strides and
the pointers' alignment, nothing else:

- ``"wgmma"`` (bf16; chunk 128; dqk and dv multiples of 64, dqk at most
  1024; q, k and v with contiguous rows, 16-byte aligned, their other
  strides multiples of 8): three launches (``csrc/mlstm_tc.cuh``).  The
  gates, a warp a chunk; the chunk-start states, each 128 x 128 tile of C
  walking the chunks in fp32 registers by wgmma and saved in bf16; the
  output, q k^T and q C by wgmma over dqk, the mask and decay in registers,
  S v from registers.  q, k and v are read in the layout they come in (the
  model's transposed (B, S, H, d) projections, without a copy) and h is a
  (B, H, S, dv) view of a (B, S, H, dv) tensor.  It rounds what
  ``ref.mlstm_scan_ref(..., bf16_products=True)`` rounds.  It keeps
  :class:`MLSTMTcSaved` for the backward: B H (nc - 1) dqk dv bf16 of state
  (48 MB at the training shape) and a few fp32 rows.
- ``"simt"`` (fp32, any other shape; contiguous tensors): eight launches,
  every product an fp32 FMA on the CUDA cores from shared-memory tiles.  It
  keeps :class:`MLSTMSaved`: the fp32 state at every chunk's start (128 MB a
  call at the training shape), the scores and the fp32 h.

There is no fallback between them: a CUDA tensor launches its route's
kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ref import mlstm_chunk_len

#: wrapper calls that launched the kernels since the count was last set to 0
#: (one call makes 3 launches on "wgmma", 8 on "simt")
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "simt")
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: batch entries (b, h, chunk) of one product launch: the grid's z extent
MAX_ENTRIES = 65535
#: the chunk and the widest dqk of the tensor-core route
TC_CHUNK = 128
TC_MAX_DQK = 1024


class MLSTMSaved(NamedTuple):
    """What the CUDA-core forward keeps for the backward, all fp32."""

    hf: torch.Tensor       # (B, H, S, dv) h before its cast (the output itself when fp32)
    gates: torch.Tensor    # (4, B, H, S): b, m_t, inter, w
    decay: torch.Tensor    # (B, H, nc)
    scores: torch.Tensor   # (B, H, nc, L, L): S = (q k^T) D
    C: torch.Tensor        # (B, H, nc, dqk, dv) at each chunk's start
    n: torch.Tensor        # (B, H, nc, dqk) at each chunk's start
    den: torch.Tensor      # (B, H, S)


class MLSTMTcSaved(NamedTuple):
    """What the tensor-core forward keeps for the backward."""

    h: torch.Tensor        # (B, H, S, dv) bf16: the output, a view of (B, S, H, dv)
    gates: torch.Tensor    # (5, B, H, S) fp32: b, m_t, inter, w, i - b
    decay: torch.Tensor    # (B, H, nc) fp32
    C: torch.Tensor        # (B, H, nc - 1, dqk, dv) bf16: C at the start of chunks 1 ..
    n: torch.Tensor        # (B, H, nc, dqk) fp32 at each chunk's start
    den: torch.Tensor      # (B, H, S) fp32
    qn: torch.Tensor       # (B, H, S) fp32: scale (q . n)


def _tma_rows(t: torch.Tensor) -> bool:
    """Whether TMA reads ``t`` (B, H, S, F) as it lies: contiguous rows, a
    16-byte aligned start, the other strides (of axes longer than 1) positive
    multiples of 8 elements."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(n == 1 or (s > 0 and s % 8 == 0) for n, s in zip(t.shape[:3], t.stride()[:3]))


def route(L: int, q, k, v, *more) -> str:
    """The kernels that take these (checked) arguments, one of :data:`ROUTES`;
    ``more``: further bf16 tensors of v's shape read by TMA (the backward's dh)."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if (q.dtype != torch.bfloat16 or L != TC_CHUNK or dqk == 0 or dqk % 64
            or dqk > TC_MAX_DQK or dv == 0 or dv % 64
            or not all(_tma_rows(t) for t in (q, k, v, *more))):
        return "simt"
    return "wgmma"


def check_args(q, k, v, i_raw, log_f, chunk: int) -> int:
    """Raise unless the kernels take these arguments; return the chunk length
    L.  The CUDA-core route reads contiguous tensors only; the tensor-core
    route also strided views (:func:`route`)."""
    if q.dtype not in DTYPES:
        raise TypeError(f"mlstm_scan: unsupported dtype {q.dtype}")
    if any(t.dtype != q.dtype for t in (k, v, i_raw, log_f)):
        raise TypeError("mlstm_scan: q, k, v, i_raw and log_f must share a dtype")
    L = mlstm_chunk_len(q, k, v, i_raw, log_f, chunk)
    entries = q.shape[0] * q.shape[1] * (q.shape[2] // L)
    if entries > MAX_ENTRIES:
        raise ValueError(f"mlstm_scan: {entries} (b, h, chunk) entries > {MAX_ENTRIES}")
    if (not all(t.is_contiguous() for t in (q, k, v, i_raw, log_f))
            and route(L, q, k, v) != "wgmma"):
        raise ValueError("mlstm_scan: q, k, v, i_raw and log_f must be contiguous, or bf16 "
                         "views with rows the tensor-core route reads")
    return L


def readable(q, k, v, i_raw, log_f, chunk: int):
    """The five inputs as the kernels will read them: as they are where the
    tensor-core route takes them, else contiguous copies."""
    L = mlstm_chunk_len(q, k, v, i_raw, log_f, chunk)
    if route(L, q, k, v) == "wgmma":
        return q, k, v, i_raw, log_f
    return tuple(t.contiguous() for t in (q, k, v, i_raw, log_f))


def strides(*tensors) -> ctypes.Array:
    """The (b, h, s) strides of each (B, H, S[, F]) tensor, in one C array."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def launch(route_name: str, q, k, v, i_raw, log_f, L: int):
    """Run ``route_name``'s kernels on checked CUDA tensors; the caller counts.
    Returns ``(h, saved)``."""
    B, H, S, dqk = q.shape
    dv = v.shape[-1]
    nc = S // L
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale = float(dqk ** -0.5)
    if route_name == "wgmma":
        out = torch.empty((B, S, H, dv), dtype=v.dtype, device=dev).transpose(1, 2)
        saved = MLSTMTcSaved(
            h=out, gates=torch.empty((5, B, H, S), **f32), decay=torch.empty((B, H, nc), **f32),
            C=torch.empty((B, H, nc - 1, dqk, dv), dtype=v.dtype, device=dev),
            n=torch.empty((B, H, nc, dqk), **f32), den=torch.empty((B, H, S), **f32),
            qn=torch.empty((B, H, S), **f32),
        )
        build.launch("rt_mlstm_scan_tc", dev,
                     *(t.data_ptr() for t in (q, k, v, i_raw, log_f, *saved)),
                     strides(q, k, v, i_raw, log_f), B, H, S, dqk, dv, scale)
        return out, saved
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
    build.launch("rt_mlstm_scan", dev,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), i_raw.data_ptr(), log_f.data_ptr(),
                 out.data_ptr(), hf, *(t.data_ptr() for t in saved[1:6]), num.data_ptr(),
                 saved.den.data_ptr(), B * H, S, L, dqk, dv, scale, DTYPES[q.dtype])
    return out, saved


def mlstm_scan_cuda(q, k, v, i_raw, log_f, *, chunk: int):
    """Launch the kernels on CUDA tensors (contiguous, or views that the
    tensor-core route reads); returns ``(h, saved)``: h (B, H, S, dv) in v's
    dtype and the :class:`MLSTMTcSaved` or :class:`MLSTMSaved` tensors the
    backward reads."""
    global launches
    build.on_card("mlstm_scan", q, k, v, i_raw, log_f)
    L = check_args(q, k, v, i_raw, log_f, chunk)
    name = route(L, q, k, v)
    out = launch(name, q, k, v, i_raw, log_f, L)
    if q.is_cuda:
        launches += 1
        route_launches[name] += 1
    return out
