"""One-token GQA decode attention on the card: the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``_decode_kernel`` / ``decode_attention``
(``src/repro/kernels/decode_attention.py``).  What bounds it on the H100:
device memory, for the visible K and V rows read once (2 * B * Hkv *
visible * hd * bytes); its operations (4 * B * Hq * visible * hd) are far
below the card's rate.  Its design: one block per (batch row, kv head) with
the G query heads of the group as its tile, so each cache row is read once
for the whole group; a loop over the cache in 64-position tiles replaces the
TPU's sequential grid axis and carries (m, l, acc) in fp32; the loop starts
at the first visible position and stops at ``valid_len``, so masked
positions cost nothing.  ``valid_len`` is an int32 ``(B,)`` device tensor; a
scalar is broadcast here.
"""

from __future__ import annotations

import torch

from . import build
from .ref import valid_len_vector

#: kernel launches since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 16


def check_args(q, k_cache, v_cache) -> None:
    """Raise unless the kernel takes these arguments."""
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: unsupported dtype {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: q, k_cache and v_cache must share a dtype")
    if q.ndim != 4 or q.shape[2] != 1 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, caches {tuple(k_cache.shape)} and "
            f"{tuple(v_cache.shape)}; expected (B, Hq, 1, hd) and two (B, Hkv, S, hd)"
        )
    B, Hq, _, hd = q.shape
    Bk, Hkv, _, hdk = k_cache.shape
    if Bk != B or hdk != hd or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k_cache.shape)}")
    if hd > MAX_HEAD_DIM or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: hd {hd} > {MAX_HEAD_DIM} or group "
                         f"{Hq // Hkv} > {MAX_GROUP}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and the caches must be contiguous")


def decode_attention_cuda(q, k_cache, v_cache, valid_len, *, window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``valid_len``: scalar or (B,)."""
    global launches
    tensors = (q, k_cache, v_cache)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"decode_attention: tensors on {[str(t.device) for t in tensors]}, "
                         "expected one GPU")
    check_args(q, k_cache, v_cache)
    lib = build.library()
    B, Hq, _, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    vl = valid_len_vector(valid_len, B, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), vl.data_ptr(), out.data_ptr(),
            B, Hkv, Hq // Hkv, S, hd, int(window), float(hd ** -0.5), DTYPES[q.dtype], stream,
        )
    build.check(err, "rt_decode_attention")
    launches += 1
    return out

