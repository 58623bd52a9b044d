"""Flash attention forward on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention``
(``src/repro/kernels/flash_attention.py``).  What bounds it on the H100: at
the training shape (qwen1.5-0.5b, 8 x 512 tokens, hd 64, causal) bytes, for
q, k, v and out read or written once; its causal band of operations
(4 * hd per visible pair) is below the tensor cores' rate.  Its design: one
block per (b, query head, 64 query rows), walking only the kv tiles its
rows can see, with K/V of kv head ``h // G``; fp32 online softmax; also
writes the fp32 row log-sum-exp (B, Hq, Sq) that the backward reads.  The
kernel takes contiguous tensors: the wrapper copies q, k and v where they
are views (the model's v is a transposed view of its projection).
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def check_args(q, k, v) -> None:
    """Raise unless the kernel takes these arguments (contiguity aside)."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)}; expected (B, Hq, Sq, hd) and two (B, Hkv, Skv, hd)")
    B, Hq, _, hd = q.shape
    Bk, Hkv, _, hdk = k.shape
    if Bk != B or hdk != hd or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: hd {hd} > {MAX_HEAD_DIM}")


def on_one_gpu(name: str, *tensors) -> None:
    """Raise unless every tensor lies on the first one's CUDA device."""
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}, "
                         "expected one GPU")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Launch the kernel on CUDA tensors; returns ``(out, lse)``."""
    global launches
    on_one_gpu("flash_attention", q, k, v)
    check_args(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = build.library()
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Hq, Hkv, Sq, Skv, hd, int(causal), int(window), int(q_offset),
            float(hd ** -0.5), DTYPES[q.dtype], stream,
        )
    build.check(err, "rt_flash_attention")
    launches += 1
    return out, lse
