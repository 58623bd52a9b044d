"""Flash attention backward on the card: the wrapper of ``csrc/flash_attention_bwd.cu``.

The Pallas flash kernel is forward only; the JAX package's training path
differentiates ``repro.models.layers.blockwise_attention`` with XLA.  This
is the FA2 backward of the port's flash forward: P recomputed from q, k and
the saved LSE, ``D = rowsum(dO * O)`` in fp32, two launches (a q-side pass
for dq and D, a kv-side pass for dk and dv that sums the G query heads of
its kv head) and no atomics.  What bounds it on the H100: bytes at the
training shape (q, k, v, o, dO read once, dq, dk, dv written once); this
first version runs its 10 * hd operations per visible pair on the CUDA
cores, which bound it instead.
"""

from __future__ import annotations

import torch

from . import build
from .flash_attention import DTYPES, check_args, on_one_gpu

#: wrapper calls that launched the kernels since the count was last set to 0
launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                             q_offset: int = 0):
    """Launch the kernels on CUDA tensors; returns ``(dq, dk, dv)``.

    ``dout`` may be a strided view (autograd hands over the transpose of the
    model's (B, S, H * hd) gradient); it is copied to a contiguous tensor.
    """
    global launches
    on_one_gpu("flash_attention_bwd", q, k, v, out, lse, dout)
    check_args(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if out.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: out must have q's dtype and lse must be float32")
    q, k, v, out, lse = (t.contiguous() for t in (q, k, v, out, lse))
    dout = dout.to(q.dtype).contiguous()
    lib = build.library()
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dvec = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(),
            B, Hq, Hkv, Sq, Skv, hd, int(causal), int(window), int(q_offset),
            float(hd ** -0.5), DTYPES[q.dtype], stream,
        )
    build.check(err, "rt_flash_attention_bwd")
    launches += 1
    return dq, dk, dv
