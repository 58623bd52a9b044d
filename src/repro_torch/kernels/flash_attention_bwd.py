"""Flash attention backward on the card: the wrapper of ``csrc/flash_attention_bwd.cu``.

The Pallas flash kernel is forward only; the JAX package's training path
differentiates ``repro.models.layers.blockwise_attention`` with XLA.  This
is the FA2 backward of the port's flash forward: P recomputed from q, k and
the saved LSE, ``D = rowsum(dO * O)`` in fp32, two launches (a q-side pass
for dq and D, a kv-side pass for dk and dv that sums the G query heads of
its kv head) and no atomics, so the gradients have the same bits every run.
v, out, dout and dv may be narrower than q, k, dq and dk, as in the forward
(MLA: 128 beside 192).  :func:`route` picks the kernels from the dtype, the
widths and the pointers' alignment, nothing else:

- ``"wgmma"`` (bf16, (hd, hdv) in ``flash_attention.TC_WIDTHS``, 16-byte
  aligned; the forward's rule, which here also covers ``out`` and
  ``dout``): Hopper's tensor cores, TMA tiles in mbarrier rings, every
  product by wgmma with P and dS rounded to bf16 as the A operand of the
  products that follow (the plain version keeps them in fp32; the bf16
  gradient tolerance covers it).  Bound on the H100 by the 8 hd + 6 hdv
  operations of each visible pair at the models' shapes (S and dP formed on
  both sides).  At (192, 128) the q side walks K/V tiles of 64 keys and the
  kv side query tiles of 32 rows, to fit shared memory and registers.
- ``"simt"`` (fp32, other widths): the CUDA-core kernels, four threads a
  row, fp32 FMAs, which bound them.
"""

from __future__ import annotations

import torch

from . import build
from . import flash_attention

#: wrapper calls that launched the kernels since the count was last set to 0
launches = 0
ROUTES = ("wgmma", "simt")
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)


def route(q, k, v, out, dout) -> str:
    """The kernels that take these (checked, contiguous) arguments, one of :data:`ROUTES`."""
    if flash_attention.route(q, k, v) == "wgmma" and not any(
            t.data_ptr() % 16 for t in (out, dout)):
        return "wgmma"
    return "simt"


def launch(route_name: str, q, k, v, out, lse, dout, *, causal: bool, window: int,
           q_offset: int):
    """Run ``route_name``'s kernels on checked contiguous CUDA tensors; the caller counts."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, hdv = v.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(),
            B, Hq, Hkv, Sq, Skv, hd, hdv, int(causal), int(window), int(q_offset),
            float(hd ** -0.5))
    if route_name == "wgmma":
        build.launch("rt_flash_attention_bwd_tc", q.device, *args)
    else:
        build.launch("rt_flash_attention_bwd", q.device, *args, flash_attention.DTYPES[q.dtype])
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                             q_offset: int = 0):
    """Launch the kernels on CUDA tensors; returns ``(dq, dk, dv)``.

    ``dout`` may be a strided view (autograd hands over the transpose of the
    model's (B, S, H * hd) gradient); it is copied to a contiguous tensor.
    """
    global launches
    build.on_card("flash_attention_bwd", q, k, v, out, lse, dout)
    flash_attention.check_args(q, k, v)
    want = (*q.shape[:3], v.shape[3])
    if out.shape != want or dout.shape != want or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} for q {tuple(q.shape)} "
                         f"and v {tuple(v.shape)}")
    if out.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: out must have q's dtype and lse must be float32")
    q, k, v, out, lse = (t.contiguous() for t in (q, k, v, out, lse))
    dout = dout.to(q.dtype).contiguous()
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    name = route(q, k, v, out, dout)
    grads = launch(name, q, k, v, out, lse, dout, causal=causal, window=window,
                   q_offset=q_offset)
    if q.is_cuda:
        launches += 1
        route_launches[name] += 1
    return grads
