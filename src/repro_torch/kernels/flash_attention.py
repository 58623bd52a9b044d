"""Flash attention forward on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention``
(``src/repro/kernels/flash_attention.py``).  A block owns one (b, query
head) and a tile of query rows and walks only the kv tiles its rows can
see, with K/V of kv head ``h // G``; fp32 online softmax; it also writes
the fp32 row log-sum-exp (B, Hq, Sq) that the backward reads.  v may be
narrower than q and k (``hdv <= hd <= 192``): MLA's full-sequence attention
has q and k of ``qk_nope + qk_rope`` = 192 channels and v of 128, as JAX's
``blockwise_attention`` takes them.  :func:`route` picks the kernel from the
dtype, the widths and the pointers' alignment, nothing else:

- ``"wgmma"`` (bf16, (hd, hdv) in :data:`TC_WIDTHS`, 16-byte aligned):
  Hopper's tensor cores, 128 query rows a block, K/V tiles of 128 keys by
  TMA in a two-stage mbarrier ring, ``S = Q K^T`` and ``O += P V`` by wgmma
  with P rounded to bf16 (the plain version keeps P in fp32; the bf16
  tolerance covers it).  Bound on the H100 by bytes at qwen's training shape
  (8 x 16 heads x 512, hd 64: 0.010 ms) and by the 2 (hd + hdv) operations
  of each visible pair at Hymba's (0.031 ms global, 0.022 ms window 1024)
  and deepseek-v2-lite-16b's (2 x 16 heads x 2048 at (192, 128): 0.043 ms).
- ``"simt"`` (fp32, other widths): the CUDA-core kernel, 64 query rows a
  block, four threads a row, fp32 FMAs.

The kernels take contiguous tensors: the wrapper copies q, k and v where
they are views (the model's v is a transposed view of its projection).
"""

from __future__ import annotations

import torch

from . import build

#: kernel launches since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 192
ROUTES = ("wgmma", "simt")
#: kernel launches by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: (hd, hdv) of the tensor-core route: the dense models' 64 and 128, MLA's (192, 128)
TC_WIDTHS = ((64, 64), (128, 128), (192, 128))


def check_args(q, k, v) -> None:
    """Raise unless the kernel takes these arguments (contiguity aside): q (B,
    Hq, Sq, hd), k (B, Hkv, Skv, hd), v (B, Hkv, Skv, hdv), hdv <= hd <= 192."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)}; expected (B, Hq, Sq, hd), (B, Hkv, Skv, hd) and "
                         "(B, Hkv, Skv, hdv)")
    B, Hq, _, hd = q.shape
    Bk, Hkv, _, hdk = k.shape
    if Bk != B or hdk != hd or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: hd {hd} > {MAX_HEAD_DIM}")
    if v.shape[3] > hd:
        raise ValueError(f"flash_attention: v's hd {v.shape[3]} > q and k's {hd}")


def route(q, k, v) -> str:
    """The kernel that takes these (checked, contiguous) arguments, one of :data:`ROUTES`."""
    if (q.dtype != torch.bfloat16 or (q.shape[-1], v.shape[-1]) not in TC_WIDTHS
            or k.shape[2] == 0 or any(t.data_ptr() % 16 for t in (q, k, v))):
        return "simt"
    return "wgmma"


def launch(route_name: str, q, k, v, *, causal: bool, window: int, q_offset: int):
    """Run ``route_name``'s kernel on checked contiguous CUDA tensors; the caller counts."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, hdv = v.shape
    out = q.new_empty((B, Hq, Sq, hdv))
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Hq, Hkv, Sq, Skv, hd, hdv, int(causal), int(window), int(q_offset),
            float(hd ** -0.5))
    if route_name == "wgmma":
        build.launch("rt_flash_attention_tc", q.device, *args)
    else:
        build.launch("rt_flash_attention", q.device, *args, DTYPES[q.dtype])
    return out, lse


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Launch the kernel on CUDA tensors; returns ``(out, lse)``.  On meta
    tensors everything but the launch runs and nothing is counted."""
    global launches
    build.on_card("flash_attention", q, k, v)
    check_args(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.numel() == 0:
        return q.new_empty((*q.shape[:3], v.shape[3])), torch.empty(
            q.shape[:3], dtype=torch.float32, device=q.device)
    name = route(q, k, v)
    out = launch(name, q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.is_cuda:
        launches += 1
        route_launches[name] += 1
    return out
