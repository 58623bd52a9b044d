"""One-token GQA decode attention on the card: the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``_decode_kernel`` / ``decode_attention``
(``src/repro/kernels/decode_attention.py``).  What bounds it on the H100:
device memory, for the visible K and V rows read once (2 * B * Hkv *
visible * hd * bytes); its operations (4 * B * Hq * visible * hd, at most
about 2 G a byte) are far below the card's rate, so no route uses the
tensor cores.  :func:`route` picks the body from the dtype, hd and the
pointers' alignment, nothing else:

- ``"split"`` (hd a multiple of 8, 16-byte aligned q, k and v):
  flash-decoding.  :func:`plan_splits` cuts the cache into spans from the
  shapes alone; a block per (batch row, kv head, up to 8 query heads,
  span) keeps (m, l, acc) per warp in registers, reads K and V 16 bytes a
  lane with the next rows in flight, and merges its warps once.  With more
  than one span a second launch merges the spans' fp32 partials in span
  order, from scratch this wrapper allocates.
- ``"simt"`` (any other hd): the first port of the kernel, one block per (batch row, kv
  head) walking the cache in tiles of 64 with three barriers a tile.

Both read only the visible positions and keep the Pallas order: scores in
fp32, scaled after the dot; a row with no visible position gives zeros.
``valid_len`` is an int32 ``(B,)`` device tensor (a scalar or another form
is made into one here, one fill launch); it stays on the device, so the
launch never waits for the host and a CUDA graph of it replays at any fill
level.  The host path is the lean one of the rmsnorm wrappers: the checks
that depend only on shapes, dtypes and devices, and the split plan, run
once per such key (``build.checked_once``), and the launch takes PyTorch's
raw stream handle without a device context (``build.launch``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import build
from .ref import valid_len_vector

#: wrapper calls that launched a kernel since the count was last set to 0
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 16
ROUTES = ("split", "simt")
#: wrapper calls by route since the counts were last set to 0
route_launches = dict.fromkeys(ROUTES, 0)
#: a span is a whole number of these positions
SPAN_GRANULE = 64
#: blocks an SM the planner aims for where the cache is long enough
BLOCKS_PER_SM = 2
#: a span holds at least this many elements of K (and as many of V): 256
#: positions at hd 64, 128 at hd 128
MIN_SPAN_ELEMS = 16384
#: the split body's query heads a block; G = 9..16 takes two blocks a kv head
MAX_GROUP_A_BLOCK = 8
#: (shapes, dtypes, devices of q, k, v) -> (whether hd suits "split", plan);
#: filled on first sight
_checked: dict = {}


class SplitPlan(NamedTuple):
    """``n_split`` spans of ``span`` positions over a cache of ``S`` (the last
    may be shorter)."""

    n_split: int
    span: int
    S: int

    @property
    def spans(self) -> tuple[tuple[int, int], ...]:
        """``(start, stop)`` of each span, in order; together they cover ``[0, S)`` once."""
        return tuple((i * self.span, min((i + 1) * self.span, self.S))
                     for i in range(self.n_split))


def plan_splits(B: int, Hkv: int, S: int, hd: int, G: int = 1, *, n_sm: int = 132) -> SplitPlan:
    """The split route's spans, from the shapes only (never from ``valid_len``).

    As many spans as give :data:`BLOCKS_PER_SM` blocks on each of ``n_sm`` SMs,
    but no span shorter than ``MIN_SPAN_ELEMS / hd`` positions; each span a
    multiple of :data:`SPAN_GRANULE`.  One span when the cache is short, as at
    serving's 168 slots.
    """
    blocks = B * Hkv * math.ceil(G / MAX_GROUP_A_BLOCK)
    want = math.ceil(BLOCKS_PER_SM * n_sm / max(1, blocks))
    n = max(1, min(want, S // max(1, MIN_SPAN_ELEMS // hd)))
    span = max(SPAN_GRANULE, math.ceil(math.ceil(S / n) / SPAN_GRANULE) * SPAN_GRANULE)
    return SplitPlan(max(1, math.ceil(S / span)), span, S)


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


def _split_shape(q) -> bool:
    """Whether the ``"split"`` body takes q's head dimension: a multiple of 8."""
    return q.shape[-1] % 8 == 0


def _aligned(q, k_cache, v_cache) -> bool:
    return not (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16


def route(q, k_cache, v_cache) -> str:
    """The body that takes these (checked, contiguous) arguments, one of :data:`ROUTES`."""
    return "split" if _split_shape(q) and _aligned(q, k_cache, v_cache) else "simt"


_sm_count = build.sm_count


def _check_key(q, k_cache, v_cache) -> tuple[bool, SplitPlan]:
    """Raise unless one GPU and :func:`check_args` take the arguments;
    (:func:`_split_shape`, the split plan on this card)."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k_cache, v_cache)):
        raise ValueError(f"decode_attention: tensors on "
                         f"{[str(t.device) for t in (q, k_cache, v_cache)]}, expected one GPU")
    check_args(q, k_cache, v_cache)
    B, Hq, _, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    return _split_shape(q), plan_splits(B, Hkv, S, hd, Hq // Hkv, n_sm=_sm_count(q.device))


def launch(route_name: str, q, k_cache, v_cache, valid_len: torch.Tensor, window: int,
           plan: SplitPlan | None = None) -> torch.Tensor:
    """Run ``route_name``'s body on checked contiguous CUDA tensors, ``valid_len``
    an int32 (B,) tensor on their device; the caller counts.  ``plan``: the
    ``"split"`` body's spans (``"simt"`` takes none)."""
    B, Hq, _, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    out = torch.empty_like(q)
    lib = build.library()
    scale = float(hd ** -0.5)
    if route_name == "simt":
        build.launch(lib.rt_decode_attention, "rt_decode_attention", q.device, q.data_ptr(),
                     k_cache.data_ptr(), v_cache.data_ptr(), valid_len.data_ptr(),
                     out.data_ptr(), B, Hkv, Hq // Hkv, S, hd, int(window), scale,
                     DTYPES[q.dtype])
        return out
    part = (torch.empty(B * Hq * plan.n_split * (hd + 2), dtype=torch.float32, device=q.device)
            if plan.n_split > 1 else None)
    build.launch(lib.rt_decode_attention_split, "rt_decode_attention_split", q.device,
                 q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_len.data_ptr(),
                 out.data_ptr(), None if part is None else part.data_ptr(), B, Hkv, Hq // Hkv,
                 S, hd, int(window), plan.n_split, plan.span, scale, DTYPES[q.dtype])
    return out


def decode_attention_cuda(q, k_cache, v_cache, valid_len, *, window: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``valid_len``: scalar or (B,)."""
    global launches
    split_ok, plan = build.checked_once(
        _checked, (q.shape, k_cache.shape, v_cache.shape, q.dtype, k_cache.dtype,
                   v_cache.dtype, q.device, k_cache.device, v_cache.device),
        _check_key, q, k_cache, v_cache)
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and the caches must be contiguous")
    B = q.shape[0]
    vl = valid_len
    if not (isinstance(vl, torch.Tensor) and vl.dtype == torch.int32 and vl.shape == (B,)
            and vl.device == q.device and vl.is_contiguous()):
        vl = valid_len_vector(valid_len, B, q.device)
    if q.numel() == 0:
        return torch.empty_like(q)
    name = "split" if split_ok and _aligned(q, k_cache, v_cache) else "simt"
    out = launch(name, q, k_cache, v_cache, vl, window, plan)
    launches += 1
    route_launches[name] += 1
    return out
