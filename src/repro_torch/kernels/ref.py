"""Plain PyTorch versions of the port's kernels.

Each function repeats its CUDA kernel's arithmetic and rounding order, which
is the order of the Pallas kernel it replaces: the kernel wrappers take these
for CPU tensors, the CPU tests hold them against the JAX package, and the chip
smoke run holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last axis: fp32 mean of squares, ``rsqrt(ms + eps)``,
    times gamma in fp32, then one cast to ``x.dtype``."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def swiglu_ref(x, w_gate, w_up, w_down) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu)`` in fp32, cast to ``x.dtype``, then ``@ Wd``
    accumulated in fp32 and cast to ``x.dtype``."""
    xf = x.float()
    h = (F.silu(xf @ w_gate.float()) * (xf @ w_up.float())).to(x.dtype)
    return (h.float() @ w_down.float()).to(x.dtype)


def valid_len_vector(valid_len, batch: int, device) -> torch.Tensor:
    """A scalar or ``(B,)`` ``valid_len`` as an int32 ``(B,)`` tensor on ``device``."""
    if isinstance(valid_len, torch.Tensor):
        vl = valid_len.to(device=device, dtype=torch.int32)
        if vl.ndim == 0:
            return vl.expand(batch).contiguous()
        if vl.shape != (batch,):
            raise ValueError(f"valid_len has shape {tuple(vl.shape)}, expected () or ({batch},)")
        return vl.contiguous()
    return torch.full((batch,), int(valid_len), dtype=torch.int32, device=device)


def decode_attention_ref(q, k_cache, v_cache, valid_len, *, window: int = 0) -> torch.Tensor:
    """One-token GQA attention against a KV cache.

    q: (B, Hq, 1, hd); caches: (B, Hkv, S, hd); ``valid_len``: scalar or (B,).
    Position ``p`` is visible when ``p < valid`` and, with ``window > 0``,
    ``p > valid - 1 - window``.  Scores are taken in fp32 and scaled after the
    dot; a row with no visible position gives zeros (the ``l == 0`` guard).
    """
    B, Hq, _, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) * (hd ** -0.5)
    vl = valid_len_vector(valid_len, B, q.device)[:, None]          # (B, 1)
    pos = torch.arange(S, device=q.device)[None, :]
    mask = pos < vl
    if window > 0:
        mask &= pos > vl - 1 - window
    mask = mask[:, None, None, :]                                   # (B, 1, 1, S)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float()) / torch.where(l == 0, 1.0, l)
    return out.reshape(B, Hq, 1, -1).to(v_cache.dtype)
