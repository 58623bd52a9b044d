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


def rmsnorm_bwd_ref(x, gamma, dy, eps: float = 1e-5):
    """Gradients of :func:`rmsnorm_ref`: ``(dx, dgamma)``, all in fp32.

    Per row, ``r = rsqrt(mean(x^2) + eps)``, ``xhat = x * r``, ``g = dy * gamma``;
    ``dx = r * (g - xhat * mean(g * xhat))`` and ``dgamma = sum_rows dy * xhat``,
    each cast once to its input's dtype.
    """
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    g = dyf * gamma.float()
    dx = r * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dgamma = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


def swiglu_ref(x, w_gate, w_up, w_down) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu)`` in fp32, cast to ``x.dtype``, then ``@ Wd``
    accumulated in fp32 and cast to ``x.dtype``."""
    xf = x.float()
    h = (F.silu(xf @ w_gate.float()) * (xf @ w_up.float())).to(x.dtype)
    return (h.float() @ w_down.float()).to(x.dtype)


def swiglu_gate_bwd_ref(a, b, dh):
    """The gate of the SwiGLU backward, elementwise in fp32 with one cast.

    ``a = x @ Wg``, ``b = x @ Wu`` and ``dh = dy @ Wd^T``; returns
    ``h = silu(a) * b`` (for ``dWd``), ``da = dh * b * silu'(a)`` and
    ``db = dh * silu(a)``, where ``silu'(a) = sig(a) * (1 + a * (1 - sig(a)))``.
    """
    af, bf, gf = a.float(), b.float(), dh.float()
    sig = 1.0 / (1.0 + torch.exp(-af))
    silu = af * sig
    h = silu * bf
    da = gf * bf * (sig * (1.0 + af * (1.0 - sig)))
    db = gf * silu
    return h.to(a.dtype), da.to(a.dtype), db.to(a.dtype)


def swiglu_bwd(x, w_gate, w_up, w_down, dy, gate_bwd):
    """Gradients of the SwiGLU MLP: ``(dx, dWg, dWu, dWd)``.

    The products are ``torch.matmul`` in x's dtype (XLA's dots in the JAX
    package); ``gate_bwd(a, b, dh) -> (h, da, db)`` is the elementwise part,
    the CUDA kernel or :func:`swiglu_gate_bwd_ref`.
    """
    D = x.shape[-1]
    x2, dy2 = x.reshape(-1, D), dy.reshape(-1, D)
    a, b = x2 @ w_gate, x2 @ w_up
    h, da, db = gate_bwd(a, b, dy2 @ w_down.T)
    dx = da @ w_gate.T + db @ w_up.T
    return dx.reshape(x.shape), x2.T @ da, x2.T @ db, h.T @ dy2


def swiglu_bwd_ref(x, w_gate, w_up, w_down, dy):
    """:func:`swiglu_bwd` with the plain elementwise gate."""
    return swiglu_bwd(x, w_gate, w_up, w_down, dy, swiglu_gate_bwd_ref)


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int,
                   device) -> torch.Tensor:
    """(Sq, Skv) visibility: query ``i`` sits at ``q_offset + i``; key ``j`` is
    visible when ``j <= q_offset + i`` (causal) and ``j > q_offset + i - window``
    (``window > 0``).  Queries align to the start of the keys, as in the
    Pallas kernel and ``blockwise_attention``."""
    q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
    kv_pos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Attention with the flash kernel's arithmetic: ``(out, lse)``.

    q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd), GQA by ``h // (Hq // Hkv)``.
    Scores in fp32, scaled by ``hd ** -0.5`` after the dot; masked keys weigh
    exactly 0, and a row with no visible key gives zeros (the ``l == 0``
    guard) and ``lse = -inf``.  ``lse`` is the fp32 (B, Hq, Sq) natural-log
    sum of exp of the visible scores, which the backward reads.
    """
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, Sq, hd)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (hd ** -0.5)
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
    return out.reshape(B, Hq, Sq, hd).to(v.dtype), lse.reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                            q_offset: int = 0):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_ref`, the FA2 way.

    ``P`` is recomputed from q, k and the saved ``lse``; ``D = rowsum(dO * O)``
    in fp32; ``dS = P * (dO V^T - D)``; ``dq = dS K * scale``, ``dk = dS^T Q *
    scale``, ``dv = P^T dO``, summed over the G query heads of each kv head.
    Invisible pairs weigh 0, so a row with ``lse = -inf`` gives zero gradients.
    """
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    scale = hd ** -0.5
    qg = q.float().reshape(B, Hkv, G, Sq, hd)
    dog = dout.float().reshape(B, Hkv, G, Sq, hd)
    kf, vf = k.float(), v.float()
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    lse_g = lse.reshape(B, Hkv, G, Sq, 1)
    p = torch.where(mask, torch.exp(s - torch.where(torch.isfinite(lse_g), lse_g, 0.0)), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    d_row = (dog * out.float().reshape(B, Hkv, G, Sq, hd)).sum(dim=-1, keepdim=True)
    ds = p * (dp - d_row)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
