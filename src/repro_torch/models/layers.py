"""Shared model primitives of the serving path: norm, RoPE, decode attention, MLP.

``rms_norm``, ``decode_attention`` and ``swiglu`` go through
:mod:`repro_torch.kernels.ops`: the hand-written kernels on the card, their
plain versions on the CPU.  Their rounding follows the kernels, which differ
from the JAX package's XLA layers in two places (bf16 only; identical in
fp32 up to the order of sums):

* ``rms_norm`` multiplies by gamma in fp32 and casts once; the JAX layer
  casts first and multiplies in the input dtype;
* ``decode_attention`` scales the scores in fp32 after the dot; the JAX layer
  scales q in the input dtype before it.
"""

from __future__ import annotations

import torch

from ..kernels import ops


def rms_norm(x, gamma, eps: float = 1e-5):
    return ops.rmsnorm(x, gamma, eps=eps)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding.  x: (..., S, d); positions: (S,) or broadcastable."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].to(torch.float32) * freqs     # (S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def decode_attention(q, k_cache, v_cache, valid_len, *, window: int = 0):
    """Single-position attention against a cache.

    q: (B, Hq, 1, hd); caches: (B, Hkv, S, hd); ``valid_len``: scalar or (B,)
    number of valid cache positions (the new token lives at valid_len - 1).
    """
    return ops.decode_attention(q, k_cache, v_cache, valid_len, window=window)


def swiglu(x, w_gate, w_up, w_down):
    return ops.swiglu_mlp(x, w_gate, w_up, w_down)
