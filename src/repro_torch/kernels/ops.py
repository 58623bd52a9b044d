"""Kernel dispatch on the tensor's device.

A CUDA tensor launches the hand-written kernel (or the launch raises); a CPU
tensor takes the kernel's plain PyTorch version in ``ref``.  Nothing else
decides, and no failure falls back to the other path.
"""

from __future__ import annotations

import torch

from . import decode_attention as _decode_attention
from . import ref
from . import rmsnorm as _rmsnorm
from . import swiglu as _swiglu


def _on_cuda(x: torch.Tensor, op: str) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {x.device}")


def rmsnorm(x, gamma, *, eps: float = 1e-5):
    if _on_cuda(x, "rmsnorm"):
        return _rmsnorm.rmsnorm_cuda(x, gamma, eps)
    return ref.rmsnorm_ref(x, gamma, eps)


def swiglu_mlp(x, w_gate, w_up, w_down):
    if _on_cuda(x, "swiglu_mlp"):
        return _swiglu.swiglu_cuda(x, w_gate, w_up, w_down)
    return ref.swiglu_ref(x, w_gate, w_up, w_down)


def decode_attention(q, k_cache, v_cache, valid_len, *, window: int = 0):
    if _on_cuda(q, "decode_attention"):
        return _decode_attention.decode_attention_cuda(q, k_cache, v_cache, valid_len,
                                                       window=window)
    return ref.decode_attention_ref(q, k_cache, v_cache, valid_len, window=window)
