"""The kernels' cost formulas: a frozen copy of the parts of
``repro_torch.kernels.cost`` that the roofline reader uses (``avg_context``,
``flash_attention_cost``'s operations, ``swiglu_cost``, ``rmsnorm_cost``,
``rmsnorm_bwd_cost`` and ``backward``'s factor of two), returned as
``(flops, bytes_accessed)`` pairs."""

from __future__ import annotations

from typing import Optional


def avg_context(seq_len: int, kv_len: int, *, causal: bool = True, window: int = 0) -> float:
    """Mean visited KV positions per query row."""
    if window > 0:
        w = min(window, kv_len)
        if seq_len <= w:
            return (seq_len + 1) / 2.0 if causal else float(kv_len)
        return w - w * (w - 1) / (2.0 * seq_len)
    if causal and seq_len == kv_len:
        return (kv_len + 1) / 2.0
    return float(kv_len)


def flash_attention_flops(batch: int, q_heads: int, q_len: int, kv_len: int, head_dim: int,
                          *, causal: bool = True, window: int = 0,
                          head_dim_v: Optional[int] = None) -> float:
    """The forward's operations: ``QK^T`` at ``2 ctx head_dim`` and ``PV`` at
    ``2 ctx head_dim_v`` a query a head, over the visited context."""
    ctx = avg_context(q_len, kv_len, causal=causal, window=window)
    width = float(head_dim + (head_dim if head_dim_v is None else head_dim_v))
    return 2.0 * batch * q_heads * q_len * ctx * width


def swiglu_cost(tokens: int, d_model: int, d_ff: int, *, dtype_bytes: int = 2):
    """Forward of one ``swiglu_mlp`` call (three products and the gate)."""
    flops = 6.0 * tokens * d_model * d_ff
    io_bytes = (2.0 * tokens * d_model + 3.0 * d_model * d_ff) * dtype_bytes
    return flops, io_bytes


def rmsnorm_cost(rows: int, d: int, *, dtype_bytes: int = 2):
    """Forward of one ``rmsnorm`` call: x read and y written once, gamma read once."""
    return 0.0, (2.0 * rows * d + d) * dtype_bytes


def rmsnorm_bwd_cost(rows: int, d: int, *, dtype_bytes: int = 2):
    """Backward of one ``rmsnorm`` call: x and dy read, dx written, gamma read
    and dgamma written."""
    return 0.0, (3.0 * rows * d + 2.0 * d) * dtype_bytes


#: a backward's operations over its forward's (``cost.backward``)
BACKWARD_FACTOR = 2.0
