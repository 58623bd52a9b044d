"""Analytic cost estimates for the kernels (the JAX package's ``pl.CostEstimate`` math).

The JAX package's ``kernels/cost.py``, copied as it is: ``KernelCost``,
``avg_context``, ``flash_attention_cost``, ``mlstm_scan_cost``,
``ssd_scan_cost`` and ``swiglu_cost`` give the same floats.  Each mirrors
the grid/BlockSpec arithmetic of the Pallas kernel it prices and returns
the three quantities a ``pl.CostEstimate`` declares to the compiler:
``flops``, ``bytes_accessed`` and ``transcendentals``.  The roofline table
(:mod:`repro_torch.roofline.table`) sums these per layer to price the
attention/scan work that the dense ``6*N*D`` matmul model does not cover.

JAX counts its kernels' calls in the compiled HLO; PyTorch has no such
count, so the port's step counter (:mod:`repro_torch.roofline.count`)
prices each call of a hand-written kernel by the functions here, under the
same conventions.  For that the port adds what the JAX file lacks:
``rmsnorm_cost``, ``decode_attention_cost``, a ``head_dim_v`` for
``flash_attention_cost`` (MLA's v narrower than q and k), and every
backward (``flash_attention_bwd_cost``, ``rmsnorm_bwd_cost``,
``swiglu_bwd_cost``, ``mlstm_scan_bwd_cost``, ``ssd_scan_bwd_cost``).

Conventions (shared with :mod:`repro.roofline.analysis`):

* FLOPs count MXU work only (2 per multiply-accumulate); vector-unit
  elementwise work rides along free.
* ``bytes_accessed`` is HBM traffic of the tiled kernel: operand tiles are
  charged once per grid visit (flash attention re-streams K/V once per query
  block — that re-read is the kernel's real memory cost), outputs once.
* Masked-out work is *not* charged: causal/windowed attention prices the
  average visited context per query, matching the ``causal_pairs`` block
  enumeration rather than the dense rectangle.

A backward is priced at twice its forward on every axis (``backward``),
the factor ``roofline/table.py``'s ``kernel_factor`` assumes (fwd + ~2x
bwd), except RMSNorm's, whose bytes are derived below.

Pure Python, no framework import — loadable from table generation and tests alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KernelCost:
    """The three axes of ``pl.CostEstimate``, as plain floats."""

    flops: float
    bytes_accessed: float
    transcendentals: float = 0.0

    def __add__(self, other: "KernelCost") -> "KernelCost":
        return KernelCost(
            self.flops + other.flops,
            self.bytes_accessed + other.bytes_accessed,
            self.transcendentals + other.transcendentals,
        )

    def scale(self, k: float) -> "KernelCost":
        return KernelCost(self.flops * k, self.bytes_accessed * k, self.transcendentals * k)


ZERO_COST = KernelCost(0.0, 0.0, 0.0)


def avg_context(seq_len: int, kv_len: int, *, causal: bool = True, window: int = 0) -> float:
    """Mean visited KV positions per query row.

    Full attention sees ``kv_len``; causal row ``i`` sees ``i+1`` (mean
    ``(kv_len+1)/2`` for square self-attention); a sliding window of ``w``
    clamps that at ``w`` once past the ramp: exact mean
    ``w - w*(w-1)/(2*seq_len)`` for ``seq_len >= w``.
    """
    if window > 0:
        w = min(window, kv_len)
        if seq_len <= w:
            return (seq_len + 1) / 2.0 if causal else float(kv_len)
        return w - w * (w - 1) / (2.0 * seq_len)
    if causal and seq_len == kv_len:
        return (kv_len + 1) / 2.0
    return float(kv_len)


def flash_attention_cost(
    batch: int,
    q_heads: int,
    q_len: int,
    kv_len: int,
    head_dim: int,
    *,
    causal: bool = True,
    window: int = 0,
    block_q: int = 128,
    block_k: int = 128,
    dtype_bytes: int = 2,
    head_dim_v: Optional[int] = None,
) -> KernelCost:
    """Forward cost of one ``flash_attention`` call.

    FLOPs: ``QK^T`` and ``PV`` are each ``2*ctx*head_dim`` per query per
    head; transcendentals: one ``exp`` per visited score.  Bytes: Q and O
    tiles stream once, K/V tiles once per *visited* query block
    (``n_q_blocks * visited_fraction`` re-reads — the flash-attention
    HBM-traffic signature).

    ``head_dim_v`` (the port's; None or ``head_dim`` gives JAX's floats): v
    and O narrower than q and k, as MLA's 128 beside 192.  ``QK^T`` costs
    ``2*ctx*head_dim`` and ``PV`` ``2*ctx*head_dim_v``; Q and K stream at
    ``head_dim``, O and V at ``head_dim_v``.
    """
    ctx = avg_context(q_len, kv_len, causal=causal, window=window)
    bh = float(batch * q_heads)
    transcendentals = bh * q_len * ctx
    n_q_blocks = -(-q_len // max(1, block_q))
    visited = ctx / float(kv_len)
    if head_dim_v is None or head_dim_v == head_dim:
        flops = 4.0 * bh * q_len * ctx * head_dim
        qo_bytes = 2.0 * bh * q_len * head_dim * dtype_bytes
        kv_bytes = 2.0 * bh * kv_len * head_dim * dtype_bytes * n_q_blocks * visited
        return KernelCost(flops, qo_bytes + kv_bytes, transcendentals)
    width = float(head_dim + head_dim_v)
    flops = 2.0 * bh * q_len * ctx * width
    qo_bytes = bh * q_len * width * dtype_bytes
    kv_bytes = bh * kv_len * width * dtype_bytes * n_q_blocks * visited
    return KernelCost(flops, qo_bytes + kv_bytes, transcendentals)


def mlstm_scan_cost(
    batch: int,
    heads: int,
    seq_len: int,
    d_qk: int,
    d_v: int,
    *,
    chunk: int = 128,
    dtype_bytes: int = 2,
) -> KernelCost:
    """Forward cost of one chunked ``mlstm_scan`` call.

    Per token per head: intra-chunk pair weights cost ``2*L*(d_qk + d_v)``
    (QK^T over the chunk + the (L,L)@V read-out), the cross-chunk matrix
    memory costs ``4*d_qk*d_v`` (K^T V state update + Q-through-C read).
    One decay ``exp`` per intra-chunk pair.
    """
    L = min(chunk, seq_len)
    bht = float(batch * heads * seq_len)
    flops = bht * (2.0 * L * (d_qk + d_v) + 4.0 * d_qk * d_v)
    transcendentals = bht * L
    io_bytes = bht * (2.0 * d_qk + 2.0 * d_v + 2.0) * dtype_bytes
    return KernelCost(flops, io_bytes, transcendentals)


def ssd_scan_cost(
    batch: int,
    heads: int,
    seq_len: int,
    head_channels: int,
    state_dim: int,
    *,
    chunk: int = 128,
    dtype_bytes: int = 2,
) -> KernelCost:
    """Forward cost of one chunked ``ssd_scan`` (Mamba-2 SSD) call.

    Per token per head: intra-chunk decay-weighted pair read-out
    ``2*L*head_channels``, plus the carried (chd, N) state — outer-product
    update and C-read — at ``4*head_channels*state_dim``.
    """
    L = min(chunk, seq_len)
    bht = float(batch * heads * seq_len)
    flops = bht * head_channels * (2.0 * L + 4.0 * state_dim)
    transcendentals = bht * L
    io_bytes = bht * (2.0 * head_channels + 3.0 * state_dim) * dtype_bytes
    return KernelCost(flops, io_bytes, transcendentals)


def swiglu_cost(
    tokens: int, d_model: int, d_ff: int, *, dtype_bytes: int = 2
) -> KernelCost:
    """Forward cost of one ``swiglu_mlp`` call (three matmuls + gate)."""
    flops = 6.0 * tokens * d_model * d_ff
    io_bytes = (2.0 * tokens * d_model + 3.0 * d_model * d_ff) * dtype_bytes
    return KernelCost(flops, io_bytes, float(tokens * d_ff))


# ----------------------------------------------------------------------------
# The port's additions: the kernels the JAX file does not price, and backwards.
# ----------------------------------------------------------------------------

def backward(fwd: KernelCost) -> KernelCost:
    """A backward priced at twice its forward on every axis (``kernel_factor``'s
    fwd + ~2x bwd): it reads what the forward read and the output's gradient,
    writes a gradient for each input, and recomputes or transposes each of
    the forward's products once more."""
    return fwd.scale(2.0)


def rmsnorm_cost(rows: int, d: int, *, dtype_bytes: int = 2) -> KernelCost:
    """Forward cost of one ``rmsnorm`` call over ``rows`` rows of ``d``.

    No MXU work (the file's convention: elementwise work rides along free),
    so FLOPs are 0.  Bytes: x read and y written once, gamma read once.
    One ``rsqrt`` a row.
    """
    io_bytes = (2.0 * rows * d + d) * dtype_bytes
    return KernelCost(0.0, io_bytes, float(rows))


def rmsnorm_bwd_cost(rows: int, d: int, *, dtype_bytes: int = 2) -> KernelCost:
    """Backward cost of one ``rmsnorm`` call: FLOPs 0 as the forward's.  Bytes,
    derived rather than doubled: x and dy read and dx written (3 a row
    element), gamma read and dgamma written (2 a column).  One ``rsqrt`` a row,
    as the forward."""
    io_bytes = (3.0 * rows * d + 2.0 * d) * dtype_bytes
    return KernelCost(0.0, io_bytes, float(rows))


def decode_attention_cost(
    batch: int,
    q_heads: int,
    kv_heads: int,
    cache_len: int,
    head_dim: int,
    *,
    window: int = 0,
    dtype_bytes: int = 2,
) -> KernelCost:
    """Cost of one ``decode_attention`` call: one query row per head over a
    KV cache of ``cache_len`` slots, ``window`` of them visible when set.

    The visible context is the whole cache (or the window): the valid length
    lies on the device, and the count does not read it.  FLOPs: ``q K^T``
    and ``P V`` at ``2*ctx*head_dim`` each per query head; one ``exp`` per
    score.  Bytes: q read and o written once, the visible K and V rows of
    each kv head once (the group's query heads share them).
    """
    ctx = float(min(window, cache_len) if window > 0 else cache_len)
    bh = float(batch * q_heads)
    flops = 4.0 * bh * ctx * head_dim
    qo_bytes = 2.0 * bh * head_dim * dtype_bytes
    kv_bytes = 2.0 * batch * kv_heads * ctx * head_dim * dtype_bytes
    return KernelCost(flops, qo_bytes + kv_bytes, bh * ctx)


def flash_attention_bwd_cost(*args, **kw) -> KernelCost:
    """Backward cost of one ``flash_attention`` call (:func:`flash_attention_cost`'s
    arguments): :func:`backward` of its forward."""
    return backward(flash_attention_cost(*args, **kw))


def swiglu_bwd_cost(*args, **kw) -> KernelCost:
    """Backward cost of one ``swiglu_mlp`` call: :func:`backward` of its forward
    (dx and the three weight gradients are twice the forward's products)."""
    return backward(swiglu_cost(*args, **kw))


def mlstm_scan_bwd_cost(*args, **kw) -> KernelCost:
    """Backward cost of one ``mlstm_scan`` call: :func:`backward` of its forward."""
    return backward(mlstm_scan_cost(*args, **kw))


def ssd_scan_bwd_cost(*args, **kw) -> KernelCost:
    """Backward cost of one ``ssd_scan`` call: :func:`backward` of its forward."""
    return backward(ssd_scan_cost(*args, **kw))
