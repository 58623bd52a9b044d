"""Sequence-parallel decode attention, flash decoding across ranks: the port
of ``repro.serve.flash_decoding``.

The KV cache's sequence dimension is cut over one mesh axis (``model`` by
default): every rank computes a partial online softmax ``(m, l, acc)`` over
its shard of the cache, and the partials merge with two all-reduces, the
cross-rank mirror of the decode-attention kernel's block algebra.  With the
global maximum ``m*`` (an all-reduce MAX),

    out = sum_i exp(m_i - m*) acc_i / sum_i exp(m_i - m*) l_i

(an all-reduce SUM of each scaled term).  GQA head counts that do not divide
the axis (10 heads over 4 ranks) are no obstacle: the cut is along the
sequence, and each rank holds ``S / n`` slots.

The per-shard partial is plain PyTorch, as JAX's is plain ``jnp``.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _partial_softmax(q, k_shard, v_shard, pos0, valid_len):
    """One rank's partial attention.  q: (B, Hq, 1, hd); shards: (B, Hkv, Sl, hd).

    Positions ``pos0 + i`` below ``valid_len`` are visible.  Returns ``(m, l,
    acc)`` in fp32: the running max (B, Hkv, G, 1), the denominator (B, Hkv,
    G, 1) and the unnormalised output (B, Hkv, G, 1, hd).
    """
    B, Hq, _, hd = q.shape
    _, Hkv, Sl, _ = k_shard.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, 1, hd).float() * (hd ** -0.5)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_shard.float())
    pos = pos0 + torch.arange(Sl, device=q.device)
    s = torch.where(pos < valid_len, s, torch.full_like(s, _NEG))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v_shard.float())
    return m, l, acc


def make_flash_decode(mesh, axis: str = "model"):
    """``fn(q, k_shard, v_shard, valid_len)`` on one rank of ``mesh``.

    ``q`` (B, Hq, 1, hd) is the same on every rank of ``axis``; ``k_shard``
    and ``v_shard`` (B, Hkv, S / n, hd) are this rank's part of the caches,
    rank ``i`` of the axis holding slots ``[i S / n, (i + 1) S / n)`` (a
    ``NamedSharding`` with spec ``P(None, None, axis, None)`` cuts them so);
    ``valid_len`` is an int or a 0-d tensor.  Returns the attention output
    (B, Hq, 1, hd) in the caches' dtype, the same on every rank, zeros where
    the merged denominator is 0.
    """
    idx = mesh.coords[axis]

    def fn(q, k_shard, v_shard, valid_len):
        B, Hq, _, hd = q.shape
        m, l, acc = _partial_softmax(q, k_shard, v_shard, idx * k_shard.shape[2], valid_len)
        m_star = mesh.all_reduce(m.clone(), axis, op="max")
        scale = torch.exp(m - m_star)
        l_tot = mesh.all_reduce(l * scale, axis)
        acc_tot = mesh.all_reduce(acc * scale[..., None], axis)
        out = acc_tot / torch.where(l_tot == 0, 1.0, l_tot)[..., None]
        return out.reshape(B, Hq, 1, hd).to(v_shard.dtype)

    return fn
