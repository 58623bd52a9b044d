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


def swiglu_fwd_ref(x, w_gate, w_up, w_down):
    """:func:`swiglu_ref`'s output, and ``a = x @ Wg``, ``b = x @ Wu`` as (N, F)
    fp32 sums cast once to ``x.dtype``: what the tensor-core forward saves for
    the backward."""
    xf = x.reshape(-1, x.shape[-1]).float()
    a, b = xf @ w_gate.float(), xf @ w_up.float()
    h = (F.silu(a) * b).to(x.dtype)
    y = (h.float() @ w_down.float()).to(x.dtype)
    return y.reshape(x.shape), a.to(x.dtype), b.to(x.dtype)


def swiglu_ref(x, w_gate, w_up, w_down) -> torch.Tensor:
    """``silu(x @ Wg) * (x @ Wu)`` in fp32, cast to ``x.dtype``, then ``@ Wd``
    accumulated in fp32 and cast to ``x.dtype``."""
    return swiglu_fwd_ref(x, w_gate, w_up, w_down)[0]


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


def swiglu_bwd_products(x, w_gate, w_up, dy, h, da, db):
    """The products of the SwiGLU backward after the gate: ``(dx, dWg, dWu,
    dWd)``, ``torch.matmul`` in x's dtype (XLA's dots in the JAX package), dx
    as one ``addmm`` so that ``da Wg^T`` and ``db Wu^T`` meet in its fp32 sum."""
    D = x.shape[-1]
    x2, dy2 = x.reshape(-1, D), dy.reshape(-1, D)
    dx = torch.addmm(da @ w_gate.T, db, w_up.T)
    return dx.reshape(x.shape), x2.T @ da, x2.T @ db, h.T @ dy2


def swiglu_bwd(x, w_gate, w_up, w_down, dy, gate_bwd):
    """Gradients of the SwiGLU MLP from x alone: ``(dx, dWg, dWu, dWd)``.

    ``a = x Wg``, ``b = x Wu`` and ``dh = dy Wd^T`` by ``torch.matmul`` in x's
    dtype; ``gate_bwd(a, b, dh) -> (h, da, db)`` is the elementwise part, the
    CUDA kernel or :func:`swiglu_gate_bwd_ref`; then :func:`swiglu_bwd_products`.
    """
    D = x.shape[-1]
    x2, dy2 = x.reshape(-1, D), dy.reshape(-1, D)
    h, da, db = gate_bwd(x2 @ w_gate, x2 @ w_up, dy2 @ w_down.T)
    return swiglu_bwd_products(x, w_gate, w_up, dy, h, da, db)


def swiglu_bwd_ref(x, w_gate, w_up, w_down, dy):
    """:func:`swiglu_bwd` with the plain elementwise gate."""
    return swiglu_bwd(x, w_gate, w_up, w_down, dy, swiglu_gate_bwd_ref)


def swiglu_bwd_saved_ref(x, w_gate, w_up, w_down, a, b, dy):
    """Gradients of the SwiGLU MLP from the forward's saved (N, F) ``a`` and
    ``b``, with the tensor-core kernel's arithmetic: ``dh = dy Wd^T`` kept in
    fp32, the gate of :func:`swiglu_gate_bwd_ref` on it (one cast each of h,
    da and db), then :func:`swiglu_bwd_products`."""
    dh = dy.reshape(-1, x.shape[-1]).float() @ w_down.float().T
    h, da, db = swiglu_gate_bwd_ref(a, b, dh)
    return swiglu_bwd_products(x, w_gate, w_up, dy, h, da, db)


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


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                        p_bf16: bool = False):
    """Attention with the flash kernel's arithmetic: ``(out, lse)``.

    q, k: (B, Hq, Sq, hd), (B, Hkv, Skv, hd); v: (B, Hkv, Skv, hdv), its own
    width (MLA's 128 beside q and k's 192); GQA by ``h // (Hq // Hkv)``.
    Scores in fp32, scaled by ``hd ** -0.5`` after the dot; masked keys weigh
    exactly 0, and a row with no visible key gives zeros (the ``l == 0``
    guard) and ``lse = -inf``.  ``lse`` is the fp32 (B, Hq, Sq) natural-log
    sum of exp of the visible scores, which the backward reads.  With
    ``p_bf16``, P is rounded to bf16 before ``P V`` and ``l`` stays the fp32
    sum, as in the tensor-core route; that kernel rounds P against its
    running max and this against the row's, so the two share the rounding's
    size, not its bits.
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
    if p_bf16:
        p = _bf16_round(p)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))
    return out.reshape(B, Hq, Sq, -1).to(v.dtype), lse.reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                            q_offset: int = 0, p_bf16: bool = False):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention_ref`, the FA2 way.

    ``P`` is recomputed from q, k and the saved ``lse``; ``D = rowsum(dO * O)``
    in fp32; ``dS = P * (dO V^T - D)``; ``dq = dS K * scale``, ``dk = dS^T Q *
    scale``, ``dv = P^T dO``, summed over the G query heads of each kv head.
    v, dout and out may be narrower than q and k, as in :func:`flash_attention_ref`.
    Invisible pairs weigh 0, so a row with ``lse = -inf`` gives zero gradients.
    With ``p_bf16``, P is rounded to bf16 before ``P^T dO`` and dS before
    ``dS K`` and ``dS^T Q``, as in the tensor-core route (dS itself is formed
    from the fp32 P there too).
    """
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    scale = hd ** -0.5
    qg = q.float().reshape(B, Hkv, G, Sq, hd)
    dog = dout.float().reshape(B, Hkv, G, Sq, -1)
    kf, vf = k.float(), v.float()
    mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    lse_g = lse.reshape(B, Hkv, G, Sq, 1)
    p = torch.where(mask, torch.exp(s - torch.where(torch.isfinite(lse_g), lse_g, 0.0)), 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", _bf16_round(p) if p_bf16 else p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    d_row = (dog * out.float().reshape(B, Hkv, G, Sq, -1)).sum(dim=-1, keepdim=True)
    ds = p * (dp - d_row)
    if p_bf16:
        ds = _bf16_round(ds)
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


def decode_attention_split_ref(q, k_cache, v_cache, valid_len, *, window: int = 0,
                               spans) -> torch.Tensor:
    """:func:`decode_attention_ref` as the ``"split"`` kernel forms it: each span
    ``(start, stop)`` of ``spans`` (in order, covering the cache once) gives its
    own ``(m, l, acc)`` over its visible positions, and the spans merge in order:
    ``out = sum_i e^(m_i - m*) acc_i / sum_i e^(m_i - m*) l_i`` with ``m*`` their
    largest ``m``, zeros where the sum of ``l`` is 0.  A span with no visible
    position gives ``m = -1e30``, ``l = 0``, ``acc = 0``.
    """
    B, Hq, _, hd = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = Hq // Hkv
    qg = q.float().reshape(B, Hkv, G, hd)
    vl = valid_len_vector(valid_len, B, q.device)[:, None, None, None]   # (B, 1, 1, 1)
    parts = []
    for start, stop in spans:
        pos = torch.arange(start, stop, device=q.device)
        s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache[:, :, start:stop].float()) * (hd ** -0.5)
        mask = pos < vl
        if window > 0:
            mask &= pos > vl - 1 - window
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m) * mask
        acc = torch.einsum("bhgk,bhkd->bhgd", p, v_cache[:, :, start:stop].float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    m_star = parts[0][0]
    for m, _, _ in parts[1:]:
        m_star = torch.maximum(m_star, m)
    l_tot = torch.zeros_like(m_star)
    acc_tot = torch.zeros((B, Hkv, G, hd), device=q.device)
    for m, l, acc in parts:
        w = torch.exp(m - m_star)
        l_tot = l_tot + w * l
        acc_tot = acc_tot + w * acc
    out = acc_tot / torch.where(l_tot == 0, 1.0, l_tot)
    return out.reshape(B, Hq, 1, hd).to(v_cache.dtype)


def mlstm_chunk_len(q, k, v, i_raw, log_f, chunk: int) -> int:
    """The chunk length ``L = min(chunk, S)``; raise unless q, k (B, H, S, dqk),
    v (B, H, S, dv) and i_raw, log_f (B, H, S) fit and L divides ``S``."""
    if q.ndim != 4 or v.ndim != 4:
        raise ValueError(f"mlstm_scan: q {tuple(q.shape)} and v {tuple(v.shape)}; expected "
                         "(B, H, S, dqk) and (B, H, S, dv)")
    B, H, S, _ = q.shape
    if k.shape != q.shape or v.shape[:3] != (B, H, S) or i_raw.shape != (B, H, S) \
            or log_f.shape != (B, H, S):
        raise ValueError(f"mlstm_scan: k {tuple(k.shape)}, v {tuple(v.shape)}, i_raw "
                         f"{tuple(i_raw.shape)}, log_f {tuple(log_f.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"mlstm_scan: sequence length {S} is not a multiple of the chunk {L}")
    return L


def _mlstm_gates(ii, ff, m_prev):
    """Gate algebra of one chunk, all (B, H, L) fp32 but ``decay``, ``m_next`` (B, H).

    ``b`` is the cumulative log forget gate within the chunk, ``m_t = b +
    max(m_prev, cummax(i - b))`` the stabilizer; ``inter`` weighs the carried
    state in row t, ``w`` row s of the chunk-end state update and ``decay``
    the carried state in that update.  With ``m_prev = -1e30`` (the first
    chunk) ``inter`` and ``decay`` are exactly 0.
    """
    b = torch.cumsum(ff, dim=-1)
    r = torch.cummax(ii - b, dim=-1).values
    m_t = b + torch.maximum(m_prev[..., None], r)
    inter = torch.exp(b + m_prev[..., None] - m_t)
    m_next = b[..., -1] + torch.maximum(m_prev, r[..., -1])
    w = torch.exp(b[..., -1:] - b + ii - m_next[..., None])
    decay = torch.exp(b[..., -1] + m_prev - m_next)
    return b, m_t, inter, w, decay, m_next


def _mlstm_scores(qs, kc, b, ii, m_t):
    """``(S, D)`` of one chunk: ``D_ts = exp(b_t - b_s + i_s - m_t)`` for s <= t,
    else 0 (the exponent is masked before ``exp``, so no inf meets a 0), and
    ``S = (qs k^T) * D``."""
    L = b.shape[-1]
    tri = torch.ones((L, L), dtype=torch.bool, device=b.device).tril()
    logD = b[..., :, None] - b[..., None, :] + ii[..., None, :] - m_t[..., :, None]
    D = torch.exp(logD.masked_fill(~tri, float("-inf")))
    return (qs @ kc.transpose(-1, -2)) * D, D


def _mlstm_sv(s, vc, bf16_products: bool):
    """``S v``; with ``bf16_products`` as the tensor-core route takes it, S split
    into its bf16 rounding and the bf16 rounding of the rest, two products."""
    if not bf16_products:
        return s @ vc
    hi = _bf16_round(s)
    return hi @ vc + _bf16_round(s - hi) @ vc


def _mlstm_inputs(q, k, v, i_raw, log_f, chunk):
    L = mlstm_chunk_len(q, k, v, i_raw, log_f, chunk)
    f32 = (q.float() * q.shape[-1] ** -0.5, k.float(), v.float(), i_raw.float(), log_f.float())
    return (*f32, L, q.shape[2] // L)


def mlstm_scan_ref(q, k, v, i_raw, log_f, *, chunk: int, bf16_products: bool = False):
    """Chunkwise stabilized mLSTM in the Pallas kernel's order (``mlstm_scan.py:34-68``).

    q, k: (B, H, S, dqk); v: (B, H, S, dv); i_raw, log_f: (B, H, S).  In fp32,
    with q scaled by ``dqk ** -0.5``; per chunk of ``L = min(chunk, S)`` steps
    ``num = S v + inter (q C)``, ``den = rowsum(S) + inter (q . n)`` and ``h =
    num / max(|den|, exp(-m_t))``, then the chunk-end update of (C, n, m) from
    C = 0, n = 0, m = -1e30.  Returns ``(h, C, n, m)``: h in v's dtype and the
    fp32 states at the START of each chunk, C (B, H, nc, dqk, dv), n (B, H, nc,
    dqk), m (B, H, nc), which the backward reads.  With ``bf16_products``,
    operands are rounded to bf16 where the tensor-core route rounds them: S
    as two bf16 parts before ``S v`` (one rounding loses too much where the
    causal sum cancels: h feeds dden, which 1 / g amplifies), the chunk-start
    C before ``q C`` (the route keeps it in bf16), and ``w o k`` before the
    state update; C is carried in fp32 and every sum stays fp32.
    """
    r = _bf16_round if bf16_products else (lambda t: t)
    qs, kf, vf, ii, ff, L, nc = _mlstm_inputs(q, k, v, i_raw, log_f, chunk)
    B, H, _, dqk = q.shape
    C = qs.new_zeros((B, H, dqk, vf.shape[-1]))
    n = qs.new_zeros((B, H, dqk))
    m = qs.new_full((B, H), _NEG_INF)
    hs, Cs, ns, ms = [], [], [], []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        Cs.append(C)
        ns.append(n)
        ms.append(m)
        qc, kc, vc, ic = qs[..., sl, :], kf[..., sl, :], vf[..., sl, :], ii[..., sl]
        b, m_t, inter, w, decay, m = _mlstm_gates(ic, ff[..., sl], m)
        s, _ = _mlstm_scores(qc, kc, b, ic, m_t)
        num = _mlstm_sv(s, vc, bf16_products) + inter[..., None] * (qc @ r(C))
        den = s.sum(-1) + inter * (qc @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        kw = kc * w[..., None]
        C = decay[..., None, None] * C + r(kw).transpose(-1, -2) @ vc
        n = decay[..., None] * n + kw.sum(-2)
    h = torch.cat(hs, dim=2).to(v.dtype)
    return h, torch.stack(Cs, 2), torch.stack(ns, 2), torch.stack(ms, 2)


def mlstm_scan_bwd_ref(q, k, v, i_raw, log_f, C, n, m, dh, *, chunk: int,
                       bf16_products: bool = False):
    """Gradients ``(dq, dk, dv, di, df)`` of :func:`mlstm_scan_ref`, each in its
    input's dtype, from the saved chunk-start states ``(C, n, m)``.

    The stabilizer drops out of h (``num`` and ``den`` both carry
    ``exp(-m_t)``), so every ``m`` is held constant: no derivative of cummax.
    In reverse over chunks, carrying dC (dqk, dv) and dn (dqk) of the
    chunk-end state, each chunk's forward is rebuilt in fp32 and
    ``dnum = dh / g`` with ``g = max(|den|, exp(-m_t))``, ``dden = -sign(den)
    rowsum(dh * h) / g`` where ``|den| > exp(-m_t)``, else 0; ``dS = dnum v^T +
    dden`` on s <= t; ``dP = dS * D`` feeds dq and dk, ``dlogD = dS * S`` feeds
    ``di_s`` (column sums) and ``db`` (row minus column sums); the ``inter``
    terms and the state update add to dq, dk, dv, ``db`` and the carried dC and
    dn; ``df`` is the reverse cumulative sum of ``db`` within the chunk, since
    ``b`` restarts each chunk.  Mirrors the CUDA-core kernels' factorisation.

    With ``bf16_products`` it takes the tensor-core route's factorisation and
    roundings (``csrc/mlstm_tc.cuh``): the forward's roundings (C from the
    flagged :func:`mlstm_scan_ref`, rounded as the route keeps it), h rounded
    to bf16 as the forward returned it (dden reads it), and ``1 / g`` carried
    on the rows of the products instead of dnum: ``scale dP`` and ``S / g``
    rounded before their products with k, q and dh, ``q o inter scale / g``
    before the carried ``dC += (.)^T dh``, and dC before its products with v
    and k; the row and column sums, ddecay and the carried dC and dn are fp32.
    """
    r = _bf16_round if bf16_products else (lambda t: t)
    qs, kf, vf, ii, ff, L, nc = _mlstm_inputs(q, k, v, i_raw, log_f, chunk)
    qf = q.float()
    dqk = q.shape[-1]
    scale = dqk ** -0.5
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dhf = dh.float()
    dCe = torch.zeros_like(C[:, :, 0])
    dne = torch.zeros_like(n[:, :, 0])
    out: list[list[torch.Tensor]] = [[] for _ in range(5)]
    for c in reversed(range(nc)):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, ic, dhc = qs[..., sl, :], kf[..., sl, :], vf[..., sl, :], ii[..., sl], \
            dhf[..., sl, :]
        Cc, ncur = r(C[:, :, c]), n[:, :, c]
        b, m_t, inter, w, decay, _ = _mlstm_gates(ic, ff[..., sl], m[:, :, c])
        s, D = _mlstm_scores(qc, kc, b, ic, m_t)
        qn = (qc @ ncur[..., None])[..., 0]
        num = _mlstm_sv(s, vc, bf16_products) + inter[..., None] * (qc @ Cc)
        den = s.sum(-1) + inter * qn
        floor = torch.exp(-m_t)
        g = torch.maximum(den.abs(), floor)
        h = r(num / g[..., None])
        dden = torch.where(den.abs() > floor, -torch.sign(den) * (dhc * h).sum(-1) / g, 0.0)
        if bf16_products:
            dS = torch.where(tri, (dhc @ vc.transpose(-1, -2)) / g[..., None] + dden[..., None],
                             0.0)
            dlogD, dP = dS * s, dS * D
            dPs, Sg = r(scale * dP), r(s / g[..., None])
            Gh = dhc @ Cc.transpose(-1, -2)                  # (L, dqk): C dh_t
            fq = scale * inter / g
            dq = dPs @ kc + fq[..., None] * Gh \
                + (scale * inter * dden)[..., None] * ncur[..., None, :]
            dlog_inter = inter * ((qc * Gh).sum(-1) / g + dden * qn)
            dCr = r(dCe)
            Hk = vc @ dCr.transpose(-1, -2) + dne[..., None, :]   # (L, dqk): dC v_s + dn
            dk = dPs.transpose(-1, -2) @ qf[..., sl, :] + w[..., None] * Hk
            dlogw = w * (kc * Hk).sum(-1)
            dv = Sg.transpose(-1, -2) @ dhc + w[..., None] * (kc @ dCr)
            dC_add = r(qf[..., sl, :] * fq[..., None]).transpose(-1, -2) @ dhc
        else:
            dnum = dhc / g[..., None]
            dS = torch.where(tri, dnum @ vc.transpose(-1, -2) + dden[..., None], 0.0)
            dlogD, dP = dS * s, dS * D
            G = dnum @ Cc.transpose(-1, -2)                  # (L, dqk): C dnum_t
            Hk = vc @ dCe.transpose(-1, -2)                  # (L, dqk): dC v_s
            dq = (dP @ kc + inter[..., None] * G
                  + (inter * dden)[..., None] * ncur[..., None, :]) * scale
            dlog_inter = inter * ((qc * G).sum(-1) + dden * qn)
            dk = dP.transpose(-1, -2) @ qc + w[..., None] * Hk + w[..., None] * dne[..., None, :]
            dlogw = w * ((kc * Hk).sum(-1) + (kc @ dne[..., None])[..., 0])
            dv = s.transpose(-1, -2) @ dnum + w[..., None] * (kc @ dCe)
            dC_add = (qc * inter[..., None]).transpose(-1, -2) @ dnum
        ddecay = (dCe * Cc).sum((-1, -2)) + (dne * ncur).sum(-1)
        col = dlogD.sum(-2)
        db = dlogD.sum(-1) - col + dlog_inter - dlogw
        db[..., -1] += dlogw.sum(-1) + ddecay * decay
        df = db.flip(-1).cumsum(-1).flip(-1)
        for acc, t in zip(out, (dq, dk, dv, col + dlogw, df)):
            acc.append(t)
        dCe = decay[..., None, None] * dCe + dC_add
        dne = decay[..., None] * dne + ((inter * dden)[..., None] * qc).sum(-2)
    grads = [torch.cat(acc[::-1], dim=2) for acc in out]
    return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v, i_raw, log_f)))


def ssd_chunk_len(lf, b, x, c, chunk: int) -> int:
    """The chunk length ``L = min(chunk, S)``; raise unless lf (B, S, H), b, c
    (B, S, H, N) and x (B, S, H, chd) fit and L divides ``S``."""
    if lf.ndim != 3 or b.ndim != 4 or x.ndim != 4:
        raise ValueError(f"ssd_scan: lf {tuple(lf.shape)}, b {tuple(b.shape)}, x "
                         f"{tuple(x.shape)}; expected (B, S, H), (B, S, H, N), (B, S, H, chd)")
    B, S, H = lf.shape
    if b.shape[:3] != (B, S, H) or c.shape != b.shape or x.shape[:3] != (B, S, H):
        raise ValueError(f"ssd_scan: b {tuple(b.shape)}, x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)} do not fit lf {tuple(lf.shape)}")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"ssd_scan: sequence length {S} is not a multiple of the chunk {L}")
    return L


def _ssd_inputs(lf, b, x, c, chunk):
    """fp32 (B, nc, L, H, ...) chunks of each input, and the inclusive ``cum`` of
    lf within each chunk, (B, nc, L, H)."""
    L = ssd_chunk_len(lf, b, x, c, chunk)
    B, S = lf.shape[:2]
    lff, bf, xf, cf = (t.float().reshape(B, S // L, L, *t.shape[2:]) for t in (lf, b, x, c))
    return lff, bf, xf, cf, torch.cumsum(lff, dim=2)


def _ssd_decay(cum):
    """``D[t, s] = exp(cum_t - cum_s)`` for s <= t, else 0: (B, nc, L, L, H).  The
    exponent is masked before ``exp``: above the diagonal it is a sum of -lf
    over up to L - 1 steps, which overflows fp32 once it passes about 88.7."""
    L = cum.shape[2]
    tri = torch.ones((L, L), dtype=torch.bool, device=cum.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    return torch.exp(diff.masked_fill(~tri[None, None, :, :, None], float("-inf")))


def ssd_scan_ref(lf, b, x, c, *, chunk: int, bf16_products: bool = False):
    """Mamba-2 SSD chunked scan in the Pallas kernel's arithmetic (``ssd_scan.py:34-58``).

    lf: (B, S, H) per-step log-decay; b, c: (B, S, H, N); x: (B, S, H, chd);
    ``S`` a multiple of ``L = min(chunk, S)``.  In fp32, per chunk with ``cum``
    the inclusive sum of lf within it: ``y_t = sum_{s<=t} (c_t . b_s)
    exp(cum_t - cum_s) x_s + exp(cum_t) h c_t`` and ``h <- exp(cum_L) h +
    sum_s exp(cum_L - cum_s) x_s b_s^T`` from h = 0.  Returns ``(y, h_last,
    states)``: y in x's dtype, h_last (B, H, chd, N) and the states at the
    START of each chunk (B, H, nc, chd, N), both fp32; the backward reads the
    states.  With ``bf16_products``, operands are rounded to bf16 where the
    tensor-core route rounds them: the decayed Gram before its product with
    x (as the Pallas kernel rounds it to x's dtype), ``exp(cum_L - cum_s)
    b_s`` before the chunk's own state, and the chunk-start state before
    its read-out through c; every sum stays fp32.
    """
    r = _bf16_round if bf16_products else (lambda t: t)
    _, bf, xf, cf, cum = _ssd_inputs(lf, b, x, c, chunk)
    B, nc, L, H, chd = xf.shape
    y = torch.einsum("bklsh,bkshd->bklhd",
                     r(torch.einsum("bklhn,bkshn->bklsh", cf, bf) * _ssd_decay(cum)), xf)
    w = torch.exp(cum[:, :, -1:] - cum)
    own = torch.einsum("bkshd,bkshn->bkhdn", xf, r(bf * w[..., None]))
    decay = torch.exp(cum[:, :, -1])
    h = xf.new_zeros((B, H, chd, b.shape[-1]))
    states = []
    for k in range(nc):
        states.append(h)
        h = decay[:, k, :, None, None] * h + own[:, k]
    states = torch.stack(states, 2)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bklhn,bhkdn->bklhd", cf, r(states))
    return y.reshape(x.shape).to(x.dtype), h, states


def ssd_scan_bwd_ref(lf, b, x, c, states, dy, *, chunk: int, bf16_products: bool = False):
    """Gradients ``(dlf, db, dx, dc)`` of :func:`ssd_scan_ref`'s y, each in its
    input's dtype, from the saved chunk-start states (h_last is not
    differentiated).

    Per chunk, with ``G = (c_t . b_s) D[t, s]``, ``A = D[t, s] (dy_t . x_s)``,
    ``w_s = exp(cum_L - cum_s)``, h the state at the chunk's start and dH the
    gradient of the state at its end (carried over the chunks in reverse:
    ``dH <- exp(cum_L) dH + sum_t exp(cum_t) dy_t c_t^T``, 0 after the last):
    ``dx_s = sum_t G dy_t + w_s dH b_s``, ``db_s = sum_t A c_t + w_s dH^T
    x_s``, ``dc_t = sum_s A b_s + exp(cum_t) h^T dy_t``; ``dcum_t = c_t .
    dc_t - b_t . db_t`` plus, at the chunk's last step, ``sum_s b_s . (w_s
    dH^T x_s) + exp(cum_L) sum(dH * h)``, and ``dlf`` is the reverse
    cumulative sum of dcum within the chunk.  Mirrors the CUDA kernels'
    factorisation.  With ``bf16_products``, operands are rounded to bf16
    where the tensor-core route rounds them: ``exp(cum_t) c_t`` before the
    chunk's own dH term, G and A before their products, and h and dH before
    their products with dy, x and b; dcum and the last step's terms take the
    fp32 sums.
    """
    r = _bf16_round if bf16_products else (lambda t: t)
    _, bf, xf, cf, cum = _ssd_inputs(lf, b, x, c, chunk)
    B, nc, L, H, chd = xf.shape
    dyf = dy.float().reshape(xf.shape)
    D = _ssd_decay(cum)
    G = r(torch.einsum("bkthn,bkshn->bktsh", cf, bf) * D)
    A = r(torch.einsum("bkthd,bkshd->bktsh", dyf, xf) * D)
    w = torch.exp(cum[:, :, -1:] - cum)
    et = torch.exp(cum)
    decay = torch.exp(cum[:, :, -1])
    own = torch.einsum("bkthd,bkthn->bkhdn", dyf, r(cf * et[..., None]))
    g = xf.new_zeros((B, H, chd, b.shape[-1]))
    dH = []
    for k in reversed(range(nc)):
        dH.append(g)
        g = decay[:, k, :, None, None] * g + own[:, k]
    dH = torch.stack(dH[::-1], 1)
    hs = states.transpose(1, 2)
    dHr, hsr = r(dH), r(hs)
    dx = torch.einsum("bktsh,bkthd->bkshd", G, dyf) \
        + w[..., None] * torch.einsum("bkhdn,bkshn->bkshd", dHr, bf)
    db_state = w[..., None] * torch.einsum("bkhdn,bkshd->bkshn", dHr, xf)
    db = torch.einsum("bktsh,bkthn->bkshn", A, cf) + db_state
    dc = torch.einsum("bktsh,bkshn->bkthn", A, bf) \
        + et[..., None] * torch.einsum("bkhdn,bkthd->bkthn", hsr, dyf)
    dcum = (cf * dc).sum(-1) - (bf * db).sum(-1)
    dcum[:, :, -1] += (bf * db_state).sum((2, -1)) + decay * (dH * hs).sum((-1, -2))
    dlf = dcum.flip(2).cumsum(2).flip(2)
    return tuple(g.reshape(t.shape).to(t.dtype) for g, t in zip((dlf, db, dx, dc), (lf, b, x, c)))
