"""Shared model primitives: norms, RoPE, sinusoidal positions, blockwise and
decode attention, the decode cache's slot rule, MLPs, routed experts, causal
depthwise convolution, and :class:`ModelAxis`, the pieces of the ``model``
axis that ``DecoderLM``, ``Hymba``, ``EncDecLM`` and ``XLSTM`` share.

``rms_norm``, ``blockwise_attention``, ``decode_attention`` and ``swiglu`` go
through :mod:`repro_torch.kernels.ops`: the hand-written kernels on the
card, their plain versions on the CPU, forward and backward.  Their rounding
follows the kernels, which differ from the JAX package's XLA layers in these
places (bf16 only; identical in fp32 up to the order of sums):

* ``rms_norm`` multiplies by gamma in fp32 and casts once; the JAX layer
  casts first and multiplies in the input dtype;
* ``decode_attention`` and ``blockwise_attention`` scale the scores in fp32
  after the dot; the JAX layers scale q in the input dtype before it, and
  ``blockwise_attention`` also casts p to v's dtype before ``p @ v``.

``layer_norm`` and ``gelu_mlp`` (Whisper's) have no Pallas body in the JAX
package (XLA fuses them) and are plain PyTorch here, in the JAX layers'
order of rounding.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel import (TP, all_reduce_sum, copy_to_region, gather_from_region,
                        reduce_from_region, regroup_columns, scatter_to_region, tp_mesh,
                        tp_size)
from . import params as PM
from .params import P


def rms_norm(x, gamma, eps: float = 1e-5):
    return ops.rmsnorm(x, gamma, eps=eps)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """The JAX ``layer_norm``'s order: fp32 mean and variance, the normalised
    value cast to x's dtype, then ``* gamma + beta`` in that dtype
    (``F.layer_norm`` with a weight would round once less in bf16)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * gamma + beta


@functools.lru_cache(maxsize=8)
def _sinusoid_table(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    div = np.exp(np.arange(0, d, 2) / d * -math.log(10000.0))
    table = np.zeros((seq, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    table.flags.writeable = False
    return table


def sinusoidal_positions(seq: int, d: int, device="cpu") -> torch.Tensor:
    """Whisper's encoder positions: the JAX layer's float64 numpy table, cast
    to fp32, as a (seq, d) tensor on ``device``."""
    return torch.tensor(_sinusoid_table(seq, d), device=device)


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


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Online-softmax attention.  q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd[v]).

    Queries sit at ``q_offset + arange(Sq)``.  The JAX layer's tiling knobs
    (``q_block``, ``kv_block``, ``pairs``, ``mask_mode``) shape XLA's loops and
    do not change the result; the flash kernel picks its own tiles and walks
    only the causal / window band.
    """
    return ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, valid_len, *, window: int = 0):
    """Single-position attention against a cache.

    q: (B, Hq, 1, hd); caches: (B, Hkv, S, hd); ``valid_len``: scalar or (B,)
    number of valid cache positions (the new token lives at valid_len - 1).
    """
    return ops.decode_attention(q, k_cache, v_cache, valid_len, window=window)


def cache_slot(index: int, S_cache: int, window: int) -> tuple[int, int]:
    """(the slot the token at ``index`` is written to, the slots visible to it).

    With a window the cache is a ring buffer of ``S_cache`` slots: slot
    ``index % S_cache``, all slots visible once warm (the rule of the JAX
    models, ``hymba.py`` ``_decode_block``).  Without one, ``index`` past the
    cache's end raises ``IndexError``, where JAX's ``dynamic_update_slice``
    clamps it to the last slot.
    """
    if window:
        return index % S_cache, min(index + 1, S_cache)
    if index < S_cache:
        return index, index + 1
    raise IndexError(f"decode index {index} past the cache length {S_cache}")


class ShardSlot(NamedTuple):
    """:func:`cache_shard_slot`'s answer for a cache cut on its slots over ``tp`` ranks."""

    owner: int              # the rank whose cut holds the token's slot
    local: int              # that slot in the owner's cut
    counts: tuple           # each rank's visible slots of its own cut, rank by rank


def cache_shard_slot(index: int, S_cache: int, window: int, tp: int) -> ShardSlot:
    """:func:`cache_slot` for a cache of ``S_cache`` slots cut into ``tp`` equal
    parts, rank ``i`` holding slots ``[i S/tp, (i + 1) S/tp)`` (JAX's cache
    specs over the ``model`` axis).

    The visible slots are always a prefix of the whole cache (a ring fills
    slots 0, 1, ... before it wraps), so rank ``i`` sees
    ``clamp(n_valid - i S/tp, 0, S/tp)`` of its own; once a ring is warm
    every slot of every rank is visible, and the writing rank moves with
    ``index % S_cache``.  ``S_cache`` not a multiple of ``tp`` raises
    ``ValueError`` (JAX's ``NamedSharding`` cannot cut it either); an index
    past a cache without a window raises ``IndexError``.
    """
    if S_cache % tp:
        raise ValueError(f"a cache of {S_cache} slots does not cut into {tp} equal parts "
                         "over the model axis")
    slot, n_valid = cache_slot(index, S_cache, window)
    per = S_cache // tp
    counts = tuple(min(max(n_valid - i * per, 0), per) for i in range(tp))
    return ShardSlot(slot // per, slot % per, counts)


def swiglu(x, w_gate, w_up, w_down):
    return ops.swiglu_mlp(x, w_gate, w_up, w_down)


def gelu_mlp(x, w_in, b_in, w_out, b_out, mesh=None):
    """Whisper's MLP: the tanh GELU, as ``jax.nn.gelu(approximate=True)``.
    Over the ``model`` axis of ``mesh`` (``parallel.tp_mesh``): ``w_in`` and
    ``b_in`` this rank's columns, ``w_out`` its rows, the partial output
    reduced before ``b_out`` is added once."""
    y = F.gelu(copy_to_region(x, mesh) @ w_in + b_in, approximate="tanh") @ w_out
    return reduce_from_region(y, mesh) + b_out


class MoERoute(NamedTuple):
    """The routing decisions of :func:`moe_route` for N tokens, E experts, top k."""

    probs: torch.Tensor     # (N, E) fp32 softmax of the fp32 router logits
    gates: torch.Tensor     # (N, k) fp32 top-k probabilities, renormalised to sum 1
    idx: torch.Tensor       # (N, k) int64 experts, the larger probability first
    slot: torch.Tensor      # (N, k) int64 place in the expert's queue; C - 1 where dropped
    keep: torch.Tensor      # (N, k) bool: the pair fits the expert's capacity C
    capacity: int           # C
    #: (N, k) int64 with data axes: the global slot at which this rank's
    #: pairs of the pair's expert start (None without)
    offset: Optional[torch.Tensor] = None


def moe_route(x, router_w, *, top_k: int, capacity_factor: float,
              choice: Optional[torch.Tensor] = None, mesh=None, data_axes=()) -> MoERoute:
    """Top-k routing with capacity, the JAX ``moe_block``'s order of arithmetic.

    The router runs in fp32; softmax, then the top k, renormalised by their
    sum (at least 1e-9).  Among equal probabilities the lower expert comes
    first, as ``lax.top_k`` orders them (``torch.topk`` promises no order): a
    stable sort on the probabilities, descending.  Each (token, k) pair takes
    the next slot of its expert's queue in token-major order; pairs past the
    capacity ``C = ceil(N k / E * capacity_factor)`` are dropped and point at
    slot ``C - 1``.  ``choice`` ((N, k) experts) replays a choice made
    elsewhere, such as on another device at a near-tie: the gates are then
    this call's probabilities of those experts, renormalised the same way.

    With ``data_axes`` (axes of ``mesh``), x holds this rank's rows of a
    global batch cut into equal parts over those axes, in the order of their
    coordinates, and the routing is the global batch's, as JAX computes it
    on the whole batch: N is the global count in ``C``, and a pair's slot is
    its place in the global token-major queue, behind the pairs of the lower
    ranks (an exclusive prefix of the ranks' per-expert counts, gathered).
    """
    N = x.shape[0]
    E = router_w.shape[-1]
    n_global = N * mesh.axis_size(data_axes) if data_axes else N
    C = max(1, int(math.ceil(n_global * top_k / E * capacity_factor)))
    logits = x.float() @ router_w.float()                                 # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top, idx = probs.sort(dim=-1, descending=True, stable=True)
    gates, idx = top[:, :top_k], idx[:, :top_k]
    if choice is not None:
        idx = choice.to(device=probs.device, dtype=idx.dtype)
        gates = probs.gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # position of each (token, k) inside its expert's capacity queue
    flat = torch.zeros((N * top_k, E), dtype=torch.int64, device=x.device)
    flat.scatter_(1, idx.reshape(-1, 1), 1)
    pos = flat.cumsum(0) - flat
    offset = None
    if data_axes:
        lower = mesh.all_gather(flat.sum(0), data_axes)[:mesh.index_in(data_axes)]
        start = torch.stack(lower).sum(0) if lower else torch.zeros_like(flat[0])
        pos = pos + start
        offset = start[idx]
    slot = (pos * flat).sum(-1).view(N, top_k)
    keep = slot < C
    slot = torch.where(keep, slot, C - 1)
    return MoERoute(probs, gates, idx, slot, keep, C, offset)


def moe_block(x, router_w, w_gate, w_up, w_down, *, top_k: int,
              capacity_factor: float = 1.25, shared: Optional[tuple] = None, mesh=None,
              data_axes=()):
    """Top-k routed experts with capacity, gather/scatter dispatch: ``(y, aux)``.

    x: (N, D); expert weights (E, D, F) / (E, F, D); ``shared`` = (w_gate,
    w_up, w_down) of the always-on experts, which go through :func:`swiglu`
    (the kernel).  As in JAX, every expert's (C, D) buffer is computed, empty
    ones included.  ``aux`` is the Switch-style load-balancing loss.

    The buffers are filled by an index add that gives the same bits on every
    run: each kept slot receives exactly one nonzero source, and a dropped
    pair adds a zeroed source into its expert's slot ``C - 1``, so the order
    of the adds does not matter.

    Over a ``mesh`` of one rank's coordinates whose ``model`` axis is above 1
    (``parallel.tp_size``), the expert weights are this rank's shards over
    it: its own E/tp experts (``_expert_specs``' expert parallelism; the
    other experts' pairs add zeroed sources into a local slot, as a dropped
    pair does) or a slice of every expert's F.  The
    routing is the same on every rank of the group; x and the gates enter the
    experts through ``copy_to_region``, and the routed and shared partial
    outputs leave in one ``reduce_from_region``.  With ``data_axes`` the
    routing is the global batch's (:func:`moe_route`) and so is ``aux``: the
    product of the global means of the probabilities (summed over the ranks
    by ``all_reduce_sum``) and of the pair counts.  A rank computes only its
    own rows' pairs, in buffers of ``min(C, N)`` rows an expert (its pairs of
    one expert sit in consecutive global slots from ``offset``).
    """
    N, D = x.shape
    E = router_w.shape[-1]
    r = moe_route(x, router_w, top_k=top_k, capacity_factor=capacity_factor, mesh=mesh,
                  data_axes=data_axes)
    C, slot = r.capacity, r.slot
    if data_axes:
        # this rank's kept pairs of an expert hold the global slots from
        # r.offset on, fewer than its rows and than C: its buffers hold them
        C = min(C, N)
        slot = torch.where(r.keep, r.slot - r.offset, C - 1)
    tp = tp_mesh(mesh)
    xe, gates, idx, keep = copy_to_region(x, tp), copy_to_region(r.gates, tp), r.idx, r.keep
    E_local = w_gate.shape[0]
    if E_local < E:                                   # this rank's experts alone
        e0 = mesh.index_in("model") * E_local
        keep = keep & (idx >= e0) & (idx < e0 + E_local)
        idx = (idx - e0).clamp(0, E_local - 1)
    rows = (idx * C + slot).reshape(-1)                                  # (N k,) into (E C)
    keep_f = keep.reshape(-1)
    src = (xe[:, None] * keep[..., None].to(x.dtype)).reshape(N * top_k, D)   # each token k times
    buf = xe.new_zeros((E_local * C, D)).index_add(0, rows, src).view(E_local, C, D)
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    y_e = torch.bmm(h, w_down).view(E_local * C, D)
    gathered = y_e[rows] * (gates.reshape(-1) * keep_f).to(x.dtype)[:, None]
    y = gathered.view(N, top_k, D).sum(1)
    if shared is not None:
        y = y + swiglu(xe, *shared)
    y = reduce_from_region(y, tp)
    counts = torch.zeros_like(r.probs).scatter_(1, r.idx, 1.0)           # (N, E)
    if data_axes:
        n = N * mesh.axis_size(data_axes)
        me = all_reduce_sum(r.probs.sum(0), mesh, data_axes) / n
        ce = mesh.all_reduce(counts.sum(0), data_axes) / n / top_k
        aux = E * (me * ce).sum()
    else:
        aux = E * (r.probs.mean(0) * (counts.mean(0) / top_k)).sum()
    return y, aux


def causal_conv(x, w):
    """Causal depthwise conv along time as W shifted products, the JAX models'
    form (``F.conv1d`` would be a cuDNN kernel).  x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    return sum(pad[:, i:i + S] * w[i] for i in range(W))


# ------------------------------------------------------------ the model axis
def vocab_specs(vocab: int, d_model: int, model_axis: int) -> tuple[tuple, tuple]:
    """(embedding spec, unembedding spec): cut on vocab where it divides the
    axis, else on d_model where that does, else replicated (JAX's rule)."""
    if vocab % model_axis == 0:
        return P(TP, None), P(None, TP)
    if d_model % model_axis == 0:
        return P(None, TP), P(TP, None)
    return P(None, None), P(None, None)


class ModelAxis:
    """The ``model`` axis as the port's model classes execute it: a mixin of
    ``DecoderLM``, ``Hymba``, ``EncDecLM`` and ``XLSTM``, which set ``cfg``,
    ``mesh``, ``device`` and ``dtype`` and call :meth:`_init_model_axis`.

    Built over a mesh of one rank's coordinates whose ``model`` axis is above
    1 (``parallel.tp_size``), the parameters are this rank's shards
    (:meth:`init_params`), and the pieces below run Megatron's regions; with
    no such axis every region is the identity.  Heads: a projection cut into
    whole heads a rank gives this rank's heads; one cut inside a head is
    gathered over the axis and the heads a rank's queries need are taken (a
    gather whose backward sums the ranks' partial gradients); with the queries
    cut inside a head every rank computes every head and keeps its slice of
    the output for the row-parallel ``wo``.  Vocab (:func:`vocab_specs`): a
    vocab-parallel embedding (rows outside the shard masked, then summed),
    local-vocab logits and a vocab-parallel cross-entropy (the max over the
    axis, then the sum of exponentials and the gold logit summed over it, in
    fp32) where the vocab divides; the embedding's columns gathered and a
    row-parallel unembedding whose logits are summed where only ``d_model``
    does; replicated otherwise.
    """

    def _init_model_axis(self, mesh) -> None:
        cfg = self.cfg
        self.tp = tp_size(mesh)
        #: the mesh the regions run over: None without a ``model`` axis above 1,
        #: where every region is the identity
        self.tp_mesh = tp_mesh(mesh)
        self.tp_rank = mesh.coords[TP] if self.tp > 1 else 0
        self._row_axes: tuple = ()
        emb_spec = vocab_specs(cfg.vocab, cfg.d_model, self.tp)[0]
        self._vocab_cut = (None if self.tp == 1 else "vocab" if emb_spec == P(TP, None) else
                           "d_model" if emb_spec == P(None, TP) else None)

    @contextlib.contextmanager
    def rows_split(self, axes):
        """Within: the rows are one rank's equal part of a batch cut over the
        mesh's ``axes`` (the experts route the global batch)."""
        prev, self._row_axes = self._row_axes, tuple(axes)
        try:
            yield
        finally:
            self._row_axes = prev

    def _check_tp(self) -> None:
        if self.tp > 1 and self.model_axis != self.tp:
            raise ValueError(f"{self.cfg.arch}: built for a model axis of {self.model_axis}, "
                             f"run over one of {self.tp}")

    def init_params(self, generator: torch.Generator) -> dict:
        """The full tree by the JAX package's rules; over a ``model`` axis, this
        rank's shards of it (every rank draws the same tree)."""
        layout = self.layout()
        full = PM.init_params(layout, generator, device=self.device, dtype=self.dtype)
        return PM.shard_params(full, layout, self.mesh) if self.tp > 1 else full

    def _zero_cache(self, layout) -> dict:
        """A zero cache of ``layout``; over a ``model`` axis, this rank's shard
        of it (``params.cache_shards``)."""
        if self.tp > 1:
            layout = PM.cache_shards(layout, self.mesh)
        return PM.zeros_cache(layout, device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------- heads
    def _head_span(self, n_heads: int) -> tuple[int, int, bool]:
        """``(lo, hi, local)``: the query heads this rank computes, and whether
        they are its own columns (whole heads a rank) or every head."""
        if n_heads % self.tp == 0:
            per = n_heads // self.tp
            return self.tp_rank * per, (self.tp_rank + 1) * per, True
        return 0, n_heads, False

    def _heads(self, t, n_heads: int, width: int, local: bool, pick):
        """(B, S, h, width): this rank's columns ``t`` of an (n_heads x width)
        projection as its heads, or with ``local`` False the projection
        gathered over the axis and the heads ``pick`` (a slice or an index
        list) taken."""
        B, S, _ = t.shape
        if local:
            return t.view(B, S, -1, width)
        full = gather_from_region(t, self.tp_mesh, -1, partial=True).view(B, S, n_heads, width)
        if isinstance(pick, slice):
            return full[:, :, pick].contiguous()
        return full.index_select(2, torch.tensor(pick, device=t.device))

    def _kv_pick(self, lo: int, hi: int, q_local: bool) -> tuple[bool, Any]:
        """``(local, pick)`` of the kv heads that queries ``lo:hi`` read: this
        rank's own columns where both head counts divide the axis, else the
        heads of a gathered projection (a slice where the groups stay
        uniform, one kv head a query otherwise)."""
        H, Hkv = self.cfg.n_heads, self.cfg.n_kv_heads
        if q_local and Hkv % self.tp == 0:
            return True, None
        G = H // Hkv
        k0, k1 = lo // G, (hi - 1) // G + 1
        want = [(lo + i) // G - k0 for i in range(hi - lo)]
        nq, nk = hi - lo, k1 - k0
        if nq % nk == 0 and want == [i // (nq // nk) for i in range(nq)]:
            return False, slice(k0, k1)
        return False, [(lo + i) // G for i in range(nq)]

    def _gather_columns(self, *parts, dim: int = -1):
        """Each of ``parts`` (one shape but the last dimension) with every rank's
        part of it concatenated along ``dim`` in rank order, in one all-gather
        of the parts side by side."""
        widths = [t.shape[-1] for t in parts]
        ranks = self.tp_mesh.all_gather(torch.cat(parts, -1), TP)
        out, start = [], 0
        for w in widths:
            out.append(torch.cat([r[..., start:start + w] for r in ranks], dim))
            start += w
        return out

    def _gather_whole(self, *parts) -> list:
        """Each ``(shard, dim)`` of ``parts`` whole: every rank's shard
        concatenated along ``dim`` in rank order, all of them in one
        all-gather of the shards flattened side by side.  Backward, this
        rank's part of each gradient, with no sum: every rank computes the
        same from the whole tensors (or, for a norm's gamma, uses only its
        own columns of the result)."""
        flat = gather_from_region(torch.cat([t.reshape(-1) for t, _ in parts]), self.tp_mesh, 0)
        flat = flat.view(self.tp, -1)
        out, start = [], 0
        for t, dim in parts:
            n, dim = t.numel(), dim % t.dim()
            piece = flat[:, start:start + n].reshape(self.tp, *t.shape).movedim(0, dim)
            out.append(piece.reshape(*t.shape[:dim], -1, *t.shape[dim + 1:]))
            start += n
        return out

    def _split_halves(self, up, width: int):
        """(x, z) of an in-projection ``up`` whose ``2 width`` columns the
        axis cuts (``P(None, TP)``): the ``chunk(2)`` of the whole row would
        leave x on the low ranks and z on the high ones, so the ranks'
        products are exchanged (``regroup_columns``: one all-gather, its
        backward another) and each holds its contiguous ``width/tp`` columns
        of both."""
        if self.tp == 1:
            return up.chunk(2, dim=-1)
        c = width // self.tp
        picks = [[slice(r * c, (r + 1) * c), slice(width + r * c, width + (r + 1) * c)]
                 for r in range(self.tp)]
        return regroup_columns(up, self.tp_mesh, picks).chunk(2, dim=-1)

    def _own_columns(self, t, cols: int):
        """This rank's ``cols`` columns of a whole row ``t`` (its part of a
        ``P(TP)`` cut)."""
        return t[..., self.tp_rank * cols:(self.tp_rank + 1) * cols]

    def _attn_out(self, p, x, out, local: bool):
        """x plus ``wo`` of the attention output (B, S, heads x v width):
        row-parallel, summed over the axis; with every head computed, this
        rank's slice of the output first."""
        if not local:
            out = self._own_columns(out, p["wo"].shape[0])
        return x + reduce_from_region(out @ p["wo"], self.tp_mesh)

    # ------------------------------------------------------------- vocab
    def _head_weight(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def embed(self, params, tokens):
        if self._vocab_cut == "vocab":
            rows = params["embed"].shape[0]
            local = tokens - self.tp_rank * rows
            mine = (local >= 0) & (local < rows)
            e = params["embed"][local.clamp(0, rows - 1)].to(self.dtype)
            return reduce_from_region(torch.where(mine[..., None], e, 0), self.tp_mesh)
        if self._vocab_cut == "d_model":
            return gather_from_region(params["embed"][tokens].to(self.dtype), self.tp_mesh, -1)
        return params["embed"][tokens].to(self.dtype)

    def unembed(self, params, h):
        return h @ self._head_weight(params)

    def _nll(self, params, h, labels):
        """The mean next-token cross-entropy of the final hidden states ``h``
        against ``labels`` (int64), the logits cast to fp32 before the
        log-sum-exp, as in JAX: vocab-parallel, ``d_model``-cut or whole."""
        if self._vocab_cut == "vocab":
            return self._vocab_parallel_nll(params, h, labels)
        if self._vocab_cut == "d_model":
            h_part = scatter_to_region(h, self.tp_mesh, -1)
            logits = reduce_from_region(h_part @ self._head_weight(params), self.tp_mesh).float()
        else:
            logits = self.unembed(params, h).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (lse - gold).mean()

    def _vocab_parallel_nll(self, params, h, labels):
        """The mean cross-entropy of this rank's vocab columns' fp32 logits:
        the max over the axis, the sum of exponentials and the gold logit
        (on the one rank whose columns hold it) summed over it."""
        mesh = self.tp_mesh
        logits = (copy_to_region(h, mesh) @ self._head_weight(params)).float()   # (B, S, V/tp)
        cols = logits.shape[-1]
        top = mesh.all_reduce(logits.detach().amax(-1), TP, op="max")
        lse = top + torch.log(reduce_from_region(torch.exp(logits - top[..., None]).sum(-1),
                                                 mesh))
        local = labels - self.tp_rank * cols
        mine = (local >= 0) & (local < cols)
        gold = torch.gather(logits, -1, local.clamp(0, cols - 1)[..., None])[..., 0]
        gold = reduce_from_region(torch.where(mine, gold, 0.0), mesh)
        return (lse - gold).mean()

    def _serve_logits(self, params, h):
        """The whole fp32 logits of ``h`` on every rank: a vocab cut's local
        columns gathered, a ``d_model`` cut's row-parallel products summed."""
        if self._vocab_cut == "vocab":
            local = h @ self._head_weight(params)
            return torch.cat(self.tp_mesh.all_gather(local, TP), -1).float()
        if self._vocab_cut == "d_model":
            h_part = scatter_to_region(h, self.tp_mesh, -1)
            return reduce_from_region(h_part @ self._head_weight(params), self.tp_mesh).float()
        return self.unembed(params, h).float()
