"""Kernel dispatch on the tensor's device, forward and backward.

A CUDA tensor launches the hand-written kernel (or the launch raises); a CPU
tensor takes the kernel's plain PyTorch version in ``ref``; a meta tensor
takes the card's path, every line of the wrapper but the launch (its checks,
route and allocations: the dry-run's memory is the card's), and never the
plain version.  Nothing else decides, and no failure falls back to the
other path.  Each public function and each backward is one kernel call to
the step counter (:func:`repro_torch.roofline.count.kernel`), priced by
:mod:`.cost` from the shapes alone, whatever the device.  ``rmsnorm``,
``swiglu_mlp``, ``flash_attention``, ``mlstm_scan`` and ``ssd_scan`` are
``torch.autograd.Function``s whose backward dispatches the same way, so on
the CPU autograd runs the same backward formulas that the card's backward
kernels are held to.  When no
input needs a gradient (``torch.no_grad``, as in serving) they skip the
Function and call the forward dispatch directly, which spares its host time
on the host-bound decode step (``chip_smoke.py`` times both at the serving
shape).
"""

from __future__ import annotations

import torch

from ..roofline import count as _count
from . import cost as _cost
from . import decode_attention as _decode_attention
from . import flash_attention as _flash_attention
from . import flash_attention_bwd as _flash_attention_bwd
from . import mlstm_scan as _mlstm_scan
from . import mlstm_scan_bwd as _mlstm_scan_bwd
from . import ref
from . import rmsnorm as _rmsnorm
from . import rmsnorm_bwd as _rmsnorm_bwd
from . import ssd_scan as _ssd_scan
from . import ssd_scan_bwd as _ssd_scan_bwd
from . import swiglu as _swiglu
from . import swiglu_bwd as _swiglu_bwd


def _on_cuda(x: torch.Tensor, op: str) -> bool:
    """Whether ``x`` takes the card's path: True on a CUDA tensor (the kernel
    launches) and on a meta tensor (everything but the launch), False on a
    CPU tensor (the plain version); any other device raises."""
    if x.device.type in ("cuda", "meta"):
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {x.device}")


# ---------------------------------------------------------------- costs
def _rows(x) -> int:
    return x.numel() // max(1, x.shape[-1])


def _rmsnorm_cost(x, fn=_cost.rmsnorm_cost):
    return lambda: fn(_rows(x), x.shape[-1], dtype_bytes=x.element_size())


def _swiglu_cost(x, w_gate, fn=_cost.swiglu_cost):
    return lambda: fn(_rows(x), x.shape[-1], w_gate.shape[-1], dtype_bytes=x.element_size())


def _flash_cost(q, k, v, causal, window, fn=_cost.flash_attention_cost):
    B, Hq, Sq, hd = q.shape
    return lambda: fn(B, Hq, Sq, k.shape[2], hd, causal=causal, window=window,
                      head_dim_v=v.shape[-1], dtype_bytes=q.element_size())


def _mlstm_cost(q, v, chunk, fn=_cost.mlstm_scan_cost):
    B, H, S, dqk = q.shape
    return lambda: fn(B, H, S, dqk, v.shape[-1], chunk=chunk, dtype_bytes=v.element_size())


def _ssd_cost(b, x, chunk, fn=_cost.ssd_scan_cost):
    B, S, H, chd = x.shape
    return lambda: fn(B, H, S, chd, b.shape[-1], chunk=chunk, dtype_bytes=x.element_size())


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rmsnorm_fwd(x, gamma, eps):
    if _on_cuda(x, "rmsnorm"):
        return _rmsnorm.rmsnorm_cuda(x, gamma, eps)
    return ref.rmsnorm_ref(x, gamma, eps)


def _swiglu_fwd(x, w_gate, w_up, w_down):
    if _on_cuda(x, "swiglu_mlp"):
        return _swiglu.swiglu_cuda(x, w_gate, w_up, w_down)
    return ref.swiglu_ref(x, w_gate, w_up, w_down)


def _flash_fwd(q, k, v, mask):
    if _on_cuda(q, "flash_attention"):
        return _flash_attention.flash_attention_cuda(q, k, v, **mask)
    return ref.flash_attention_ref(q, k, v, **mask)


def _mlstm_fwd(q, k, v, i_raw, log_f, chunk):
    """``(h, saved)``: the kernel's :class:`MLSTMTcSaved` or :class:`MLSTMSaved`
    on the card, the plain version's chunk-start states ``[C, n, m]`` on the
    CPU."""
    if _on_cuda(q, "mlstm_scan"):
        return _mlstm_scan.mlstm_scan_cuda(q, k, v, i_raw, log_f, chunk=chunk)
    h, *states = ref.mlstm_scan_ref(q, k, v, i_raw, log_f, chunk=chunk)
    return h, states


def _ssd_fwd(lf, b, x, c, chunk):
    """``(y, h_last, saved)``: the kernel's :class:`SSDSaved` on the card, the
    plain version's chunk-start states on the CPU."""
    if _on_cuda(x, "ssd_scan"):
        return _ssd_scan.ssd_scan_cuda(lf, b, x, c, chunk=chunk)
    y, h_last, states = ref.ssd_scan_ref(lf, b, x, c, chunk=chunk)
    return y, h_last, (states,)


def _rmsnorm_bwd_call(x, gamma, dy, eps):
    if _on_cuda(x, "rmsnorm_bwd"):
        return _rmsnorm_bwd.rmsnorm_bwd_cuda(x, gamma, dy, eps)
    return ref.rmsnorm_bwd_ref(x, gamma, dy, eps)


class RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        x, gamma = x.contiguous(), gamma.contiguous()
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _rmsnorm_fwd(x, gamma, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        return (*_count.kernel("rmsnorm_bwd", _rmsnorm_cost(x, _cost.rmsnorm_bwd_cost),
                               _rmsnorm_bwd_call, x, gamma, dy, ctx.eps), None)


class SwiGLU(torch.autograd.Function):
    """The forward saves ``a = x @ Wg`` and ``b = x @ Wu`` beside x, as XLA's
    autodiff of ``layers.swiglu`` does; on the card only its tensor-core routes
    write them (None from ``"simt"``, whose backward computes them again)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        x = x.contiguous()
        if _on_cuda(x, "swiglu_mlp"):
            out, a, b = _swiglu.swiglu_cuda(x, w_gate, w_up, w_down, save_ab=True)
        else:
            out, a, b = ref.swiglu_fwd_ref(x, w_gate, w_up, w_down)
        ctx.save_for_backward(x, w_gate, w_up, w_down, a, b)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w_gate, w_up, w_down, a, b = ctx.saved_tensors
        return _count.kernel("swiglu_bwd", _swiglu_cost(x, w_gate, _cost.swiglu_bwd_cost),
                             _swiglu_bwd_call, x, w_gate, w_up, w_down, dy, a, b)


def _swiglu_bwd_call(x, w_gate, w_up, w_down, dy, a, b):
    if _on_cuda(x, "swiglu_mlp_bwd"):
        return _swiglu_bwd.swiglu_bwd_cuda(x, w_gate, w_up, w_down, dy, a, b)
    return ref.swiglu_bwd_saved_ref(x, w_gate, w_up, w_down, a, b, dy)


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        mask = dict(causal=causal, window=window, q_offset=q_offset)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _flash_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        m = ctx.mask
        grads = _count.kernel("flash_attention_bwd",
                              _flash_cost(q, k, v, m["causal"], m["window"],
                                          _cost.flash_attention_bwd_cost),
                              _flash_bwd_call, q, k, v, out, lse, dout, m)
        return (*grads, None, None, None)


def _flash_bwd_call(q, k, v, out, lse, dout, mask):
    if _on_cuda(q, "flash_attention_bwd"):
        return _flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **mask)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **mask)


class MLSTMScan(torch.autograd.Function):
    """On the tensor-core route the saved tensors include the output h (the
    backward reads it) and the inputs as the model's views, so nothing is
    copied to be kept."""

    @staticmethod
    def forward(ctx, q, k, v, i_raw, log_f, chunk):
        out, saved = _mlstm_fwd(q, k, v, i_raw, log_f, chunk)
        ctx.save_for_backward(q, k, v, i_raw, log_f, *saved)
        ctx.chunk = chunk
        ctx.saved_type = type(saved)
        return out

    @staticmethod
    def backward(ctx, dh):
        tensors = ctx.saved_tensors      # once: a checkpoint unpacks each tensor once
        inputs, saved = tensors[:5], tensors[5:]
        grads = _count.kernel("mlstm_scan_bwd",
                              _mlstm_cost(inputs[0], inputs[2], ctx.chunk,
                                          _cost.mlstm_scan_bwd_cost),
                              _mlstm_bwd_call, inputs, saved, ctx, dh)
        return (*grads, None)


def _mlstm_bwd_call(inputs, saved, ctx, dh):
    if _on_cuda(dh, "mlstm_scan_bwd"):
        return _mlstm_scan_bwd.mlstm_scan_bwd_cuda(*inputs, ctx.saved_type(*saved), dh,
                                                   chunk=ctx.chunk)
    return ref.mlstm_scan_bwd_ref(*inputs, *saved, dh, chunk=ctx.chunk)


class SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lf, b, x, c, chunk):
        y, h_last, saved = _ssd_fwd(lf, b, x, c, chunk)
        ctx.save_for_backward(lf, b, x, c, *saved)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(h_last)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, _dh_last):
        tensors = ctx.saved_tensors      # once: a checkpoint unpacks each tensor once
        inputs, saved = tensors[:4], tensors[4:]
        grads = _count.kernel("ssd_scan_bwd",
                              _ssd_cost(inputs[1], inputs[2], ctx.chunk, _cost.ssd_scan_bwd_cost),
                              _ssd_bwd_call, inputs, saved, dy, ctx.chunk)
        return (*grads, None)


def _ssd_bwd_call(inputs, saved, dy, chunk):
    if _on_cuda(dy, "ssd_scan_bwd"):
        return _ssd_scan_bwd.ssd_scan_bwd_cuda(*inputs, _ssd_scan.SSDSaved(*saved), dy,
                                               chunk=chunk)
    return ref.ssd_scan_bwd_ref(*inputs, *saved, dy, chunk=chunk)


def _rmsnorm_call(x, gamma, eps):
    if _needs_grad(x, gamma):
        return RMSNorm.apply(x, gamma, eps)
    return _rmsnorm_fwd(x, gamma, eps)


def rmsnorm(x, gamma, *, eps: float = 1e-5):
    if _count.ACTIVE is not None:
        return _count.kernel("rmsnorm", _rmsnorm_cost(x), _rmsnorm_call, x, gamma, eps)
    return _rmsnorm_call(x, gamma, eps)


def _swiglu_call(x, w_gate, w_up, w_down):
    if _needs_grad(x, w_gate, w_up, w_down):
        return SwiGLU.apply(x, w_gate, w_up, w_down)
    return _swiglu_fwd(x, w_gate, w_up, w_down)


def swiglu_mlp(x, w_gate, w_up, w_down):
    if _count.ACTIVE is not None:
        return _count.kernel("swiglu", _swiglu_cost(x, w_gate), _swiglu_call, x, w_gate, w_up,
                             w_down)
    return _swiglu_call(x, w_gate, w_up, w_down)


def _flash(q, k, v, causal, window, q_offset):
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _flash_fwd(q, k, v, dict(causal=causal, window=window, q_offset=q_offset))[0]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """q: (B, Hq, Sq, hd); k: (B, Hkv, Skv, hd); v: (B, Hkv, Skv, hdv) -> (B, Hq,
    Sq, hdv).  The card's kernels take hdv <= hd <= 192 (MLA's 192 / 128 on
    the tensor cores in bf16) and raise on anything else; the plain version
    takes any hdv."""
    if _count.ACTIVE is not None:
        return _count.kernel("flash_attention", _flash_cost(q, k, v, causal, window), _flash,
                             q, k, v, causal, window, q_offset)
    return _flash(q, k, v, causal, window, q_offset)


def _decode(q, k_cache, v_cache, valid_len, window):
    if _on_cuda(q, "decode_attention"):
        return _decode_attention.decode_attention_cuda(q, k_cache, v_cache, valid_len,
                                                       window=window)
    return ref.decode_attention_ref(q, k_cache, v_cache, valid_len, window=window)


def decode_attention(q, k_cache, v_cache, valid_len, *, window: int = 0):
    """One query row a head against a KV cache; priced over the whole cache
    (or the window) by the step counter, which does not read ``valid_len``."""
    if _count.ACTIVE is not None:
        B, Hq, _, hd = q.shape
        _, Hkv, S, _ = k_cache.shape
        return _count.kernel(
            "decode_attention",
            lambda: _cost.decode_attention_cost(B, Hq, Hkv, S, hd, window=window,
                                                dtype_bytes=q.element_size()),
            _decode, q, k_cache, v_cache, valid_len, window)
    return _decode(q, k_cache, v_cache, valid_len, window)


def _decode_partial(q, k_cache, v_cache, valid_len, window):
    if _on_cuda(q, "decode_attention"):
        return _decode_attention.decode_attention_partial_cuda(q, k_cache, v_cache, valid_len,
                                                               window=window)
    return ref.decode_attention_partial_ref(q, k_cache, v_cache, valid_len, window=window)


def decode_attention_partial(q, k_cache, v_cache, valid_len, *, window: int = 0):
    """The decode kernel's partial mode over one rank's cut of a cache: ``(out
    (B, Hq, 1, hd) fp32 normalised by this cut's denominator, lse (B, Hq)
    fp32)``, ``-inf`` and zeros where nothing is visible.  Priced by the step
    counter as :func:`decode_attention` (the same kernel)."""
    if _count.ACTIVE is not None:
        B, Hq, _, hd = q.shape
        _, Hkv, S, _ = k_cache.shape
        return _count.kernel(
            "decode_attention",
            lambda: _cost.decode_attention_cost(B, Hq, Hkv, S, hd, window=window,
                                                dtype_bytes=q.element_size()),
            _decode_partial, q, k_cache, v_cache, valid_len, window)
    return _decode_partial(q, k_cache, v_cache, valid_len, window)


def mlstm_scan(q, k, v, i_raw, log_f, *, chunk: int = 128):
    """Chunked mLSTM: q, k (B, H, S, dqk); v (B, H, S, dv); i_raw, log_f (B, H,
    S) -> h (B, H, S, dv) in v's dtype.  ``S`` must be a multiple of
    ``min(chunk, S)``: the kernel's wrapper or the plain version checks.  On
    the card, inputs that the tensor-core route reads as they lie (the
    model's transposed projections) are not copied, and h is then a view of
    a (B, S, H, dv) tensor; anything else is made contiguous first."""
    if _count.ACTIVE is not None:
        return _count.kernel("mlstm_scan", _mlstm_cost(q, v, chunk), _mlstm, q, k, v, i_raw,
                             log_f, chunk)
    return _mlstm(q, k, v, i_raw, log_f, chunk)


def _mlstm(q, k, v, i_raw, log_f, chunk):
    if _on_cuda(q, "mlstm_scan"):
        q, k, v, i_raw, log_f = _mlstm_scan.readable(q, k, v, i_raw, log_f, chunk)
    else:
        q, k, v, i_raw, log_f = (t.contiguous() for t in (q, k, v, i_raw, log_f))
    if _needs_grad(q, k, v, i_raw, log_f):
        return MLSTMScan.apply(q, k, v, i_raw, log_f, chunk)
    return _mlstm_fwd(q, k, v, i_raw, log_f, chunk)[0]


def ssd_scan(lf, b, x, c, *, chunk: int = 128):
    """Mamba-2 SSD chunked scan: lf (B, S, H) fp32 log-decay; b, c (B, S, H, N);
    x (B, S, H, chd) -> ``(y, h_last)``: y (B, S, H, chd) in x's dtype and the
    fp32 final state (B, H, chd, N), which carries no gradient.  ``S`` must be
    a multiple of ``min(chunk, S)``: the kernel's wrapper or the plain version
    checks; ``models.hymba.ssd_scan`` pads to whole chunks."""
    if _count.ACTIVE is not None:
        return _count.kernel("ssd_scan", _ssd_cost(b, x, chunk), _ssd, lf, b, x, c, chunk)
    return _ssd(lf, b, x, c, chunk)


def _ssd(lf, b, x, c, chunk):
    lf, b, x, c = (t.contiguous() for t in (lf, b, x, c))
    if _needs_grad(lf, b, x, c):
        return SSDScan.apply(lf, b, x, c, chunk)
    return _ssd_fwd(lf, b, x, c, chunk)[:2]
