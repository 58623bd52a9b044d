"""The port's kernels on the CPU: each plain version against the JAX package.

Inputs are drawn with numpy from a seed and fed to both sides.  Each plain
version (what a kernel wrapper runs for a CPU tensor) is held against
``repro.kernels.ref`` and against the Pallas kernel run with
``interpret=True``, at the tolerances of ``tests/test_kernels.py``.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers' argument checks, the dispatch and the build's C interface are
checked as far as the CPU reaches.
"""

import itertools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro.kernels.flash_attention import flash_attention as pallas_flash_attention
from repro.kernels.mlstm_scan import mlstm_scan as pallas_mlstm_scan
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.ssd_scan import ssd_scan_kernel as pallas_ssd_scan
from repro.kernels.swiglu import swiglu_mlp as pallas_swiglu
from repro.models import layers as jlayers
from repro.models.hymba import ssd_scan as jssd_scan
from repro.models.xlstm import mlstm_chunked
from repro_torch.kernels import build, ops, ref
from repro_torch.models import hymba as port_hymba
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import flash_attention as k_flash
from repro_torch.kernels import flash_attention_bwd as k_flash_bwd
from repro_torch.kernels import mlstm_scan as k_mlstm
from repro_torch.kernels import mlstm_scan_bwd as k_mlstm_bwd
from repro_torch.kernels import rmsnorm as k_rmsnorm
from repro_torch.kernels import rmsnorm_bwd as k_rmsnorm_bwd
from repro_torch.kernels import ssd_scan as k_ssd
from repro_torch.kernels import ssd_scan_bwd as k_ssd_bwd
from repro_torch.kernels import swiglu as k_swiglu
from repro_torch.kernels import swiglu_bwd as k_swiglu_bwd

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _close(got, want, dtype, *, swiglu=False):
    if dtype == "bfloat16":
        tol = 5e-2 if swiglu else 2e-2
    else:
        tol = 1e-4 if swiglu else 2e-5
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,D", [(8, 128), (100, 96)])
def test_rmsnorm_plain_matches_jax(dtype, rows, D):
    rng = np.random.default_rng(rows * D)
    x, jx = _pair(rng, (rows, D), dtype)
    g, jg = _pair(rng, (D,), dtype)
    got = ops.rmsnorm(x, g, eps=1e-5)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, jref.rmsnorm_ref(jx, jg), dtype)
    _close(got, pallas_rmsnorm(jx, jg, block_rows=64, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,F", [(8, 64, 128), (20, 96, 224)])
def test_swiglu_plain_matches_jax(dtype, N, D, F):
    rng = np.random.default_rng(N + D + F)
    x, jx = _pair(rng, (N, D), dtype, 0.5)
    wg, jwg = _pair(rng, (D, F), dtype, 0.1)
    wu, jwu = _pair(rng, (D, F), dtype, 0.1)
    wd, jwd = _pair(rng, (F, D), dtype, 0.1)
    got = ops.swiglu_mlp(x, wg, wu, wd)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, jref.swiglu_ref(jx, jwg, jwu, jwd), dtype, swiglu=True)
    pallas = pallas_swiglu(jx, jwg, jwu, jwd, block_m=32, block_f=64, interpret=True)
    _close(got, pallas, dtype, swiglu=True)


def _decode_inputs(dtype, G, seed, B=2):
    Hkv, S, hd = 2, 128, 32
    rng = np.random.default_rng(seed)
    q, jq = _pair(rng, (B, Hkv * G, 1, hd), dtype)
    k, jk = _pair(rng, (B, Hkv, S, hd), dtype)
    v, jv = _pair(rng, (B, Hkv, S, hd), dtype)
    return (q, k, v), (jq, jk, jv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 64])
def test_decode_attention_plain_scalar_valid(dtype, G, window):
    """Scalar valid_len: against the Pallas kernel, and the oracle without a window."""
    (q, k, v), (jq, jk, jv) = _decode_inputs(dtype, G, seed=G + window)
    valid = 100
    got = ops.decode_attention(q, k, v, valid, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = pallas_decode_attention(jq, jk, jv, valid, window=window, block_k=64,
                                     interpret=True)
    _close(got, pallas, dtype)
    if window == 0:
        _close(got, jref.decode_attention_ref(jq, jk, jv, valid), dtype)
    else:
        _close(got, jlayers.decode_attention(jq, jk, jv, valid, window=window), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 64])
def test_decode_attention_plain_vector_valid(dtype, G, window):
    """(B,) valid_len: against the JAX layer, and row by row against Pallas.
    The last row's valid_len runs past the cache, which anchors the window
    past its end."""
    (q, k, v), (jq, jk, jv) = _decode_inputs(dtype, G, seed=10 + G + window, B=3)
    valid = np.array([1, 77, 128 + 40], np.int32)
    got = ops.decode_attention(q, k, v, torch.from_numpy(valid), window=window)
    _close(got, jlayers.decode_attention(jq, jk, jv, jnp.asarray(valid), window=window), dtype)
    for b, vb in enumerate(valid):
        row = pallas_decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], int(vb),
                                      window=window, block_k=64, interpret=True)
        _close(got[b:b + 1], row, dtype)


def test_decode_attention_no_visible_position_gives_zeros():
    """valid_len 0 takes the l == 0 guard, as the kernels do."""
    (q, k, v), _ = _decode_inputs("float32", 2, seed=3)
    out = ops.decode_attention(q, k, v, 0)
    assert torch.count_nonzero(out) == 0


#: (G, spans, hd, dtype, windowed): every G of the port's callers and beyond,
#: 1, 2, 3 and 7 spans, each hd with each dtype, windows with each dtype
DECODE_SPLIT_CASES = [
    (G, n, (32, 64, 128)[i % 3], ("float32", "bfloat16")[(i // 3) % 2], i % 2 == 1)
    for i, (G, n) in enumerate(itertools.product((1, 2, 4, 5, 8, 16), (1, 2, 3, 7)))
]


@pytest.mark.parametrize("G,n_split,hd,dtype,windowed", DECODE_SPLIT_CASES,
                         ids=lambda v: str(v))
def test_decode_split_ref_matches_jax(G, n_split, hd, dtype, windowed):
    """The split plain version over spans of 24 positions against the Pallas
    kernel with ``block_k`` = the span (row by row: it takes a scalar
    valid_len), the JAX layer with (B,) valid lengths and the unsplit plain
    version.  Valid lengths 0 (zeros: the l == 0 guard), 40 past the cache and
    a random one; the window (1.5 spans and 41) crosses span edges and leaves
    the row past the cache positions to see."""
    B, Hkv, span = 3, 2, 24
    S = n_split * span
    rng = np.random.default_rng(100 * G + 10 * n_split + hd)
    q, jq = _pair(rng, (B, Hkv * G, 1, hd), dtype)
    k, jk = _pair(rng, (B, Hkv, S, hd), dtype)
    v, jv = _pair(rng, (B, Hkv, S, hd), dtype)
    valid = np.array([0, S + 40, rng.integers(1, S + 1)], np.int32)
    window = span + span // 2 + 41 if windowed else 0
    spans = tuple((i * span, (i + 1) * span) for i in range(n_split))
    got = ref.decode_attention_split_ref(q, k, v, torch.from_numpy(valid), window=window,
                                         spans=spans)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.count_nonzero(got[0]) == 0
    _close(got[1:], jlayers.decode_attention(jq[1:], jk[1:], jv[1:], jnp.asarray(valid[1:]),
                                             window=window), dtype)
    for b in (1, 2):
        row = pallas_decode_attention(jq[b:b + 1], jk[b:b + 1], jv[b:b + 1], int(valid[b]),
                                      window=window, block_k=span, interpret=True)
        _close(got[b:b + 1], row, dtype)
    whole = ref.decode_attention_ref(q, k, v, torch.from_numpy(valid), window=window)
    _close(got, whole.float().numpy(), dtype)


@pytest.mark.parametrize("window", [0, 150])
def test_decode_split_plan_is_right_at_every_fill_level(window):
    """One plan, made from the shapes, serves every valid_len: the split plain
    version over its spans (four, the last one short) equals the unsplit one
    at fill levels from 0 to 40 past the cache."""
    B, Hkv, S, hd, G = 2, 2, 600, 128, 2
    plan = k_decode.plan_splits(B, Hkv, S, hd, G)
    assert plan.n_split == 4 and plan.spans[-1][1] - plan.spans[-1][0] < plan.span
    rng = np.random.default_rng(window)
    q, _ = _pair(rng, (B, Hkv * G, 1, hd), "float32")
    k, _ = _pair(rng, (B, Hkv, S, hd), "float32")
    v, _ = _pair(rng, (B, Hkv, S, hd), "float32")
    for n in range(0, S + 41, 37):
        valid = torch.tensor([n, S - n // 2], dtype=torch.int32)
        got = ref.decode_attention_split_ref(q, k, v, valid, window=window, spans=plan.spans)
        _close(got, ref.decode_attention_ref(q, k, v, valid, window=window).numpy(), "float32")


@pytest.mark.parametrize("B,Hkv,S,hd,G", [
    (8, 16, 168, 64, 1), (1, 16, 32768, 64, 1), (8, 16, 4096, 64, 1), (8, 8, 4096, 128, 4),
    (2, 5, 2176, 64, 5), (2, 2, 3000, 128, 16), (3, 2, 600, 128, 2), (1, 1, 1, 8, 1),
    (1, 1, 0, 64, 1),
])
def test_plan_splits_covers_the_cache_once(B, Hkv, S, hd, G):
    plan = k_decode.plan_splits(B, Hkv, S, hd, G)
    assert [p for a, b in plan.spans for p in range(a, b)] == list(range(S))
    assert plan.span % k_decode.SPAN_GRANULE == 0 and len(plan.spans) == plan.n_split
    assert all(b > a for a, b in plan.spans) or S == 0


def test_plan_splits_at_the_serving_and_long_shapes():
    """One span at serving's 168 slots; at the long caches, at least two blocks
    on each of the 132 SMs, and spans of at least 256 positions at hd 64."""
    assert k_decode.plan_splits(8, 16, 168, 64).n_split == 1
    for B, Hkv, S, hd, G in ((1, 16, 32768, 64, 1), (8, 16, 4096, 64, 1), (8, 8, 4096, 128, 4)):
        plan = k_decode.plan_splits(B, Hkv, S, hd, G, n_sm=132)
        assert plan.n_split > 1 and B * Hkv * plan.n_split >= 2 * 132
        assert plan.span >= k_decode.MIN_SPAN_ELEMS // hd
    assert k_decode.plan_splits(1, 16, 32768, 64) == (17, 1984, 32768)


@pytest.mark.parametrize("dtype,hd,G,bad,want", [
    ("bfloat16", 64, 1, None, "split"),     # qwen1.5-0.5b serving
    ("bfloat16", 128, 4, None, "split"),    # qwen3-4b
    ("bfloat16", 64, 5, None, "split"),     # hymba-1.5b
    ("float32", 128, 16, None, "split"),
    ("bfloat16", 8, 2, None, "split"),
    ("float32", 40, 1, None, "split"),
    ("bfloat16", 36, 1, None, "simt"),      # hd not a multiple of 8
    ("float32", 100, 2, None, "simt"),
    ("bfloat16", 64, 1, "k", "simt"),       # the cache 2 bytes off a 16-byte line
    ("bfloat16", 64, 1, "q", "simt"),
])
def test_decode_route(dtype, hd, G, bad, want):
    """The route follows from the dtype, hd and the pointers' alignment."""
    tdt = DTYPES[dtype][0]
    shapes = {"q": (2, 2 * G, 1, hd), "k": (2, 2, 50, hd), "v": (2, 2, 50, hd)}
    args = {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}
    k_decode.check_args(*args.values())
    assert k_decode.route(*args.values()) == want
    assert want in k_decode.ROUTES and set(k_decode.route_launches) == set(k_decode.ROUTES)


def test_decode_wrapper_host_path(monkeypatch):
    """The lean host path, with the device check passed over and the library
    and launch recorded (there is no card): one ``build.launch`` a call with
    as many arguments as the C entry point takes; the split plan comes from
    the shapes, the same at every valid_len; an int32 (B,) valid_len on the
    device is passed as it is, an int made into one; scratch only with more
    than one span; each call counted once, by route."""
    monkeypatch.setattr(k_decode, "_checked", {})
    monkeypatch.setattr(k_decode, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    calls, made = [], []
    monkeypatch.setattr(build, "launch", lambda name, device, *a: calls.append((name, a)))
    monkeypatch.setattr(k_decode, "valid_len_vector",
                        lambda *a: made.append(a) or ref.valid_len_vector(*a))
    before = (k_decode.launches, dict(k_decode.route_launches))
    for B, Hkv, S, hd, n_split in ((8, 16, 168, 64, 1), (1, 16, 4096, 64, 16),
                                   (2, 2, 50, 36, None)):
        q = torch.empty((B, Hkv, 1, hd), dtype=torch.bfloat16)
        k, v = (torch.empty((B, Hkv, S, hd), dtype=torch.bfloat16) for _ in range(2))
        for n in (S, 0, S + 40):
            valid = torch.full((B,), n, dtype=torch.int32)
            calls.clear()
            k_decode.decode_attention_cuda(q, k, v, valid)
            (fn, a), = calls
            sig = build.SIGNATURES["rt_decode_attention" if n_split is None
                                   else "rt_decode_attention_split"]
            assert len(a) + 1 == len(sig) and a[3] == valid.data_ptr()
            if n_split is None:
                assert fn == "rt_decode_attention"
            else:
                assert fn == "rt_decode_attention_split"
                assert a[12:14] == (n_split, k_decode.plan_splits(B, Hkv, S, hd).span)
                assert (a[5] is None) == (n_split == 1)
    assert made == []
    k_decode.decode_attention_cuda(q, k, v, 7)
    assert len(made) == 1 and calls[-1][1][3] != valid.data_ptr()
    assert k_decode.launches == before[0] + 10
    assert k_decode.route_launches == {"split": before[1]["split"] + 6,
                                       "simt": before[1]["simt"] + 4}


@pytest.mark.parametrize("case", ["group", "head_dim", "float16", "mixed", "k_strided",
                                  "cached_then_strided"])
def test_decode_lean_wrapper_refuses_what_check_args_refuses(monkeypatch, case):
    """The (shape, dtype, device) key is checked once and contiguity on every
    call: each argument ``check_args`` refuses is still refused, a refused key
    is not remembered, and nothing is counted."""
    monkeypatch.setattr(k_decode, "_checked", {})
    monkeypatch.setattr(k_decode, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    f32 = torch.ones
    q, kv = f32(2, 4, 1, 64), f32(2, 2, 10, 64)
    args, err = {
        "group": ((f32(2, 64, 1, 64), f32(2, 2, 10, 64), f32(2, 2, 10, 64)), ValueError),
        "head_dim": ((f32(2, 2, 1, 256), f32(2, 2, 10, 256), f32(2, 2, 10, 256)), ValueError),
        "float16": ((q.half(), kv.half(), kv.half()), TypeError),
        "mixed": ((q, kv.bfloat16(), kv), TypeError),
        "k_strided": ((q, f32(2, 2, 64, 10).transpose(2, 3), kv), ValueError),
        "cached_then_strided": ((q, f32(2, 2, 64, 10).transpose(2, 3), kv), ValueError),
    }[case]
    if case == "cached_then_strided":       # the key was seen, contiguous, before
        build.checked_once(k_decode._checked, (q.shape, kv.shape, kv.shape, q.dtype, kv.dtype,
                                               kv.dtype, q.device, kv.device, kv.device),
                           k_decode._check_key, q, kv, kv)
    before = (k_decode.launches, dict(k_decode.route_launches), len(k_decode._checked))
    with pytest.raises(err):
        k_decode.decode_attention_cuda(*args, 3)
    assert (k_decode.launches, dict(k_decode.route_launches),
            len(k_decode._checked)) == before


def test_valid_len_vector_forms():
    assert ref.valid_len_vector(5, 3, "cpu").tolist() == [5, 5, 5]
    assert ref.valid_len_vector(torch.tensor(4), 2, "cpu").dtype == torch.int32
    assert ref.valid_len_vector(torch.tensor([1, 2]), 2, "cpu").tolist() == [1, 2]
    with pytest.raises(ValueError):
        ref.valid_len_vector(torch.tensor([1, 2, 3]), 2, "cpu")


class _Elsewhere:
    """A tensor's stand-in on a device with no kernel (this build of torch has
    none but the CPU and meta; meta takes the card's path short of the launch)."""

    device = torch.device("xpu")
    requires_grad = False

    def __init__(self, *shape):
        self.shape = shape

    def contiguous(self):
        return self


def test_ops_refuse_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        ops.rmsnorm(_Elsewhere(2, 8), _Elsewhere(8))


@pytest.mark.parametrize("fn", [k_rmsnorm.rmsnorm_cuda, k_swiglu.swiglu_cuda,
                                k_decode.decode_attention_cuda])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    """A wrapper launches on CUDA tensors only; it never falls back."""
    args = {
        k_rmsnorm.rmsnorm_cuda: (torch.ones(2, 8), torch.ones(8)),
        k_swiglu.swiglu_cuda: (torch.ones(2, 8), torch.ones(8, 4), torch.ones(8, 4),
                               torch.ones(4, 8)),
        k_decode.decode_attention_cuda: (torch.ones(1, 2, 1, 8), torch.ones(1, 2, 4, 8),
                                         torch.ones(1, 2, 4, 8), 3),
    }[fn]
    before = (k_rmsnorm.launches, k_swiglu.launches, k_decode.launches,
              dict(k_decode.route_launches))
    with pytest.raises(ValueError, match="expected one GPU"):
        fn(*args)
    assert (k_rmsnorm.launches, k_swiglu.launches, k_decode.launches,
            dict(k_decode.route_launches)) == before


def test_wrapper_argument_checks():
    f32 = torch.ones
    k_rmsnorm.check_args(f32(4, 8), f32(8))
    with pytest.raises(ValueError):
        k_rmsnorm.check_args(f32(4, 8), f32(7))
    with pytest.raises(TypeError):
        k_rmsnorm.check_args(f32(4, 8, dtype=torch.float16), f32(8, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        k_rmsnorm.check_args(f32(8, 4).T, f32(8))
    k_swiglu.check_args(f32(3, 8), f32(8, 16), f32(8, 16), f32(16, 8))
    with pytest.raises(ValueError):
        k_swiglu.check_args(f32(3, 8), f32(8, 16), f32(8, 16), f32(8, 16))
    with pytest.raises(TypeError):
        k_swiglu.check_args(f32(3, 8), f32(8, 16, dtype=torch.bfloat16), f32(8, 16),
                            f32(16, 8))
    k_decode.check_args(f32(2, 4, 1, 64), f32(2, 2, 10, 64), f32(2, 2, 10, 64))
    with pytest.raises(ValueError):
        k_decode.check_args(f32(2, 3, 1, 64), f32(2, 2, 10, 64), f32(2, 2, 10, 64))
    with pytest.raises(ValueError):
        k_decode.check_args(f32(2, 2, 1, 256), f32(2, 2, 10, 256), f32(2, 2, 10, 256))
    with pytest.raises(ValueError):
        k_decode.check_args(f32(2, 64, 1, 64), f32(2, 2, 10, 64), f32(2, 2, 10, 64))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(tmp_path / "kernels")


def test_c_entry_points_match_their_ctypes_signatures():
    """Each declared entry point exists once as extern "C" with as many arguments."""
    text = "\n".join((build.CSRC / s).read_text() for s in build.SOURCES)
    for name, argtypes in build.SIGNATURES.items():
        found = re.findall(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert len(found) == 1, name
        assert len(found[0].split(",")) == len(argtypes), name


def test_source_digest_tracks_the_sources(monkeypatch, tmp_path):
    for s in build.SOURCES + ("common.cuh",):
        (tmp_path / s).write_text((build.CSRC / s).read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    a = build.source_digest()
    (tmp_path / "rmsnorm.cu").write_text((tmp_path / "rmsnorm.cu").read_text() + "\n// edit\n")
    assert build.source_digest() != a


def _bf16_unaligned(*shape):
    """A contiguous bf16 tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=torch.bfloat16)
    off = (-base.data_ptr() // 2) % 8 + 1      # elements to the next boundary, plus one
    return base[off:off + n].view(shape)


@pytest.mark.parametrize("dtype,rows,D,F,bad,want", [
    ("bfloat16", 4096, 1024, 2816, None, "wgmma"),         # qwen training rows
    ("bfloat16", 4352, 1600, 5504, None, "wgmma"),         # Hymba's: D is 12.5 tiles
    ("bfloat16", 64, 96, 224, None, "wgmma"),              # the first 128-row-tile count
    ("bfloat16", 63, 96, 224, None, "wgmma_split_k"),
    ("bfloat16", 8, 1024, 2816, None, "wgmma_split_k"),    # serving's decode rows
    ("bfloat16", 333, 100, 256, None, "simt"),             # D not a multiple of 8
    ("bfloat16", 8, 96, 260, None, "simt"),                # F not a multiple of 8
    ("bfloat16", 4096, 1024, 2816, "x", "simt"),           # x 2 bytes off a 16-byte line
    ("bfloat16", 8, 1024, 2816, "w_down", "simt"),
    ("float32", 4096, 1024, 2816, None, "simt"),
    ("float32", 8, 1024, 2816, None, "simt"),
])
def test_swiglu_route(dtype, rows, D, F, bad, want):
    """The route follows from the dtype, the shape and the pointers' alignment."""
    tdt = DTYPES[dtype][0]
    shapes = {"x": (rows, D), "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}
    args = {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}
    k_swiglu.check_args(*args.values())
    assert k_swiglu.route(*args.values()) == want
    assert want in k_swiglu.ROUTES and set(k_swiglu.route_launches) == set(k_swiglu.ROUTES)


def test_swiglu_route_counts_rows_over_leading_axes():
    x = torch.empty((2, 40, 96), dtype=torch.bfloat16)          # 80 rows
    w, wd = torch.empty((96, 224), dtype=torch.bfloat16), torch.empty((224, 96),
                                                                      dtype=torch.bfloat16)
    assert k_swiglu.route(x, w, w, wd) == "wgmma"
    assert k_swiglu.route(x[:1, :30], w, w, wd) == "wgmma_split_k"


@pytest.mark.parametrize("N,D,F,want", [
    (8, 1024, 2816, (6, 33)),      # serving: 22 gated and 4 down column tiles on 132 SMs
    (8, 1600, 5504, (4, 19)),      # Hymba's widths
    (20, 96, 224, (2, 4)),         # capped by the contraction's 64-deep steps
    (8, 64, 20000, (1, 132)),      # 157 gated column tiles fill the card alone
])
def test_swiglu_split_k(N, D, F, want):
    """Split-K gives each product about one block per SM, never more blocks
    along the contraction than it has 64-deep steps."""
    sg, sd = k_swiglu.split_k(N, D, F, 132)
    assert (sg, sd) == want
    for split, cols, tile, depth in ((sg, F, 128, D), (sd, D, 256, F)):
        assert 1 <= split <= -(-depth // 64)
        assert split == -(-depth // 64) or split * -(-cols // tile) >= 132


# ------------------------------------------------------------ training kernels
#: (B, Hq, Hkv, Sq, Skv, hd, causal, window, block_q, block_k): tests/test_kernels.py:32-36
FLASH_SWEEP = [
    (1, 2, 2, 128, 128, 32, True, 0, 64, 64),
    (2, 4, 2, 256, 256, 64, True, 0, 128, 64),
    (1, 8, 2, 192, 192, 32, True, 64, 64, 64),      # SWA + ragged blocks
    (2, 2, 2, 128, 256, 64, False, 0, 64, 128),     # cross attention
    (1, 4, 4, 100, 100, 16, True, 0, 64, 64),       # unaligned seq
]
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _flash_inputs(rng, shape, dtype):
    B, Hq, Hkv, Sq, Skv, hd = shape[:6]
    return [_pair(rng, s, dtype) for s in ((B, Hq, Sq, hd), (B, Hkv, Skv, hd), (B, Hkv, Skv, hd),
                                           (B, Hq, Sq, hd))]


def _grads_close(got, want, dtype):
    for g, w in zip(got, want):
        tol = GRAD_TOL[dtype]
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SWEEP, ids=lambda s: "x".join(map(str, s[:8])))
def test_flash_attention_plain_matches_jax(dtype, shape):
    """Against the oracle, the interpret-mode Pallas kernel and the XLA layer."""
    B, Hq, Hkv, Sq, Skv, hd, causal, window, bq, bk = shape
    (q, jq), (k, jk), (v, jv), _ = _flash_inputs(np.random.default_rng(Sq + hd), shape, dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window), dtype)
    _close(got, pallas_flash_attention(jq, jk, jv, causal=causal, window=window, block_q=bq,
                                       block_k=bk, interpret=True), dtype)
    _close(got, jlayers.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                            q_block=bq, kv_block=bk), dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    assert torch.isfinite(lse).all() and torch.equal(out, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [FLASH_SWEEP[i] for i in (1, 2, 3, 4)],
                         ids=lambda s: "x".join(map(str, s[:8])))
def test_flash_attention_bwd_plain_matches_jax_vjp(dtype, shape):
    """dq, dk, dv of the plain FA2 backward against ``jax.vjp`` of the oracle,
    and against torch autograd through the plain forward."""
    causal, window = shape[6], shape[7]
    (q, jq), (k, jk), (v, jv), (do, jdo) = _flash_inputs(np.random.default_rng(7), shape, dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
    assert [g.dtype for g in got] == [q.dtype] * 3
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal=causal, window=window),
                     jq, jk, jv)
    _grads_close(got, vjp(jdo), dtype)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(ops.flash_attention(*leaves, causal=causal, window=window),
                               leaves, do)
    plain = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal, window=window)[0], leaves, do)
    _grads_close(auto, [p.float().numpy() for p in plain], dtype)


@pytest.mark.parametrize("dtype,hd,bad,want", [
    ("bfloat16", 64, None, "wgmma"),       # both models' head width
    ("bfloat16", 128, None, "wgmma"),
    ("bfloat16", 32, None, "simt"),
    ("bfloat16", 96, None, "simt"),
    ("bfloat16", 16, None, "simt"),
    ("bfloat16", 64, "q", "simt"),         # q 2 bytes off a 16-byte line
    ("bfloat16", 64, "v", "simt"),
    ("float32", 64, None, "simt"),
    ("float32", 128, None, "simt"),
    ("bfloat16", (192, 128), None, "wgmma"),    # MLA's q / k and v widths
    ("bfloat16", (192, 128), "v", "simt"),
    ("bfloat16", (192, 192), None, "simt"),
    ("bfloat16", (128, 64), None, "simt"),
    ("bfloat16", (48, 32), None, "simt"),       # deepseek-v2-lite-16b's smoke widths
    ("float32", (192, 128), None, "simt"),
])
def test_flash_route(dtype, hd, bad, want):
    """The route follows from the dtype, the widths (hd, or q / k's and v's)
    and the pointers' alignment."""
    tdt = DTYPES[dtype][0]
    hd, hdv = hd if isinstance(hd, tuple) else (hd, hd)
    shapes = {"q": (1, 4, 40, hd), "k": (1, 2, 96, hd), "v": (1, 2, 96, hdv)}
    args = {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}
    k_flash.check_args(*args.values())
    assert k_flash.route(*args.values()) == want
    assert want in k_flash.ROUTES and set(k_flash.route_launches) == set(k_flash.ROUTES)


@pytest.mark.parametrize("dtype,hd,bad,want", [
    ("bfloat16", 64, None, "wgmma"),       # both models' head width
    ("bfloat16", 128, None, "wgmma"),
    ("bfloat16", 32, None, "simt"),
    ("bfloat16", 96, None, "simt"),
    ("bfloat16", 64, "q", "simt"),         # q 2 bytes off a 16-byte line
    ("bfloat16", 64, "k", "simt"),
    ("bfloat16", 64, "out", "simt"),
    ("bfloat16", 128, "dout", "simt"),
    ("float32", 64, None, "simt"),
    ("float32", 128, None, "simt"),
    ("bfloat16", (192, 128), None, "wgmma"),    # MLA's q / k and v widths
    ("bfloat16", (192, 128), "dout", "simt"),
    ("bfloat16", (48, 32), None, "simt"),
    ("float32", (192, 128), None, "simt"),
])
def test_flash_bwd_route(dtype, hd, bad, want):
    """The backward's route follows from the dtype, the widths and the alignment
    of q, k, v, out and dout: the forward's rule, over two more pointers."""
    tdt = DTYPES[dtype][0]
    hd, hdv = hd if isinstance(hd, tuple) else (hd, hd)
    shapes = {"q": (1, 4, 40, hd), "k": (1, 2, 96, hd), "v": (1, 2, 96, hdv),
              "out": (1, 4, 40, hdv), "dout": (1, 4, 40, hdv)}
    args = {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}
    k_flash.check_args(args["q"], args["k"], args["v"])
    assert k_flash_bwd.route(*args.values()) == want
    assert want in k_flash_bwd.ROUTES
    assert set(k_flash_bwd.route_launches) == set(k_flash_bwd.ROUTES)


def test_flash_route_needs_keys():
    q = torch.empty((1, 2, 4, 64), dtype=torch.bfloat16)
    kv = torch.empty((1, 2, 0, 64), dtype=torch.bfloat16)
    assert k_flash.route(q, kv, kv) == "simt"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [s for s in FLASH_SWEEP if s[5] == 64],
                         ids=lambda s: "x".join(map(str, s[:8])))
def test_flash_attention_plain_with_bf16_p_matches_jax(dtype, shape):
    """P rounded to bf16 before ``P V``, as the tensor-core route rounds it,
    stays within the bf16 tolerance (2e-2) of the JAX oracle and of the
    interpret-mode Pallas kernel, which keep P in fp32; lse does not move."""
    B, Hq, Hkv, Sq, Skv, hd, causal, window, bq, bk = shape
    (q, jq), (k, jk), (v, jv), _ = _flash_inputs(np.random.default_rng(Sq + hd), shape, dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, p_bf16=True)
    assert out.dtype == q.dtype and out.shape == q.shape
    for want in (jref.attention_ref(jq, jk, jv, causal=causal, window=window),
                 pallas_flash_attention(jq, jk, jv, causal=causal, window=window, block_q=bq,
                                        block_k=bk, interpret=True)):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)
    assert torch.equal(lse, ref.flash_attention_ref(q, k, v, causal=causal, window=window)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [FLASH_SWEEP[i] for i in (1, 2, 3, 4)],
                         ids=lambda s: "x".join(map(str, s[:8])))
def test_flash_attention_bwd_plain_with_bf16_p_matches_jax_vjp(dtype, shape):
    """P and dS rounded to bf16 before their products, as the tensor-core
    backward rounds them, keep dq, dk and dv within the bf16 gradient
    tolerance (5e-2) of ``jax.vjp`` of the oracle, which keeps them in fp32."""
    causal, window = shape[6], shape[7]
    (q, jq), (k, jk), (v, jv), (do, jdo) = _flash_inputs(np.random.default_rng(7), shape, dtype)
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window,
                                      p_bf16=True)
    assert [g.dtype for g in got] == [q.dtype] * 3
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal=causal, window=window),
                     jq, jk, jv)
    _grads_close(got, vjp(jdo), "bfloat16")


def test_flash_attention_q_offset_and_empty_rows():
    """Queries placed at ``q_offset`` see keys up to their absolute position,
    as ``blockwise_attention(q_offset=...)``; a row that sees no key gives zero
    output, ``lse = -inf`` and zero gradients, not NaN."""
    rng = np.random.default_rng(3)
    (q, jq), (k, jk), (v, jv), (do, _) = _flash_inputs(rng, (1, 4, 2, 40, 96, 32), "float32")
    got = ops.flash_attention(q, k, v, causal=True, q_offset=56)
    want = jlayers.blockwise_attention(jq, jk, jv, causal=True, q_block=16, kv_block=32,
                                       q_offset=56)
    _close(got, want, "float32")
    out, lse = ref.flash_attention_ref(q, k, v, causal=True, window=4, q_offset=-8)
    assert torch.isinf(lse[:, :, :8]).all() and torch.isfinite(lse[:, :, 8:]).all()
    assert torch.count_nonzero(out[:, :, :8]) == 0
    grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True, window=4,
                                        q_offset=-8)
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.count_nonzero(grads[0][:, :, :8]) == 0


#: (B, Hq, Hkv, S, hd, hdv, window): v narrower than q and k, as MLA's: at
#: deepseek-v2-lite-16b's smoke widths (48, 32), at (96, 64) with GQA and a
#: window, and at its full widths (192, 128)
FLASH_NARROW_V = [(1, 4, 4, 40, 48, 32, 0), (2, 4, 2, 64, 96, 64, 16), (1, 2, 2, 48, 192, 128, 0)]


@pytest.mark.parametrize("p_bf16", [False, True], ids=["p_fp32", "p_bf16"])
@pytest.mark.parametrize("shape", FLASH_NARROW_V, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_plain_narrow_v_matches_jax(shape, p_bf16):
    """The plain forward and backward with v narrower than q and k, on fp32
    inputs: out within 2e-5 of JAX's ``blockwise_attention`` (the Pallas body
    takes no narrower v, so it is no oracle here) and dq, dk, dv within 1e-4
    of its ``jax.vjp``; with P (and dS) rounded to bf16 as the tensor-core
    routes round them, within the bf16 bounds 2e-2 and 5e-2.  Autograd
    through ``ops.flash_attention`` gives the plain backward's gradients."""
    B, Hq, Hkv, S, hd, hdv, window = shape
    rng = np.random.default_rng(hd + hdv)
    (q, jq), (k, jk), (v, jv), (do, jdo) = (
        _pair(rng, s, "float32") for s in ((B, Hq, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hdv),
                                           (B, Hq, S, hdv)))
    jout, vjp = jax.vjp(lambda a, b, c: jlayers.blockwise_attention(
        a, b, c, causal=True, window=window, q_block=16, kv_block=32), jq, jk, jv)
    out, lse = ref.flash_attention_ref(q, k, v, window=window, p_bf16=p_bf16)
    grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, window=window, p_bf16=p_bf16)
    assert out.shape == (B, Hq, S, hdv) and lse.shape == (B, Hq, S)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    tol, gtol = (2e-2, 5e-2) if p_bf16 else (2e-5, 1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=tol, atol=tol)
    for g, w in zip(grads, vjp(jdo)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=gtol, atol=gtol)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(ops.flash_attention(*leaves, window=window), leaves, do)
    plain = ref.flash_attention_bwd_ref(q, k, v, *ref.flash_attention_ref(q, k, v, window=window),
                                        do, window=window)
    for a, b in zip(auto, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_plain_matches_jax_vjp(dtype):
    rng = np.random.default_rng(11)
    (x, jx), (g, jg), (dy, jdy) = (_pair(rng, s, dtype) for s in ((3, 7, 96), (96,), (3, 7, 96)))
    dx, dgamma = ref.rmsnorm_bwd_ref(x, g, dy, 1e-5)
    assert dx.dtype == x.dtype and dgamma.dtype == g.dtype
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm_ref(a, b, 1e-5), jx, jg)
    _grads_close((dx, dgamma), vjp(jdy), dtype)
    leaves = [t.detach().requires_grad_() for t in (x, g)]
    auto = torch.autograd.grad(ops.rmsnorm(*leaves, eps=1e-5), leaves, dy)
    plain = torch.autograd.grad(ref.rmsnorm_ref(*leaves, 1e-5), leaves, dy)
    _grads_close(auto, [p.float().numpy() for p in plain], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_bwd_plain_matches_jax_vjp(dtype):
    rng = np.random.default_rng(12)
    x, jx = _pair(rng, (2, 10, 64), dtype, 0.5)
    wg, jwg = _pair(rng, (64, 160), dtype, 0.1)
    wu, jwu = _pair(rng, (64, 160), dtype, 0.1)
    wd, jwd = _pair(rng, (160, 64), dtype, 0.1)
    dy, jdy = _pair(rng, (2, 10, 64), dtype)
    got = ref.swiglu_bwd_ref(x, wg, wu, wd, dy)
    assert [t.shape for t in got] == [x.shape, wg.shape, wu.shape, wd.shape]
    _, vjp = jax.vjp(jref.swiglu_ref, jx, jwg, jwu, jwd)
    _grads_close(got, vjp(jdy), dtype)
    leaves = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
    auto = torch.autograd.grad(ops.swiglu_mlp(*leaves), leaves, dy)
    plain = torch.autograd.grad(ref.swiglu_ref(*leaves), leaves, dy)
    _grads_close(auto, [p.float().numpy() for p in plain], dtype)


def test_swiglu_gate_bwd_plain_is_the_silu_derivative():
    a = torch.linspace(-6, 6, 97, dtype=torch.float64).float().requires_grad_()
    b, dh = torch.randn(97), torch.randn(97)
    h, da, db = ref.swiglu_gate_bwd_ref(a.detach(), b, dh)
    y = torch.nn.functional.silu(a) * b
    (want_da,) = torch.autograd.grad(y, a, dh)
    torch.testing.assert_close(h, y.detach())
    torch.testing.assert_close(da, want_da)
    torch.testing.assert_close(db, dh * torch.nn.functional.silu(a.detach()))


@pytest.mark.parametrize("fn", [k_flash.flash_attention_cuda, k_flash_bwd.flash_attention_bwd_cuda,
                                k_rmsnorm_bwd.rmsnorm_bwd_cuda, k_swiglu_bwd.swiglu_bwd_cuda])
def test_training_cuda_wrappers_refuse_cpu_tensors(fn):
    """The training kernels' wrappers launch on CUDA tensors only."""
    q = torch.ones(1, 2, 4, 8)
    args = {
        k_flash.flash_attention_cuda: (q, q, q),
        k_flash_bwd.flash_attention_bwd_cuda: (q, q, q, q, torch.ones(1, 2, 4), q),
        k_rmsnorm_bwd.rmsnorm_bwd_cuda: (torch.ones(2, 8), torch.ones(8), torch.ones(2, 8)),
        k_swiglu_bwd.swiglu_bwd_cuda: (torch.ones(2, 8), torch.ones(8, 4), torch.ones(8, 4),
                                       torch.ones(4, 8), torch.ones(2, 8)),
    }[fn]
    modules = (k_flash, k_flash_bwd, k_rmsnorm_bwd, k_swiglu_bwd)
    before = [m.launches for m in modules]
    routes = [dict(m.route_launches) for m in (k_flash, k_flash_bwd)]
    with pytest.raises(ValueError, match="expected one GPU"):
        fn(*args)
    assert [m.launches for m in modules] == before
    assert [dict(m.route_launches) for m in (k_flash, k_flash_bwd)] == routes


def test_flash_wrapper_argument_checks():
    f32 = torch.ones
    k_flash.check_args(f32(2, 8, 5, 64), f32(2, 2, 7, 64), f32(2, 2, 7, 64))
    with pytest.raises(ValueError):
        k_flash.check_args(f32(2, 3, 5, 64), f32(2, 2, 7, 64), f32(2, 2, 7, 64))
    with pytest.raises(ValueError):
        k_flash.check_args(f32(2, 2, 5, 256), f32(2, 2, 7, 256), f32(2, 2, 7, 256))
    with pytest.raises(ValueError, match="hd 200 > 192"):
        k_flash.check_args(f32(2, 2, 5, 200), f32(2, 2, 7, 200), f32(2, 2, 7, 128))
    with pytest.raises(ValueError):
        k_flash.check_args(f32(2, 2, 5, 64), f32(2, 2, 7, 64), f32(2, 2, 6, 64))
    with pytest.raises(TypeError):
        k_flash.check_args(f32(2, 2, 5, 64), f32(2, 2, 7, 64, dtype=torch.bfloat16),
                           f32(2, 2, 7, 64))


# ----------------------------------------------------------------- mLSTM scan
def _mlstm_inputs(rng, B, H, S, dqk, dv, q_scale=1.0, f_lo=0.7):
    """q, k, v, i_raw, log_f as tests/test_kernels.py draws them, as torch and jax pairs."""
    arrays = [
        (rng.normal(size=(B, H, S, dqk)) * q_scale).astype(np.float32),
        rng.normal(size=(B, H, S, dqk)).astype(np.float32),
        rng.normal(size=(B, H, S, dv)).astype(np.float32),
        rng.normal(size=(B, H, S)).astype(np.float32),
        np.log(rng.uniform(f_lo, 1.0, (B, H, S))).astype(np.float32),
    ]
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def _rel_close(got, want, tol):
    """Within ``tol`` of the largest entry of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("dqk,dv", [(16, 32), (32, 32)])
def test_mlstm_plain_matches_jax(chunk, dqk, dv):
    """The sweep of tests/test_kernels.py:130-141: against the interpret-mode
    Pallas kernel and the sequential oracle (2e-3) and ``mlstm_chunked`` (1e-4)."""
    B, H, S = 2, 2, 256
    t, j = _mlstm_inputs(np.random.default_rng(chunk + dqk), B, H, S, dqk, dv)
    h, C, n, m = ref.mlstm_scan_ref(*t, chunk=chunk)
    nc = S // chunk
    assert h.dtype == torch.float32 and h.shape == (B, H, S, dv)
    assert C.shape == (B, H, nc, dqk, dv) and n.shape == (B, H, nc, dqk) and m.shape == (B, H, nc)
    assert torch.count_nonzero(C[:, :, 0]) == 0 and bool((m[:, :, 0] == -1e30).all())
    np.testing.assert_allclose(h.numpy(), np.asarray(pallas_mlstm_scan(*j, chunk=chunk,
                                                                       interpret=True)),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(jref.mlstm_ref(*j)), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h.numpy(), np.asarray(mlstm_chunked(*j, chunk=chunk)),
                               rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        assert torch.equal(ops.mlstm_scan(*t, chunk=chunk), h)


@pytest.mark.parametrize("q_scale", [1.0, 0.05], ids=["q", "small_q"])
@pytest.mark.parametrize("chunk", [32, 64])
def test_mlstm_bwd_plain_matches_jax_vjp(q_scale, chunk):
    """dq, dk, dv, di, df of the plain backward (m held constant) against
    ``jax.vjp`` of ``mlstm_chunked`` and torch autograd through the plain
    forward, within 1e-4 of each gradient's largest entry.  With q scaled by
    0.05 rows reach the ``exp(-m)`` floor of the denominator."""
    B, H, S, dqk, dv = 2, 2, 256, 16, 32
    rng = np.random.default_rng(int(q_scale * 100) + chunk)
    t, j = _mlstm_inputs(rng, B, H, S, dqk, dv, q_scale=q_scale)
    dh = rng.normal(size=(B, H, S, dv)).astype(np.float32)
    h, C, n, m = ref.mlstm_scan_ref(*t, chunk=chunk)
    got = ref.mlstm_scan_bwd_ref(*t, C, n, m, torch.from_numpy(dh), chunk=chunk)
    assert [g.shape for g in got] == [x.shape for x in t]
    _, vjp = jax.vjp(lambda *a: mlstm_chunked(*a, chunk=chunk), *j)
    for g, w in zip(got, vjp(jnp.asarray(dh))):
        _rel_close(g, w, 1e-4)
    leaves = [x.detach().requires_grad_() for x in t]
    auto = torch.autograd.grad(ref.mlstm_scan_ref(*leaves, chunk=chunk)[0], leaves,
                               torch.from_numpy(dh))
    for g, w in zip(got, auto):
        _rel_close(g, w, 1e-4)
    if q_scale < 1:       # some rows take the floor, so some dden are exactly 0
        qs = t[0] * dqk ** -0.5
        L = chunk
        floor_hit = 0
        for c in range(S // L):
            sl = slice(c * L, (c + 1) * L)
            b, m_t, inter, _, _, _ = ref._mlstm_gates(t[3][..., sl], t[4][..., sl], m[:, :, c])
            s, _ = ref._mlstm_scores(qs[..., sl, :], t[1][..., sl, :], b, t[3][..., sl], m_t)
            den = s.sum(-1) + inter * (qs[..., sl, :] @ n[:, :, c][..., None])[..., 0]
            floor_hit += int((den.abs() <= torch.exp(-m_t)).sum())
        assert floor_hit > 0


def test_mlstm_ops_autograd_is_the_plain_backward():
    """On the CPU, autograd through ``ops.mlstm_scan`` runs ``mlstm_scan_bwd_ref``;
    non-contiguous inputs (the model's transposed views) give the same."""
    rng = np.random.default_rng(21)
    t, _ = _mlstm_inputs(rng, 1, 2, 96, 16, 32)
    dh = torch.from_numpy(rng.normal(size=(1, 2, 96, 32)).astype(np.float32))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in t[:3]] + t[3:]
    leaves = [x.detach().requires_grad_() for x in views]
    out = ops.mlstm_scan(*leaves, chunk=32)
    auto = torch.autograd.grad(out, leaves, dh)
    h, C, n, m = ref.mlstm_scan_ref(*t, chunk=32)
    assert torch.equal(out.detach(), h)
    for a, b in zip(auto, ref.mlstm_scan_bwd_ref(*t, C, n, m, dh, chunk=32)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mlstm_ops_cpu_takes_dtypes_the_kernel_refuses():
    """The kernel takes fp32 and bf16 only; on the CPU ``ops.mlstm_scan`` runs
    the plain version for any float type, forward and backward."""
    rng = np.random.default_rng(23)
    t, _ = _mlstm_inputs(rng, 1, 2, 64, 16, 32)
    t64 = [x.double() for x in t]
    with pytest.raises(TypeError):
        k_mlstm.check_args(*t64, chunk=32)
    leaves = [x.detach().requires_grad_() for x in t64]
    out = ops.mlstm_scan(*leaves, chunk=32)
    h, C, n, m = ref.mlstm_scan_ref(*t64, chunk=32)
    assert out.dtype == torch.float64 and torch.equal(out.detach(), h)
    dh = torch.ones_like(h)
    auto = torch.autograd.grad(out, leaves, dh)
    for a, b in zip(auto, ref.mlstm_scan_bwd_ref(*t64, C, n, m, dh, chunk=32)):
        assert a.dtype == torch.float64 and torch.equal(a, b)


def test_mlstm_plain_bf16_is_fp32_inside():
    """bf16 inputs run in fp32 and round once: the result is the fp32 result cast."""
    rng = np.random.default_rng(22)
    t, _ = _mlstm_inputs(rng, 1, 2, 64, 16, 32)
    tb = [x.to(torch.bfloat16) for x in t]
    h = ref.mlstm_scan_ref(*tb, chunk=32)[0]
    assert h.dtype == torch.bfloat16
    want = ref.mlstm_scan_ref(*[x.float() for x in tb], chunk=32)[0]
    assert torch.equal(h, want.to(torch.bfloat16))


def test_mlstm_wrappers_refuse_bad_arguments():
    """A sequence that is not whole chunks, a wrong shape, mixed dtypes, a
    strided view and a device without the kernel are refused, and no launch
    is counted."""
    f32 = torch.ones
    good = (f32(1, 2, 64, 16), f32(1, 2, 64, 16), f32(1, 2, 64, 32), f32(1, 2, 64),
            f32(1, 2, 64))
    assert k_mlstm.check_args(*good, chunk=32) == 32
    assert k_mlstm.check_args(*good, chunk=128) == 64         # L = min(chunk, S)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        k_mlstm.check_args(*good, chunk=48)
    with pytest.raises(ValueError):
        k_mlstm.check_args(good[0], f32(1, 2, 64, 8), *good[2:], chunk=32)
    with pytest.raises(ValueError):
        k_mlstm.check_args(*good[:3], f32(1, 2, 63), good[4], chunk=32)
    with pytest.raises(TypeError):
        k_mlstm.check_args(good[0].bfloat16(), *good[1:], chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        k_mlstm.check_args(good[0].transpose(1, 2).contiguous().transpose(1, 2), *good[1:],
                           chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.mlstm_scan(*good, chunk=48)
    with pytest.raises(ValueError, match="no kernel"):
        ops.mlstm_scan(*(_Elsewhere(*x.shape) for x in good), chunk=32)
    before = (k_mlstm.launches, k_mlstm_bwd.launches)
    with pytest.raises(ValueError, match="expected one GPU"):
        k_mlstm.mlstm_scan_cuda(*good, chunk=32)
    saved = k_mlstm.MLSTMSaved(*(f32(1) for _ in k_mlstm.MLSTMSaved._fields))
    with pytest.raises(ValueError, match="expected one GPU"):
        k_mlstm_bwd.mlstm_scan_bwd_cuda(*good, saved, f32(1, 2, 64, 32), chunk=32)
    assert (k_mlstm.launches, k_mlstm_bwd.launches) == before


def _mlstm_bf16_case(rng, B, H, S, dqk, dv):
    """bf16 q, k, v, i_raw, log_f and dh as torch tensors, and the same values in
    fp32 as jax arrays, so that the JAX model computes on exactly the kernel's
    inputs."""
    t, _ = _mlstm_inputs(rng, B, H, S, dqk, dv)
    t = [x.bfloat16() for x in t]
    dh = torch.from_numpy(rng.normal(size=(B, H, S, dv)).astype(np.float32)).bfloat16()
    return t, [jnp.asarray(x.float().numpy()) for x in t], dh


#: (chunk, dqk, dv): a short chunk, and the tensor-core route's chunk with dqk
#: and dv of 64 and 128 each way round
MLSTM_BF16_SWEEP = [(32, 64, 128), (128, 64, 128), (128, 128, 64)]


@pytest.mark.parametrize("chunk,dqk,dv", MLSTM_BF16_SWEEP, ids=lambda v: str(v))
def test_mlstm_plain_with_bf16_products_matches_jax(chunk, dqk, dv):
    """The forward rounded where the tensor-core route rounds (S in two bf16
    parts before S v, the chunk-start C before q C, w o k before the state
    update) stays within 2e-2 of the largest entry of ``mlstm_chunked``'s h;
    the carried C, which takes one rounded operand a chunk, within 2e-2 of the
    fp32 one."""
    B, H, S = 1, 2, 256
    t, j, _ = _mlstm_bf16_case(np.random.default_rng(chunk + dqk), B, H, S, dqk, dv)
    h, C, n, m = ref.mlstm_scan_ref(*t, chunk=chunk, bf16_products=True)
    assert h.dtype == torch.bfloat16 and C.dtype == n.dtype == torch.float32
    _rel_close(h.float(), mlstm_chunked(*j, chunk=chunk), 2e-2)
    _, plain_C, plain_n, plain_m = ref.mlstm_scan_ref(*t, chunk=chunk)
    _rel_close(C, plain_C, 2e-2)
    assert torch.equal(m, plain_m) and not torch.equal(C, plain_C)    # the option does round
    torch.testing.assert_close(n, plain_n, rtol=0, atol=0)            # n takes no rounding


@pytest.mark.parametrize("chunk,dqk,dv", MLSTM_BF16_SWEEP, ids=lambda v: str(v))
def test_mlstm_bwd_plain_with_bf16_products_matches_jax_vjp(chunk, dqk, dv):
    """The backward in the tensor-core route's factorisation and roundings (h
    the bf16 output, scale dP, S / g, q o inter scale / g and dC rounded before
    their products): dq, dk, dv, di and df within 2e-2 of the largest entry of
    ``jax.vjp`` of the model, and not the unflagged backward's bits."""
    B, H, S = 1, 2, 256
    t, j, dh = _mlstm_bf16_case(np.random.default_rng(7 + chunk + dqk), B, H, S, dqk, dv)
    _, C, n, m = ref.mlstm_scan_ref(*t, chunk=chunk, bf16_products=True)
    got = ref.mlstm_scan_bwd_ref(*t, C, n, m, dh, chunk=chunk, bf16_products=True)
    assert [g.dtype for g in got] == [x.dtype for x in t]
    _, vjp = jax.vjp(lambda *a: mlstm_chunked(*a, chunk=chunk), *j)
    for g, w in zip(got, vjp(jnp.asarray(dh.float().numpy()))):
        _rel_close(g.float(), w, 2e-2)
    plain = ref.mlstm_scan_bwd_ref(*t, C, n, m, dh, chunk=chunk)
    assert not all(torch.equal(a, b) for a, b in zip(got, plain))


def _mlstm_view(B, H, S, d, pad=0, dtype=torch.bfloat16):
    """A (B, H, S, d) view of a (B, S, H, d + pad) tensor, as the model hands
    q, k and v over (pad 0)."""
    return torch.zeros((B, S, H, d + pad), dtype=dtype)[..., :d].transpose(1, 2)


@pytest.mark.parametrize("case,want", [
    ("bf16", "wgmma"),
    ("model_views", "wgmma"),           # the model's transposed projections, as they lie
    ("training_shape", "wgmma"),        # xlstm-1.3b: dqk 512, dv 1024
    ("float32", "simt"),
    ("chunk_64", "simt"),
    ("short_sequence", "simt"),         # L = min(chunk, S) = 96
    ("dv_96", "simt"),                  # dv not a multiple of 64
    ("dqk_96", "simt"),
    ("dqk_1088", "simt"),               # wider than the route's n row
    ("row_stride_68", "simt"),          # a view whose steps are 136 bytes apart
    ("q_unaligned", "simt"),            # 2 bytes off a 16-byte line
    ("dh_unaligned", "simt"),           # the backward's dh
])
def test_mlstm_route(case, want):
    """The route follows from the dtype, the chunk, dqk and dv, the strides and
    the pointers' alignment (dh's too, for the backward), and both wrappers
    count by the same routes."""
    B, H, S, dqk, dv, chunk = 1, 2, 256, 64, 128, 128
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    if case == "chunk_64":
        chunk = 64
    if case == "short_sequence":
        S = 96
    if case == "training_shape":
        B, H, S, dqk, dv = 1, 1, 256, 512, 1024
    dqk = {"dqk_96": 96, "dqk_1088": 1088}.get(case, dqk)
    dv = 96 if case == "dv_96" else dv
    if case in ("model_views", "row_stride_68"):
        pad = 4 if case == "row_stride_68" else 0
        q, k, v, dh = (_mlstm_view(B, H, S, d, pad) for d in (dqk, dqk, dv, dv))
    else:
        q, k = (torch.zeros((B, H, S, dqk), dtype=dtype) for _ in range(2))
        v, dh = (torch.zeros((B, H, S, dv), dtype=dtype) for _ in range(2))
    if case == "q_unaligned":
        q = _bf16_unaligned(B, H, S, dqk)
    if case == "dh_unaligned":
        dh = _bf16_unaligned(B, H, S, dv)
    gate = torch.zeros((B, H, S), dtype=dtype)
    if case == "model_views":                   # i_raw and log_f are read by plain loads
        gate = torch.zeros((B, S, H), dtype=dtype).transpose(1, 2)
    if case == "row_stride_68":
        L = min(chunk, S)                       # check_args refuses it: see below
    else:
        L = k_mlstm.check_args(q, k, v, gate, gate, chunk)
    assert k_mlstm.route(L, q, k, v, dh) == want
    if case != "dh_unaligned":
        assert k_mlstm.route(L, q, k, v) == want
    assert want in k_mlstm.ROUTES
    assert set(k_mlstm.route_launches) == set(k_mlstm_bwd.route_launches) == set(k_mlstm.ROUTES)


def test_mlstm_wrappers_refuse_a_layout_they_do_not_read():
    """A strided view that the tensor-core route does not read (steps 136
    bytes apart) is refused by the wrapper and copied by ``readable``, which
    hands the model's views over as they are; the backward refuses a saved h
    that is not the forward's (B, S, H, dv) layout."""
    B, H, S = 1, 2, 256
    gate = torch.zeros((B, S, H), dtype=torch.bfloat16).transpose(1, 2)
    bad = [_mlstm_view(B, H, S, d, pad=4) for d in (64, 64, 128)]
    with pytest.raises(ValueError, match="contiguous"):
        k_mlstm.check_args(*bad, gate, gate, 128)
    copied = k_mlstm.readable(*bad, gate, gate, 128)
    assert all(t.is_contiguous() for t in copied)
    assert all(torch.equal(a, b) for a, b in zip(copied, (*bad, gate, gate)))
    good = [_mlstm_view(B, H, S, d) for d in (64, 64, 128)]
    assert k_mlstm.check_args(*good, gate, gate, 128) == 128
    assert all(a is b for a, b in zip(k_mlstm.readable(*good, gate, gate, 128),
                                      (*good, gate, gate)))
    f32 = dict(dtype=torch.float32)
    nc = S // 128
    saved = k_mlstm.MLSTMTcSaved(
        h=_mlstm_view(B, H, S, 128), gates=torch.zeros((5, B, H, S), **f32),
        decay=torch.zeros((B, H, nc), **f32),
        C=torch.zeros((B, H, nc - 1, 64, 128), dtype=torch.bfloat16),
        n=torch.zeros((B, H, nc, 64), **f32), den=torch.zeros((B, H, S), **f32),
        qn=torch.zeros((B, H, S), **f32))
    k_mlstm_bwd._check_saved(saved, B, H, S, 64, 128, 128)
    with pytest.raises(ValueError, match="saved h"):
        k_mlstm_bwd._check_saved(saved._replace(h=torch.zeros((B, H, S, 128),
                                                              dtype=torch.bfloat16)),
                                 B, H, S, 64, 128, 128)
    with pytest.raises(ValueError, match="saved C"):
        k_mlstm_bwd._check_saved(saved._replace(C=saved.C.float()), B, H, S, 64, 128, 128)


def test_mlstm_tc_signatures_match_the_c_entry_points():
    """The tensor-core entry points' pointer counts, stride array and ints as
    ``build.SIGNATURES`` declares them for ctypes."""
    text = "\n".join((build.CSRC / s).read_text() for s in ("mlstm_scan.cu", "mlstm_scan_bwd.cu"))
    for name, n_ptr in (("rt_mlstm_scan_tc", 12), ("rt_mlstm_scan_bwd_tc", 26)):
        args = re.findall(rf'extern "C" int {name}\(([^)]*)\)', text)[0].split(",")
        assert sum("void*" in a for a in args) == n_ptr + 1             # + the stream
        assert sum("long long*" in a for a in args) == 1
        assert build.SIGNATURES[name] == (*(build._P,) * n_ptr, build._LP, *(build._I,) * 5,
                                          build._F, build._P)
    assert k_mlstm.strides(torch.zeros((2, 3, 4, 8)))[:] == [96, 32, 8]


@pytest.mark.parametrize("header", ["common.cuh", "mlstm.cuh", "ssd.cuh", "hopper.cuh",
                                    "mlstm_tc.cuh"])
def test_source_digest_tracks_the_shared_headers(monkeypatch, tmp_path, header):
    """The library's name changes when a header that the sources share changes."""
    for path in build.CSRC.iterdir():
        (tmp_path / path.name).write_text(path.read_text())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    a = build.source_digest()
    (tmp_path / header).write_text((tmp_path / header).read_text() + "\n// edit\n")
    assert build.source_digest() != a


# ------------------------------------------------------------------ SSD scan
def _ssd_inputs(rng, B, S, H, N, chd, dtype="float32", lf_lo=0.7):
    """lf, b, x, c as tests/test_extensions.py:19-30 draws them, as torch and
    jax pairs; lf stays fp32, as the model promotes it."""
    arrays = [
        np.log(rng.uniform(lf_lo, 1.0, (B, S, H))).astype(np.float32),
        (rng.normal(size=(B, S, H, N)) * 0.3).astype(np.float32),
        rng.normal(size=(B, S, H, chd)).astype(np.float32),
        (rng.normal(size=(B, S, H, N)) * 0.3).astype(np.float32),
    ]
    tdt, jdt = DTYPES[dtype]
    dts = [(torch.float32, jnp.float32)] + [(tdt, jdt)] * 3
    return ([torch.from_numpy(a).to(t) for a, (t, _) in zip(arrays, dts)],
            [jnp.asarray(a, j) for a, (_, j) in zip(arrays, dts)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("N,chd", [(8, 16), (16, 32)])
def test_ssd_plain_matches_jax(dtype, chunk, N, chd):
    """The sweep of tests/test_extensions.py:19-30: y and h_last against the
    model's XLA ``ssd_scan``, y against the interpret-mode Pallas kernel
    (fp32 2e-4, bf16 2e-2), and the chunk-start states against the carry."""
    B, S, H = 2, 128, 2
    t, j = _ssd_inputs(np.random.default_rng(chunk + N), B, S, H, N, chd, dtype)
    y, h_last, states = ref.ssd_scan_ref(*t, chunk=chunk)
    assert y.dtype == t[2].dtype and y.shape == (B, S, H, chd)
    assert h_last.dtype == torch.float32 and states.shape == (B, H, S // chunk, chd, N)
    assert torch.count_nonzero(states[:, :, 0]) == 0
    tol = 2e-4 if dtype == "float32" else 2e-2
    want, want_h = jssd_scan(*j, chunk=chunk)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_h), rtol=2e-4, atol=2e-4)
    got = pallas_ssd_scan(*j, chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(got, np.float32), rtol=tol, atol=tol)
    _, h_mid = jssd_scan(*(a[:, :S - chunk] for a in j), chunk=chunk)
    np.testing.assert_allclose(states[:, :, -1].numpy(), np.asarray(h_mid), rtol=2e-4, atol=2e-4)
    with torch.no_grad():
        got_y, got_h = ops.ssd_scan(*t, chunk=chunk)
    assert torch.equal(got_y, y) and torch.equal(got_h, h_last)


def test_ssd_plain_matches_sequential_recurrence():
    """Chunked == step by step in float64: h_t = exp(lf_t) h + x_t b_t^T; y_t = h_t c_t."""
    B, S, H, N, chd = 1, 64, 2, 4, 8
    t, _ = _ssd_inputs(np.random.default_rng(3), B, S, H, N, chd, lf_lo=0.6)
    lf, b, x, c = (a.double().numpy() for a in t)
    h = np.zeros((B, H, chd, N))
    want = np.zeros((B, S, H, chd))
    for s in range(S):
        h = np.exp(lf[:, s])[..., None, None] * h + x[:, s][..., None] * b[:, s][..., None, :]
        want[:, s] = np.einsum("bhcn,bhn->bhc", h, c[:, s])
    y, h_last, _ = ref.ssd_scan_ref(*t, chunk=16)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("N,chd", [(8, 16), (16, 32)])
def test_ssd_bwd_plain_matches_jax_vjp(chunk, N, chd):
    """dlf, db, dx, dc of the plain backward against ``jax.vjp`` of the model's
    ``ssd_scan`` and torch autograd through the plain forward, within 1e-4 of
    each gradient's largest entry."""
    B, S, H = 2, 128, 2
    rng = np.random.default_rng(100 + chunk + N)
    t, j = _ssd_inputs(rng, B, S, H, N, chd)
    dy = rng.normal(size=(B, S, H, chd)).astype(np.float32)
    _, _, states = ref.ssd_scan_ref(*t, chunk=chunk)
    got = ref.ssd_scan_bwd_ref(*t, states, torch.from_numpy(dy), chunk=chunk)
    assert [g.shape for g in got] == [a.shape for a in t]
    _, vjp = jax.vjp(lambda *a: jssd_scan(*a, chunk=chunk)[0], *j)
    for g, w in zip(got, vjp(jnp.asarray(dy))):
        _rel_close(g, w, 1e-4)
    leaves = [a.detach().requires_grad_() for a in t]
    auto = torch.autograd.grad(ref.ssd_scan_ref(*leaves, chunk=chunk)[0], leaves,
                               torch.from_numpy(dy))
    for g, w in zip(got, auto):
        _rel_close(g, w, 1e-4)


@pytest.mark.parametrize("S", [72, 100])
def test_ssd_model_scan_pads_to_whole_chunks(S):
    """The model-side ``ssd_scan`` at a sequence that is not whole chunks of 32:
    y, h_last and the four gradients against the JAX model's, which pads the
    same way."""
    B, H, N, chd, chunk = 2, 2, 16, 32, 32
    rng = np.random.default_rng(S)
    t, j = _ssd_inputs(rng, B, S, H, N, chd)
    dy = rng.normal(size=(B, S, H, chd)).astype(np.float32)
    leaves = [a.detach().requires_grad_() for a in t]
    y, h_last = port_hymba.ssd_scan(*leaves, chunk=chunk)
    assert not h_last.requires_grad
    want, want_h = jssd_scan(*j, chunk=chunk)
    _rel_close(y.detach(), want, 1e-5)
    _rel_close(h_last, want_h, 1e-5)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    _, vjp = jax.vjp(lambda *a: jssd_scan(*a, chunk=chunk)[0], *j)
    for g, w in zip(grads, vjp(jnp.asarray(dy))):
        _rel_close(g, w, 1e-4)


def test_ssd_plain_gradient_is_finite_where_the_upper_triangle_overflows():
    """Chunk 128 with lf = -0.9 each step: within a chunk sum |lf| reaches 114,
    so exp(cum_t - cum_s) above the diagonal overflows fp32.  The JAX model
    forms it and zeroes it with ``where``, so its gradient meets 0 * inf and
    is NaN (a limit of the reference); the plain version masks the exponent
    before ``exp``, and its gradient is finite and equals autograd's."""
    B, S, H, N, chd, chunk = 1, 256, 2, 16, 32, 128
    rng = np.random.default_rng(9)
    t, j = _ssd_inputs(rng, B, S, H, N, chd)
    t[0] = torch.full((B, S, H), -0.9)
    j[0] = jnp.full((B, S, H), -0.9, jnp.float32)
    assert float(-t[0][0, :chunk, 0].sum()) > 100
    dy = torch.from_numpy(rng.normal(size=(B, S, H, chd)).astype(np.float32))
    _, vjp = jax.vjp(lambda *a: jssd_scan(*a, chunk=chunk)[0], *j)
    assert np.isnan(np.asarray(vjp(jnp.asarray(dy.numpy()))[0])).any()
    y, _, states = ref.ssd_scan_ref(*t, chunk=chunk)
    assert torch.isfinite(y).all()
    got = ref.ssd_scan_bwd_ref(*t, states, dy, chunk=chunk)
    leaves = [a.detach().requires_grad_() for a in t]
    auto = torch.autograd.grad(ref.ssd_scan_ref(*leaves, chunk=chunk)[0], leaves, dy)
    for g, w in zip(got, auto):
        assert torch.isfinite(g).all() and torch.isfinite(w).all()
        _rel_close(g, w, 1e-4)


def test_ssd_ops_autograd_is_the_plain_backward():
    """On the CPU, autograd through ``ops.ssd_scan`` runs ``ssd_scan_bwd_ref``;
    a strided c (the model's view into its (2, N) interleave) gives the same,
    and h_last carries no gradient."""
    rng = np.random.default_rng(31)
    t, _ = _ssd_inputs(rng, 1, 64, 2, 8, 16)
    dy = torch.from_numpy(rng.normal(size=(1, 64, 2, 16)).astype(np.float32))
    c_view = torch.stack([torch.zeros_like(t[3]), t[3]], dim=3)[..., 1, :]
    assert not c_view.is_contiguous()
    leaves = [a.detach().requires_grad_() for a in t[:3]] + [c_view.requires_grad_()]
    y, h_last = ops.ssd_scan(*leaves, chunk=32)
    assert not h_last.requires_grad
    auto = torch.autograd.grad(y, leaves, dy)
    want, _, states = ref.ssd_scan_ref(*t, chunk=32)
    assert torch.equal(y.detach(), want)
    for a, b in zip(auto, ref.ssd_scan_bwd_ref(*t, states, dy, chunk=32)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_plain_bf16_is_fp32_inside():
    """bf16 b, x, c run in fp32 and round once: y is the fp32 result cast."""
    t, _ = _ssd_inputs(np.random.default_rng(32), 1, 64, 2, 8, 16, "bfloat16")
    y = ref.ssd_scan_ref(*t, chunk=32)[0]
    assert y.dtype == torch.bfloat16
    want = ref.ssd_scan_ref(*[a.float() for a in t], chunk=32)[0]
    assert torch.equal(y, want.to(torch.bfloat16))


def test_ssd_wrappers_refuse_bad_arguments():
    """A sequence that is not whole chunks, a chunk or a state the kernels do
    not hold, a wrong shape, a bf16 lf, mixed dtypes, a strided view and a
    device without the kernel are refused, and no launch is counted."""
    f32 = torch.ones
    good = (f32(1, 64, 2), f32(1, 64, 2, 16), f32(1, 64, 2, 32), f32(1, 64, 2, 16))
    assert k_ssd.check_args(*good, chunk=32) == 32
    assert k_ssd.check_args(*good, chunk=128) == 64          # L = min(chunk, S)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        k_ssd.check_args(*good, chunk=48)
    with pytest.raises(ValueError, match="chunk 256 > 128"):
        k_ssd.check_args(f32(1, 256, 2), f32(1, 256, 2, 16), f32(1, 256, 2, 32),
                         f32(1, 256, 2, 16), chunk=256)
    with pytest.raises(ValueError, match="state 65 > 64"):
        k_ssd.check_args(good[0], f32(1, 64, 2, 65), good[2], f32(1, 64, 2, 65), chunk=32)
    with pytest.raises(ValueError):
        k_ssd.check_args(good[0], f32(1, 64, 2, 8), *good[2:], chunk=32)
    with pytest.raises(ValueError):
        k_ssd.check_args(f32(1, 64, 3), *good[1:], chunk=32)
    with pytest.raises(TypeError, match="lf must be float32"):
        k_ssd.check_args(good[0].bfloat16(), *good[1:], chunk=32)
    with pytest.raises(TypeError, match="share a dtype"):
        k_ssd.check_args(good[0], good[1].bfloat16(), *good[2:], chunk=32)
    with pytest.raises(TypeError, match="unsupported dtype"):
        k_ssd.check_args(good[0], *(a.double() for a in good[1:]), chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        k_ssd.check_args(*good[:2], good[2].transpose(1, 2).contiguous().transpose(1, 2),
                         good[3], chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(*good, chunk=48)
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_scan(*(_Elsewhere(*a.shape) for a in good), chunk=32)
    before = (k_ssd.launches, k_ssd_bwd.launches)
    with pytest.raises(ValueError, match="expected one GPU"):
        k_ssd.ssd_scan_cuda(*good, chunk=32)
    saved = k_ssd.SSDSaved(f32(1, 2, 2, 32, 16), f32(1, 2, 64))
    with pytest.raises(ValueError, match="expected one GPU"):
        k_ssd_bwd.ssd_scan_bwd_cuda(*good, saved, f32(1, 64, 2, 32), chunk=32)
    assert (k_ssd.launches, k_ssd_bwd.launches) == before


def test_ssd_entry_points_take_the_wrappers_arguments():
    """The C entry points' argument counts are those the wrappers pass."""
    text = "\n".join((build.CSRC / s).read_text() for s in ("ssd_scan.cu", "ssd_scan_bwd.cu"))
    for name, n_ptr in (("rt_ssd_scan", 8), ("rt_ssd_scan_bwd", 11)):
        args = re.findall(rf'extern "C" int {name}\(([^)]*)\)', text)[0].split(",")
        assert sum("*" in a for a in args) == n_ptr + 1                # + the stream
        assert build.SIGNATURES[name] == (*(build._P,) * n_ptr, *(build._I,) * 7, build._P)


def _ssd_bf16_case(rng, B, S, H, N, chd):
    """bf16 b, x, c (and dy) as torch tensors, and the same values in fp32 as
    jax arrays, so that the JAX model computes on exactly the kernel's inputs."""
    t, _ = _ssd_inputs(rng, B, S, H, N, chd, "bfloat16")
    dy = torch.from_numpy(rng.normal(size=(B, S, H, chd)).astype(np.float32)).bfloat16()
    j = [jnp.asarray(a.float().numpy()) for a in t]
    return t, j, dy


SSD_BF16_SWEEP = [(32, 8, 16), (64, 16, 32), (128, 16, 400), (128, 32, 48)]


@pytest.mark.parametrize("chunk,N,chd", SSD_BF16_SWEEP, ids=lambda v: str(v))
def test_ssd_plain_with_bf16_products_matches_jax(chunk, N, chd):
    """The forward rounded where the tensor-core route rounds (the decayed
    Gram, w o b, the chunk-start state before its read-out) stays within 2e-2
    of the largest entry of the JAX model's y; h_last and the states, which
    take one rounded operand each, within 2e-2 of the fp32 ones."""
    B, S, H = 1, 256, 2
    t, j, _ = _ssd_bf16_case(np.random.default_rng(chunk + N + chd), B, S, H, N, chd)
    y, h_last, states = ref.ssd_scan_ref(*t, chunk=chunk, bf16_products=True)
    assert y.dtype == torch.bfloat16 and h_last.dtype == states.dtype == torch.float32
    want, want_h = jssd_scan(*j, chunk=chunk)
    _rel_close(y.float(), want, 2e-2)
    _rel_close(h_last, want_h, 2e-2)
    _, _, plain_states = ref.ssd_scan_ref(*t, chunk=chunk)
    _rel_close(states, plain_states, 2e-2)
    assert not torch.equal(states, plain_states)          # the option does round


@pytest.mark.parametrize("chunk,N,chd", SSD_BF16_SWEEP, ids=lambda v: str(v))
def test_ssd_bwd_plain_with_bf16_products_matches_jax_vjp(chunk, N, chd):
    """The backward rounded where the tensor-core route rounds (exp(cum) o c,
    G, A, h and dH before their products; dcum from the fp32 sums): dlf, db,
    dx and dc within 2e-2 of the largest entry of ``jax.vjp`` of the model."""
    B, S, H = 1, 256, 2
    t, j, dy = _ssd_bf16_case(np.random.default_rng(7 + chunk + N + chd), B, S, H, N, chd)
    _, _, states = ref.ssd_scan_ref(*t, chunk=chunk, bf16_products=True)
    got = ref.ssd_scan_bwd_ref(*t, states, dy, chunk=chunk, bf16_products=True)
    assert [g.dtype for g in got] == [a.dtype for a in t]
    _, vjp = jax.vjp(lambda *a: jssd_scan(*a, chunk=chunk)[0], *j)
    for g, w in zip(got, vjp(jnp.asarray(dy.float().numpy()))):
        _rel_close(g.float(), w, 2e-2)


def _ssd_route_args(S, N, chd, dtype, bad):
    shapes = {"b": (1, S, 2, N), "x": (1, S, 2, chd), "c": (1, S, 2, N), "dy": (1, S, 2, chd)}
    tdt = DTYPES[dtype][0]
    return {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}


@pytest.mark.parametrize("dtype,S,chunk,N,chd,bad,want", [
    ("bfloat16", 256, 128, 16, 400, None, "wgmma"),    # hymba-1.5b's heads
    ("bfloat16", 256, 128, 32, 48, None, "wgmma"),
    ("bfloat16", 256, 128, 48, 136, None, "wgmma"),
    ("bfloat16", 256, 128, 64, 448, None, "wgmma"),    # the widest chd the route holds
    ("bfloat16", 256, 128, 64, 456, None, "simt"),
    ("bfloat16", 256, 128, 8, 16, None, "simt"),       # N not a multiple of 16
    ("bfloat16", 256, 128, 16, 404, None, "simt"),     # chd not a multiple of 8
    ("bfloat16", 256, 64, 16, 400, None, "simt"),      # chunk 64
    ("bfloat16", 96, 128, 16, 400, None, "simt"),      # L = min(chunk, S) = 96
    ("bfloat16", 256, 128, 16, 400, "x", "simt"),      # x 2 bytes off a 16-byte line
    ("bfloat16", 256, 128, 16, 400, "c", "simt"),
    ("bfloat16", 256, 128, 16, 400, "dy", "simt"),     # the backward's dy
    ("float32", 256, 128, 16, 400, None, "simt"),
])
def test_ssd_route(dtype, S, chunk, N, chd, bad, want):
    """The route follows from the dtype, the chunk, N, chd and the pointers'
    alignment (dy's too, for the backward), and the backward counts by the
    forward's routes."""
    a = _ssd_route_args(S, N, chd, dtype, bad)
    lf = torch.empty((1, S, 2))
    L = k_ssd.check_args(lf, a["b"], a["x"], a["c"], chunk)
    assert k_ssd.route(L, a["b"], a["x"], a["c"], a["dy"]) == want
    if bad != "dy":
        assert k_ssd.route(L, a["b"], a["x"], a["c"]) == want
    assert want in k_ssd.ROUTES
    assert set(k_ssd.route_launches) == set(k_ssd_bwd.route_launches) == set(k_ssd.ROUTES)


@pytest.mark.parametrize("dtype,D,bad,want", [
    ("bfloat16", 1024, None, "vec"),        # qwen's rows
    ("bfloat16", 1600, None, "vec"),        # Hymba's: 7 vectors a lane
    ("bfloat16", 96, None, "vec"),
    ("bfloat16", 8192, None, "vec"),        # the longest row the route holds
    ("bfloat16", 8200, None, "block"),
    ("bfloat16", 100, None, "block"),       # D not a multiple of 8
    ("bfloat16", 1024, "x", "block"),       # x 2 bytes off a 16-byte line
    ("bfloat16", 1024, "gamma", "block"),
    ("float32", 4096, None, "vec"),
    ("float32", 4104, None, "block"),
    ("float32", 1020, None, "block"),
])
def test_rmsnorm_route(dtype, D, bad, want):
    """The route follows from the dtype, D and the pointers' alignment."""
    tdt = DTYPES[dtype][0]
    shapes = {"x": (3, D), "gamma": (D,)}
    args = {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}
    k_rmsnorm.check_args(*args.values())
    assert k_rmsnorm.route(*args.values()) == want
    assert want in k_rmsnorm.ROUTES and set(k_rmsnorm.route_launches) == set(k_rmsnorm.ROUTES)


@pytest.mark.parametrize("case", ["gamma_shape", "float16", "mixed", "x_strided",
                                  "gamma_strided", "cached_then_strided"])
def test_rmsnorm_lean_wrapper_refuses_what_check_args_refuses(monkeypatch, case):
    """The wrapper checks a (shape, dtype, device) key once and contiguity on
    every call: each argument that ``check_args`` refuses is still refused,
    a refused key is not remembered, and nothing is launched.  The device
    check is passed over here (there is no card), so the others are reached."""
    monkeypatch.setattr(k_rmsnorm, "_checked", {})
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    f32 = torch.ones
    x, g = f32(4, 8), f32(8)
    args, err = {
        "gamma_shape": ((x, f32(7)), ValueError),
        "float16": ((x.half(), g.half()), TypeError),
        "mixed": ((x, g.bfloat16()), TypeError),
        "x_strided": ((f32(8, 4).T, g), ValueError),
        "gamma_strided": ((x, f32(16)[::2]), ValueError),
        "cached_then_strided": ((f32(8, 4).T, g), ValueError),
    }[case]
    if case == "cached_then_strided":       # the key (4, 8) was seen, contiguous, before
        build.checked_once(k_rmsnorm._checked, (x.shape, g.shape, x.dtype, g.dtype, x.device,
                                                g.device), k_rmsnorm._check_key, x, g)
    before = (k_rmsnorm.launches, dict(k_rmsnorm.route_launches), len(k_rmsnorm._checked))
    with pytest.raises(err):
        k_rmsnorm.rmsnorm_cuda(*args)
    assert (k_rmsnorm.launches, dict(k_rmsnorm.route_launches),
            len(k_rmsnorm._checked)) == before


def test_build_checked_once_runs_each_key_once():
    calls = []

    def check(v):
        calls.append(v)
        if v < 0:
            raise ValueError("negative")
        return v * 2

    cache = {}
    assert build.checked_once(cache, "a", check, 3) == 6
    assert build.checked_once(cache, "a", check, 3) == 6
    with pytest.raises(ValueError):
        build.checked_once(cache, "b", check, -1)
    with pytest.raises(ValueError):
        build.checked_once(cache, "b", check, -1)
    assert calls == [3, -1, -1] and set(cache) == {"a"}


@pytest.mark.parametrize("name,n_ptr", [("rt_ssd_scan_tc", 8), ("rt_ssd_scan_bwd_tc", 11)])
def test_ssd_tc_entry_points_take_the_wrappers_arguments(name, n_ptr):
    """The tensor-core entry points take the simt ones' arguments less the dtype."""
    text = "\n".join((build.CSRC / s).read_text() for s in ("ssd_scan.cu", "ssd_scan_bwd.cu"))
    args = re.findall(rf'extern "C" int {name}\(([^)]*)\)', text)[0].split(",")
    assert sum("*" in a for a in args) == n_ptr + 1                    # + the stream
    assert build.SIGNATURES[name] == (*(build._P,) * n_ptr, *(build._I,) * 6, build._P)


# ------------------------------------------- backwards from saved residuals
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_bwd_from_saved_ab_matches_jax_vjp(dtype):
    """The plain backward from the forward's saved a = x Wg and b = x Wu (dh in
    fp32, dx by one addmm) against ``jax.vjp`` of ``layers.swiglu``; the forward
    that saves them gives the plain forward's output."""
    rng = np.random.default_rng(18)
    x, jx = _pair(rng, (2, 12, 64), dtype, 0.5)
    wg, jwg = _pair(rng, (64, 160), dtype, 0.1)
    wu, jwu = _pair(rng, (64, 160), dtype, 0.1)
    wd, jwd = _pair(rng, (160, 64), dtype, 0.1)
    dy, jdy = _pair(rng, (2, 12, 64), dtype)
    y, a, b = ref.swiglu_fwd_ref(x, wg, wu, wd)
    assert a.shape == b.shape == (24, 160) and a.dtype == b.dtype == x.dtype
    torch.testing.assert_close(y, ref.swiglu_ref(x, wg, wu, wd), rtol=0, atol=0)
    xf = x.reshape(-1, 64).float()
    torch.testing.assert_close(a, (xf @ wg.float()).to(x.dtype), rtol=0, atol=0)
    torch.testing.assert_close(b, (xf @ wu.float()).to(x.dtype), rtol=0, atol=0)
    got = ref.swiglu_bwd_saved_ref(x, wg, wu, wd, a, b, dy)
    assert [t.shape for t in got] == [x.shape, wg.shape, wu.shape, wd.shape]
    assert all(t.dtype == x.dtype for t in got)
    _, vjp = jax.vjp(jlayers.swiglu, jx, jwg, jwu, jwd)
    _grads_close(got, vjp(jdy), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_mlp_ops_grads_match_jax_vjp(dtype):
    """``ops.swiglu_mlp`` on the CPU saves a and b in its forward and its
    backward is the plain backward from them, held against ``jax.vjp`` of
    ``layers.swiglu``."""
    rng = np.random.default_rng(19)
    x, jx = _pair(rng, (3, 8, 96), dtype, 0.5)
    wg, jwg = _pair(rng, (96, 224), dtype, 0.1)
    wu, jwu = _pair(rng, (96, 224), dtype, 0.1)
    wd, jwd = _pair(rng, (224, 96), dtype, 0.1)
    dy, jdy = _pair(rng, (3, 8, 96), dtype)
    leaves = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
    out = ops.swiglu_mlp(*leaves)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6 and saved[4].shape == saved[5].shape == (24, 224)
    got = torch.autograd.grad(out, leaves, dy)
    _, a, b = ref.swiglu_fwd_ref(x, wg, wu, wd)
    for g, w in zip(got, ref.swiglu_bwd_saved_ref(x, wg, wu, wd, a, b, dy)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    _, vjp = jax.vjp(jlayers.swiglu, jx, jwg, jwu, jwd)
    _grads_close(got, vjp(jdy), dtype)


@pytest.mark.parametrize("dtype,rows,D,F,saved,bad,want", [
    ("bfloat16", 4096, 1024, 2816, True, None, "wgmma"),     # qwen training rows
    ("bfloat16", 4352, 1600, 5504, True, None, "wgmma"),     # Hymba's
    ("bfloat16", 2048, 2048, 2688, True, None, "wgmma"),     # xLSTM's SwiGLU
    ("bfloat16", 20, 96, 224, True, None, "wgmma"),          # few rows: one ragged tile
    ("bfloat16", 4096, 1024, 2816, False, None, "simt"),     # the forward saved no a, b
    ("bfloat16", 37, 100, 256, True, None, "simt"),          # D not a multiple of 8
    ("bfloat16", 37, 96, 260, True, None, "simt"),           # F not a multiple of 8
    ("bfloat16", 4096, 1024, 2816, True, "dy", "simt"),      # dy 2 bytes off a 16-byte line
    ("bfloat16", 4096, 1024, 2816, True, "a", "simt"),
    ("bfloat16", 4096, 1024, 2816, True, "w_down", "simt"),
    ("float32", 4096, 1024, 2816, True, None, "simt"),
])
def test_swiglu_bwd_route(dtype, rows, D, F, saved, bad, want):
    """The backward's route follows from the dtype, the shape, the pointers'
    alignment and whether the forward saved a and b."""
    tdt = DTYPES[dtype][0]
    shapes = {"x": (rows, D), "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
              "dy": (rows, D), "a": (rows, F), "b": (rows, F)}
    args = {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}
    if not saved:
        args["a"] = args["b"] = None
    k_swiglu.check_args(args["x"], args["w_gate"], args["w_up"], args["w_down"])
    assert k_swiglu_bwd.route(*args.values()) == want
    assert want in k_swiglu_bwd.ROUTES
    assert set(k_swiglu_bwd.route_launches) == set(k_swiglu_bwd.ROUTES)


@pytest.mark.parametrize("case", ["a_alone", "a_shape", "a_dtype", "a_strided", "dy_shape"])
def test_swiglu_bwd_wrapper_refuses_bad_saved_residuals(monkeypatch, case):
    """Saved a and b come together, (N, F), in x's dtype and contiguous, and dy
    matches x; anything else is refused before a launch.  The device check is
    passed over here (there is no card), so the others are reached."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    x, dy = torch.ones(6, 16), torch.ones(6, 16)
    wg, wu, wd = torch.ones(16, 24), torch.ones(16, 24), torch.ones(24, 16)
    a = b = torch.ones(6, 24)
    a, b, dy = {
        "a_alone": (a, None, dy),
        "a_shape": (torch.ones(5, 24), b, dy),
        "a_dtype": (a.bfloat16(), b, dy),
        "a_strided": (torch.ones(24, 6).T, b, dy),
        "dy_shape": (a, b, torch.ones(6, 8)),
    }[case]
    before = (k_swiglu_bwd.launches, dict(k_swiglu_bwd.route_launches))
    with pytest.raises(ValueError):
        k_swiglu_bwd.swiglu_bwd_cuda(x, wg, wu, wd, dy, a, b)
    assert (k_swiglu_bwd.launches, dict(k_swiglu_bwd.route_launches)) == before


@pytest.mark.parametrize("dtype,D,bad,want", [
    ("bfloat16", 1024, None, "vec"),        # qwen's rows
    ("bfloat16", 1600, None, "vec"),        # Hymba's: 7 vectors a lane
    ("bfloat16", 2048, None, "vec"),        # xLSTM's
    ("bfloat16", 4096, None, "vec"),        # xLSTM's mLSTM output norm: the longest row
    ("bfloat16", 4104, None, "block"),
    ("bfloat16", 100, None, "block"),       # D not a multiple of 8
    ("bfloat16", 1024, "x", "block"),       # x 2 bytes off a 16-byte line
    ("bfloat16", 1024, "gamma", "block"),
    ("bfloat16", 1024, "dy", "block"),
    ("float32", 2048, None, "vec"),
    ("float32", 2056, None, "block"),
    ("float32", 1020, None, "block"),
])
def test_rmsnorm_bwd_route(dtype, D, bad, want):
    """The backward's body follows from the dtype, D and the pointers' alignment."""
    tdt = DTYPES[dtype][0]
    shapes = {"x": (3, D), "gamma": (D,), "dy": (3, D)}
    args = {name: _bf16_unaligned(*shape) if name == bad else torch.empty(shape, dtype=tdt)
            for name, shape in shapes.items()}
    k_rmsnorm.check_args(args["x"], args["gamma"])
    assert k_rmsnorm_bwd.route(*args.values()) == want
    assert want in k_rmsnorm_bwd.ROUTES
    assert set(k_rmsnorm_bwd.route_launches) == set(k_rmsnorm_bwd.ROUTES)


@pytest.mark.parametrize("case", ["gamma_shape", "float16", "mixed", "x_strided",
                                  "gamma_strided", "dy_shape", "dy_dtype", "too_wide",
                                  "cached_then_strided"])
def test_rmsnorm_bwd_lean_wrapper_refuses_what_check_args_refuses(monkeypatch, case):
    """The backward's wrapper checks a (shape, dtype, device) key once and
    contiguity on every call: each argument that ``check_args``, the dy checks
    or ``MAX_D`` refuse is still refused, a refused key is not remembered, and
    nothing is launched.  The device check is passed over here (there is no
    card), so the others are reached."""
    monkeypatch.setattr(k_rmsnorm_bwd, "_checked", {})
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    f32 = torch.ones
    x, g, dy = f32(4, 8), f32(8), f32(4, 8)
    wide = k_rmsnorm_bwd.MAX_D + 8
    args, err = {
        "gamma_shape": ((x, f32(7), dy), ValueError),
        "float16": ((x.half(), g.half(), dy.half()), TypeError),
        "mixed": ((x, g.bfloat16(), dy), TypeError),
        "x_strided": ((f32(8, 4).T, g, dy), ValueError),
        "gamma_strided": ((x, f32(16)[::2], dy), ValueError),
        "dy_shape": ((x, g, f32(4, 7)), ValueError),
        "dy_dtype": ((x, g, dy.bfloat16()), ValueError),
        "too_wide": ((f32(1, wide), f32(wide), f32(1, wide)), ValueError),
        "cached_then_strided": ((f32(8, 4).T, g, dy), ValueError),
    }[case]
    if case == "cached_then_strided":       # the key (4, 8) was seen, contiguous, before
        # the launch shape asks the card for its SMs and the kernel's occupancy
        monkeypatch.setattr(k_rmsnorm_bwd, "_sm_count", lambda device: 132)
        monkeypatch.setattr(k_rmsnorm_bwd, "_vec_blocks", lambda x, rows, sms: 1)
        key = (x.shape, g.shape, dy.shape, x.dtype, g.dtype, dy.dtype, x.device, g.device,
               dy.device)
        build.checked_once(k_rmsnorm_bwd._checked, key, k_rmsnorm_bwd._check_key, x, g, dy)
    before = (k_rmsnorm_bwd.launches, dict(k_rmsnorm_bwd.route_launches),
              len(k_rmsnorm_bwd._checked))
    with pytest.raises(err):
        k_rmsnorm_bwd.rmsnorm_bwd_cuda(*args)
    assert (k_rmsnorm_bwd.launches, dict(k_rmsnorm_bwd.route_launches),
            len(k_rmsnorm_bwd._checked)) == before


def test_backward_tc_entry_points_take_the_wrappers_arguments():
    """The new C entry points take the arguments their wrappers pass: seven
    pointers and four ints (N, D, F, the SM count) for the SwiGLU backward,
    the rmsnorm backward's own less the block body's rows a block."""
    text = (build.CSRC / "swiglu_bwd.cu").read_text() + (build.CSRC / "rmsnorm_bwd.cu").read_text()
    args = re.findall(r'extern "C" int rt_swiglu_bwd_tc\(([^)]*)\)', text)[0].split(",")
    assert sum("*" in a for a in args) == 8                           # + the stream
    assert build.SIGNATURES["rt_swiglu_bwd_tc"] == (*(build._P,) * 7, *(build._I,) * 4, build._P)
    vec = build.SIGNATURES["rt_rmsnorm_bwd_vec"]
    block = build.SIGNATURES["rt_rmsnorm_bwd"]
    assert vec == block[:8] + block[9:]
    args = re.findall(r'extern "C" int rt_rmsnorm_bwd_vec_config\(([^)]*)\)', text)[0].split(",")
    assert [a.split()[0] for a in args] == ["int", "int", "int*", "int*"]
    assert build.SIGNATURES["rt_rmsnorm_bwd_vec_config"] == (build._I, build._I, build._IP,
                                                             build._IP)


def test_decode_partial_wrapper_host_path(monkeypatch):
    """The partial mode's host path on both routes: the C entry point takes
    the lse pointer as its last argument before the stream (null in the whole
    mode), the output is fp32 and lse (B, Hq) fp32; each call counted once, by
    route, as a whole-mode call is."""
    monkeypatch.setattr(k_decode, "_checked", {})
    monkeypatch.setattr(k_decode, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, device, *a: calls.append((name, a)))
    before = (k_decode.launches, dict(k_decode.route_launches))
    for hd, fn in ((64, "rt_decode_attention_split"), (36, "rt_decode_attention")):
        q = torch.empty((4, 16, 1, hd), dtype=torch.bfloat16)
        k, v = (torch.empty((4, 16, 32, hd), dtype=torch.bfloat16) for _ in range(2))
        valid = torch.full((4,), 5, dtype=torch.int32)
        calls.clear()
        out, lse = k_decode.decode_attention_partial_cuda(q, k, v, valid)
        (name, a), = calls
        assert name == fn and len(a) + 1 == len(build.SIGNATURES[fn])
        assert a[-1] == lse.data_ptr() and a[4] == out.data_ptr()
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == q.shape and lse.shape == (4, 16)
        calls.clear()
        k_decode.decode_attention_cuda(q, k, v, valid)
        assert calls[0][1][-1] is None
    assert k_decode.launches == before[0] + 4
    assert k_decode.route_launches == {"split": before[1]["split"] + 2,
                                       "simt": before[1]["simt"] + 2}


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_decode_partial_dispatch(device):
    """``ops.decode_attention_partial``: the card's path on meta (shapes and
    dtypes, nothing launched or counted), the plain version on the CPU; both
    priced by the step counter as one ``decode_attention`` call."""
    from repro_torch.roofline import count as C

    q = torch.randn(2, 4, 1, 32, device=device)
    k, v = (torch.randn(2, 2, 16, 32, device=device) for _ in range(2))
    before = k_decode.launches
    (out, lse), counts = C.count(ops.decode_attention_partial, q, k, v, torch.tensor(
        [3, 0], dtype=torch.int32, device=device))
    assert out.shape == q.shape and out.dtype == torch.float32 and out.device.type == device
    assert lse.shape == (2, 4) and lse.dtype == torch.float32
    assert counts["kernels"]["decode_attention"]["calls"] == 1
    assert k_decode.launches == before
    if device == "cpu":
        assert torch.isneginf(lse[1]).all() and torch.equal(out[1], torch.zeros_like(out[1]))
