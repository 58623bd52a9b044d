"""The port's kernels on the CPU: each plain version against the JAX package.

Inputs are drawn with numpy from a seed and fed to both sides.  Each plain
version (what a kernel wrapper runs for a CPU tensor) is held against
``repro.kernels.ref`` and against the Pallas kernel run with
``interpret=True``, at the tolerances of ``tests/test_kernels.py``.  The CUDA
kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers' argument checks, the dispatch and the build's C interface are
checked as far as the CPU reaches.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.swiglu import swiglu_mlp as pallas_swiglu
from repro.models import layers as jlayers
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as k_decode
from repro_torch.kernels import rmsnorm as k_rmsnorm
from repro_torch.kernels import swiglu as k_swiglu

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


def test_valid_len_vector_forms():
    assert ref.valid_len_vector(5, 3, "cpu").tolist() == [5, 5, 5]
    assert ref.valid_len_vector(torch.tensor(4), 2, "cpu").dtype == torch.int32
    assert ref.valid_len_vector(torch.tensor([1, 2]), 2, "cpu").tolist() == [1, 2]
    with pytest.raises(ValueError):
        ref.valid_len_vector(torch.tensor([1, 2, 3]), 2, "cpu")


def test_ops_refuse_devices_without_a_kernel():
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rmsnorm(x, torch.empty((8,), device="meta"))


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
    before = (k_rmsnorm.launches, k_swiglu.launches, k_decode.launches)
    with pytest.raises(ValueError, match="expected one GPU"):
        fn(*args)
    assert (k_rmsnorm.launches, k_swiglu.launches, k_decode.launches) == before


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
