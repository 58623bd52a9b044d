"""Sequence-parallel flash decoding of the port in a spawned world of 8 CPU
ranks (``gloo``), mesh data 2 x model 4, against JAX's
``decode_attention_ref`` within 2e-5, with a head count (10 over 2 KV heads)
that does not divide the 4-way axis; and the per-shard partial softmax
against JAX's on one shard within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import flash_world
from repro.kernels.ref import decode_attention_ref as jdecode_attention_ref
from repro.serve.flash_decoding import _partial_softmax as j_partial_softmax
from repro_torch.launch.mesh import run_ranks
from repro_torch.serve.flash_decoding import _partial_softmax

B, HQ, HKV, S, HD = 2, 10, 2, 256, 32
VALIDS = (1, 130, 256)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"q": rng.normal(size=(B, HQ, 1, HD)).astype(np.float32),
            "k": rng.normal(size=(B, HKV, S, HD)).astype(np.float32),
            "v": rng.normal(size=(B, HKV, S, HD)).astype(np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    init = f"file://{tmp_path_factory.mktemp('flash')}/rendezvous"
    return run_ranks(flash_world, 8, _inputs(), VALIDS, init_method=init, timeout=90.0)


def test_flash_decoding_matches_jax_reference(world):
    x = _inputs()
    want = [np.asarray(jdecode_attention_ref(jnp.asarray(x["q"]), jnp.asarray(x["k"]),
                                             jnp.asarray(x["v"]), jnp.asarray(valid)))
            for valid in (*VALIDS, VALIDS[1])]
    for out in world:
        for got, ref in zip(out["outs"], want):
            assert got.shape == (B, HQ, 1, HD) and got.dtype == np.float32
            assert float(np.abs(got - ref).max()) < 2e-5


def test_each_rank_holds_its_contiguous_sequence_shard(world):
    x = _inputs()
    for out in world:
        i = out["coords"]["model"]
        np.testing.assert_array_equal(out["k_shard"], x["k"][:, :, i * S // 4:(i + 1) * S // 4])
        assert out["contiguous"] and out["gathered"]


@pytest.mark.parametrize("pos0,valid", [(0, 1), (64, 130), (192, 256), (128, 100)])
def test_partial_softmax_matches_jax(pos0, valid):
    x = _inputs(1)
    ks, vs = x["k"][:, :, pos0:pos0 + 64], x["v"][:, :, pos0:pos0 + 64]
    want = j_partial_softmax(jnp.asarray(x["q"]), jnp.asarray(ks), jnp.asarray(vs), pos0, valid)
    got = _partial_softmax(torch.from_numpy(x["q"]), torch.from_numpy(ks), torch.from_numpy(vs),
                           pos0, valid)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
