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


# ------------------------------------------------ the kernel's partial mode
class _Gathered:
    """A stand-in mesh for one rank of a cut cache: its ``all_gather`` checks
    that this rank packed its own pair and returns every rank's, packed the
    same way."""

    def __init__(self, pairs, rank):
        self.packed = [torch.cat([o, l.reshape(*o.shape[:-1], 1)], -1) for o, l in pairs]
        self.rank = rank

    def all_gather(self, t, axis):
        assert axis == "model"
        assert torch.equal(t, self.packed[self.rank])
        return self.packed


def _f64_partial(q, k, v, valid, window):
    """out and lse of one cache in float64 over the visible positions (NaN rows
    where nothing is visible)."""
    B, Hq, _, hd = q.shape
    G = Hq // k.shape[1]
    qg = q.double().reshape(B, k.shape[1], G, hd)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.double()) / np.sqrt(hd)
    pos = torch.arange(k.shape[2])[None, :]
    vl = torch.as_tensor(valid).reshape(-1, 1)
    mask = pos < vl
    if window:
        mask &= pos > vl - 1 - window
    s = s.masked_fill(~mask[:, None, None, :], -np.inf)
    lse = torch.logsumexp(s, -1)
    out = torch.einsum("bhgk,bhkd->bhgd", torch.exp(s - lse[..., None]), v.double())
    return out.reshape(B, Hq, 1, hd), lse.reshape(B, Hq)


@pytest.mark.parametrize("window", [0, 48])
def test_partial_mode_plain_version_matches_float64(window):
    """``ref.decode_attention_partial_ref``: the output normalised by this
    cache's own denominator and the log-sum-exp, against float64, with a row
    that sees nothing (zeros, lse -inf), one slot, part of the cache and all."""
    from repro_torch.kernels import ref

    x = _inputs(2)
    q, k, v = (torch.from_numpy(x[n]) for n in ("q", "k", "v"))
    valid = torch.tensor([0, 200]) if window else torch.tensor([1, 256])
    for vl in (valid, valid.flip(0), torch.tensor([130, 0])):
        out, lse = ref.decode_attention_partial_ref(q, k, v, vl, window=window)
        want_out, want_lse = _f64_partial(q, k, v, vl, window)
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == (B, HQ, 1, HD) and lse.shape == (B, HQ)
        for b in range(B):
            if int(vl[b]) == 0:
                assert torch.equal(out[b], torch.zeros_like(out[b]))
                assert torch.isneginf(lse[b]).all()
                continue
            np.testing.assert_allclose(out[b].numpy(), want_out[b].numpy(), rtol=0, atol=2e-6)
            np.testing.assert_allclose(lse[b].numpy(), want_lse[b].numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("valid", [(1, 256), (70, 130), (256, 64)])
def test_cut_cache_merged_equals_the_whole(n, valid):
    """The cache cut on its sequence into ``n`` shards, each shard's partial
    (``ops.decode_attention_partial`` on the CPU: the plain version, each
    rank's local count ``clamp(valid - i S/n, 0, S/n)``) merged by
    ``merge_partials`` on every rank: ``decode_attention_ref`` over the whole
    cache within 1e-6, the same bits on every rank; a shard with no visible
    slot gives lse -inf, zeros and no NaN."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import merge_partials

    x = _inputs(3)
    q, k, v = (torch.from_numpy(x[name]) for name in ("q", "k", "v"))
    per = S // n
    pairs = []
    for i in range(n):
        local = torch.tensor([min(max(vl - i * per, 0), per) for vl in valid], dtype=torch.int32)
        pairs.append(ops.decode_attention_partial(q, k[:, :, i * per:(i + 1) * per].contiguous(),
                                                  v[:, :, i * per:(i + 1) * per].contiguous(),
                                                  local))
        for b in range(B):
            if int(local[b]) == 0:
                assert torch.isneginf(pairs[-1][1][b]).all()
                assert torch.equal(pairs[-1][0][b], torch.zeros_like(pairs[-1][0][b]))
    assert any(torch.isneginf(l).any() for _, l in pairs)
    want = ref.decode_attention_ref(q, k, v, torch.tensor(valid))
    merged = [merge_partials(*pairs[i], _Gathered(pairs, i), dtype=torch.float32)
              for i in range(n)]
    for got in merged:
        assert not torch.isnan(got).any()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
        assert torch.equal(got, merged[0])
