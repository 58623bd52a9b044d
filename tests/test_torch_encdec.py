"""The port's Whisper encoder-decoder (whisper-large-v3) on the CPU against the
JAX package.

Parameters come from the JAX side and carry over with ``params_from_jax``;
tokens and frame embeddings are drawn with numpy from a seed.  At fp32 on
the smoke config (2 encoder and 2 decoder layers) the port reproduces JAX's
encoder output, loss within 1e-5, every gradient leaf within 1e-4 of its
largest entry, prefill, decode logits and caches within 1e-4 (the cross
cache filled through each package's ``_qkv``), greedy tokens exactly, and
three train steps within 1e-4.  Also the layers Whisper adds (LayerNorm,
the tanh-GELU MLP, the sinusoid table) and the plain flash version at
Whisper's non-causal, ragged shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import params as JPM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import config_digest as jconfig_digest
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS
from repro_torch.data import TokenDatasetSpec, read_items
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import EncDecLM, build_model, layers
from repro_torch.models import params as PM
from repro_torch.models.encdec import MAX_DEC_POS
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.train import AdamWConfig, config_digest, make_train_step

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax fp32 params, port model, port params) for the smoke config."""
    jcfg = JARCHS[ARCH].smoke()
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    return jmodel, jparams, model, PM.params_from_jax(_np(jparams), device="cpu", dtype=None)


def _batch(cfg, B=2, S=24, S_enc=40, seed=0, labels=True):
    """(port batch, JAX batch): decoder tokens (and labels) and (B, S_enc,
    d_model) frame embeddings."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
              "enc_emb": rng.normal(size=(B, S_enc, cfg.d_model)).astype(np.float32)}
    if labels:
        arrays["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    port = {k: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
            for k, a in arrays.items()}
    return port, {k: jnp.asarray(a) for k, a in arrays.items()}


def _layout_items(layout, is_leaf):
    flat = jax.tree_util.tree_flatten_with_path(layout, is_leaf=is_leaf)[0]
    return [("/".join(k.key for k in path), tuple(info.shape)) for path, info in flat]


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_config_and_layout_match_jax(full):
    """The copied config keeps its published widths (repr and digest are JAX's),
    and every layout leaf's path and shape is JAX's, the cache's too, at full
    size as ``ParamInfo`` (nothing materialised) and at the smoke size."""
    cfg = ARCHS[ARCH] if full else ARCHS[ARCH].smoke()
    jcfg = JARCHS[ARCH] if full else JARCHS[ARCH].smoke()
    assert repr(cfg) == repr(jcfg) and config_digest(cfg) == jconfig_digest(jcfg)
    assert cfg.encdec.n_encoder_layers == (32 if full else 2)
    model, jmodel = build_model(cfg, device="cpu"), jbuild_model(jcfg, mesh=None)
    port_leaf = lambda x: isinstance(x, PM.ParamInfo)  # noqa: E731
    jax_leaf = lambda x: isinstance(x, JPM.ParamInfo)  # noqa: E731
    assert _layout_items(model.layout(), port_leaf) == _layout_items(jmodel.layout(), jax_leaf)
    assert (_layout_items(model.cache_layout(8, 168, 1500), port_leaf)
            == _layout_items(jmodel.cache_layout(8, 168, 1500), jax_leaf))
    assert model.layout()["dec_pos"].shape == (MAX_DEC_POS, cfg.d_model)


def test_params_and_cache_from_jax_keep_layout(pair):
    """``params_from_jax`` carries EncDec's tree over unchanged, and
    ``cache_from_jax`` its 4-leaf cache (self and cross K and V)."""
    jmodel, jparams, model, params = pair
    assert isinstance(model, EncDecLM)
    got, want = PM.tree_leaves(params), jax.tree.leaves(jparams)
    assert [tuple(t.shape) for t in got] == [i.shape for i in PM.tree_leaves(model.layout())]
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jcache = JPM.materialize(jmodel.cache_layout(2, 12, 20), jax.random.PRNGKey(4), "float32")
    cache = PM.cache_from_jax(_np(jcache), model.cache_layout(2, 12, 20), device="cpu",
                              dtype="float32")
    assert sorted(cache["layers"]) == ["cross_k", "cross_v", "k", "v"]
    for t, j in zip(PM.tree_leaves(cache), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError):
        PM.cache_from_jax(_np(jcache), model.cache_layout(2, 12, 24), device="cpu",
                          dtype="float32")


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """The JAX order of rounding: fp32 statistics, the normed value cast, then
    ``* gamma + beta`` in the input's dtype (one bf16 step in bf16)."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 7, 96)) * 3 + 1).astype(np.float32)
    g, b = (rng.normal(size=(96,)).astype(np.float32) for _ in "gb")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = layers.layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, g, b)), 1e-5)
    want = jlayers.layer_norm(*(jnp.asarray(a, jdt) for a in (x, g, b)), 1e-5)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_gelu_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * 0.2 for s in ((64, 160), (160,), (160, 64),
                                                                (64,))]
    got = layers.gelu_mlp(torch.from_numpy(x), *map(torch.from_numpy, w))
    want = jlayers.gelu_mlp(jnp.asarray(x), *map(jnp.asarray, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seq,d", [(1500, 1280), (40, 128), (7, 10)])
def test_sinusoidal_positions_bit_for_bit(seq, d):
    got = layers.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlayers.sinusoidal_positions(seq, d)))


@pytest.mark.parametrize("shape", [(1, 4, 4, 56, 150, 64), (2, 4, 4, 150, 150, 64),
                                   (1, 2, 2, 130, 70, 32)])
def test_flash_plain_non_causal_ragged_matches_jax(shape):
    """The plain flash version at Whisper's non-causal shapes (cross attention:
    fewer queries than keys; the encoder: no tile divides the length), forward
    against JAX's ``blockwise_attention`` and ``attention_ref``, backward
    against ``jax.vjp`` of the oracle."""
    B, Hq, Hkv, Sq, Skv, hd = shape
    rng = np.random.default_rng(6)
    q, k, v, do = (rng.normal(size=s).astype(np.float32) for s in
                   ((B, Hq, Sq, hd), (B, Hkv, Skv, hd), (B, Hkv, Skv, hd), (B, Hq, Sq, hd)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=False)
    for want in (jlayers.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=False,
                                             q_block=64, kv_block=64),
                 jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=False)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    grads = torch.autograd.grad(ops.flash_attention(*leaves, causal=False), leaves, tdo)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal=False),
                     *map(jnp.asarray, (q, k, v)))
    for g, j in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------------- model
def test_encode_matches_jax(pair):
    jmodel, jparams, model, params = pair
    batch, jbatch = _batch(model.cfg, seed=1)
    with torch.no_grad():
        got = model.encode(params, batch["enc_emb"])
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.encode(jparams, jbatch["enc_emb"])),
                               **TOL)


def test_loss_and_grads_match_jax(pair):
    """Loss within 1e-5 and every gradient leaf within 1e-4 of its largest entry
    (the encoder's, the cross attention's and the tied embedding's among them)."""
    jmodel, jparams, model, params = pair
    batch, jbatch = _batch(model.cfg, seed=3)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jbatch)
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, PM.tree_leaves(leaves))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert float(metrics["aux"]) == 0.0
    jleaves = jax.tree.leaves(jgrads)
    assert [tuple(g.shape) for g in grads] == [j.shape for j in jleaves]
    for g, j in zip(grads, jleaves):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_prefill_matches_jax(pair):
    jmodel, jparams, model, params = pair
    batch, jbatch = _batch(model.cfg, S=20, seed=4, labels=False)
    got = model.prefill(params, batch)
    assert got.shape == (2, 1, model.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.prefill(jparams, jbatch)), **TOL)


def _filled_caches(jmodel, jparams, model, params, enc, B, S):
    """(JAX cache, port cache) of S slots whose cross K and V each package
    forms from its own encoder output through its own ``_qkv``, as
    ``prefill``'s cross attention forms them."""
    jenc = jmodel.encode(jparams, jnp.asarray(enc))
    jcache = JPM.materialize(jmodel.cache_layout(B, S, enc.shape[1]), jax.random.PRNGKey(0),
                             "float32")
    cp = jparams["dec_layers"]["cross_attn"]
    jk, jv = zip(*(jmodel._qkv(jax.tree.map(lambda t, i=i: t[i], cp), jenc, jenc)[1:]
                   for i in range(model.cfg.n_layers)))
    jcache["layers"]["cross_k"], jcache["layers"]["cross_v"] = jnp.stack(jk), jnp.stack(jv)
    cache = model.init_cache(B, S, enc.shape[1])
    with torch.no_grad():
        tenc = model.encode(params, torch.from_numpy(enc))
        for i, p in enumerate(PM.unstack(params["dec_layers"])):
            _, k, v = model._qkv(p["cross_attn"], tenc, tenc)
            cache["layers"]["cross_k"][i], cache["layers"]["cross_v"][i] = k, v
    return jcache, cache


def test_decode_steps_match_jax(pair):
    """10 decode steps over a cross cache that each package fills from its own
    encoder: logits at every step, then the self and the cross caches, within
    1e-4; the self K and V land in place at each index."""
    jmodel, jparams, model, params = pair
    B, S = 2, 14
    enc = np.random.default_rng(5).normal(size=(B, 30, model.cfg.d_model)).astype(np.float32)
    jcache, cache = _filled_caches(jmodel, jparams, model, params, enc, B, S)
    toks = np.random.default_rng(11).integers(0, model.cfg.vocab, (B, 10), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(10):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(t, jnp.int32)})
        logits, out = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                 "cache": cache, "index": t})
        assert out is cache and logits.shape == (B, 1, model.cfg.vocab)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), **TOL)
    assert torch.count_nonzero(cache["layers"]["k"][:, :, :, 10:]) == 0


def test_decode_matches_own_prefill(pair):
    """Fed one by one through ``decode_step`` over the filled cross cache, the
    tokens give the port's own ``prefill`` logits at the last position
    (tests/test_models.py's decode/prefill tolerance, 2e-3)."""
    jmodel, jparams, model, params = pair
    B, S = 1, 16
    rng = np.random.default_rng(7)
    enc = rng.normal(size=(B, 36, model.cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, model.cfg.vocab, (B, S), dtype=np.int32)
    want = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                  "enc_emb": torch.from_numpy(enc)})
    _, cache = _filled_caches(jmodel, jparams, model, params, enc, B, S + 4)
    for t in range(S):
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": t})
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


def test_decode_hands_every_layer_two_valid_lens(pair, monkeypatch):
    """A step makes two int32 (B,) valid lengths, the self cache's ``index + 1``
    and the cross cache's frame count, and every layer's decode attention
    takes one of those same two tensors."""
    from repro_torch.models import encdec

    _, _, model, params = pair
    seen = []

    def spy(q, k_cache, v_cache, valid_len, *, window=0):
        seen.append(valid_len)
        return layers.decode_attention(q, k_cache, v_cache, valid_len, window=window)

    monkeypatch.setattr(encdec, "decode_attention", spy)
    cache = model.init_cache(2, 8, 24)
    for t in range(3):
        seen.clear()
        model.decode_step(params, {"tokens": torch.zeros((2, 1), dtype=torch.long),
                                   "cache": cache, "index": t})
        assert len(seen) == 2 * model.cfg.n_layers
        self_len, frames = seen[0], seen[1]
        assert all(v is self_len for v in seen[0::2]) and all(v is frames for v in seen[1::2])
        assert self_len.dtype == frames.dtype == torch.int32
        assert self_len.tolist() == [t + 1] * 2 and frames.tolist() == [24] * 2


def test_decode_past_cache_end_raises(pair):
    _, _, model, params = pair
    cache = model.init_cache(1, 4, 8)
    with pytest.raises(IndexError):
        model.decode_step(params, {"tokens": torch.zeros(1, 1, dtype=torch.int64),
                                   "cache": cache, "index": 4})


def test_engine_matches_jax_with_zero_cross_cache(pair):
    """Both engines with ``enc_len=0``: a zero cross cache of 64 frames, greedy
    tokens equal (the JAX launcher's defaults: 4 requests, prompt 16, 8 new)."""
    jmodel, jparams, model, params = pair
    spec = TokenDatasetSpec("prompts", n_sequences=64, seq_len=16, vocab=model.cfg.vocab)
    prompts = read_items(spec, range(4), items_per_chunk=8)
    jsrv = JServingEngine(jmodel, jparams, cache_len=32, batch=4)
    srv = ServingEngine(model, params, cache_len=32, batch=4)
    assert srv.cache["layers"]["cross_k"].shape == jsrv.cache["layers"]["cross_k"].shape
    assert srv.cache["layers"]["cross_k"].shape[3] == 64
    jout = jsrv.generate(prompts, JServeConfig(max_new_tokens=8))
    out = srv.generate(prompts, ServeConfig(max_new_tokens=8))
    assert out.dtype == np.int32 and out.shape == (4, 8)
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert ServingEngine(model, params, cache_len=8, batch=1,
                         enc_len=20).cache["layers"]["cross_v"].shape[3] == 20


def test_whisper_encoder_affects_decoder(pair):
    """The twin of tests/test_models.py::test_whisper_encoder_affects_decoder:
    scaled frame embeddings change the loss, by as much as they change JAX's."""
    jmodel, jparams, model, params = pair
    b1, j1 = _batch(model.cfg, S=64, S_enc=64)
    b2, j2 = dict(b1, enc_emb=b1["enc_emb"] * 2.0), dict(j1, enc_emb=j1["enc_emb"] * 2.0)
    with torch.no_grad():
        l1, l2 = (float(model.loss(params, b)[0]) for b in (b1, b2))
    jl1, jl2 = (float(jmodel.loss(jparams, b)[0]) for b in (j1, j2))
    assert abs(l1 - l2) > 1e-6
    assert abs((l1 - l2) - (jl1 - jl2)) < 1e-5


def test_three_train_steps_match_jax(pair):
    """Three AdamW steps with the frame embeddings in the batch, from JAX's
    parameters and optimizer state: loss, grad norm and learning rate each
    step within 1e-4, then every parameter."""
    jmodel, jparams, model, _ = pair
    jstate = jinit_opt_state(jparams, JAdamWConfig(lr=1e-3, warmup_steps=2))
    params = PM.params_from_jax(_np(jparams), device="cpu", dtype=None)
    state = PM.params_from_jax(_np(jstate), device="cpu", dtype=None)
    jstep = jax.jit(jmake_train_step(jmodel, JAdamWConfig(lr=1e-3, warmup_steps=2)))
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2))
    for i in range(3):
        batch, jbatch = _batch(model.cfg, S=20, S_enc=30, seed=10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        params, state, m = step(params, state, batch)
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= 1e-4, (i, name)
    got, want = PM.tree_leaves(params), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_serve_launcher_on_cpu(capsys):
    """The serving launcher runs Whisper against the engine's zero cross cache,
    as JAX's does."""
    res = port_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                           "--prompt-len", "6", "--new-tokens", "3"])
    assert res["tokens"].shape == (2, 3) and res["steps"] == 9
    assert res["tokens"].max() < ARCHS[ARCH].vocab
    assert "whisper-large-v3" in capsys.readouterr().out


def test_train_launcher_refuses_without_frame_embeddings(tmp_path):
    with pytest.raises(SystemExit, match="enc_emb"):
        port_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                         "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
