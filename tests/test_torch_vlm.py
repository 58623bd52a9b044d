"""The port's VLM (internvl2-2b: image-patch embeddings before a dense GQA
backbone) on the CPU against the JAX package.

Parameters come from the JAX side and carry over with ``params_from_jax``;
tokens and image embeddings are drawn with numpy from a seed.  At fp32 on
the smoke config (16 image tokens) the port reproduces JAX's loss within
1e-5, every gradient leaf within 1e-4 of its largest entry, the
image-prefixed prefill, decode logits and cache within 1e-4, greedy tokens
exactly, and three train steps within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import config_digest as jconfig_digest
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS
from repro_torch.data import TokenDatasetSpec, read_items
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import DecoderLM, build_model
from repro_torch.models import params as PM
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.train import AdamWConfig, config_digest, make_train_step

ARCH = "internvl2-2b"
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


def _batch(cfg, B=2, S=40, seed=0, labels=True):
    """(port batch, JAX batch): text tokens (and labels) and (B, n_image_tokens,
    d_model) image embeddings."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
              "img_emb": rng.normal(size=(B, cfg.vlm.n_image_tokens, cfg.d_model))
              .astype(np.float32)}
    if labels:
        arrays["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    port = {k: torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
            for k, a in arrays.items()}
    return port, {k: jnp.asarray(a) for k, a in arrays.items()}


def _layout_items(layout, is_leaf):
    flat = jax.tree_util.tree_flatten_with_path(layout, is_leaf=is_leaf)[0]
    return [("/".join(k.key for k in path), tuple(info.shape)) for path, info in flat]


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
def test_config_and_layout_match_jax(full):
    """The copied config keeps its published widths (repr and digest are JAX's),
    and every layout leaf's path and shape is JAX's, at full size as
    ``ParamInfo`` (nothing materialised) and at the smoke size."""
    cfg = ARCHS[ARCH] if full else ARCHS[ARCH].smoke()
    jcfg = JARCHS[ARCH] if full else JARCHS[ARCH].smoke()
    assert repr(cfg) == repr(jcfg) and config_digest(cfg) == jconfig_digest(jcfg)
    assert cfg.vlm.n_image_tokens == (256 if full else 16)
    port = _layout_items(build_model(cfg, device="cpu").layout(),
                         lambda x: isinstance(x, PM.ParamInfo))
    want = _layout_items(jbuild_model(jcfg, mesh=None).layout(),
                         lambda x: isinstance(x, JPM.ParamInfo))
    assert port == want


def test_params_from_jax_keep_layout(pair):
    _, jparams, model, params = pair
    assert isinstance(model, DecoderLM)
    got = PM.tree_leaves(params)
    want = jax.tree.leaves(jparams)
    assert [tuple(t.shape) for t in got] == [i.shape for i in PM.tree_leaves(model.layout())]
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_loss_and_grads_match_jax(pair):
    """Loss within 1e-5 and every gradient leaf within 1e-4 of its largest entry,
    the image positions dropped before the unembedding."""
    jmodel, jparams, model, params = pair
    batch, jbatch = _batch(model.cfg, seed=3)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jbatch)
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, PM.tree_leaves(leaves))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    jleaves = jax.tree.leaves(jgrads)
    assert [tuple(g.shape) for g in grads] == [j.shape for j in jleaves]
    for g, j in zip(grads, jleaves):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_image_prefixed_prefill_matches_jax(pair):
    jmodel, jparams, model, params = pair
    batch, jbatch = _batch(model.cfg, S=24, seed=4, labels=False)
    want = np.asarray(jmodel.prefill(jparams, jbatch))
    got = model.prefill(params, batch)
    assert got.shape == (2, 1, model.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_steps_match_jax(pair):
    """Text decoding (no image path, as in JAX): 10 steps, logits at every step
    and the cache at the end within 1e-4."""
    jmodel, jparams, model, params = pair
    B, S = 2, 14
    jcache = JPM.materialize(jmodel.cache_layout(B, S), jax.random.PRNGKey(0), "float32")
    cache = PM.cache_from_jax(_np(jcache), model.cache_layout(B, S), device="cpu",
                              dtype="float32")
    toks = np.random.default_rng(11).integers(0, model.cfg.vocab, (B, 10), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(10):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(t, jnp.int32)})
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": t})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), **TOL)


def test_greedy_generate_matches_jax(pair):
    """The JAX launcher's defaults: 4 requests, prompt 16, 8 new tokens."""
    jmodel, jparams, model, params = pair
    spec = TokenDatasetSpec("prompts", n_sequences=64, seq_len=16, vocab=model.cfg.vocab)
    prompts = read_items(spec, range(4), items_per_chunk=8)
    jout = JServingEngine(jmodel, jparams, cache_len=32, batch=4).generate(
        prompts, JServeConfig(max_new_tokens=8))
    out = ServingEngine(model, params, cache_len=32, batch=4).generate(
        prompts, ServeConfig(max_new_tokens=8))
    assert out.dtype == np.int32 and out.shape == (4, 8)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_vlm_sees_image_prefix(pair):
    """The twin of tests/test_models.py::test_vlm_sees_image_prefix: other image
    embeddings change the loss, and by as much as they change JAX's."""
    jmodel, jparams, model, params = pair
    b1, j1 = _batch(model.cfg, S=128)
    b2, j2 = dict(b1, img_emb=b1["img_emb"] + 1.0), dict(j1, img_emb=j1["img_emb"] + 1.0)
    with torch.no_grad():
        l1, l2 = (float(model.loss(params, b)[0]) for b in (b1, b2))
    jl1, jl2 = (float(jmodel.loss(jparams, b)[0]) for b in (j1, j2))
    assert abs(l1 - l2) > 1e-6
    assert abs((l1 - l2) - (jl1 - jl2)) < 1e-5


def test_three_train_steps_match_jax(pair):
    """Three AdamW steps with the image embeddings in the batch, from JAX's
    parameters and optimizer state: loss, grad norm and learning rate each
    step within 1e-4, then every parameter."""
    jmodel, jparams, model, _ = pair
    jstate = jinit_opt_state(jparams, JAdamWConfig(lr=1e-3, warmup_steps=2))
    params = PM.params_from_jax(_np(jparams), device="cpu", dtype=None)
    state = PM.params_from_jax(_np(jstate), device="cpu", dtype=None)
    jstep = jax.jit(jmake_train_step(jmodel, JAdamWConfig(lr=1e-3, warmup_steps=2)))
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2))
    for i in range(3):
        batch, jbatch = _batch(model.cfg, S=24, seed=10 + i)
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        params, state, m = step(params, state, batch)
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= 1e-4, (i, name)
    got, want = PM.tree_leaves(params), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_serve_launcher_on_cpu(capsys):
    """The serving launcher runs the VLM as a text decoder, as JAX's does."""
    res = port_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                           "--prompt-len", "6", "--new-tokens", "3"])
    assert res["tokens"].shape == (2, 3) and res["steps"] == 9
    assert res["tokens"].max() < ARCHS[ARCH].vocab
    assert "internvl2-2b" in capsys.readouterr().out


def test_train_launcher_refuses_without_image_embeddings(tmp_path):
    with pytest.raises(SystemExit, match="img_emb"):
        port_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "1",
                         "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
