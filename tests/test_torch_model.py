"""The port's serving slice on the CPU against the JAX package.

Parameters come from the JAX side (``PM.materialize``) and carry over with
``params_from_jax``; inputs are drawn with numpy from a seed.  At fp32 on the
qwen1.5-0.5b smoke config the port reproduces JAX's decode logits and cache
within 1e-4 and its greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import build_cluster
from repro.data import TokenDatasetSpec as JTokenDatasetSpec
from repro.data import materialize_token_dataset
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import params as JPM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch import device as port_device
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.data import TokenDatasetSpec, read_item, read_items
from repro_torch.launch import serve as port_serve
from repro_torch.models import build_model, layers
from repro_torch.models import params as PM
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "qwen1.5-0.5b"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) for the smoke config."""
    jcfg = JARCHS[ARCH].smoke()
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    params = PM.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu",
                                dtype="float32")
    return jmodel, jparams, model, params


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("full", [False, True])
def test_config_fields_match_jax(full):
    """Every field the port keeps has the JAX package's value."""
    cfg = ARCHS[ARCH] if full else ARCHS[ARCH].smoke()
    jcfg = JARCHS[ARCH] if full else JARCHS[ARCH].smoke()
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert names == [f.name for f in dataclasses.fields(type(jcfg))]
    assert {n: getattr(cfg, n) for n in names} == {n: getattr(jcfg, n) for n in names}


def test_params_from_jax_keeps_layout(pair):
    """Names and shapes of the JAX tree are the port's layout; no transposes."""
    _, jparams, model, params = pair
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = ["/".join(k.key for k in path) for path, _ in jflat]
    port = {}

    def walk(t, prefix):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], prefix + (k,))
            else:
                port["/".join(prefix + (k,))] = t[k]

    walk(params, ())
    assert list(port) == names
    layout_shapes = [i.shape for i in PM.tree_leaves(model.layout())]
    assert [tuple(t.shape) for t in port.values()] == layout_shapes
    for (_, leaf), t in zip(jflat, port.values()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_init_params_follows_jax_rules():
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    a = model.init_params(torch.Generator().manual_seed(3))
    b = model.init_params(torch.Generator().manual_seed(3))
    for x, y in zip(PM.tree_leaves(a), PM.tree_leaves(b)):
        assert torch.equal(x, y)
    D = model.cfg.d_model
    assert torch.equal(a["final_ln"], torch.ones(D))
    assert torch.count_nonzero(a["layers"]["attn"]["bq"]) == 0
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert abs(float(a["layers"]["mlp"]["w_gate"].std()) - D ** -0.5) < 0.01
    assert abs(float(a["layers"]["mlp"]["w_down"].std()) - model.cfg.d_ff ** -0.5) < 0.01


def test_layers_match_jax_layers():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)), **TOL)

    q = rng.normal(size=(2, 4, 5, 32)).astype(np.float32)
    pos = np.arange(7, 12)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(q), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(q), jnp.asarray(pos), 10000.0)), **TOL)

    q1 = rng.normal(size=(2, 4, 1, 32)).astype(np.float32)
    kc = rng.normal(size=(2, 2, 40, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 2, 40, 32)).astype(np.float32)
    for valid in (17, np.array([3, 40], np.int32)):
        got = layers.decode_attention(torch.from_numpy(q1), torch.from_numpy(kc),
                                      torch.from_numpy(vc), torch.as_tensor(valid))
        want = jlayers.decode_attention(jnp.asarray(q1), jnp.asarray(kc), jnp.asarray(vc),
                                        jnp.asarray(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    w = [rng.normal(size=s).astype(np.float32) * 0.1 for s in ((64, 96), (64, 96), (96, 64))]
    np.testing.assert_allclose(
        layers.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w)).numpy(),
        np.asarray(jlayers.swiglu(jnp.asarray(x), *map(jnp.asarray, w))), **TOL)


def test_decode_steps_match_jax(pair):
    """16 decode steps: logits and the whole cache within 1e-4 at every step."""
    jmodel, jparams, model, params = pair
    B, S = 2, 20
    jcache = JPM.materialize(jmodel.cache_layout(B, S), jax.random.PRNGKey(0), "float32")
    cache = PM.cache_from_jax(_np_tree(jcache), device="cpu", dtype="float32")
    toks = np.random.default_rng(11).integers(0, model.cfg.vocab, (B, 16), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(16):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(t, jnp.int32)})
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": t})
        assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), **TOL)


def test_ring_buffer_decode_matches_jax():
    """With a sliding window the cache is a ring buffer; past its end the
    slots rotate and all stay valid."""
    jcfg = dataclasses.replace(JARCHS[ARCH].smoke(), sliding_window=8, n_layers=1)
    cfg = dataclasses.replace(ARCHS[ARCH].smoke(), sliding_window=8, n_layers=1)
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(1), "float32")
    model = build_model(cfg, device="cpu")
    params = PM.params_from_jax(_np_tree(jparams), device="cpu", dtype="float32")
    jcache = JPM.materialize(jmodel.cache_layout(1, 32), jax.random.PRNGKey(0), "float32")
    cache = model.init_cache(1, 32)
    assert cache["layers"]["k"].shape[3] == 8
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 12), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(12):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(t, jnp.int32)})
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": t})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_decode_past_cache_end_raises(pair):
    _, _, model, params = pair
    cache = model.init_cache(1, 4)
    with pytest.raises(IndexError):
        model.decode_step(params, {"tokens": torch.zeros(1, 1, dtype=torch.int64),
                                   "cache": cache, "index": 4})


def test_greedy_generate_matches_jax(pair):
    """The JAX launcher's defaults: 4 requests, prompt 16, 8 new tokens."""
    jmodel, jparams, model, params = pair
    spec = TokenDatasetSpec("prompts", n_sequences=64, seq_len=16, vocab=model.cfg.vocab)
    prompts = read_items(spec, range(4), items_per_chunk=8)
    cache_len = 16 + 8 + 8
    jout = JServingEngine(jmodel, jparams, cache_len=cache_len, batch=4).generate(
        prompts, JServeConfig(max_new_tokens=8))
    out = ServingEngine(model, params, cache_len=cache_len, batch=4).generate(
        prompts, ServeConfig(max_new_tokens=8))
    assert out.dtype == np.int32 and out.shape == (4, 8)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_prompts_are_the_stripe_store_items(tmp_path):
    """Port items are byte-identical to ``StripeStore.read_item`` on a corpus
    materialised as the JAX serving launcher does it."""
    clock, topo, store, cache, engine = build_cluster()
    store.root = str(tmp_path)
    jspec = JTokenDatasetSpec("prompts", n_sequences=64, seq_len=16, vocab=512, seed=3)
    materialize_token_dataset(store, cache, jspec, topo.nodes[:4], items_per_chunk=8)
    spec = TokenDatasetSpec("prompts", n_sequences=64, seq_len=16, vocab=512, seed=3)
    for i in range(64):
        assert read_item(spec, i, items_per_chunk=8) == store.read_item("prompts", i,
                                                                        topo.nodes[0])
    with pytest.raises(IndexError):
        read_item(spec, 64, items_per_chunk=8)


def test_temperature_sampling_is_seeded(pair):
    _, _, model, params = pair
    spec = TokenDatasetSpec("prompts", n_sequences=64, seq_len=8, vocab=model.cfg.vocab)
    prompts = read_items(spec, range(3), items_per_chunk=8)

    def run(seed):
        srv = ServingEngine(model, params, cache_len=24, batch=3)
        return srv.generate(prompts, ServeConfig(max_new_tokens=6, temperature=0.9, seed=seed))

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < model.cfg.vocab


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.resolve()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(ARCHS[ARCH].smoke())
    with pytest.raises(RuntimeError, match="cuda"):
        port_serve.main([])
    assert port_device.resolve("cpu").type == "cpu"


def test_other_families_name_their_slice():
    cfg = dataclasses.replace(ARCHS[ARCH].smoke(), family="hybrid")
    with pytest.raises(NotImplementedError, match="Hymba"):
        build_model(cfg, device="cpu")


def test_serve_launcher_on_cpu(capsys):
    res = port_serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "4",
                           "--new-tokens", "3"])
    assert res["tokens"].shape == (2, 3) and res["steps"] == 7
    assert "tok/s" in capsys.readouterr().out
