"""The port's serving slice on the CPU against the JAX package.

Parameters come from the JAX side (``PM.materialize``) and carry over with
``params_from_jax``; inputs are drawn with numpy from a seed.  At fp32 on the
qwen1.5-0.5b smoke config the port reproduces JAX's decode logits and cache
within 1e-4 and its greedy tokens exactly.  The other dense configs (qwen3-4b
with qk-norm and head_dim 128, phi4-mini-3.8b, phi3-medium-14b) are held at
their smoke sizes in decode and in loss and gradients.
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
from repro_torch.models import lm as port_lm
from repro_torch.models import params as PM
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "qwen1.5-0.5b"
#: the dense configs registered beside qwen1.5-0.5b
DENSE = ("qwen3-4b", "phi4-mini-3.8b", "phi3-medium-14b")
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


@pytest.mark.parametrize("workers", [1, 3])
def test_host_draw_is_the_same_in_slices_on_any_threads(monkeypatch, workers):
    """A host generator draws a leaf from its own seed in slices of DRAW_SLICE:
    the values do not depend on how many threads draw them, the slices are not
    copies of one another, and the scale and dtype are the layout's."""
    monkeypatch.setattr(PM, "DRAW_SLICE", 1000)
    one = PM._host_normal((7, 1000), torch.Generator().manual_seed(5), 0.5, torch.float32)
    PM._draw_pool.cache_clear()
    monkeypatch.setattr(PM.os, "cpu_count", lambda: workers)
    try:
        many = PM._host_normal((7, 1000), torch.Generator().manual_seed(5), 0.5, torch.float32)
        half = PM._host_normal((7, 1000), torch.Generator().manual_seed(5), 0.5, torch.bfloat16)
    finally:
        PM._draw_pool.cache_clear()
    assert torch.equal(one, many)
    assert torch.equal(half, one.to(torch.bfloat16))
    assert not torch.equal(one[0], one[1])
    assert abs(float(one.std()) - 0.5) < 0.02


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
    cache = PM.cache_from_jax(_np_tree(jcache), model.cache_layout(B, S), device="cpu",
                              dtype="float32")
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


def test_decode_step_hands_every_layer_one_valid_len(pair, monkeypatch):
    """``decode_step`` makes one int32 (B,) valid_len a step on the model's
    device and hands that same tensor to every layer's decode attention, so
    no layer makes one; the logits stay within 1e-4 of JAX's."""
    jmodel, jparams, model, params = pair
    seen = []

    def spy(q, k_cache, v_cache, valid_len, *, window=0):
        seen.append(valid_len)
        return layers.decode_attention(q, k_cache, v_cache, valid_len, window=window)

    monkeypatch.setattr(port_lm, "decode_attention", spy)
    B, S = 2, 12
    jcache = JPM.materialize(jmodel.cache_layout(B, S), jax.random.PRNGKey(3), "float32")
    cache = PM.cache_from_jax(_np_tree(jcache), model.cache_layout(B, S), device="cpu",
                              dtype="float32")
    toks = np.random.default_rng(13).integers(0, model.cfg.vocab, (B, 6), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(6):
        seen.clear()
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(t, jnp.int32)})
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": t})
        assert len(seen) == model.cfg.n_layers and all(v is seen[0] for v in seen)
        assert seen[0].dtype == torch.int32 and seen[0].tolist() == [t + 1] * B
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


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


def test_serve_launcher_on_cpu(capsys):
    res = port_serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "4",
                           "--new-tokens", "3"])
    assert res["tokens"].shape == (2, 3) and res["steps"] == 7
    assert "tok/s" in capsys.readouterr().out


def test_serve_launcher_draws_on_the_device_when_asked():
    """``--init-on device`` draws the weights on ``--device``'s generator: on
    the CPU that is the host's draw, so the same tokens."""
    argv = ["--device", "cpu", "--requests", "2", "--prompt-len", "4", "--new-tokens", "3"]
    host = port_serve.main(argv)
    device = port_serve.main(argv + ["--init-on", "device"])
    assert np.array_equal(np.asarray(host["tokens"]), np.asarray(device["tokens"]))


# ------------------------------------------------------- other dense configs
def _dense_pair(arch):
    jcfg = JARCHS[arch].smoke()
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    model = build_model(ARCHS[arch].smoke(), device="cpu")
    return jmodel, jparams, model, PM.params_from_jax(_np_tree(jparams), device="cpu",
                                                      dtype=None)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_fields_match_jax(arch, full):
    """The copied configs keep their published widths: every field is JAX's."""
    cfg = ARCHS[arch] if full else ARCHS[arch].smoke()
    jcfg = JARCHS[arch] if full else JARCHS[arch].smoke()
    assert repr(cfg) == repr(jcfg)
    shapes = [i.shape for i in PM.tree_leaves(build_model(cfg, device="cpu").layout())]
    jlayout = jbuild_model(jcfg, mesh=None).layout()
    assert shapes == [i.shape for i in jax.tree.leaves(
        jlayout, is_leaf=lambda x: isinstance(x, JPM.ParamInfo))]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_decode_steps_match_jax(arch):
    """8 decode steps at the smoke config: logits at every step and the cache
    at the end within 1e-4 (qwen3-4b: q_norm and k_norm on every head)."""
    jmodel, jparams, model, params = _dense_pair(arch)
    B, S = 2, 12
    jcache = JPM.materialize(jmodel.cache_layout(B, S), jax.random.PRNGKey(0), "float32")
    cache = PM.cache_from_jax(_np_tree(jcache), model.cache_layout(B, S), device="cpu",
                              dtype="float32")
    toks = np.random.default_rng(12).integers(0, model.cfg.vocab, (B, 8), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(8):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(t, jnp.int32)})
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": t})
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][name].numpy(),
                                   np.asarray(jcache["layers"][name]), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_loss_and_grads_match_jax(arch):
    """Loss within 1e-5 and every gradient leaf within 1e-4 of its largest entry."""
    jmodel, jparams, model, params = _dense_pair(arch)
    rng = np.random.default_rng(3)
    toks, labels = (rng.integers(0, model.cfg.vocab, (2, 40)).astype(np.int32) for _ in "tl")
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(leaves, {"tokens": torch.from_numpy(toks).long(),
                                  "labels": torch.from_numpy(labels).long()})
    grads = torch.autograd.grad(loss, PM.tree_leaves(leaves))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    jleaves = jax.tree.leaves(jgrads)
    assert [tuple(g.shape) for g in grads] == [j.shape for j in jleaves]
    for g, j in zip(grads, jleaves):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-4 * np.abs(j).max()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serving_hands_the_kernels_contiguous_tensors(arch, monkeypatch):
    """On the card the rmsnorm, SwiGLU and decode-attention wrappers take only
    contiguous tensors and raise on others; on the CPU their plain versions take
    any.  So what ``prefill`` and ``decode_step`` hand them is checked here, at
    every arch's smoke config (qwen3-4b's q_norm and k_norm, deepseek-v2-lite-16b's
    kv_ln on the MLA latent and its shared experts, internvl2-2b's image prefix,
    whisper-large-v3's self and cross caches among them)."""
    from repro_torch.kernels import ops

    seen = []
    for name in ("rmsnorm", "swiglu_mlp", "decode_attention"):
        def spy(*args, _fn=getattr(ops, name), _name=name, **kw):
            seen.append((_name, all(a.is_contiguous() for a in args
                                    if isinstance(a, torch.Tensor))))
            return _fn(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    model = build_model(ARCHS[arch].smoke(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    cfg = model.cfg
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    batch = {"tokens": toks}
    if cfg.vlm is not None:
        batch["img_emb"] = torch.randn((2, cfg.vlm.n_image_tokens, cfg.d_model), generator=gen)
    if cfg.encdec is not None:
        batch["enc_emb"] = torch.randn((2, 24, cfg.d_model), generator=gen)
    model.prefill(params, batch)
    cache = model.init_cache(2, 8, 24) if cfg.encdec is not None else model.init_cache(2, 8)
    for t in range(3):
        model.decode_step(params, {"tokens": toks[:, t:t + 1], "cache": cache, "index": t})
    moe = cfg.moe
    # mixtral's routed experts are batched products; the SwiGLU kernel serves
    # dense MLPs, deepseek's shared experts and its dense layer0; Whisper's
    # LayerNorm and GELU MLP are no kernels
    whisper = cfg.encdec is not None
    swiglu_called = not whisper and (moe is None or bool(moe.n_shared or moe.first_dense))
    names = {n for n, _ in seen}
    assert ("rmsnorm" in names) != whisper and ("swiglu_mlp" in names) == swiglu_called
    assert ("decode_attention" in names) == (cfg.family != "ssm" and cfg.mla is None)
    assert [n for n, ok in seen if not ok] == []
