"""The port's Hymba training path on the CPU, held against the JAX package.

The smoke config of hymba-1.5b widened to 4 layers with global layers (0, 3),
so that one run of two sliding-window blocks sits between them (d_model 128,
4 heads over 2 kv heads, 2 SSM heads of 128 channels, state 16, chunk 32, 8
meta tokens, window 64), runs in fp32 with the JAX model's parameters carried
over by ``params_from_jax``.  Batches of 80 tokens are drawn with numpy from
a seed and fed to both sides: with the meta tokens that is 88 positions, so
the window of 64 bites and the scan pads 88 to 3 chunks of 32.  On the CPU
the port's scan takes the kernels' plain versions, forward and backward
(``kernels/ref.py``); the JAX side is the XLA model, whose ``ssd_scan`` the
Pallas kernel tiles.  The plain 2-layer smoke config, whose run between the
two global layers holds no block, goes through the launcher.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import SamplerState as JSamplerState
from repro.train import config_digest as jconfig_digest
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS
from repro_torch.configs.base import HybridConfig, ModelConfig
from repro_torch.launch import train as port_train
from repro_torch.models import Hymba, build_model
from repro_torch.models import params as PM
from repro_torch.train import (
    AdamWConfig,
    CheckpointManager,
    SamplerState,
    config_digest,
    init_opt_state,
    make_eval_step,
    make_train_step,
)

ARCH = "hymba-1.5b"


def _four_layers(cfg):
    return dataclasses.replace(cfg, n_layers=4, hybrid=dataclasses.replace(
        cfg.hybrid, global_layers=(0, 3)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return PM.params_from_jax(_np(tree), device="cpu", dtype=None)


def _batch(vocab, shape=(2, 80), seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    return {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}, jb


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax fp32 params, port model, port params) for the 4-layer smoke config."""
    jcfg = _four_layers(JARCHS[ARCH].smoke())
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    model = build_model(_four_layers(ARCHS[ARCH].smoke()), device="cpu")
    return jmodel, jparams, model, _port(jparams)


def _layout_paths(jlayout):
    flat = jax.tree_util.tree_flatten_with_path(
        jlayout, is_leaf=lambda x: isinstance(x, JPM.ParamInfo))[0]
    return {"/".join(k.key for k in path): info for path, info in flat}


def _port_paths(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_port_paths(tree[k], prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tree[k]
    return out


CONFIGS = {
    "full": (lambda c: c),
    "smoke": (lambda c: c.smoke()),
    "smoke4": (lambda c: _four_layers(c.smoke())),
}


@pytest.mark.parametrize("which", list(CONFIGS))
def test_config_and_digest_match_jax(which):
    cfg, jcfg = CONFIGS[which](ARCHS[ARCH]), CONFIGS[which](JARCHS[ARCH])
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert [f.name for f in dataclasses.fields(HybridConfig)] == \
        [f.name for f in dataclasses.fields(type(jcfg.hybrid))]
    assert dataclasses.asdict(cfg.hybrid) == dataclasses.asdict(jcfg.hybrid)
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    assert {n: getattr(cfg, n) for n in names if n not in ("ssm", "hybrid")} == \
        {n: getattr(jcfg, n) for n in names if n not in ("ssm", "hybrid")}
    assert repr(cfg) == repr(jcfg)
    assert config_digest(cfg) == jconfig_digest(jcfg)


@pytest.mark.parametrize("which", list(CONFIGS))
def test_layout_matches_jax(which):
    """Leaf for leaf, name, shape, initializer and scale of the JAX layout,
    the zero-size run of the 2-layer smoke config included."""
    jcfg = CONFIGS[which](JARCHS[ARCH])
    model = Hymba(CONFIGS[which](ARCHS[ARCH]), device="cpu")
    want = _layout_paths(jbuild_model(jcfg, mesh=None).layout())
    got = _port_paths(model.layout())
    assert list(got) == list(want)
    for name, info in got.items():
        j = want[name]
        assert (info.shape, info.init, info.scale) == (j.shape, j.init, j.scale), name
    if which == "smoke":
        assert got["swa_0/wq"].shape[0] == 0


def test_full_config_holds_1_66_billion_parameters():
    layout = Hymba(ARCHS[ARCH], device="cpu").layout()
    total = sum(int(np.prod(i.shape)) for i in PM.tree_leaves(layout))
    assert total == JPM.param_count(jbuild_model(JARCHS[ARCH], mesh=None).layout())
    assert 1.65e9 < total < 1.67e9
    assert [layout[f"swa_{i}"]["wq"].shape[0] for i in range(2)] == [14, 15]


def test_params_from_jax_keeps_layout(pair):
    _, jparams, model, params = pair
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    port = _port_paths(params)
    assert list(port) == ["/".join(k.key for k in path) for path, _ in jflat]
    assert [tuple(t.shape) for t in port.values()] == \
        [i.shape for i in PM.tree_leaves(model.layout())]
    for (_, leaf), t in zip(jflat, port.values()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_loss_and_grads_match_jax(pair):
    jmodel, jparams, model, params = pair
    batch, jbatch = _batch(model.cfg.vocab)
    (jloss, jaux), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(jparams, jbatch)
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, aux = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, PM.tree_leaves(leaves))
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert abs(float(aux["nll"].detach()) - float(jaux["nll"])) < 1e-5
    assert float(aux["aux"]) == 0.0
    jleaves = jax.tree.leaves(jgrads)
    assert [tuple(g.shape) for g in grads] == [j.shape for j in jleaves]
    for g, j in zip(grads, jleaves):
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_eval_step_is_the_loss(pair):
    _, _, model, params = pair
    batch, _ = _batch(model.cfg.vocab, seed=5)
    metrics = make_eval_step(model)(params, batch)
    loss, _ = model.loss(params, batch)
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()))


def test_prefill_matches_jax(pair):
    jmodel, jparams, model, params = pair
    toks = np.random.default_rng(7).integers(0, model.cfg.vocab, (2, 100), dtype=np.int32)
    got = model.prefill(params, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 1, model.cfg.vocab) and got.dtype == torch.float32
    want = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_three_train_steps_match_jax(pair):
    jmodel, jparams, model, _ = pair
    cfg = JAdamWConfig(lr=1e-3, warmup_steps=2)
    jstate = jinit_opt_state(jparams, cfg)
    params, state = _port(jparams), _port(jstate)
    jstep = jax.jit(jmake_train_step(jmodel, cfg))
    step = make_train_step(model, AdamWConfig(**dataclasses.asdict(cfg)))
    jp = jparams
    for i in range(3):
        batch, jbatch = _batch(model.cfg.vocab, seed=i)
        jp, jstate, jm = jstep(jp, jstate, jbatch)
        params, state, m = step(params, state, batch)
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= 1e-4, (i, name)
    got, want = PM.tree_leaves(params), jax.tree.leaves(jp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_jax_checkpoint_restores_in_the_port(tmp_path, pair):
    """fp32: a JAX-written Hymba checkpoint restores in the port leaf for leaf,
    and a port-written one in JAX."""
    _, jparams, _, _ = pair
    jopt = jinit_opt_state(jparams, JAdamWConfig())
    jopt["count"] = jnp.asarray(4, jnp.int32)
    JCheckpointManager(str(tmp_path / "jax"), async_write=False).save(
        4, jparams, jopt, sampler=JSamplerState(1, 2, 3))
    params, opt = _port(jparams), _port(jopt)
    template = {"params": PM.tree_map(torch.zeros_like, params),
                "opt": PM.tree_map(torch.zeros_like, opt)}
    step, p, o, sampler = CheckpointManager(str(tmp_path / "jax")).restore(template=template)
    assert step == 4 and sampler == SamplerState(1, 2, 3) and o["count"].dtype == torch.int32
    for a, b in zip(PM.tree_leaves({"params": p, "opt": o}),
                    jax.tree.leaves({"params": jparams, "opt": jopt})):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    CheckpointManager(str(tmp_path / "port"), async_write=False).save(5, params, opt)
    jstep, jp, jo, _ = JCheckpointManager(str(tmp_path / "port")).restore(
        template={"params": jparams, "opt": jopt})
    assert jstep == 5
    for a, b in zip(PM.tree_leaves({"params": params, "opt": opt}),
                    jax.tree.leaves({"params": jp, "opt": jo})):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_empty_run_takes_zero_gradients_and_updates():
    """The 2-layer smoke config's ``swa_0`` holds no block: its zero-size leaves
    get zero-size gradients, AdamW passes them through, and the loss matches
    JAX's, which scans over the empty run."""
    jcfg = JARCHS[ARCH].smoke()
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(1), jcfg.dtype)
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    params = _port(jparams)
    assert params["swa_0"]["w_in"].shape == (0, 128, 512)
    batch, jbatch = _batch(model.cfg.vocab, shape=(1, 40), seed=3)
    opt = init_opt_state(params, AdamWConfig())
    params, opt, m = make_train_step(model)(params, opt, batch)
    jloss, _ = jmodel.loss(jparams, jbatch)
    assert abs(float(m["loss"]) - float(jloss)) < 1e-5
    assert params["swa_0"]["w_in"].shape == (0, 128, 512)
    assert opt["mu"]["swa_0"]["w_in"].shape == (0, 128, 512) and int(opt["count"]) == 1


# ------------------------------------------------------------------ decode
def _decode_cfg(cfg):
    """The 4-layer smoke config with a window of 8: a ring of 8 slots in the
    sliding-window blocks, so that 20 decode steps wrap it."""
    cfg = _four_layers(cfg.smoke())
    return dataclasses.replace(cfg, hybrid=dataclasses.replace(cfg.hybrid, sliding_window=8))


@pytest.fixture(scope="module")
def decode_pair(pair):
    """``pair``'s weights (the window leaves the layout as it is) in models of
    the window-8 config."""
    _, jparams, _, params = pair
    jmodel = jbuild_model(_decode_cfg(JARCHS[ARCH]), mesh=None)
    return jmodel, jparams, build_model(_decode_cfg(ARCHS[ARCH]), device="cpu"), params


def _random_cache(jmodel, B, S, seed):
    """A JAX cache tree of the layout's shapes, drawn with numpy (fp32)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda i: rng.normal(size=i.shape).astype(np.float32),
                        jmodel.cache_layout(B, S), is_leaf=lambda x: isinstance(x, JPM.ParamInfo))


def test_decode_steps_match_jax_through_a_ring_wrap(decode_pair):
    """20 steps from index ``meta_tokens`` (8) on a random cache of 32 slots: the
    ring of 8 slots wraps twice.  Logits within 1e-4 at every step, every cache
    leaf at the end, and the cache is the one handed in, updated in place."""
    jmodel, jparams, model, params = decode_pair
    B, S, nm = 2, 32, model.cfg.hybrid.meta_tokens
    cache_np = _random_cache(jmodel, B, S, seed=4)
    jcache = jax.tree.map(jnp.asarray, cache_np)
    cache = PM.cache_from_jax(cache_np, model.cache_layout(B, S), device="cpu", dtype="float32")
    toks = np.random.default_rng(11).integers(0, model.cfg.vocab, (B, 20), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(20):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(nm + t)})
        logits, out = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                 "cache": cache, "index": nm + t})
        assert out is cache
        assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    got, want = _port_paths(cache), _layout_paths(_np(jcache))
    assert list(got) == list(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_cache_layout_matches_jax_in_bf16():
    """Shapes and per-leaf dtypes of a bf16 model's cache: k, v and conv in
    bf16, the SSM state in fp32, as JAX's ``abstract`` gives them."""
    cfg = dataclasses.replace(_decode_cfg(ARCHS[ARCH]), dtype="bfloat16")
    jcfg = dataclasses.replace(_decode_cfg(JARCHS[ARCH]), dtype="bfloat16")
    want = _layout_paths(JPM.abstract(jbuild_model(jcfg, mesh=None).cache_layout(3, 40),
                                      "bfloat16"))
    got = _port_paths(build_model(cfg, device="cpu").init_cache(3, 40))
    assert list(got) == list(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
        assert not t.any()
    assert got["global_0/ssm"].dtype == torch.float32 and got["swa_0/k"].shape[3] == 8


def test_cache_from_jax_carries_mixed_ranks_and_dtypes():
    """A bf16 JAX cache (3- to 5-dim leaves, bf16 beside fp32) carries over
    leaf by leaf in each leaf's layout dtype; a leaf of another shape or a
    missing key raises."""
    cfg = dataclasses.replace(_decode_cfg(ARCHS[ARCH]), dtype="bfloat16")
    jcfg = dataclasses.replace(_decode_cfg(JARCHS[ARCH]), dtype="bfloat16")
    jmodel, model = jbuild_model(jcfg, mesh=None), build_model(cfg, device="cpu")
    jcache = JPM.materialize(jmodel.cache_layout(2, 16), jax.random.PRNGKey(0), "bfloat16")
    rng = np.random.default_rng(6)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jcache)
    layout = model.cache_layout(2, 16)
    cache = PM.cache_from_jax(_np(jcache), layout, device="cpu", dtype=model.dtype)
    got, want = _port_paths(cache), _layout_paths(_np(jcache))
    assert {t.ndim for t in got.values()} == {3, 4, 5}
    for name, t in got.items():
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(want[name], np.float32))
    bad = _np(jcache)
    bad["global_0"]["k"] = bad["global_0"]["k"][:, :, :8]
    with pytest.raises(ValueError, match="shape"):
        PM.cache_from_jax(bad, layout, device="cpu", dtype=model.dtype)
    del bad["global_1"]
    with pytest.raises(ValueError, match="keys"):
        PM.cache_from_jax(bad, layout, device="cpu", dtype=model.dtype)


def test_decode_step_hands_every_block_one_valid_len_per_cache_length(decode_pair, monkeypatch):
    """One int32 (B,) valid_len a step for each cache length (32 global slots,
    the ring of 8), the same tensor in every block of that length, and the
    window left to the ring (``window=0``)."""
    from repro_torch.models import hymba as port_hymba
    from repro_torch.models import layers

    jmodel, jparams, model, params = decode_pair
    seen = []

    def spy(q, k_cache, v_cache, valid_len, *, window=0):
        seen.append((k_cache.shape[2], valid_len, window))
        return layers.decode_attention(q, k_cache, v_cache, valid_len, window=window)

    monkeypatch.setattr(port_hymba, "decode_attention", spy)
    B, S = 2, 32
    cache = model.init_cache(B, S)
    for index in (0, 7, 8, 21):
        seen.clear()
        model.decode_step(params, {"tokens": torch.zeros((B, 1), dtype=torch.int64),
                                   "cache": cache, "index": index})
        assert [s for s, _, _ in seen] == [S, 8, 8, S] and {w for *_, w in seen} == {0}
        by_len = {s: {id(v) for s2, v, _ in seen if s2 == s} for s in (S, 8)}
        assert all(len(ids) == 1 for ids in by_len.values())
        for s, v, _ in seen:
            assert v.dtype == torch.int32 and v.tolist() == [min(index + 1, s)] * B


def test_decode_past_the_global_cache_raises(decode_pair):
    """The ring of the window layers wraps, but the global layers' cache ends:
    JAX's ``dynamic_update_slice`` would clamp the index, the port raises."""
    _, _, model, params = decode_pair
    cache = model.init_cache(1, 12)
    tok = torch.zeros((1, 1), dtype=torch.int64)
    model.decode_step(params, {"tokens": tok, "cache": cache, "index": 11})
    with pytest.raises(IndexError):
        model.decode_step(params, {"tokens": tok, "cache": cache, "index": 12})


def test_greedy_generate_matches_jax(decode_pair):
    """Greedy tokens of the serving engines, 3 prompts of 12 tokens and 8 new
    ones through a ring of 8 slots: the port's equal the JAX engine's."""
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServingEngine as JServingEngine
    from repro_torch.serve import ServeConfig, ServingEngine

    jmodel, jparams, model, params = decode_pair
    prompts = np.random.default_rng(9).integers(0, model.cfg.vocab, (3, 12), dtype=np.int32)
    jout = JServingEngine(jmodel, jparams, cache_len=28, batch=3).generate(
        prompts, JServeConfig(max_new_tokens=8))
    out = ServingEngine(model, params, cache_len=28, batch=3).generate(
        prompts, ServeConfig(max_new_tokens=8))
    assert out.dtype == np.int32 and out.shape == (3, 8)
    np.testing.assert_array_equal(out, np.asarray(jout))


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve as port_serve

    res = port_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                           "--prompt-len", "4", "--new-tokens", "3"])
    assert res["tokens"].shape == (2, 3) and res["steps"] == 7
    assert 0 <= res["tokens"].min() and res["tokens"].max() < ARCHS[ARCH].smoke().vocab
    assert "tok/s" in capsys.readouterr().out


def test_train_launcher_on_cpu_smoke_config(tmp_path):
    """``--arch hymba-1.5b`` through the launcher at the 2-layer smoke config
    (an empty ``swa_0``; seq 64 + 8 meta tokens padded to 3 chunks of 32):
    finite losses, and a checkpoint whose digest is the JAX config's and whose
    empty run restores with its shape."""
    res = port_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq", "64", "--ckpt-dir", str(tmp_path)])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["restarts"] == 0 and res["final_step"] == 2
    manifest = json.loads((tmp_path / "step_000002" / "manifest.json").read_text())
    assert manifest["config_digest"] == jconfig_digest(JARCHS[ARCH].smoke())
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = init_opt_state(params, AdamWConfig())
    step, p, _, _ = CheckpointManager(str(tmp_path)).restore(
        template={"params": params, "opt": opt})
    assert step == 2 and p["swa_0"]["wq"].shape == (0, 128, 128)
    assert not torch.equal(p["global_0"]["wq"], params["global_0"]["wq"])
