"""The port's xLSTM training path on the CPU, held against the JAX package.

The smoke config of xlstm-1.3b (4 layers: 3 mLSTM blocks and 1 sLSTM block,
d_model 128, 4 heads, chunk 32) runs in fp32 with the JAX model's parameters
carried over by ``params_from_jax``; batches are drawn with numpy from a seed
and fed to both sides.  On the CPU the port's mLSTM core takes the kernels'
plain versions, forward and backward (``kernels/ref.py``); the JAX side is
the XLA model, whose ``mlstm_chunked`` the Pallas kernel tiles.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import config_digest as jconfig_digest
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.launch import train as port_train
from repro_torch.models import XLSTM, build_model
from repro_torch.models import params as PM
from repro_torch.train import AdamWConfig, config_digest, make_eval_step, make_train_step

ARCH = "xlstm-1.3b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return PM.params_from_jax(_np(tree), device="cpu", dtype=None)


def _batch(vocab, shape=(2, 64), seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, shape).astype(np.int32)
    labels = rng.integers(0, vocab, shape).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    return {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}, jb


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax fp32 params, port model, port params) for the smoke config."""
    jcfg = JARCHS[ARCH].smoke()
    jmodel = jbuild_model(jcfg, mesh=None)
    jparams = JPM.materialize(jmodel.layout(), jax.random.PRNGKey(0), jcfg.dtype)
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    return jmodel, jparams, model, _port(jparams)


def _layout_paths(jlayout):
    flat = jax.tree_util.tree_flatten_with_path(jlayout, is_leaf=lambda x: isinstance(x, JPM.ParamInfo))[0]
    return {"/".join(k.key for k in path): info for path, info in flat}


def _port_paths(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_port_paths(tree[k], prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tree[k]
    return out


@pytest.mark.parametrize("full", [False, True])
def test_config_and_digest_match_jax(full):
    cfg = ARCHS[ARCH] if full else ARCHS[ARCH].smoke()
    jcfg = JARCHS[ARCH] if full else JARCHS[ARCH].smoke()
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    assert {n: getattr(cfg, n) for n in names if n != "ssm"} == \
        {n: getattr(jcfg, n) for n in names if n != "ssm"}
    assert [f.name for f in dataclasses.fields(SSMConfig)] == \
        [f.name for f in dataclasses.fields(type(jcfg.ssm))]
    assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
    assert repr(cfg) == repr(jcfg)
    assert config_digest(cfg) == jconfig_digest(jcfg)


@pytest.mark.parametrize("full", [False, True])
def test_layout_matches_jax(full):
    """Leaf for leaf, name, shape, initializer and scale of the JAX layout."""
    jcfg = JARCHS[ARCH] if full else JARCHS[ARCH].smoke()
    model = XLSTM(ARCHS[ARCH] if full else ARCHS[ARCH].smoke(), device="cpu")
    want = _layout_paths(jbuild_model(jcfg, mesh=None).layout())
    got = _port_paths(model.layout())
    assert list(got) == list(want)
    for name, info in got.items():
        j = want[name]
        assert (info.shape, info.init, info.scale) == (j.shape, j.init, j.scale), name


def test_full_config_holds_2_92_billion_parameters():
    layout = XLSTM(ARCHS[ARCH], device="cpu").layout()
    total = sum(int(np.prod(i.shape)) for i in PM.tree_leaves(layout))
    assert total == JPM.param_count(jbuild_model(JARCHS[ARCH], mesh=None).layout())
    assert 2.91e9 < total < 2.93e9


def test_init_params_follow_jax_rules():
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    a = model.init_params(torch.Generator().manual_seed(3))
    b = model.init_params(torch.Generator().manual_seed(3))
    for x, y in zip(PM.tree_leaves(a), PM.tree_leaves(b)):
        assert torch.equal(x, y)
    m = a["groups"]["mlstm"]
    assert torch.equal(m["b_f"], torch.ones_like(m["b_f"]))     # "ones" ignores scale=3.0
    assert torch.count_nonzero(m["b_i"]) == 0
    assert torch.equal(a["final_ln"], torch.ones(model.cfg.d_model))
    assert abs(float(m["conv"].std()) - 0.3) < 0.03
    assert abs(float(a["groups"]["slstm"]["r_gates"].std()) - 0.02) < 2e-3
    assert abs(float(m["w_up"].std()) - model.cfg.d_model ** -0.5) < 0.01


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
    toks = np.random.default_rng(7).integers(0, model.cfg.vocab, (2, 96), dtype=np.int32)
    got = model.prefill(params, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 1, model.cfg.vocab) and got.dtype == torch.float32
    want = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_three_train_steps_match_jax(pair):
    """AdamW's eps is 1e-5 here, in both packages: a few gradient entries of
    this model lie at fp32 rounding level (|g| ~ 1e-7 against a largest entry
    of 0.05), where the two packages' sums may differ in sign, and with the
    default eps of 1e-8 the first update moves such an entry by about +lr or
    -lr, a difference that no tolerance on the step would then hide."""
    jmodel, jparams, model, _ = pair
    cfg = JAdamWConfig(lr=1e-3, warmup_steps=2, eps=1e-5)
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


def test_sequence_must_be_whole_chunks(pair):
    """No padding, as in the JAX form: 40 tokens are not whole chunks of 32."""
    _, _, model, params = pair
    batch, _ = _batch(model.cfg.vocab, shape=(1, 40))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        model.loss(params, batch)
    short, _ = _batch(model.cfg.vocab, shape=(1, 16))      # one chunk of 16
    assert torch.isfinite(model.loss(params, short)[0])


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("start", ["zero", "random"])
def test_mlstm_decode_matches_jax(start):
    """One mLSTM step on numpy-drawn inputs, from the zero state (as a cache
    starts) and from a random one: h, C, n and m within 1e-4 of JAX, and C, n
    and m updated in place."""
    from repro.models.xlstm import mlstm_decode as jmlstm_decode
    from repro_torch.models.xlstm import mlstm_decode

    rng = np.random.default_rng(21)
    B, H, dqk, dv = 2, 3, 8, 16
    q, k = (rng.normal(size=(B, H, dqk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, H, dv)).astype(np.float32)
    i_raw = rng.normal(size=(B, H)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rng.normal(size=(B, H)) - 2))).astype(np.float32)
    if start == "zero":
        state = [np.zeros((B, H, dqk, dv), np.float32), np.zeros((B, H, dqk), np.float32),
                 np.zeros((B, H), np.float32)]
    else:
        state = [rng.normal(size=(B, H, dqk, dv)).astype(np.float32),
                 rng.normal(size=(B, H, dqk)).astype(np.float32),
                 rng.normal(size=(B, H)).astype(np.float32)]
    jh, jstate = jmlstm_decode(*map(jnp.asarray, (q, k, v, i_raw, log_f)),
                               tuple(map(jnp.asarray, state)))
    tstate = tuple(torch.from_numpy(a.copy()) for a in state)
    h, out = mlstm_decode(*map(torch.from_numpy, (q, k, v, i_raw, log_f)), tstate)
    assert all(a is b for a, b in zip(out, tstate))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    for got, want in zip(out, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _decode(model, params, cache, toks, t):
    return model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
                                      "cache": cache, "index": t})


def test_decode_steps_match_jax(pair):
    """16 steps from the zero cache: logits within 1e-4 at every step, every
    state leaf at the end; the cache keeps its storage from step to step."""
    jmodel, jparams, model, params = pair
    B = 2
    jcache = JPM.materialize(jmodel.cache_layout(B, 16), jax.random.PRNGKey(0), "float32")
    cache = PM.cache_from_jax(_np(jcache), model.cache_layout(B, 16), device="cpu",
                              dtype="float32")
    ptrs = [t.data_ptr() for t in PM.tree_leaves(cache)]
    toks = np.random.default_rng(11).integers(0, model.cfg.vocab, (B, 16), dtype=np.int32)
    jdecode = jax.jit(jmodel.decode_step)
    for t in range(16):
        jlogits, jcache = jdecode(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                            "cache": jcache, "index": jnp.asarray(t)})
        logits, out = _decode(model, params, cache, toks, t)
        assert out is cache
        assert logits.shape == (B, 1, model.cfg.vocab) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert [t.data_ptr() for t in PM.tree_leaves(cache)] == ptrs
    got, want = _port_paths(cache), _layout_paths(_np(jcache))
    assert list(got) == list(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_decode_matches_own_prefill(pair):
    """Feeding 32 tokens one by one through ``decode_step`` reproduces the
    port's ``prefill`` logits at the last position (tests/test_models.py:64):
    the decode state's m starts at 0, the chunked scan's at -1e30, and the
    stabiliser cancels from h."""
    _, _, model, params = pair
    toks = np.random.default_rng(8).integers(0, model.cfg.vocab, (2, 32), dtype=np.int32)
    want = model.prefill(params, {"tokens": torch.from_numpy(toks).long()})
    cache = model.init_cache(2, 32)
    for t in range(32):
        logits, cache = _decode(model, params, cache, toks, t)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


def test_cache_layout_matches_jax_in_bf16():
    """Per-leaf dtypes of a bf16 model's state: the conv tails in bf16, C, n, m
    and the sLSTM state in fp32 (6-dim C), as JAX's ``abstract`` gives them."""
    cfg = dataclasses.replace(ARCHS[ARCH].smoke(), dtype="bfloat16")
    jmodel = jbuild_model(dataclasses.replace(JARCHS[ARCH].smoke(), dtype="bfloat16"), mesh=None)
    want = _layout_paths(JPM.abstract(jmodel.cache_layout(3, 64), "bfloat16"))
    got = _port_paths(build_model(cfg, device="cpu").init_cache(3, 64))
    assert list(got) == list(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
        assert not t.any()
    assert got["groups/mlstm/C"].ndim == 6 and got["groups/mlstm/C"].dtype == torch.float32
    assert got["groups/mlstm/conv"].dtype == torch.bfloat16


def test_cache_from_jax_carries_the_six_dim_state():
    """A bf16 JAX state tree (4- to 6-dim leaves, fp32 beside bf16) carries over
    in each leaf's layout dtype, values unchanged."""
    jmodel = jbuild_model(dataclasses.replace(JARCHS[ARCH].smoke(), dtype="bfloat16"), mesh=None)
    model = build_model(dataclasses.replace(ARCHS[ARCH].smoke(), dtype="bfloat16"), device="cpu")
    rng = np.random.default_rng(2)
    jcache = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype),
                          JPM.abstract(jmodel.cache_layout(2, 8), "bfloat16"))
    cache = PM.cache_from_jax(_np(jcache), model.cache_layout(2, 8), device="cpu",
                              dtype=model.dtype)
    got, want = _port_paths(cache), _layout_paths(_np(jcache))
    assert {t.ndim for t in got.values()} == {4, 5, 6}
    for name, t in got.items():
        assert str(t.dtype).removeprefix("torch.") == str(want[name].dtype), name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(want[name], np.float32))


def test_greedy_generate_matches_jax(pair):
    """Greedy tokens of the serving engines, 3 prompts of 12 tokens, 8 new ones."""
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServingEngine as JServingEngine
    from repro_torch.serve import ServeConfig, ServingEngine

    jmodel, jparams, model, params = pair
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


def test_train_launcher_on_cpu_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    """``--arch xlstm-1.3b`` through the launcher: steps, checkpoints, and after an
    injected fault a restart that resumes from the last checkpoint."""
    argv = ["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    res = port_train.main(argv)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["restarts"] == 0 and res["final_step"] == 2
    manifest = json.loads((tmp_path / "step_000002" / "manifest.json").read_text())
    assert manifest["config_digest"] == jconfig_digest(JARCHS[ARCH].smoke())

    real_step = port_train.make_train_step
    crashed = []

    def flaky_step(*a, **k):
        fn = real_step(*a, **k)

        def step(*args):
            if not crashed:
                crashed.append(1)
                raise RuntimeError("injected fault")
            return fn(*args)
        return step

    monkeypatch.setattr(port_train, "make_train_step", flaky_step)
    res = port_train.main(argv[:5] + ["3"] + argv[6:])
    assert res["restarts"] == 1 and "[restore] resumed from step 2" in capsys.readouterr().out
    assert len(res["losses"]) == 1 and res["final_step"] == 3
    assert sorted(os.listdir(tmp_path)) == ["step_000001", "step_000002", "step_000003"]
