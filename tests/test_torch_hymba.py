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


def test_decoding_names_its_slice(pair):
    _, _, model, params = pair
    for call in (lambda: model.cache_layout(1, 8), lambda: model.decode_step(params, {})):
        with pytest.raises(NotImplementedError, match="Hymba decode slice"):
            call()


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
