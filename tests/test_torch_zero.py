"""Data-parallel training with ZeRO-1 in a spawned world of 4 CPU ranks
(``gloo``), mesh pod 2 x data 2 x model 1, on the qwen1.5-0.5b smoke config
in fp32, against JAX's single-device step on the global batch and the port's
own single-process gradient and update.

One world (``world`` fixture, at most 90 s) runs the step in parts and
whole, a second step, a ZeRO checkpoint and its restore at data 4 over the
same ranks, and the refusals (a model not built over the mesh's model axis
or, for MoE, over its data axes); the tests read what it returned.  Weights come
from JAX (``params_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import zero_world
from repro.configs import ARCHS as JARCHS
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.train import AdamWConfig, CheckpointManager, init_opt_state, make_train_step

ARCH = "qwen1.5-0.5b"
BATCH = (8, 32)


def _batch(vocab):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, vocab, BATCH).astype(np.int64),
            "labels": rng.integers(0, vocab, BATCH).astype(np.int64)}


@pytest.fixture(scope="module")
def setup():
    jcfg = JARCHS[ARCH].smoke()
    jparams = JPM.materialize(jbuild_model(jcfg).layout(), jax.random.PRNGKey(0), jcfg.dtype)
    return jcfg, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    _, jparams = setup
    cfg = ARCHS[ARCH].smoke()
    root = tmp_path_factory.mktemp("zero")
    outs = run_ranks(zero_world, 4, cfg, jparams, _batch(cfg.vocab), str(root / "ckpt"),
                     ARCHS["mixtral-8x7b"].smoke(), init_method=f"file://{root}/rendezvous",
                     timeout=90.0)
    return outs, str(root / "ckpt")


def test_global_loss_matches_jax_single_device_step(setup, world):
    jcfg, jparams = setup
    jmodel = jbuild_model(jcfg)
    batch = {k: jnp.asarray(v, jnp.int32) for k, v in _batch(jcfg.vocab).items()}
    params = jax.tree.map(jnp.asarray, jparams)
    _, _, m = jmake_train_step(jmodel, JAdamWConfig())(
        params, jinit_opt_state(params, JAdamWConfig()), batch)
    outs, _ = world
    for out in outs:
        assert abs(out["loss"] - float(m["loss"])) < 1e-5
        assert out["loss"] == outs[0]["loss"] and out["loss2"] == outs[0]["loss2"]
    assert np.mean([o["local_loss"] for o in outs]) == pytest.approx(outs[0]["loss"], abs=1e-6)


def test_ranks_take_their_rows_by_the_batch_spec(world):
    outs, _ = world
    tokens = _batch(ARCHS[ARCH].smoke().vocab)["tokens"]
    for out in outs:
        i = out["coords"]["pod"] * 2 + out["coords"]["data"]
        np.testing.assert_array_equal(out["rows"], tokens[2 * i:2 * i + 2])


def test_synced_gradient_matches_single_process_gradient(setup, world):
    _, jparams = setup
    cfg = ARCHS[ARCH].smoke()
    model = build_model(cfg, device="cpu")
    params = PM.params_from_jax(jparams, device="cpu", dtype=cfg.dtype)
    leaves = PM.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = model.loss(leaves, {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()})
    want = [g.numpy() for g in torch.autograd.grad(loss, PM.tree_leaves(leaves))]
    outs, _ = world
    for out in outs:
        got = PM.tree_leaves(out["synced"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


def test_zero_update_is_adamw_update_bit_for_bit(world):
    outs, _ = world
    for out in outs:
        assert out["update_equal"] and out["state_equal"] and out["grad_norm_equal"]
        assert out["shards_contiguous"] and out["sharded_leaves"] > 0
        assert out["call_equal"]


def test_parameters_equal_across_ranks(world):
    outs, _ = world
    for out in outs[1:]:
        for a, b in zip(PM.tree_leaves(out["params"]), PM.tree_leaves(outs[0]["params"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(PM.tree_leaves(out["synced"]), PM.tree_leaves(outs[0]["synced"])):
            np.testing.assert_array_equal(a, b)


def test_compressed_step_keeps_ranks_equal_and_its_residual(world):
    outs, _ = world
    for out in outs:
        c = out["compressed"]
        assert np.isfinite(c["loss"]) and c["loss"] == outs[0]["compressed"]["loss"]
        assert c["residual"] > 0
        first = PM.tree_leaves(outs[0]["compressed"]["params"])
        for a, b in zip(PM.tree_leaves(c["params"]), first):
            np.testing.assert_array_equal(a, b)
        # the update moved the parameters from the plain step's
        assert any(not np.array_equal(a, b) for a, b in
                   zip(PM.tree_leaves(c["params"]), PM.tree_leaves(out["params"])))


def test_elastic_restore_at_data_4_is_bit_for_bit(world):
    outs, _ = world
    for rank, out in enumerate(outs):
        assert out["wide_coords"] == {"pod": 0, "data": rank, "model": 0}
        assert out["restored_params_equal"] and out["restored_shards_equal"]
        assert out["restored_own_shards_equal"] and out["restored_count"] == 2


def test_elastic_restore_onto_one_device_in_either_package(world):
    outs, ckpt_dir = world
    cfg = ARCHS[ARCH].smoke()
    params = PM.params_from_jax(outs[0]["params"], device="cpu", dtype=None)
    template = {"params": params, "opt": init_opt_state(params, AdamWConfig())}
    step, p, o, _ = CheckpointManager(ckpt_dir).restore(template=template)
    assert step == 2 and int(o["count"]) == 2
    for a, b in zip(PM.tree_leaves(p), PM.tree_leaves(outs[0]["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    jtemplate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), template)
    _, jp, jo, _ = JCheckpointManager(ckpt_dir).restore(template=jtemplate)
    for a, b in zip(jax.tree.leaves({"params": jp, "opt": jo}), PM.tree_leaves({"opt": o,
                                                                                 "params": p})):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # one more single-device step from the restored state runs
    _, _, m = make_train_step(build_model(cfg, device="cpu"))(
        p, o, {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab).items()})
    assert np.isfinite(float(m["loss"]))


def test_tensor_parallel_and_data_parallel_moe_are_refused(world):
    """Refused unless the model was built over the mesh: a model axis of 2
    for a model built at model 1, and MoE over data ranks without the mesh
    that routes the global batch (both run when built over it:
    ``test_torch_tensor_parallel``, ``test_torch_moe_parallel``)."""
    outs, _ = world
    for out in outs:
        assert len(out["refused"]) == 2
        assert "model_axis=2 and this mesh" in out["refused"][0]
        assert "global batch" in out["refused"][1]

