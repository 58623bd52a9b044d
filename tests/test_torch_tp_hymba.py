"""Tensor-parallel training and serving of the port's Hymba over the
``model`` axis, in one spawned world of 4 CPU ranks (``gloo``) in fp32,
against JAX's single-device ``make_train_step``, ``prefill``,
``decode_step`` and ``ServingEngine`` on the same parameters
(``tests/_torch_tp_jax.py``).

The cases, each the smoke width with 3 layers (global layers 0 and 2, so one
sliding-window block runs): (a) 5 query heads over 1 kv head, 2 SSM heads
and a vocab of 511 at data 2 x model 2 and data 1 x model 4 (heads cut
inside a head, so every rank computes every head; the SSM heads dividing
the axis at 2 and not at 4, where every head is scanned from the gathered
channels; the embedding cut on d and ``lm_head`` row-parallel); (b) the
smoke's 4 / 2 heads with 4 SSM heads at data 2 x model 2 (each rank's own
heads, the fusion norms' rows cut, vocab-parallel).  Training: the loss, the
synced gradient gathered whole and the parameters after the step within
``TOL``, replicated leaves bit-equal in each model group.  Serving: logits
within 1e-4 of JAX's, every cache shard (the fp32 SSM state cut on its
channels, as JAX cuts it) equal to JAX's slots, at data 1 x model 4 a
teacher-forced run of 68 tokens past the window of 64 so that the ring
wraps, the engine's tokens JAX's on every rank.  A rank's train step, decode step and prefill count
the same on meta as real.  The deliberate differences from JAX's
arithmetic are pinned by ``test_heads_and_ssm_heads_each_rank_computes``
and ``test_ssm_in_projection_gives_each_rank_its_x_and_z_channels``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import tp_family_world
from _torch_tp_jax import case_inputs, check_against_jax, configs, jax_serve, jax_step
from repro.models import build_model as jbuild_model
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import AbstractMesh, run_ranks
from repro_torch.models import build_model
from repro_torch.models import params as PM

HYMBA = "hymba-1.5b"
TOL = dict(rtol=1e-4, atol=1e-4)
B = 4
#: name -> (overrides, SSM heads, seed, meshes)
CASES = {
    "a": ({"n_heads": 5, "n_kv_heads": 1, "vocab": 511}, 2, 0, ((2, 2), (1, 4))),
    "b": ({}, 4, 1, ((2, 2),)),
}
PARAMS = [(c, m) for c, v in CASES.items() for m in v[3]]
#: serving by mesh: (cache slots, tokens decoded teacher-forced); at data 1 x
#: model 4 a cache of 80 slots, the sliding-window ring 64 of them, and 68
#: tokens, so that the ring wraps
SERVED = {(2, 2): (16, 12), (1, 4): (80, 68)}
#: the engine's prompt and new tokens
PROMPT, NEW = 6, 6
#: the case whose train step, decode step (a cache of 16) and prefill are counted
COUNTED = ("a", (2, 2), 8, 16)


def _name(case: str, mesh: tuple) -> str:
    return f"{case}@{mesh[0]}x{mesh[1]}"


def _configs(over: dict, nsh: int) -> tuple:
    """(JAX config, port config): the smoke config at 3 layers, global 0 and 2."""
    return tuple(dataclasses.replace(c, hybrid=dataclasses.replace(
        c.hybrid, global_layers=(0, 2), n_ssm_heads=nsh))
        for c in configs(HYMBA, n_layers=3, **over))


@pytest.fixture(scope="module")
def setup():
    out = {}
    for case, (over, nsh, seed, _) in CASES.items():
        jcfg, cfg = _configs(over, nsh)
        jparams, batch = case_inputs(jcfg, seed)
        rng = np.random.default_rng(seed + 10)
        tokens = rng.integers(0, jcfg.vocab, (B, max(n for _, n in SERVED.values())))
        serve = {m: {"tokens": tokens[:, :n].astype(np.int64), "prompt": PROMPT, "new": NEW,
                     "cache_len": slots} for m, (slots, n) in SERVED.items()}
        out[case] = (jcfg, cfg, jparams, batch, serve)
    return out


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory):
    """The world of 4 ranks, started on a thread while JAX computes the oracle."""
    root = tmp_path_factory.mktemp("tp_hymba")
    train = [(_name(c, m), m, setup[c][1], setup[c][2], setup[c][3]) for c, m in PARAMS]
    serve = [(_name(c, m), m, setup[c][1], setup[c][2], setup[c][4][m]) for c, m in PARAMS]
    case, mesh, b, s = COUNTED
    count = (mesh, setup[case][1], setup[case][2], setup[case][3], b, s)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, tp_family_world, 4, train, serve, count,
                          init_method=f"file://{root}/rendezvous", timeout=240.0)


@pytest.fixture(scope="module")
def oracle(setup, started):
    return {case: {"train": jax_step(jcfg, jparams, batch),
                   **{m: jax_serve(jcfg, jparams, serve[m], B) for m in meshes}}
            for case, (jcfg, _, jparams, batch, serve) in setup.items()
            for meshes in [CASES[case][3]]}


@pytest.fixture(scope="module")
def world(started):
    return started.result()


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_step_matches_jax_single_device_step(case, mesh, setup, oracle, world):
    name = _name(case, mesh)
    check_against_jax([o[name] for o in world], oracle[case]["train"], setup[case][2])
    # the case really cut the leaves the spec cuts on the model axis
    assert any(s != tuple(w.shape) for s, w in zip(world[0][name]["shapes"].values(),
                                                   PM.tree_leaves(oracle[case]["train"]["grads"])))


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_prefill_matches_jax(case, mesh, oracle, world):
    want = oracle[case][mesh]["prefill"]
    for out in world:
        res = out[f"serve_{_name(case, mesh)}"]
        rows = want[slice(*res["rows"])]
        assert res["prefill"].dtype == np.float32 and res["prefill"].shape == rows.shape
        np.testing.assert_allclose(res["prefill"], rows, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_teacher_forced_decode_matches_jax(case, mesh, oracle, world):
    """Every step's logits and greedy token; at data 1 x model 4 past the
    window's 64 slots."""
    want = oracle[case][mesh]["steps"]
    for out in world:
        res = out[f"serve_{_name(case, mesh)}"]
        got, ref = res["steps"], want[:, slice(*res["rows"])]
        assert got.shape == ref.shape and got.shape[0] == SERVED[mesh][1]
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_cache_shards_match_jax_slots(case, mesh, setup, oracle, world):
    """Each rank's shard of every cache leaf against its slots and rows of
    JAX's cache after the last step: k and v cut on their slots (the ring's
    too), conv on its channels, the fp32 SSM state on its ``chd`` channels
    of every head, as JAX's specs cut them."""
    cfg = setup[case][1]
    nsh, chd = cfg.hybrid.n_ssm_heads, cfg.ssm.expand * cfg.d_model // cfg.hybrid.n_ssm_heads
    whole = PM.tree_map(lambda a: torch.from_numpy(np.array(a)), oracle[case][mesh]["cache"])
    for rank, out in enumerate(world):
        abstract = AbstractMesh(mesh, ("data", "model"), rank=rank)
        model = build_model(cfg, model_axis=mesh[1], mesh=abstract, device="meta")
        layout = model.cache_layout(B, SERVED[mesh][0])
        want = PM.shard_cache(whole, layout, abstract)
        got = out[f"serve_{_name(case, mesh)}"]["cache"]
        state = (B // mesh[0], nsh, chd // mesh[1], cfg.ssm.state_dim)
        assert got["global_0"]["ssm"].shape == state
        assert got["global_0"]["ssm"].dtype == np.float32
        for path, g, w, info in zip(PM._paths(got), PM.tree_leaves(got), PM.tree_leaves(want),
                                    PM.tree_leaves(layout)):
            assert g.shape == tuple(w.shape) != tuple(info.shape), path
            np.testing.assert_allclose(g, w.numpy(), err_msg=path, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_engine_generates_jax_tokens_on_every_rank(case, mesh, oracle, world):
    want = oracle[case][mesh]["generated"]
    for out in world:
        got = out[f"serve_{_name(case, mesh)}"]["generated"]
        assert got.dtype == np.int32 and got.shape == (B, NEW)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_meta_count_equals_a_real_ranks_count(kind, world):
    """The dry-run counts one rank's tensor-parallel train step, decode step
    and prefill on meta under an AbstractMesh; a real CPU rank's count is the
    same: FLOPs, traffic, kernel calls, collectives, the state it starts with."""
    kernel = {"train": "ssd_scan_bwd", "decode": "decode_attention", "prefill": "ssd_scan"}[kind]
    for out in world:
        real, meta = out["count"][kind]["real"], out["count"][kind]["meta"]
        assert real == meta
        assert real["collectives"]["all_gather"]["calls"] > 0
        assert real["kernels"][kernel]["calls"] == 3


def _recorded_forward(mesh_shape, rank, **over):
    """hymba-1.5b's full widths cut to 3 layers, one loss on meta over an
    AbstractMesh: the heads of each flash call's q and each SSD scan's x."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(ARCHS[HYMBA], n_layers=3, hybrid=dataclasses.replace(
        ARCHS[HYMBA].hybrid, global_layers=(0, 2), **over))
    mesh = AbstractMesh(mesh_shape, ("data", "model"), rank=rank)
    model = build_model(cfg, model_axis=mesh_shape[1], mesh=mesh, device="meta")
    layout = model.layout()
    params = PM.shard_params(PM.abstract(layout, cfg.dtype), layout, mesh)
    seen = {"flash": [], "ssd": []}
    flash, ssd = ops.flash_attention, ops.ssd_scan

    def rec_flash(q, *a, **k):
        seen["flash"].append(q.shape[1])
        return flash(q, *a, **k)

    def rec_ssd(lf, b, x, *a, **k):
        seen["ssd"].append(x.shape[2])
        return ssd(lf, b, x, *a, **k)

    ops.flash_attention, ops.ssd_scan = rec_flash, rec_ssd
    try:
        tokens = torch.empty((1, 64), dtype=torch.int64, device="meta")
        model.loss(params, {"tokens": tokens, "labels": tokens})
    finally:
        ops.flash_attention, ops.ssd_scan = flash, ssd
    return seen


@pytest.mark.parametrize("tp,nsh,ssd_heads", [(2, 8, 4), (4, 8, 2), (4, 5, 5), (16, 8, 8)])
def test_heads_and_ssm_heads_each_rank_computes(tp, nsh, ssd_heads):
    """Deliberate differences from JAX's partitioned arithmetic (the result is
    JAX's, the work is not): hymba-1.5b's 25 / 5 heads cut inside a head at
    model 2, 4 and 16, so every rank's flash calls take all 25 query heads;
    the SSM heads a rank scans are its own where they divide the axis (8 over
    2 and 4), every head where they do not (5 over 4, 8 over the dry-run's
    16)."""
    seen = _recorded_forward((1, tp), tp - 1, n_ssm_heads=nsh)
    assert seen["flash"] == [25] * 3
    assert seen["ssd"] == [ssd_heads] * 3


def test_ssm_in_projection_gives_each_rank_its_x_and_z_channels(world):
    """Deliberate difference: JAX's column cut of ``w_in`` over ``2 ed`` would
    leave all of x on the low ranks and all of z on the high ones; each rank
    gets its contiguous ``ed/tp`` channels of both (``regroup_columns``),
    at model 2 and at model 4."""
    for out in world:
        for name in ("a@2x2", "a@1x4"):
            got = out[name]["ssm_in"]
            np.testing.assert_array_equal(got["x"], got["want_x"])
            np.testing.assert_array_equal(got["z"], got["want_z"])
