"""Tensor-parallel training and serving of the port's xLSTM over the
``model`` axis, in one spawned world of 4 CPU ranks (``gloo``) in fp32,
against JAX's single-device ``make_train_step``, ``prefill``,
``decode_step`` and ``ServingEngine`` on the same parameters
(``tests/_torch_tp_jax.py``).

The cases, each the smoke config (4 layers: 3 mLSTM blocks and one sLSTM
block, chunk 32): (a) 4 heads and a vocab of 512 at data 2 x model 2 and
data 1 x model 4 (each rank scans its own heads; vocab-parallel); (b) 2
heads and a vocab of 511 at data 1 x model 4 (every rank scans every head;
the embedding cut on d and ``lm_head`` row-parallel).  Training: the loss,
the synced gradient gathered whole and the parameters after the step
within ``TOL``, replicated leaves bit-equal in each model group.  Serving:
logits within 1e-4 of JAX's, every cache shard equal to JAX's slots (mLSTM
``C`` and ``n`` cut on dqk, the conv tail on ed, the sLSTM state on dh), the
engine's tokens JAX's on every rank.  A rank's train step, decode step and
prefill count the same on meta as real.  The deliberate differences from
JAX's arithmetic are pinned by ``test_slstm_loop_makes_no_collective``,
``test_mlstm_heads_each_rank_scans`` and
``test_mlstm_decode_partials_sum_to_the_whole``.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_ranks import tp_family_world
from _torch_tp_jax import case_inputs, check_against_jax, configs, jax_serve, jax_step
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import AbstractMesh, run_ranks
from repro_torch.models import build_model
from repro_torch.models import params as PM

XLSTM = "xlstm-1.3b"
TOL = dict(rtol=1e-4, atol=1e-4)
B = 4
#: name -> (overrides, seed, meshes)
CASES = {
    "a": ({}, 0, ((2, 2), (1, 4))),
    "b": ({"n_heads": 2, "vocab": 511}, 1, ((1, 4),)),
}
PARAMS = [(c, m) for c, v in CASES.items() for m in v[2]]
#: serving: the cache's slots (the state is O(1) in them), tokens decoded
#: teacher-forced, the engine's prompt and new tokens
SLOTS, STEPS, PROMPT, NEW = 16, 8, 5, 4
#: the case whose train step, decode step (a cache of 16) and prefill are counted
COUNTED = ("a", (2, 2), 8, 16)


def _name(case: str, mesh: tuple) -> str:
    return f"{case}@{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def setup():
    out = {}
    for case, (over, seed, _) in CASES.items():
        jcfg, cfg = configs(XLSTM, **over)
        jparams, batch = case_inputs(jcfg, seed)
        tokens = np.random.default_rng(seed + 10).integers(0, jcfg.vocab, (B, STEPS))
        serve = {"tokens": tokens.astype(np.int64), "prompt": PROMPT, "new": NEW,
                 "cache_len": SLOTS}
        out[case] = (jcfg, cfg, jparams, batch, serve)
    return out


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory):
    """The world of 4 ranks, started on a thread while JAX computes the oracle."""
    root = tmp_path_factory.mktemp("tp_xlstm")
    train = [(_name(c, m), m, setup[c][1], setup[c][2], setup[c][3]) for c, m in PARAMS]
    serve = [(_name(c, m), m, setup[c][1], setup[c][2], setup[c][4]) for c, m in PARAMS]
    case, mesh, b, s = COUNTED
    count = (mesh, setup[case][1], setup[case][2], setup[case][3], b, s)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, tp_family_world, 4, train, serve, count,
                          init_method=f"file://{root}/rendezvous", timeout=240.0)


@pytest.fixture(scope="module")
def oracle(setup, started):
    return {case: {"train": jax_step(jcfg, jparams, batch),
                   "serve": jax_serve(jcfg, jparams, serve, B)}
            for case, (jcfg, _, jparams, batch, serve) in setup.items()}


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
    want = oracle[case]["serve"]["prefill"]
    for out in world:
        res = out[f"serve_{_name(case, mesh)}"]
        rows = want[slice(*res["rows"])]
        assert res["prefill"].dtype == np.float32 and res["prefill"].shape == rows.shape
        np.testing.assert_allclose(res["prefill"], rows, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_teacher_forced_decode_matches_jax(case, mesh, oracle, world):
    """Every step's logits and greedy token."""
    want = oracle[case]["serve"]["steps"]
    for out in world:
        res = out[f"serve_{_name(case, mesh)}"]
        got, ref = res["steps"], want[:, slice(*res["rows"])]
        assert got.shape == ref.shape and got.shape[0] == STEPS
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_cache_shards_match_jax_slots(case, mesh, setup, oracle, world):
    """Each rank's shard of every cache leaf against its slots and rows of
    JAX's cache after the last step: mLSTM ``C`` and ``n`` on their dqk, ``m``
    whole on every rank of a model group, the conv tail on its ed channels,
    the sLSTM ``c``, ``n``, ``m`` and ``h`` on their dh, as JAX's specs cut
    them."""
    cfg = setup[case][1]
    dv = cfg.ssm.expand * cfg.d_model // cfg.n_heads
    whole = PM.tree_map(lambda a: torch.from_numpy(np.array(a)), oracle[case]["serve"]["cache"])
    for rank, out in enumerate(world):
        abstract = AbstractMesh(mesh, ("data", "model"), rank=rank)
        model = build_model(cfg, model_axis=mesh[1], mesh=abstract, device="meta")
        layout = model.cache_layout(B, SLOTS)
        want = PM.shard_cache(whole, layout, abstract)
        got = out[f"serve_{_name(case, mesh)}"]["cache"]
        C = got["groups"]["mlstm"]["C"]
        assert C.shape[-2:] == (dv // 2 // mesh[1], dv) and C.dtype == np.float32
        for path, g, w, info in zip(PM._paths(got), PM.tree_leaves(got), PM.tree_leaves(want),
                                    PM.tree_leaves(layout)):
            assert g.shape == tuple(w.shape), path
            assert (g.shape != tuple(info.shape)) == ("model" in info.spec or mesh[0] > 1), path
            np.testing.assert_allclose(g, w.numpy(), err_msg=path, **TOL)


@pytest.mark.parametrize("case,mesh", PARAMS)
def test_engine_generates_jax_tokens_on_every_rank(case, mesh, oracle, world):
    want = oracle[case]["serve"]["generated"]
    for out in world:
        got = out[f"serve_{_name(case, mesh)}"]["generated"]
        assert got.dtype == np.int32 and got.shape == (B, NEW)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_meta_count_equals_a_real_ranks_count(kind, world):
    """The dry-run counts one rank's tensor-parallel train step, decode step
    and prefill on meta under an AbstractMesh; a real CPU rank's count is the
    same: FLOPs, traffic, kernel calls, collectives, the state it starts with."""
    kernel = {"train": "mlstm_scan_bwd", "decode": "swiglu", "prefill": "mlstm_scan"}[kind]
    for out in world:
        real, meta = out["count"][kind]["real"], out["count"][kind]["meta"]
        assert real == meta
        assert real["collectives"]["all_gather"]["calls"] > 0
        assert real["collectives"]["all_reduce"]["calls"] > 0
        assert real["kernels"][kernel]["calls"] == (1 if kind == "decode" else 3)


def _meta_train_step(mesh_shape, seq: int) -> dict:
    """The counts of rank 0's train step of the smoke config on meta over an
    AbstractMesh, for 8 rows of ``seq`` tokens."""
    from repro_torch.train.step import tp_step_costs

    cfg = ARCHS[XLSTM].smoke()
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    model = build_model(cfg, model_axis=mesh_shape[1], mesh=mesh, device="meta")
    tokens = torch.empty((8, seq), dtype=torch.int64, device="meta")
    return tp_step_costs(model, {"tokens": tokens, "labels": tokens}, mesh)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_slstm_loop_makes_no_collective(mesh_shape):
    """Deliberate difference from JAX's partitioned arithmetic: JAX cuts the
    sLSTM's recurrent weight on its input dh, so its recurrent product sums
    over the axis at every time step; the port gathers the cell's weights
    once a block and runs the whole loop on every rank.  A rank's train step
    makes as many collectives at 2S as at S, though the loop's products
    double."""
    short, long = _meta_train_step(mesh_shape, 32), _meta_train_step(mesh_shape, 64)
    assert ({k: c["calls"] for k, c in short["collectives"].items()}
            == {k: c["calls"] for k, c in long["collectives"].items()})
    assert short["collectives"]["all_gather"]["calls"] > 0
    assert long["flops"] > 1.9 * short["flops"]


@pytest.mark.parametrize("tp,heads,scanned", [(2, 4, 2), (4, 4, 1), (16, 4, 4), (4, 2, 2)])
def test_mlstm_heads_each_rank_scans(tp, heads, scanned):
    """Deliberate difference: xlstm-1.3b's full widths cut to one group of 8
    blocks; a rank's mLSTM scans take its own heads where they divide the
    axis (4 over 2 and 4), every head where they do not (4 over the
    dry-run's 16, 2 over 4), of which it keeps its columns of the output."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(ARCHS[XLSTM], n_layers=8, n_heads=heads)
    mesh = AbstractMesh((1, tp), ("data", "model"), rank=tp - 1)
    model = build_model(cfg, model_axis=tp, mesh=mesh, device="meta")
    layout = model.layout()
    params = PM.shard_params(PM.abstract(layout, cfg.dtype), layout, mesh)
    seen, scan = [], ops.mlstm_scan

    def record(q, *args, **kwargs):
        seen.append(q.shape[1])
        return scan(q, *args, **kwargs)

    ops.mlstm_scan = record
    try:
        tokens = torch.empty((1, 128), dtype=torch.int64, device="meta")
        model.prefill(params, {"tokens": tokens})
    finally:
        ops.mlstm_scan = scan
    assert seen == [scanned] * 7


def test_mlstm_decode_partials_sum_to_the_whole():
    """Deliberate difference: JAX's decode reads ``q C`` and ``q . n`` of the
    whole state; over a cut of dqk each rank forms them over its slice
    (``mlstm_decode_partial``, q scaled by the whole dqk) and the totals,
    summed in fp32 over the ranks, give ``mlstm_decode``'s h, while each
    rank's state shard is the slice of the whole state's update."""
    from repro_torch.models.xlstm import mlstm_decode, mlstm_decode_partial

    rng = np.random.default_rng(3)
    Bq, H, dqk, dv, tp = 2, 3, 16, 8, 4
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    q, k, v, i_raw = t(Bq, H, dqk), t(Bq, H, dqk), t(Bq, H, dv), t(Bq, H)
    log_f = torch.nn.functional.logsigmoid(t(Bq, H))
    C, n, m = t(Bq, H, dqk, dv), t(Bq, H, dqk), t(Bq, H)
    whole = (C.clone(), n.clone(), m.clone())
    h, _ = mlstm_decode(q, k, v, i_raw, log_f, whole)
    w = dqk // tp
    num, qn = 0, 0
    for r in range(tp):
        cut = slice(r * w, (r + 1) * w)
        shard = (C[:, :, cut].clone(), n[:, :, cut].clone(), m.clone())
        part, part_qn, m_new = mlstm_decode_partial(q[..., cut], k[..., cut], v, i_raw, log_f,
                                                    shard, dqk=dqk)
        num, qn = num + part, qn + part_qn
        torch.testing.assert_close(shard[0], whole[0][:, :, cut], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(shard[1], whole[1][:, :, cut], rtol=1e-6, atol=1e-6)
        assert torch.equal(shard[2], whole[2]) and torch.equal(m_new, whole[2])
    got = num / torch.maximum(qn.abs(), torch.exp(-whole[2]))[..., None]
    torch.testing.assert_close(got, h, rtol=1e-5, atol=1e-5)
