"""Tensor-parallel execution of the ``model`` axis in the port's DecoderLM,
in one spawned world of 4 CPU ranks (``gloo``) in fp32, against JAX's
single-device ``make_train_step`` on the global batch.

Each case cuts a JAX parameter tree into every rank's shards
(``params_from_jax`` + ``shard_params``) and takes a step of
``make_train_step(model, opt_cfg, mesh)``: its loss, its synced gradient
gathered whole, the parameters after the step and ``grad_norm`` are held to
JAX's (loss 1e-5, gradients 1e-4 of each leaf's largest entry, the update
1e-6), and every replicated leaf is bit-equal across each model group.  The
cases: (a) qwen-like (tied, the vocab divides, QKV bias) at data 2 x model 2
and data 1 x model 4; (b) internvl2-like (untied, a vocab of 511 that the
axis does not divide: embedding columns gathered, ``lm_head`` row-parallel);
(c) GQA whose kv heads the axis cuts inside a head (qwen3-like, qk-norm) and
queries cut inside a head too (6 heads on 4 ranks); (g) qwen-like under
remat "none", "dots" and "full".  The world also saves the ZeRO + TP state
of (a) and restores it at data 1 x model 4, counts one rank's step against
the dry-run's meta count of it (Hymba, Whisper and xLSTM:
``test_torch_tp_hymba.py``, ``test_torch_tp_encdec.py``,
``test_torch_tp_xlstm.py``).
"""

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_ranks import tp_world
from _torch_tp_jax import case_inputs, check_against_jax, configs, jax_step
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.train import AdamWConfig, CheckpointManager, init_opt_state

#: name -> (arch, overrides, seed, meshes)
CASES = {
    "a": ("qwen1.5-0.5b", {}, 0, ((2, 2), (1, 4))),
    "b": ("internvl2-2b", {"vocab": 511}, 1, ((2, 2), (1, 4))),
    "c_kv": ("qwen3-4b", {}, 2, ((1, 4),)),
    "c_q": ("phi3-medium-14b", {"n_heads": 6}, 3, ((1, 4),)),
    "g_none": ("qwen1.5-0.5b", {"remat": "none"}, 0, ((2, 2),)),
    "g_full": ("qwen1.5-0.5b", {"remat": "full"}, 0, ((2, 2),)),
}


def _name(case: str, mesh: tuple) -> str:
    return f"{case}@{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def setup():
    out = {}
    for case, (arch, over, seed, _) in CASES.items():
        jcfg, cfg = configs(arch, **over)
        jparams, batch = case_inputs(jcfg, seed)
        out[case] = (jcfg, cfg, jparams, batch)
    return out


@pytest.fixture(scope="module")
def started(setup, tmp_path_factory):
    """The world of 4 ranks, started on a thread while JAX computes the oracle."""
    root = tmp_path_factory.mktemp("tp")
    cases = [(_name(case, mesh), mesh, setup[case][1], setup[case][2], setup[case][3],
              2 if (case, mesh) == ("a", (2, 2)) else 1)
             for case, (_, _, _, meshes) in CASES.items() for mesh in meshes]
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, tp_world, 4, cases, str(root / "ckpt"),
                          init_method=f"file://{root}/rendezvous", timeout=120.0), root


@pytest.fixture(scope="module")
def oracle(setup, started):
    """JAX's step of each case; the remat cases share case (a)'s (remat
    changes no value in JAX)."""
    out = {case: jax_step(jcfg, jparams, batch)
           for case, (jcfg, _, jparams, batch) in setup.items() if not case.startswith("g_")}
    return {**out, **{case: out["a"] for case in CASES if case.startswith("g_")}}


@pytest.fixture(scope="module")
def world(started):
    future, root = started
    return future.result(), str(root / "ckpt")


@pytest.mark.parametrize("case,mesh", [(c, m) for c, v in CASES.items() for m in v[3]])
def test_step_matches_jax_single_device_step(case, mesh, setup, oracle, world):
    outs, _ = world
    name = _name(case, mesh)
    check_against_jax([o[name] for o in outs], oracle[case], setup[case][2])
    # the case really cut the leaves the spec cuts on the model axis
    assert any(s != tuple(w.shape) for s, w in zip(outs[0][name]["shapes"].values(),
                                                   PM.tree_leaves(oracle[case]["grads"])))


def test_ranks_of_a_model_group_share_their_rows_and_the_loss(world):
    outs, _ = world
    for out in outs:
        res = out["a@2x2"]
        assert res["loss"] == outs[0]["a@2x2"]["loss"]
        assert res["later_losses"] == outs[0]["a@2x2"]["later_losses"]
        assert np.isfinite(res["later_losses"]).all()
        for path, leaf in res["later_replicated"].items():
            np.testing.assert_array_equal(leaf, outs[0]["a@2x2"]["later_replicated"][path])


def test_shards_follow_the_specs(world, setup):
    """qwen-like at model 2 and 4: vocab-parallel embedding rows, column-parallel
    q/k/v and gate/up, row-parallel o and down; the norms whole."""
    outs, _ = world
    cfg = setup["a"][1]
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    for tp in (2, 4):
        shapes = outs[0][f"a@{4 // tp}x{tp}"]["shapes"]
        assert shapes["embed"] == (V // tp, D)
        assert shapes["layers/attn/wq"][-1] * tp == cfg.n_heads * cfg.resolved_head_dim
        assert shapes["layers/attn/wo"][-2] * tp == cfg.n_heads * cfg.resolved_head_dim
        assert shapes["layers/mlp/w_gate"][-1] == F // tp
        assert shapes["layers/mlp/w_down"][-2] == F // tp
        assert shapes["final_ln"] == (D,) and shapes["layers/attn/ln"][-1] == D
    vlm = outs[0]["b@1x4"]["shapes"]
    assert vlm["embed"] == (511, cfg.d_model // 4) and vlm["lm_head"] == (cfg.d_model // 4, 511)


def test_zero_tp_state_restores_at_data_1_model_4(world):
    outs, _ = world
    for rank, out in enumerate(outs):
        ck = out["checkpoint"]
        assert ck["shards_equal"] and ck["sharded_opt_leaves"] > 0
        assert ck["tall_coords"] == {"data": 0, "model": rank}
        assert ck["crcs"] == outs[0]["checkpoint"]["crcs"]


def test_zero_tp_state_restores_whole_on_one_device(world, setup):
    outs, ckpt_dir = world
    cfg = setup["a"][1]
    params = build_model(cfg, model_axis=1, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    template = {"params": params, "opt": init_opt_state(params, AdamWConfig())}
    step, p, o, _ = CheckpointManager(ckpt_dir).restore(template=template)
    assert step == 2 and int(o["count"]) == 2
    crcs = [zlib.crc32(t.contiguous().numpy().tobytes())
            for t in PM.tree_leaves({"params": p, "opt": o})]
    assert crcs == outs[0]["checkpoint"]["crcs"]
    for path, leaf in outs[0]["a@2x2"]["later_replicated"].items():
        node = p
        for key in path.split("/"):
            node = node[key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_meta_count_equals_a_real_ranks_count(world):
    """The dry-run counts one rank's tensor-parallel step on meta under an
    AbstractMesh; a real CPU rank's step counts the same: FLOPs, traffic,
    kernel calls, collectives and the state it starts with."""
    outs, _ = world
    for out in outs:
        real, meta = out["count"]["real"], out["count"]["meta"]
        assert real == meta
        assert real["collectives"]["all_reduce"]["calls"] > 0
        assert real["kernels"]["flash_attention"]["calls"] > 0


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-lite-16b", "hymba-1.5b",
                                  "whisper-large-v3", "xlstm-1.3b"])
def test_dryrun_production_counts_the_tensor_parallel_step(arch, tmp_path):
    """The dry-run's production judgment of a train cell counts one rank's
    tensor-parallel step on meta for DecoderLM, Hymba, Whisper and xLSTM (the peak
    holds the state, so it is at least the weights and optimizer shards); a
    serving cell counts the tensor-parallel decode step too."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    cfg = ARCHS[arch].smoke()
    r = dryrun.run_cell(arch, "train_4k", cfg=cfg, out_dir=tmp_path, save=False,
                        shape=ShapeConfig("train_4k", 64, 32, "train"))
    prod = r["production"]
    assert prod["executed"]
    assert prod["total_bytes"] >= prod["weights_bytes"] + prod["opt_state_bytes"]
    assert prod["step_peak_above_state_bytes"] > 0
    assert prod["step"]["collectives"]["all_reduce"]["calls"] > 0
    assert prod["fits_80gb"] == (prod["total_bytes"] <= dryrun.HBM_PER_CHIP)
    serve = dryrun.run_cell(arch, "decode_32k", cfg=cfg, save=False,
                            shape=ShapeConfig("decode_32k", 64, 4, "decode"))["production"]
    assert serve["executed"]
    assert serve["total_bytes"] >= serve["state_bytes"] > 0
    attends = cfg.mla is None and cfg.family != "ssm"       # xLSTM and MLA: no decode kernel
    assert serve["step"]["kernels"]["decode_attention" if attends else "rmsnorm"]["calls"]
    assert serve["fits_80gb"] == (serve["total_bytes"] <= dryrun.HBM_PER_CHIP)


@pytest.mark.parametrize("mesh_shape", [None, (2, 1)])
def test_regions_are_the_identity_without_a_model_axis(mesh_shape):
    """With no mesh, or a model axis of 1, every region returns its input
    itself: a model built so runs the operations of one with no regions."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.parallel import (all_reduce_sum, copy_to_region, gather_from_region,
                                      reduce_from_region, scatter_to_region, tp_mesh)

    mesh = None if mesh_shape is None else AbstractMesh(mesh_shape, ("data", "model"))
    x = torch.randn(3, 4, requires_grad=True)
    assert tp_mesh(mesh) is None
    for out in (copy_to_region(x, mesh), reduce_from_region(x, mesh),
                gather_from_region(x, mesh, -1), scatter_to_region(x, mesh, -1)):
        assert out is x
    assert all_reduce_sum(x, mesh, "model") is x


def test_abstract_mesh_collectives_refuse_real_tensors():
    """An AbstractMesh has no process group: its collectives give shapes on
    meta tensors and raise on any other device rather than return no other
    rank's data."""
    from repro_torch.launch.mesh import AbstractMesh

    mesh = AbstractMesh((2, 2), ("data", "model"))
    meta = torch.empty(3, 4, device="meta")
    assert mesh.all_reduce(meta, "model") is meta
    assert [p.shape for p in mesh.all_gather(meta, "model")] == [(3, 4)] * 2
    for op in (lambda t: mesh.all_reduce(t, "model"), lambda t: mesh.all_gather(t, "model")):
        with pytest.raises(RuntimeError, match="no process group"):
            op(torch.zeros(3, 4))
