"""The port's training slice on the CPU against the JAX package.

Parameters and optimizer state come from the JAX side and carry over with
``params_from_jax``; batches are drawn with numpy from a seed.  At fp32 on
the qwen1.5-0.5b smoke config the port reproduces JAX's loss within 1e-5,
every gradient leaf within 1e-4 of its largest entry, one AdamW update
within 1e-6, and three train steps' loss, grad norm and learning rate
within 1e-4.  Checkpoints written by either package restore in the other.
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
from repro.core import build_cluster
from repro.data import TokenDatasetSpec as JTokenDatasetSpec
from repro.data import TokenLoader as JTokenLoader
from repro.data import materialize_token_dataset
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import SamplerState as JSamplerState
from repro.train import adamw_update as jadamw_update
from repro.train import compress_int8 as jcompress_int8
from repro.train import config_digest as jconfig_digest
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro.train import token_batch_from_bytes as jtoken_batch_from_bytes
from repro_torch.configs import ARCHS
from repro_torch.core import build_cluster as port_build_cluster
from repro_torch.data import TokenDatasetSpec, TokenLoader, read_items
from repro_torch.data import materialize_token_dataset as port_materialize_token_dataset
from repro_torch.launch import train as port_train
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.train import (
    AdamWConfig,
    CheckpointManager,
    SamplerState,
    adamw_update,
    compress_int8,
    config_digest,
    decompress_int8,
    init_opt_state,
    init_train_state,
    make_eval_step,
    make_train_step,
    token_batch_from_bytes,
)

ARCH = "qwen1.5-0.5b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A JAX tree as port tensors, each leaf in its own dtype."""
    return PM.params_from_jax(_np(tree), device="cpu", dtype=None)


def _batch(vocab, shape=(2, 48), seed=0):
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


def _assert_tree_close(port_tree, jax_tree, tol):
    got, want = PM.tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


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
    batch, _ = _batch(model.cfg.vocab)
    metrics = make_eval_step(model)(params, batch)
    loss, _ = model.loss(params, batch)
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()))


def test_prefill_matches_jax_and_own_decode(pair):
    """Prefill logits at the last position equal JAX's prefill, and feeding the
    tokens one by one through the port's own decode (tests/test_models.py:64)."""
    jmodel, jparams, model, params = pair
    toks = np.random.default_rng(7).integers(0, model.cfg.vocab, (1, 16), dtype=np.int32)
    got = model.prefill(params, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (1, 1, model.cfg.vocab) and got.dtype == torch.float32
    want = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    cache = model.init_cache(1, 20)
    for t in range(16):
        logits, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                                   "cache": cache, "index": t})
    np.testing.assert_allclose(logits.numpy(), got.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("master_fp32", [True, False], ids=["master", "no_master"])
def test_adamw_update_in_slices_is_the_whole_leaf_update(monkeypatch, master_fp32):
    """Updating each leaf in slices (7 elements here, a bf16 leaf, a leaf that
    is not contiguous, an empty one) gives the same bits as updating it
    whole: each element's arithmetic is the same."""
    from repro_torch.train import optimizer

    gen = torch.Generator().manual_seed(5)
    params = {"a": torch.randn((5, 9), generator=gen), "b": torch.randn(11, generator=gen).bfloat16(),
              "c": torch.randn((6, 4), generator=gen).t(), "d": torch.zeros((0, 3))}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in params.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, master_fp32=master_fp32)
    results = []
    for slice_len in (7, 1 << 26):
        monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_len)
        p = {k: v.clone() for k, v in params.items()}
        state = init_opt_state(p, cfg)
        for _ in range(2):
            p, state, metrics = adamw_update(grads, state, p, cfg)
        results.append((p, state, metrics))
    (p0, s0, m0), (p1, s1, m1) = results
    for k in params:
        assert torch.equal(p0[k], p1[k]) and torch.equal(s0["mu"][k], s1["mu"][k])
        assert torch.equal(s0["nu"][k], s1["nu"][k])
        if master_fp32:
            assert torch.equal(s0["master"][k], s1["master"][k])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    monkeypatch.setattr(optimizer, "UPDATE_SLICE", 7)
    assert len(optimizer._slices(params["a"], grads["a"], None)) == 1 + 44 // 7
    assert len(optimizer._slices(params["c"], grads["c"], None)) == 1   # not contiguous


def test_adamw_update_matches_jax(pair):
    """One update from identical grads, params and (non-trivial) state, within 1e-6."""
    _, jparams, _, _ = pair
    rng = np.random.default_rng(4)
    cfg = JAdamWConfig(lr=1e-3, warmup_steps=3)
    jgrads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), jparams)
    jstate = jinit_opt_state(jparams, cfg)
    jstate["mu"] = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.01,
                                                      jnp.float32), jparams)
    jstate["nu"] = jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape) * 0.01,
                                                      jnp.float32), jparams)
    jstate["count"] = jnp.asarray(2, jnp.int32)
    params, state, grads = _port(jparams), _port(jstate), _port(jgrads)
    assert state["count"].dtype == torch.int32 and state["mu"]["embed"].dtype == torch.float32
    port_cfg = AdamWConfig(**dataclasses.asdict(cfg))
    new_p, new_s, metrics = adamw_update(grads, state, params, port_cfg)
    jnew_p, jnew_s, jmetrics = jadamw_update(jgrads, jstate, jparams, cfg)
    _assert_tree_close(new_p, jnew_p, 1e-6)
    for name in ("mu", "nu", "master"):
        _assert_tree_close(new_s[name], jnew_s[name], 1e-6)
    assert int(new_s["count"]) == int(jnew_s["count"]) == 3
    for name in ("grad_norm", "lr"):
        assert float(metrics[name]) == pytest.approx(float(jmetrics[name]), rel=1e-6)


def test_three_train_steps_match_jax(pair):
    jmodel, jparams, model, _ = pair
    cfg = JAdamWConfig(lr=1e-3, warmup_steps=2)
    jstate = jinit_opt_state(jparams, cfg)
    params, state = _port(jparams), _port(jstate)
    jstep = jax.jit(jmake_train_step(jmodel, cfg))
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2))
    for i in range(3):
        batch, jbatch = _batch(model.cfg.vocab, seed=i)
        jparams_i, jstate, jm = jstep(jparams if i == 0 else jparams_i, jstate, jbatch)
        params, state, m = step(params, state, batch)
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(m[name]) - float(jm[name])) <= 1e-4, (i, name)
    _assert_tree_close(params, jparams_i, 1e-4)


def test_loss_decreases_on_fixed_batch():
    """The port of tests/test_train.py::test_loss_decreases_on_fixed_batch."""
    model = build_model(ARCHS[ARCH].smoke(), device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    params, opt = init_train_state(model, torch.Generator().manual_seed(0), opt_cfg)
    rng = np.random.default_rng(0)
    batch = {name: torch.as_tensor(rng.integers(0, model.cfg.vocab, (4, 64)))
             for name in ("tokens", "labels")}
    step = make_train_step(model, opt_cfg)
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05
    assert float(m["grad_norm"]) > 0


def test_int8_compression_matches_jax():
    g = np.random.default_rng(3).normal(size=(256,)).astype(np.float32)
    err = np.zeros_like(g)
    q, scale, new_err = compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    jq, jscale, jerr = jcompress_int8(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == pytest.approx(float(jscale), rel=1e-7)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), atol=1e-7)
    assert float((decompress_int8(q, scale) - torch.from_numpy(g)).abs().max()) <= float(scale)


def test_token_batch_from_bytes_matches_jax():
    rng = np.random.default_rng(5)
    payloads = [rng.integers(-2**31, 2**31 - 1, 40, dtype=np.int64).astype(np.int32).tobytes()
                for _ in range(3)]
    got = token_batch_from_bytes(payloads, 32, 512, device="cpu")
    want = jtoken_batch_from_bytes(payloads, 32, 512)
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.int64
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    with pytest.raises(ValueError):
        token_batch_from_bytes(payloads, 64, 512, device="cpu")


def test_token_loader_matches_jax_and_resumes(tmp_path):
    """The port's store-backed loader gives the JAX loader's batches across an
    epoch boundary, over the port's own striped store and over JAX's, and a
    SamplerState resumes the stream where it stopped."""
    clock, topo, store, cache, engine = build_cluster()
    store.root = str(tmp_path / "jax")
    jspec = JTokenDatasetSpec("train-corpus", n_sequences=40, seq_len=12, vocab=512, seed=3)
    materialize_token_dataset(store, cache, jspec, topo.nodes[:4], items_per_chunk=16)
    _, ptopo, pstore, pcache, _ = port_build_cluster()
    pstore.root = str(tmp_path / "port")
    spec = TokenDatasetSpec("train-corpus", n_sequences=40, seq_len=12, vocab=512, seed=3)
    port_materialize_token_dataset(pstore, pcache, spec, ptopo.nodes[:4], items_per_chunk=16)
    jit = iter(JTokenLoader(store, jspec, topo.nodes[0], batch=8))
    on_jax_store = iter(TokenLoader(store, spec, topo.nodes[0], batch=8))
    loader = TokenLoader(pstore, spec, ptopo.nodes[0], batch=8)
    it = iter(loader)
    for _ in range(7):                  # 5 batches an epoch: crosses into epoch 2
        (jt, jl), (t, l), (t2, l2) = next(jit), next(it), next(on_jax_store)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(t2, jt)
        np.testing.assert_array_equal(l2, jl)
        np.testing.assert_array_equal(t, read_items(spec, loader.last_ids, items_per_chunk=16))
    assert (loader.state.epoch, loader.state.step_in_epoch) == (1, 2)
    resumed = iter(TokenLoader(pstore, spec, ptopo.nodes[0], batch=8,
                               state=SamplerState(**dataclasses.asdict(loader.state))))
    for _ in range(4):
        np.testing.assert_array_equal(next(resumed)[0], next(it)[0])


def test_config_digest_equals_jax():
    for cfg, jcfg in ((ARCHS[ARCH], JARCHS[ARCH]), (ARCHS[ARCH].smoke(), JARCHS[ARCH].smoke())):
        assert config_digest(cfg) == jconfig_digest(jcfg)


def test_checkpoint_round_trip_prune_and_torn_write(tmp_path, pair):
    _, _, model, params = pair
    opt = init_opt_state(params, AdamWConfig())
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, params, opt, sampler=SamplerState(epoch=step, step_in_epoch=4, seed=9))
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_000002", "step_000003"]
    os.makedirs(tmp_path / "step_000004")                  # a torn write: no _COMMITTED
    assert mgr.latest_step() == 3
    step, p2, o2, sampler = mgr.restore(template={"params": params, "opt": opt})
    assert step == 3 and sampler == SamplerState(3, 4, 9)
    for a, b in zip(PM.tree_leaves({"p": params, "o": opt}), PM.tree_leaves({"p": p2, "o": o2})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_000003" / "manifest.json").read_text())
    assert manifest["leaf_dtypes"][0] == "int32"           # opt/count sorts first


def test_checkpoint_bf16_leaf_round_trip(tmp_path):
    """numpy has no bfloat16: the leaf is written as 2-byte records and read
    back as bfloat16 from ``leaf_dtypes``."""
    params = {"w": (torch.randn(5, 3) * 3).to(torch.bfloat16)}
    opt = {"count": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, params, opt)
    raw = np.load(tmp_path / "step_000001" / "leaf_00001.npy")
    assert raw.dtype.itemsize == 2 and raw.dtype.kind == "V"
    _, p2, o2, _ = mgr.restore(template={"params": params, "opt": opt})
    assert p2["w"].dtype == torch.bfloat16 and torch.equal(p2["w"], params["w"])
    assert o2["count"].dtype == torch.int32 and int(o2["count"]) == 7


def test_checkpoints_cross_between_packages(tmp_path, pair):
    """fp32: a JAX-written checkpoint restores in the port and a port-written
    one in JAX, leaf for leaf, with the sampler state."""
    _, jparams, _, _ = pair
    jopt = jinit_opt_state(jparams, JAdamWConfig())
    jopt["count"] = jnp.asarray(5, jnp.int32)
    JCheckpointManager(str(tmp_path / "jax"), async_write=False).save(
        5, jparams, jopt, sampler=JSamplerState(1, 2, 3))
    params, opt = _port(jparams), _port(jopt)
    template = {"params": PM.tree_map(torch.zeros_like, params),
                "opt": PM.tree_map(torch.zeros_like, opt)}
    step, p, o, sampler = CheckpointManager(str(tmp_path / "jax")).restore(template=template)
    assert step == 5 and sampler == SamplerState(1, 2, 3) and o["count"].dtype == torch.int32
    _assert_tree_close({"params": p, "opt": o}, {"params": jparams, "opt": jopt}, 0)

    CheckpointManager(str(tmp_path / "port"), async_write=False).save(
        6, params, opt, sampler=SamplerState(4, 5, 6))
    jstep, jp, jo, jsampler = JCheckpointManager(str(tmp_path / "port")).restore(
        template={"params": jparams, "opt": jopt})
    assert jstep == 6 and jsampler == JSamplerState(4, 5, 6)
    _assert_tree_close({"params": params, "opt": opt}, {"params": jp, "opt": jo}, 0)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-lite-16b", "mixtral-8x7b"])
def test_train_launcher_on_cpu_checkpoints_and_resumes(tmp_path, capsys, monkeypatch, arch):
    """The launcher at ``arch``'s smoke config (the dense model, and the two MoE
    models: routed experts, and MLA for deepseek): checkpoints, the JAX
    config digest in the manifest, and a resume after an injected fault."""
    argv = ["--arch", arch, "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "24",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    res = port_train.main(argv)
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert res["restarts"] == 0 and res["final_step"] == 3
    assert sorted(os.listdir(tmp_path)) == ["step_000002", "step_000003"]
    assert (tmp_path / "step_000003" / "_COMMITTED").is_file()
    manifest = json.loads((tmp_path / "step_000003" / "manifest.json").read_text())
    assert manifest["config_digest"] == jconfig_digest(JARCHS[arch].smoke())
    assert manifest["sampler"] == {"epoch": 0, "step_in_epoch": 3, "seed": 0}

    crashed = {"n": 0}
    real_step = port_train.make_train_step

    def flaky_step(*a, **k):
        fn = real_step(*a, **k)

        def step(*args):
            if crashed["n"] == 0:
                crashed["n"] += 1
                raise RuntimeError("injected fault")
            return fn(*args)
        return step

    monkeypatch.setattr(port_train, "make_train_step", flaky_step)
    res = port_train.main(argv[:5] + ["5"] + argv[6:])
    out = capsys.readouterr().out
    assert res["restarts"] == 1 and "[restore] resumed from step 3" in out
    assert len(res["losses"]) == 2 and res["final_step"] == 5


def test_train_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        token_batch_from_bytes([np.zeros(4, np.int32).tobytes()], 4, 8)


def test_trace_groups_only_the_port_kernels_by_name():
    """The step breakdown names the kernels of ``kernels/csrc``; PyTorch's own
    kernels in anonymous namespaces count as PyTorch's."""
    from repro_torch.launch.trace import PORT_KERNELS, kernel_group

    assert {"flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
            "rmsnorm_bwd_kernel", "swiglu_gate_bwd_kernel"} <= PORT_KERNELS
    assert {"mlstm_gates_kernel", "mlstm_fwd_gemm_kernel", "mlstm_decay_mask_kernel",
            "mlstm_state_scan_kernel", "mlstm_fwd_out_kernel", "mlstm_bwd_prep_kernel",
            "mlstm_dstate_scan_kernel", "mlstm_bwd_gemm_kernel", "mlstm_bwd_ds_kernel",
            "mlstm_bwd_combine_kernel", "mlstm_bwd_gates_kernel"} <= PORT_KERNELS
    assert kernel_group("void (anonymous namespace)::mlstm_state_scan_kernel<__nv_bfloat16, "
                        "__nv_bfloat16>(mlstm::Scan)") == "mlstm_state_scan_kernel"
    assert kernel_group("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 16>(x)") \
        == "flash_fwd_kernel"
    assert kernel_group("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") == "cublas"
    for name in ("void at::native::vectorized_elementwise_kernel<4, at::native::"
                 "(anonymous namespace)::pow_tensor_scalar_kernel_impl<float>>(int)",
                 "void at::native::(anonymous namespace)::CatArrayBatchedCopy<x>(y)"):
        assert kernel_group(name) == "torch_other"


def test_trace_finds_the_routed_experts_products_forward_and_backward():
    """``trace.is_routed_expert_bmm`` takes the three batched products of
    ``moe_block`` and the six that autograd forms for their gradients, as the
    profiler records them on the CPU, and no other batched product."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import MoEConfig
    from repro_torch.launch.trace import is_routed_expert_bmm
    from repro_torch.models import layers

    moe, D = MoEConfig(n_experts=4, top_k=2, d_expert=48), 32
    g = torch.Generator().manual_seed(0)
    x, router, wg, wu, wd = (torch.randn(s, generator=g).requires_grad_()
                             for s in ((10, D), (D, 4), (4, D, 48), (4, D, 48), (4, 48, D)))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        y, aux = layers.moe_block(x, router, wg, wu, wd, top_k=2)
        torch.autograd.grad((y.sum() + aux), (x, wg, wu, wd))
    bmms = [e.input_shapes for e in prof.events() if e.name == "aten::bmm"]
    assert len(bmms) == 9
    assert all(is_routed_expert_bmm(s, moe, D) for s in bmms)
    assert not is_routed_expert_bmm([[16, 8, 32], [16, 32, 8]], moe, D)   # another batch
    assert not is_routed_expert_bmm([[4, 8, 32], [4, 32, 8]], moe, D)     # no expert width
    assert not is_routed_expert_bmm([[10, 32], [32, 48]], moe, D)         # a plain product


def test_trace_finds_every_kernel_of_csrc():
    """Every ``__global__`` function of ``kernels/csrc`` is in ``KERNEL_SOURCE``
    under its own source, so no kernel of the port is counted as PyTorch's or
    cuBLAS's, the tensor-core kernels (template launch bounds) included."""
    from repro_torch.kernels import build
    from repro_torch.launch.trace import KERNEL_SOURCE, kernel_group, source_group

    for path in sorted(build.CSRC.glob("*.cu")):
        n = path.read_text().count("__global__")
        assert sum(stem == path.stem for stem in KERNEL_SOURCE.values()) == n, path.name
    assert {"swiglu_tc_kernel", "swiglu_splitk_sum_kernel", "rows_matmul_kernel"} == {
        k for k, v in KERNEL_SOURCE.items() if v == "swiglu"}
    assert {"flash_tc_kernel", "flash_fwd_kernel"} == {
        k for k, v in KERNEL_SOURCE.items() if v == "flash_attention"}
    name = ("void (anonymous namespace)::swiglu_tc_kernel<true, 2>(CUtensorMap_st, "
            "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Args)")
    assert kernel_group(name) == "swiglu_tc_kernel" and source_group(name) == "swiglu"
    assert source_group("void (anonymous namespace)::flash_tc_kernel<64>(CUtensorMap_st, "
                        "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::TcArgs)") \
        == "flash_attention"


def test_trace_groups_the_port_kernels_by_source():
    """Each kernel of ``kernels/csrc`` also counts toward its source file, one
    group per kernel wrapper: the SSD scan's forward launches (both routes)
    form ``ssd_scan`` and its backward launches ``ssd_scan_bwd``, template and
    plain kernels alike (a plain kernel's name has no return type)."""
    from repro_torch.launch.trace import KERNEL_SOURCE, source_group

    fwd = {"ssd_cumsum_kernel", "ssd_chunk_state_kernel", "ssd_state_scan_kernel",
           "ssd_fwd_out_kernel", "ssd_tc_state_kernel", "ssd_tc_fwd_out_kernel"}
    bwd = {"ssd_bwd_state_kernel", "ssd_bwd_scan_kernel", "ssd_bwd_dx_kernel",
           "ssd_bwd_dbc_kernel", "ssd_tc_bwd_state_kernel", "ssd_tc_bwd_dx_kernel",
           "ssd_tc_bwd_dbc_kernel"}
    assert {k for k, v in KERNEL_SOURCE.items() if v == "ssd_scan"} == fwd
    assert {k for k, v in KERNEL_SOURCE.items() if v == "ssd_scan_bwd"} == bwd
    assert source_group("(anonymous namespace)::ssd_cumsum_kernel(float const*, float*, "
                        "ssd::Dims)") == "ssd_scan"
    assert source_group("void (anonymous namespace)::ssd_bwd_dbc_kernel<__nv_bfloat16>("
                        "(anonymous namespace)::DbcArgs)") == "ssd_scan_bwd"
    assert source_group("void (anonymous namespace)::ssd_tc_bwd_dbc_kernel<1>(CUtensorMap_st, "
                        "CUtensorMap_st, (anonymous namespace)::TcDbcArgs)") == "ssd_scan_bwd"
    assert source_group("void (anonymous namespace)::mlstm_state_scan_kernel<float, float>("
                        "mlstm::Scan)") == "mlstm_scan"
    assert source_group("nvjet_tst_128x256_64x4_1x1_h_bz_coopA_TNN") == "cublas"
    assert source_group("void at::native::vectorized_elementwise_kernel<4, x>(int)") == \
        "torch_other"


@pytest.mark.parametrize("source,kernels", [
    ("mlstm_scan", {"mlstm_gates_kernel", "mlstm_decay_mask_kernel", "mlstm_fwd_gemm_kernel",
                    "mlstm_state_scan_kernel", "mlstm_fwd_out_kernel", "mlstm_tc_gates_kernel",
                    "mlstm_tc_state_kernel", "mlstm_tc_fwd_out_kernel"}),
    ("mlstm_scan_bwd", {"mlstm_bwd_gemm_kernel", "mlstm_dstate_scan_kernel",
                        "mlstm_bwd_prep_kernel", "mlstm_bwd_ds_kernel", "mlstm_bwd_combine_kernel",
                        "mlstm_bwd_gates_kernel", "mlstm_tc_bwd_rows_kernel",
                        "mlstm_tc_bwd_state_kernel", "mlstm_tc_bwd_qside_kernel",
                        "mlstm_tc_bwd_dq_kernel", "mlstm_tc_bwd_dkv_kernel",
                        "mlstm_tc_bwd_gates_kernel"}),
])
def test_trace_groups_the_mlstm_kernels_by_source(source, kernels):
    """The mLSTM scan's tensor-core kernels count toward their wrappers'
    sources beside the CUDA-core ones: every launch of the forward (either
    route) is ``mlstm_scan``, every launch of the backward ``mlstm_scan_bwd``;
    a plain kernel's demangled name has no return type."""
    from repro_torch.launch.trace import KERNEL_SOURCE, kernel_group, source_group

    assert {k for k, v in KERNEL_SOURCE.items() if v == source} == kernels
    for name in kernels - {k for k in kernels if "_tc_" not in k}:
        args = "mlstm::tc::Args" if name.endswith("gates_kernel") or "rows" in name \
            else "CUtensorMap_st, mlstm::tc::Args"
        demangled = f"(anonymous namespace)::{name}({args})"
        assert kernel_group(demangled) == name and source_group(demangled) == source


def test_trace_groups_the_decode_kernels_by_source():
    """Decode attention's split route (its kernels in a namespace inside the
    anonymous one) counts toward ``decode_attention`` beside the ``simt`` kernel."""
    from repro_torch.launch.trace import KERNEL_SOURCE, kernel_group, source_group

    assert {k for k, v in KERNEL_SOURCE.items() if v == "decode_attention"} == {
        "decode_attention_kernel", "decode_split_kernel", "decode_combine_kernel"}
    name = ("void (anonymous namespace)::split::decode_split_kernel<__nv_bfloat16, 8, 1>("
            "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, int const*, "
            "__nv_bfloat16*, float*, float*, float*, int, int, int, int, int, int, int, float)")
    assert kernel_group(name) == "decode_split_kernel" and source_group(name) == \
        "decode_attention"
    assert source_group("void (anonymous namespace)::split::decode_combine_kernel<float>("
                        "float const*, float const*, float const*, float*, int, int, int)") \
        == "decode_attention"
    assert source_group("void (anonymous namespace)::decode_attention_kernel<float>(float "
                        "const*)") == "decode_attention"


def test_trace_groups_the_backward_kernels_by_source():
    """The SwiGLU backward's tensor-core kernel and the rmsnorm backward's
    one-warp-a-row body count toward their wrappers' sources, beside the
    kernels they took over from."""
    from repro_torch.launch.trace import KERNEL_SOURCE, source_group

    assert {k for k, v in KERNEL_SOURCE.items() if v == "swiglu_bwd"} == {
        "swiglu_gate_bwd_kernel", "swiglu_bwd_tc_kernel"}
    assert {k for k, v in KERNEL_SOURCE.items() if v == "rmsnorm_bwd"} == {
        "rmsnorm_bwd_kernel", "rmsnorm_bwd_vec_kernel", "dgamma_reduce_kernel"}
    assert source_group("void (anonymous namespace)::swiglu_bwd_tc_kernel<false>(CUtensorMap_st, "
                        "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                        "(anonymous namespace)::TcArgs)") == "swiglu_bwd"
    assert source_group("void (anonymous namespace)::rmsnorm_bwd_vec_kernel<__nv_bfloat16, 8>("
                        "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
                        "__nv_bfloat16*, float*, int, int, float)") == "rmsnorm_bwd"


def test_trace_breaks_pytorch_kernels_down_by_root():
    """PyTorch's own kernels are summed by the outermost CPU event that launched
    them: a forward op by its name, a backward op by its autograd node, the
    optimizer by its range; the port's kernels and cuBLAS's stay out."""
    from types import SimpleNamespace as NS

    from repro_torch.launch.trace import root_name, torch_other_by_root

    def kernel(name, us):
        return NS(name=name, duration=us)

    adamw = NS(name="adamw_update", cpu_parent=None, kernels=[])
    node = NS(name="autograd::engine::evaluate_function: GeluBackward0", cpu_parent=None,
              kernels=[])
    events = [
        NS(name="aten::mul_", cpu_parent=adamw,
           kernels=[kernel("void at::native::vectorized_elementwise_kernel<4>(x)", 300.0)]),
        NS(name="aten::gelu_backward", cpu_parent=node,
           kernels=[kernel("void at::native::gelu_backward_kernel(x)", 100.0)]),
        NS(name="aten::gelu", cpu_parent=None,
           kernels=[kernel("void at::native::gelu_kernel(x)", 50.0)]),
        NS(name="aten::mm", cpu_parent=None, kernels=[kernel("nvjet_tst_256x128_h_bz_NNT", 900.0)]),
        NS(name="FlashAttention", cpu_parent=None, kernels=[kernel(
            "void (anonymous namespace)::flash_tc_kernel<64, 64>(CUtensorMap_st)", 700.0)]),
        adamw, node,
    ]
    assert root_name(events[0]) == "adamw_update" and root_name(events[1]) == "GeluBackward0"
    assert torch_other_by_root(events, steps=2) == {"adamw_update": 0.15, "GeluBackward0": 0.05,
                                                    "aten::gelu": 0.025}


def test_adamw_update_runs_in_its_profiler_range(pair):
    """Every op of the update runs inside the ``adamw_update`` range, which the
    trace's breakdown reads."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.trace import root_name

    _, _, model, params = pair
    params = PM.tree_map(lambda t: t.clone(), params)
    state = init_opt_state(params, AdamWConfig())
    grads = PM.tree_map(torch.ones_like, params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        adamw_update(grads, state, params, AdamWConfig())
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    assert ops and {root_name(e) for e in ops} == {"adamw_update"}


def test_trace_busy_time_leaves_out_profiler_ranges():
    """A profiler range shows on the device's timeline as an annotation that
    spans its kernels; the busy time and the launches count the kernels alone."""
    from types import SimpleNamespace as NS

    from repro_torch.launch.trace import device_summary

    def event(name, us, annotation=False):
        return NS(name=name, device_type=torch.autograd.DeviceType.CUDA,
                  is_user_annotation=annotation, time_range=NS(elapsed_us=lambda: us),
                  cpu_parent=None, kernels=[])

    events = [event("adamw_update", 900.0, annotation=True),
              event("void at::native::vectorized_elementwise_kernel<4>(x)", 500.0),
              event("nvjet_tst_256x128_h_bz_NNT", 300.0)]
    res = device_summary(NS(events=lambda: events), steps=1, traced_ms=1.0)
    assert res["device_busy_ms_per_step"] == pytest.approx(0.8)
    assert res["kernel_launches_per_step"] == 2
    assert res["ms_per_step_by_group"] == pytest.approx({"torch_other": 0.5, "cublas": 0.3})
