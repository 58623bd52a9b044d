"""The dry-run's pieces against the JAX package's, and the kernels' meta route.

* **Shapes**: ``ShapeConfig``, the four cells and ``shape_applicable``'s
  verdict and reason for every (arch, shape).
* **Parameters**: ``param_count`` and ``param_bytes`` for every arch at
  ``model_axis`` 1 and 16; ``params.abstract`` on the meta device.
* **Inputs**: ``input_specs``' shapes, dtypes and spec trees for every arch x
  shape, with no mesh and on stand-in 16 x 16 and 2 x 16 x 16 meshes (JAX's
  take any object with ``shape`` and ``axis_names``; the port's is
  ``AbstractMesh``).  Every model is built on meta: no weight is drawn.
* **Meta route**: each kernel wrapper, forward and backward, on meta tensors
  gives the plain version's output shapes and dtypes, calls no plain
  version (the names ``ops`` calls in ``ref`` are patched to raise) and adds
  no launch to the counts ``chip_smoke.py`` reads.
* **Dry-run cells**: ``run_cell`` at full width for qwen1.5-0.5b ``train_4k``
  and ``decode_32k`` on both production meshes, smoke configs of the other
  families; a rank's state bytes equal a sum over JAX's ``PM.specs`` /
  ``opt_state_specs`` and the leaf shapes; the skip reasons are JAX's.  The
  step runs at the config's ``remat`` ("dots": each layer's forward kernels
  twice); ``--override remat=none`` counts the step without the recompute.
"""

import math
from types import SimpleNamespace

import pytest
import torch

import jax.numpy as jnp
from repro.configs import ALL_SHAPES as JALL_SHAPES
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import shape_applicable as jshape_applicable
from repro.models import build_model as jbuild_model
from repro.models import params as JPM
from repro.models.registry import WHISPER_DECODE_ENC_LEN as J_ENC_LEN
from repro.models.registry import input_specs as jinput_specs
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import opt_state_specs as jopt_state_specs
from repro_torch.configs import ALL_SHAPES, ARCHS, SHAPES, ShapeConfig, shape_applicable
from repro_torch.kernels import KERNEL_MODULES, ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_abstract_production_mesh
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.models.registry import WHISPER_DECODE_ENC_LEN, input_specs, step_fn

MESHES = {"none": None, "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {jnp.dtype("int32"): torch.int32, jnp.dtype("bfloat16"): torch.bfloat16,
          jnp.dtype("float32"): torch.float32}


def _plain(tree):
    """A JAX spec tree as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(tree)


def _leaves(tree) -> list:
    """Leaves in sorted-key order (JAX's and the port's order alike)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ------------------------------------------------------------------ shapes
def test_shape_cells_match_jax():
    assert [s.name for s in ALL_SHAPES] == [s.name for s in JALL_SHAPES]
    for s, js in zip(ALL_SHAPES, JALL_SHAPES):
        assert (s.name, s.seq_len, s.global_batch, s.kind, s.is_decode) == \
            (js.name, js.seq_len, js.global_batch, js.kind, js.is_decode)
    assert sorted(SHAPES) == sorted(JSHAPES)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shape_applicable_matches_jax(arch):
    for name in SHAPES:
        assert shape_applicable(ARCHS[arch], SHAPES[name]) == \
            jshape_applicable(JARCHS[arch], JSHAPES[name])


# -------------------------------------------------------------- parameters
@pytest.mark.parametrize("model_axis", [1, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_and_bytes_match_jax(arch, model_axis):
    jlayout = jbuild_model(JARCHS[arch], model_axis=model_axis).layout()
    layout = build_model(ARCHS[arch], model_axis=model_axis, device="meta").layout()
    assert PM.param_count(layout) == JPM.param_count(jlayout)
    for dtype in ("bfloat16", "float32"):
        assert PM.param_bytes(layout, dtype) == JPM.param_bytes(jlayout, dtype)
    # abstract: meta tensors of JAX's shapes and dtypes, leaf for leaf
    got = PM.tree_leaves(PM.abstract(layout, "bfloat16"))
    want = _leaves(JPM.abstract(jlayout, "bfloat16"))
    assert all(t.device.type == "meta" for t in got)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(w.shape), DTYPES[w.dtype]) for w in want]


# ------------------------------------------------------------------ inputs
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(arch, mesh_name):
    m = MESHES[mesh_name]
    jmesh = None if m is None else SimpleNamespace(shape=dict(zip(m[1], m[0])), axis_names=m[1])
    mesh = None if m is None else AbstractMesh(*m)
    assert WHISPER_DECODE_ENC_LEN == J_ENC_LEN
    for name in SHAPES:
        jbatch, jspec = jinput_specs(JARCHS[arch], JSHAPES[name], mesh=jmesh)
        batch, spec = input_specs(ARCHS[arch], SHAPES[name], mesh=mesh)
        assert spec == _plain(jspec), (arch, name)
        got, want = PM.tree_leaves(batch), _leaves(jbatch)
        assert all(t.device.type == "meta" for t in got)
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(w.shape), DTYPES[w.dtype]) for w in want], (arch, name)


def test_step_fn_picks_the_cells_step():
    model = build_model(ARCHS["qwen1.5-0.5b"], device="meta")
    cfg = ARCHS["qwen1.5-0.5b"]
    assert step_fn(cfg, SHAPES["train_4k"], model).__name__ == "loss"
    assert step_fn(cfg, SHAPES["prefill_32k"], model).__name__ == "prefill"
    assert step_fn(cfg, SHAPES["decode_32k"], model).__name__ == "decode_step"


# --------------------------------------------------------------- meta route
PLAIN = ("rmsnorm_ref", "rmsnorm_bwd_ref", "swiglu_ref", "swiglu_fwd_ref",
         "swiglu_bwd_saved_ref", "flash_attention_ref", "flash_attention_bwd_ref",
         "decode_attention_ref", "mlstm_scan_ref", "mlstm_scan_bwd_ref", "ssd_scan_ref",
         "ssd_scan_bwd_ref")


def _calls(dtype):
    """(name, function of inputs, input shapes and dtypes, differentiable inputs)."""
    f32 = torch.float32
    return [
        ("rmsnorm", lambda x, g: ops.rmsnorm(x, g), [((64, 96), dtype), ((96,), dtype)], 2),
        ("swiglu", lambda x, a, b, c: ops.swiglu_mlp(x, a, b, c),
         [((80, 64), dtype), ((64, 128), dtype), ((64, 128), dtype), ((128, 64), dtype)], 4),
        ("flash", lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
         [((2, 4, 128, 64), dtype), ((2, 2, 128, 64), dtype), ((2, 2, 128, 64), dtype)], 3),
        ("flash_mla", lambda q, k, v: ops.flash_attention(q, k, v, causal=True, window=32),
         [((1, 2, 64, 192), dtype), ((1, 2, 64, 192), dtype), ((1, 2, 64, 128), dtype)], 3),
        ("decode", lambda q, k, v: ops.decode_attention(q, k, v, 40),
         [((2, 4, 1, 64), dtype), ((2, 2, 96, 64), dtype), ((2, 2, 96, 64), dtype)], 0),
        ("mlstm", lambda q, k, v, i, f: ops.mlstm_scan(q, k, v, i, f, chunk=128),
         [((1, 2, 256, 64), dtype), ((1, 2, 256, 64), dtype), ((1, 2, 256, 128), dtype),
          ((1, 2, 256), dtype), ((1, 2, 256), dtype)], 5),
        ("ssd", lambda lf, b, x, c: ops.ssd_scan(lf, b, x, c, chunk=128)[0],
         [((1, 256, 2), f32), ((1, 256, 2, 16), dtype), ((1, 256, 2, 32), dtype),
          ((1, 256, 2, 16), dtype)], 4),
    ]


def _run(fn, specs, n_grad, device, gen):
    inputs = []
    for i, (shape, dt) in enumerate(specs):
        t = (torch.randn(shape, generator=gen) * 0.3).to(dt)
        if device == "meta":
            t = torch.empty(shape, dtype=dt, device="meta")
        inputs.append(t.requires_grad_(i < n_grad))
    out = fn(*inputs)
    if not n_grad:
        return [out]
    out.float().sum().backward()
    return [out] + [t.grad for t in inputs[:n_grad]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_meta_route_matches_plain_shapes_without_plain_version(dtype, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    plain = {name: _run(fn, specs, n, "cpu", gen) for name, fn, specs, n in _calls(dtype)}

    def refuse(*_a, **_k):
        raise AssertionError("the meta route called a plain version")

    for name in PLAIN:
        monkeypatch.setattr(ref, name, refuse)
    for mod in KERNEL_MODULES:
        mod.launches = 0
        mod.route_launches.update(dict.fromkeys(mod.route_launches, 0))
    for name, fn, specs, n in _calls(dtype):
        got = _run(fn, specs, n, "meta", gen)
        assert all(t.device.type == "meta" for t in got), name
        assert [(tuple(t.shape), t.dtype) for t in got] == \
            [(tuple(t.shape), t.dtype) for t in plain[name]], name
    assert all(mod.launches == 0 and not any(mod.route_launches.values())
               for mod in KERNEL_MODULES)


def test_meta_route_never_reaches_cpu_or_cuda_tensors():
    """A CPU tensor takes the plain version; only meta takes the card's path
    short of the launch, so the meta route cannot see a CPU tensor."""
    x = torch.randn(4, 8)
    assert ops._on_cuda(x, "t") is False
    assert ops._on_cuda(x.to("meta"), "t") is True
    with pytest.raises(ValueError, match="one GPU"):
        from repro_torch.kernels import rmsnorm as kr
        kr.rmsnorm_cuda(x, torch.ones(8))


# ----------------------------------------------------------- dry-run cells
def _j_state_bytes(arch: str, mesh_shape: dict, train: bool) -> dict:
    """A rank's weight, gradient and AdamW bytes from JAX's specs and the
    leaf shapes: each dimension cut by the mesh sizes its spec entry names."""
    mesh = SimpleNamespace(shape=dict(mesh_shape), axis_names=tuple(mesh_shape))
    jlayout = jbuild_model(JARCHS[arch], model_axis=mesh_shape["model"], mesh=mesh).layout()
    cfg_dtype = JARCHS[arch].dtype

    def shard(shape, spec, nbytes):
        n = 1
        for d, size in enumerate(shape):
            e = spec[d] if d < len(spec) else None
            axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
            n *= size // math.prod(mesh_shape[a] for a in axes)
        return n * nbytes

    infos = _leaves(jlayout)
    weights = sum(shard(i.shape, tuple(i.spec), jnp.dtype(i.dtype or cfg_dtype).itemsize)
                  for i in infos)
    out = {"weights_bytes": weights, "grad_bytes": weights if train else 0,
           "opt_state_bytes": 0}
    if train:
        ospecs = jopt_state_specs(jlayout, mesh, JAdamWConfig())
        for part in ("mu", "nu", "master"):
            out["opt_state_bytes"] += sum(shard(i.shape, tuple(s), 4) for i, s in
                                          zip(infos, _leaves(_plain(ospecs[part]))))
        out["opt_state_bytes"] += 4                     # the int32 count
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_cell_full_width_qwen_state_bytes_match_jax_specs(shape, multi_pod):
    r = dryrun.run_cell("qwen1.5-0.5b", shape, multi_pod=multi_pod, save=False)
    mesh = make_abstract_production_mesh(multi_pod=multi_pod)
    want = _j_state_bytes("qwen1.5-0.5b", mesh.shape, shape == "train_4k")
    prod = r["production"]
    for key, n in want.items():
        assert prod[key] == n, key
    assert r["status"] == "ok" and r["remat"] == ARCHS["qwen1.5-0.5b"].remat == "dots"
    assert r["chips"] == mesh.size
    assert r["n_params"] == JPM.param_count(jbuild_model(JARCHS["qwen1.5-0.5b"]).layout())
    dp = r["data_parallel"]
    assert dp["rows_per_rank"] == 1
    assert dp["total_bytes"] == (dp["weights_bytes"] + dp["opt_state_bytes"]
                                 + dp["input_bytes"] + dp["step_peak_above_state_bytes"])
    assert dp["step_peak_above_state_bytes"] > 0 and r["counted_flops_per_chip"] > 0
    if shape == "train_4k":
        # under "dots" each layer's forward kernels run twice (the forward and
        # the recompute), the backward kernels and the final norm once
        counts = dp["counted"]["kernels"]
        assert counts["flash_attention"]["calls"] == 2 * 24
        assert counts["flash_attention_bwd"]["calls"] == 24 == counts["swiglu_bwd"]["calls"]
        assert counts["rmsnorm"]["calls"] == 2 * 2 * 24 + 1
        assert counts["rmsnorm_bwd"]["calls"] == 2 * 24 + 1
        assert 0.5 <= r["counted_over_analytic_flops"] <= 1.5


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-lite-16b"])
def test_run_cell_executes_the_tensor_parallel_serving_step(arch, shape):
    """A serving cell of DecoderLM on the production mesh counts rank 0's
    tensor-parallel ``decode_step`` or ``prefill`` on meta: its collectives
    over the ``model`` axis, each layer's kernels, and ``total_bytes`` (the
    weights' shards, the cache shard, the inputs and the step's peak) at
    least its state, against which ``fits_80gb`` is judged."""
    r = dryrun.run_cell(arch, shape, save=False)
    prod = r["production"]
    cfg = ARCHS[arch]
    mesh = make_abstract_production_mesh()
    assert prod["executed"] and r["status"] == "ok"
    step = prod["step"]
    assert step["flops"] > 0 and step["collective_bytes"] > 0
    assert step["collectives"]["all_reduce"]["calls"] >= cfg.n_layers
    assert step["collectives"]["all_gather"]["calls"] >= 1
    assert prod["total_bytes"] == step["start_bytes"] + prod["step_peak_above_state_bytes"]
    assert prod["total_bytes"] >= prod["state_bytes"]
    assert prod["fits_80gb"] == (prod["total_bytes"] <= dryrun.HBM_PER_CHIP)
    kernels = step["kernels"]
    assert kernels["rmsnorm"]["calls"] >= 2 * cfg.n_layers + 1
    if shape == "decode_32k":
        # a rank's cache shard: its slots of the sequence, all its rows' heads
        assert prod["input_bytes"] < step["start_bytes"] <= prod["state_bytes"]
        if cfg.mla is None:
            assert kernels["decode_attention"]["calls"] == cfg.n_layers
        # every layer gathers its queries and merges its partial softmax
        assert step["collectives"]["all_gather"]["calls"] >= 2 * cfg.n_layers
    else:
        assert kernels["flash_attention"]["calls"] == cfg.n_layers
    assert mesh.shape["model"] == 16


def test_run_cell_override_remat_none_counts_no_recompute():
    """``--override remat=none`` runs the step with no checkpoint: each kernel
    once, a higher peak, fewer FLOPs, whose share of the config's analytic
    cell (priced at JAX's ``"dots"``: one re-forward) is about 3/4 for a
    dense model; the cell's own analytic follows the override (no
    re-forward), so its ratio is about 1."""
    dots = dryrun.run_cell("qwen1.5-0.5b", "train_4k", save=False)
    none = dryrun.run_cell("qwen1.5-0.5b", "train_4k", overrides={"remat": "none"},
                           save=False)
    assert none["remat"] == "none" and dots["remat"] == "dots"
    counts = none["data_parallel"]["counted"]["kernels"]
    assert counts["flash_attention"]["calls"] == 24 == counts["flash_attention_bwd"]["calls"]
    assert counts["rmsnorm"]["calls"] == 49 == counts["rmsnorm_bwd"]["calls"]
    assert (none["data_parallel"]["step_peak_above_state_bytes"]
            > dots["data_parallel"]["step_peak_above_state_bytes"])
    assert none["counted_flops_per_chip"] < dots["counted_flops_per_chip"]
    busy = dots["counted_over_analytic_flops"] / dots["counted_flops_per_chip"]
    assert abs(none["counted_flops_per_chip"] * busy - 0.75) < 0.01
    assert 0.75 + 0.01 < dots["counted_over_analytic_flops"] <= 1.0
    assert abs(none["counted_over_analytic_flops"] - 1.0) < 0.01


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - {"qwen1.5-0.5b"}))
def test_run_cell_smoke_families(arch, tmp_path):
    """Every family at its smoke config (model axis 16) through the cells it
    applies to, at (4, 64): each is counted on meta and writes its JSON."""
    cfg = ARCHS[arch].smoke()
    for name, full in SHAPES.items():
        r = dryrun.run_cell(arch, name, cfg=cfg, out_dir=tmp_path,
                            shape=ShapeConfig(name, 64, 4, full.kind))
        ok, why = jshape_applicable(JARCHS[arch].smoke(), JSHAPES[name])
        if not ok:
            assert r == {"arch": arch, "shape": name, "status": "skipped", "reason": why}
            continue
        assert r["status"] == "ok" and r["data_parallel"]["counted"]["flops"] > 0
        assert (tmp_path / f"{arch}__{name}__16x16.json").is_file()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_run_cell_skips_what_jax_skips(arch):
    for name in SHAPES:
        ok, why = jshape_applicable(JARCHS[arch], JSHAPES[name])
        if not ok:
            assert dryrun.run_cell(arch, name, save=False) == \
                {"arch": arch, "shape": name, "status": "skipped", "reason": why}


def test_dryrun_cli_writes_one_json_per_cell(tmp_path):
    dryrun.main(["--arch", "qwen1.5-0.5b", "--mesh", "single", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"qwen1.5-0.5b__{s}__16x16.json"
                     for s in ("decode_32k", "prefill_32k", "train_4k")]
