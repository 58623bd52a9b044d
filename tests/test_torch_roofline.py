"""The port's roofline against the JAX package's, and the step counter.

* **Kernel costs**: ``kernels/cost.py``'s functions shared with JAX give
  equal floats on a seeded grid of shapes; the port's additions keep the
  file's conventions.
* **Roofline cells**: ``analytic_cell`` equals JAX's exactly in the
  numerators (FLOPs, bytes, collective bytes, model FLOPs, memory a
  device) for every cell of JAX's table; only the rates are the H100's.
* **The H100 table**: ``--check`` passes against the committed
  ``h100_table.json``, whose digest is the same under two ``PYTHONHASHSEED``
  values, and whose ``hardware`` block states the constants and the rule.
* **RooflineCompute**: ``tests/test_compute_plane.py``'s checks of JAX's.
* **The step's FLOPs**: on the qwen smoke config at (4, 64), ``step_flops``
  on the CPU over the port's ``analytic_cell`` at 1x1 lies in JAX's band
  [0.5, 1.5]; the meta count equals the CPU count exactly, for the smoke
  config of every family.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.kernels import cost as jcost
from repro.roofline import table as jtable
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import (PAPER, ComputeModel, RooflineCompute, ScenarioConfig, run_scenario)
from repro_torch.kernels import cost
from repro_torch.models import build_model
from repro_torch.models import params as PM
from repro_torch.roofline import analysis, table
from repro_torch.train import step as ST

ROOT = Path(__file__).resolve().parents[1]
CAL = dataclasses.replace(PAPER, dataset_bytes=1024 * 1024.0, dataset_items=1024,
                          batch_items=128)


# ------------------------------------------------------------- kernel costs
def _grid(seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield [int(v) for v in rng.integers(1, 9, 3)], int(rng.integers(1, 5)) * 64, \
            int(rng.choice([0, 64, 256])), bool(rng.integers(0, 2))


def _eq(a, b) -> bool:
    """Two ``KernelCost`` s (of either package) with equal floats."""
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def test_shared_cost_functions_equal_jax():
    for (b, h, blk), seq, window, causal in _grid(0):
        for kv in (seq, 2 * seq):
            kw = dict(causal=causal, window=window, block_q=blk * 16, block_k=64)
            assert _eq(cost.flash_attention_cost(b, h, seq, kv, 64, **kw),
                       jcost.flash_attention_cost(b, h, seq, kv, 64, **kw))
            assert cost.avg_context(seq, kv, causal=causal, window=window) == \
                jcost.avg_context(seq, kv, causal=causal, window=window)
        for chunk in (32, 128, 256):
            assert _eq(cost.mlstm_scan_cost(b, h, seq, 64 * blk, 128, chunk=chunk),
                       jcost.mlstm_scan_cost(b, h, seq, 64 * blk, 128, chunk=chunk))
            assert _eq(cost.ssd_scan_cost(b, h, seq, 16 * blk, 16, chunk=chunk),
                       jcost.ssd_scan_cost(b, h, seq, 16 * blk, 16, chunk=chunk))
        assert _eq(cost.swiglu_cost(b * seq, 64 * h, 128 * blk),
                   jcost.swiglu_cost(b * seq, 64 * h, 128 * blk))
    a, b = cost.KernelCost(1.0, 2.0, 3.0), jcost.KernelCost(1.0, 2.0, 3.0)
    assert _eq((a + a).scale(0.5), (b + b).scale(0.5))
    assert cost.ZERO_COST == cost.KernelCost(0.0, 0.0, 0.0)


def test_port_cost_additions_follow_the_conventions():
    f = cost.flash_attention_cost(2, 4, 128, 128, 64)
    # head_dim_v equal to head_dim gives JAX's floats; narrower v prices PV at its width
    assert cost.flash_attention_cost(2, 4, 128, 128, 64, head_dim_v=64) == f
    mla = cost.flash_attention_cost(2, 4, 128, 128, 192, head_dim_v=128)
    ctx = cost.avg_context(128, 128)
    assert mla.flops == 2.0 * 8 * 128 * ctx * (192 + 128)
    # every backward is twice its forward, but RMSNorm's bytes, which are derived
    assert cost.flash_attention_bwd_cost(2, 4, 128, 128, 64) == f.scale(2.0)
    assert cost.swiglu_bwd_cost(64, 32, 96) == cost.swiglu_cost(64, 32, 96).scale(2.0)
    assert cost.mlstm_scan_bwd_cost(1, 2, 256, 64, 64) == \
        cost.mlstm_scan_cost(1, 2, 256, 64, 64).scale(2.0)
    assert cost.ssd_scan_bwd_cost(1, 2, 256, 32, 16) == \
        cost.ssd_scan_cost(1, 2, 256, 32, 16).scale(2.0)
    r, rb = cost.rmsnorm_cost(10, 8), cost.rmsnorm_bwd_cost(10, 8)
    assert (r.flops, r.bytes_accessed) == (0.0, (2 * 10 * 8 + 8) * 2.0)
    assert (rb.flops, rb.bytes_accessed) == (0.0, (3 * 10 * 8 + 2 * 8) * 2.0)
    d = cost.decode_attention_cost(2, 8, 2, 100, 64, window=40)
    assert d.flops == 4.0 * 16 * 40 * 64
    assert d.bytes_accessed == (2.0 * 16 * 64 + 2.0 * 2 * 2 * 40 * 64) * 2


# ------------------------------------------------------------ roofline cells
NUMERATORS = ("hlo_flops_per_chip", "hlo_bytes_per_chip", "collective_bytes_per_chip",
              "model_flops", "memory_per_device")


def _jax_cells():
    out = []
    for name in sorted(JARCHS):
        for shape_name in jtable.TABLE_SHAPES:
            if not jtable.shape_applicable(JARCHS[name], JSHAPES[shape_name])[0]:
                continue
            for mesh in jtable.TABLE_MESHES:
                out.append((name, shape_name, mesh))
    return out


@pytest.mark.parametrize("arch,shape,mesh", _jax_cells())
def test_analytic_cell_numerators_equal_jax(arch, shape, mesh):
    want = jtable.analytic_cell(JARCHS[arch], JSHAPES[shape], mesh)
    got = table.analytic_cell(ARCHS[arch], SHAPES[shape], mesh)
    for key in NUMERATORS:
        assert getattr(got, key) == getattr(want, key), key
    assert got.collectives == want.collectives
    assert (got.arch, got.shape, got.mesh, got.chips) == \
        (want.arch, want.shape, want.mesh, want.chips)
    assert table.param_count(ARCHS[arch], model_axis=table.mesh_dims(mesh)[1]) == \
        jtable.param_count(JARCHS[arch], model_axis=jtable.mesh_dims(mesh)[1])


def test_h100_rates_and_collective_rule():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW) == (989e12, 3.35e12)
    assert analysis.collective_bw(8) == 450e9 and analysis.collective_bw(9) == 50e9
    rep = table.analytic_cell(ARCHS["qwen1.5-0.5b"], SHAPES["train_4k"], "4x2")
    assert rep.collective_s == rep.collective_bytes_per_chip / 450e9
    assert rep.compute_s == rep.hlo_flops_per_chip / 989e12
    assert rep.step_time_s == max(rep.compute_s, rep.memory_s, rep.collective_s)


# ------------------------------------------------------------------ the table
def test_committed_h100_table_is_current_and_deterministic():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    check = subprocess.run([sys.executable, "-m", "repro_torch.roofline.table", "--check"],
                           capture_output=True, text=True, env=env, cwd=ROOT)
    assert check.returncode == 0, check.stderr
    digests = {subprocess.run([sys.executable, "-m", "repro_torch.roofline.table", "--digest"],
                              capture_output=True, text=True, check=True, cwd=ROOT,
                              env={**env, "PYTHONHASHSEED": seed}).stdout.strip()
               for seed in ("0", "12345")}
    assert len(digests) == 1
    assert digests == {table.table_digest(json.loads(table.DEFAULT_TABLE_PATH.read_text()))}
    data = json.loads(table.DEFAULT_TABLE_PATH.read_text())
    hw = data["hardware"]
    assert (hw["peak_flops_per_chip"], hw["hbm_bw"], hw["nvlink_bw"], hw["nic_bw"],
            hw["nvlink_max_chips"]) == (989e12, 3.35e12, 450e9, 50e9, 8)
    assert "NVLink" in hw["collective_bw_rule"]
    assert table.DEFAULT_TABLE_PATH.parent == Path(table.__file__).parent
    assert {k.split("|")[2] for k in data["cells"]} <= set(jtable.TABLE_MESHES)


# ------------------------------------------------------------ RooflineCompute
def test_from_roofline_reads_committed_table():
    rc = RooflineCompute.from_roofline("qwen1.5-0.5b", "train_4k", "64x4")
    assert rc.name == "roofline"
    assert rc.items_per_step == 256            # train_4k global batch
    assert rc.step_s > 0
    assert rc.bottleneck in ("compute", "memory", "collective")
    assert rc.step_time_s(512) == pytest.approx(2 * rc.step_time_s(256))
    assert isinstance(rc, ComputeModel)
    from repro_torch.core.calibration import _default_table_path
    assert _default_table_path() == table.DEFAULT_TABLE_PATH


def test_from_roofline_table_overrides_and_errors(tmp_path):
    data = json.loads(table.DEFAULT_TABLE_PATH.read_text())
    via_dict = RooflineCompute.from_roofline("hymba-1.5b", "train_4k", "4x4", table=data)
    p = tmp_path / "table.json"
    p.write_text(json.dumps(data))
    via_path = RooflineCompute.from_roofline("hymba-1.5b", "train_4k", "4x4", table=p)
    assert via_dict == via_path
    with pytest.raises(KeyError, match="no calibration cell"):
        RooflineCompute.from_roofline("no-such-arch", table=data)
    with pytest.raises(FileNotFoundError):
        RooflineCompute.from_roofline("hymba-1.5b", table=tmp_path / "missing.json")


def test_intensity_ordering_in_committed_table():
    small = RooflineCompute.from_roofline("qwen1.5-0.5b", "train_4k", "64x4")
    big = RooflineCompute.from_roofline("hymba-1.5b", "train_4k", "4x4")
    assert small.step_s < big.step_s


def test_roofline_compute_reprices_scenario_gpu_time():
    def run(compute):
        return run_scenario(ScenarioConfig(backend="hoard", epochs=2, n_jobs=2, cal=CAL,
                                           fill="prepopulated", mdr=0.5, compute=compute))

    steps = CAL.steps_per_epoch
    rc = RooflineCompute(arch="toy", shape="s", mesh="1x1", step_s=2.0,
                         items_per_step=CAL.batch_items)
    base, priced = run(None), run(rc)
    for jb, jp in zip(base.jobs, priced.jobs):
        assert jp.epoch_times != jb.epoch_times
        assert jp.stall_breakdown["compute"] == pytest.approx(2.0 * steps * 2)
        assert all(e >= 2.0 * steps for e in jp.epoch_times)


# ------------------------------------------------------------ the step's FLOPs
def _batch(cfg, device, B=4, S=64, seed=0):
    rng = np.random.default_rng(seed)
    n_text = S - (cfg.vlm.n_image_tokens if cfg.vlm else 0)
    out = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (B, n_text))).to(device)
           for k in ("tokens", "labels")}
    dt = PM.as_dtype(cfg.dtype)
    if cfg.family == "encdec":
        out["enc_emb"] = torch.as_tensor(rng.standard_normal((B, S, cfg.d_model)),
                                         dtype=dt).to(device)
    if cfg.vlm:
        out["img_emb"] = torch.as_tensor(rng.standard_normal((B, cfg.vlm.n_image_tokens,
                                                              cfg.d_model)), dtype=dt).to(device)
    return out


def test_step_flops_within_jax_band_of_analytic_cell():
    """JAX holds its walked HLO FLOPs within [0.5, 1.5] of the analytic cell
    (``tests/test_compute_plane.py``); the port's counted step is held to the
    same band on the same smoke config and (4, 64) batch."""
    cfg = ARCHS["qwen1.5-0.5b"].smoke()
    model = build_model(cfg, model_axis=1, device="cpu")
    flops = ST.step_flops(model, _batch(cfg, "cpu"))
    cell = table.analytic_cell(cfg, ShapeConfig("tiny_train", 64, 4, "train"), "1x1",
                               n_params=PM.param_count(model.layout()))
    ratio = flops / cell.hlo_flops_per_chip
    assert 0.5 <= ratio <= 1.5, ratio


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_count_equals_cpu_count(arch):
    cfg = ARCHS[arch].smoke()
    got = {}
    for device in ("meta", "cpu"):
        model = build_model(cfg, model_axis=1, device=device)
        batch = _batch(cfg, "cpu")
        if device == "meta":
            batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                     for k, v in batch.items()}
        got[device] = ST.step_costs(model, batch)
    for key in ("flops", "traffic_bytes", "matmul_flops", "aten_bytes", "kernels"):
        assert got["meta"][key] == got["cpu"][key], key
    assert got["cpu"]["flops"] > 0 and got["cpu"]["kernels"]
    assert got["meta"]["start_bytes"] == got["cpu"]["start_bytes"]
    assert got["meta"]["peak_bytes"] > got["meta"]["start_bytes"]
