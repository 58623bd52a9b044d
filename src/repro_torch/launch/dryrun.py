"""The dry-run on the meta device: JAX's ``launch/dryrun.py`` for the port.

For each (arch x shape x mesh) cell it builds the model at the production
mesh's ``model`` axis with ``params.abstract`` weights and an abstract
AdamW state (tensors on ``torch.device("meta")``: shapes and dtypes, no
storage, nothing drawn), and judges the cell two ways:

* **production** — JAX's layout on the stand-in production mesh (16 x 16
  ``data x model``, or 2 x 16 x 16 with ``pod``; ``launch.mesh.AbstractMesh``):
  a rank's weights and gradients as shards of ``params.specs``, its AdamW
  state as shards of ``opt_state_specs``, its inputs as shards of
  ``registry.input_specs`` (``state_bytes``).  The port executes this
  layout for the train cells of ``DecoderLM`` (dense, MoE, MLA, VLM): one
  rank's tensor-parallel step (``train.step.tp_step_costs``, the
  ``AbstractMesh``'s collectives giving the shapes a real mesh's would) is
  counted on meta, and its live-bytes peak (its parameter shards, its ZeRO
  state, the batch, the activations, gradients and the update's
  temporaries) is ``total_bytes``, against which ``fits_80gb`` is judged;
  its FLOPs, traffic and collective bytes ride beside it (``step``).  Its
  serving cells (``prefill_32k``, ``decode_32k`` and, with a window,
  ``long_500k``) count rank 0's tensor-parallel ``prefill`` or
  ``decode_step`` the same way (``train.step.tp_serve_costs``): its
  parameter shards, its shard of the cache (slots cut over ``model``, rows
  over the data axes where the batch divides), its inputs and the step's
  peak above them make ``total_bytes``.  The other families keep the state
  alone: ``fits_80gb`` on ``state_bytes``.
* **data_parallel** — what the port executes today: every chip a data
  rank, ZeRO-1 over all of them (``opt_state_specs`` on a ``chips x 1``
  mesh).  One step at a rank's rows (``global_batch / chips``, rounded up:
  where the batch does not divide, a rank holds one row and the ranks past
  the batch idle; the decode cells at their cache) runs on meta under the
  step counter
  (:mod:`repro_torch.roofline.count`): its FLOPs, traffic and kernel calls,
  and its live-bytes peak above the state it starts with (activations,
  gradients and the update's temporaries), which with the full weights,
  the ZeRO shard of the AdamW state and the inputs gives ``total_bytes``.

The train cells also carry the analytic cell of the production mesh
(``roofline.table.analytic_cell``, H100 constants) beside the count, and
the two's FLOPs over the whole batch (``counted_over_analytic_flops``).  A
cell fits when its bytes are at most ``HBM_PER_CHIP`` (80 GB).  The step
runs at the config's rematerialisation (``remat``: JAX's ``"dots"`` unless
``--override remat=none`` or ``=full``), whose recompute the count includes
and whose saved activations the peak holds; a cell that does not fit is
reported, not escalated.  The cells that ``shape_applicable`` refuses are
skipped with its reason.  Each cell that runs is written as JSON under
``--out``.

It needs no card: meta is its device by design, as JAX's dry-run runs on
512 fake host devices.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod
    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k \
        --override remat=none
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from dataclasses import replace
from pathlib import Path


from ..configs import ALL_SHAPES, ARCHS, SHAPES, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..models import params as PM
from ..models.registry import build_model, input_specs, step_fn
from ..roofline import count as C
from ..roofline.analysis import RooflineReport, model_flops
from ..roofline.table import analytic_cell
from ..train.optimizer import AdamWConfig, abstract_opt_state, opt_state_specs
from ..train.step import step_costs, tp_serve_costs, tp_step_costs
from ..parallel import NamedSharding
from .mesh import AbstractMesh, make_abstract_production_mesh

HBM_PER_CHIP = 80e9          # H100 SXM5 80 GB

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _shard_bytes(tree, spec_tree, mesh) -> int:
    """The bytes of this rank's shards of every tensor of ``tree`` (leaf for
    leaf against ``spec_tree``) on ``mesh``."""
    specs = iter(PM.tree_leaves(spec_tree))
    total = 0
    for t in PM.tree_leaves(tree):
        shape = NamedSharding(mesh, next(specs)).shard_shape(t.shape)
        total += math.prod(shape) * t.element_size()
    return total


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in PM.tree_leaves(tree))


def _cfg_with(cfg, overrides: dict | None):
    """JAX's override rules: MoE and SSM fields go to their blocks."""
    if not overrides:
        return cfg
    overrides = dict(overrides)
    moe_keys = {k: overrides.pop(k) for k in list(overrides)
                if cfg.moe is not None and hasattr(cfg.moe, k)}
    ssm_keys = {k: overrides.pop(k) for k in list(overrides)
                if cfg.ssm is not None and hasattr(cfg.ssm, k) and not hasattr(cfg, k)}
    if moe_keys:
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_keys))
    if ssm_keys:
        cfg = replace(cfg, ssm=replace(cfg.ssm, **ssm_keys))
    if overrides:
        cfg = replace(cfg, **overrides)
    return cfg


def _active_params(cfg, n_params: int):
    """Active parameters as JAX's dry-run counts them (MoE: top_k of the routed)."""
    if cfg.moe is None:
        return None
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    expert_params = 3 * cfg.d_model * cfg.moe.d_expert
    routed_total = (cfg.n_layers - (1 if cfg.moe.first_dense else 0)) * E * expert_params
    return n_params - routed_total + routed_total * K // E


@functools.lru_cache(maxsize=None)
def _meta_step(cfg, shape: ShapeConfig, rows: int, model_axis: int) -> tuple:
    """``(counts, input bytes)`` of one step at ``rows`` on meta, counted once
    a process for each cell (both production meshes give a rank the same rows
    and the model the same layout)."""
    model = build_model(cfg, model_axis=model_axis, device="meta")
    opt_cfg = AdamWConfig()
    cell = ShapeConfig(shape.name, shape.seq_len, rows, shape.kind)
    batch, _ = input_specs(cfg, cell, model=model)
    in_bytes = _bytes(batch)
    if shape.kind == "train":
        return step_costs(model, batch, opt_cfg=opt_cfg), in_bytes
    params = PM.abstract(model.layout(), cfg.dtype)
    if shape.kind == "decode":
        batch["index"] = shape.seq_len - 1          # the last slot; read on the host
    _, counts = C.count(step_fn(cfg, cell, model=model), params, batch)
    return counts, in_bytes


@functools.lru_cache(maxsize=None)
def _tp_meta_step(cfg, shape: ShapeConfig, multi_pod: bool) -> dict:
    """The counts of rank 0's tensor-parallel train step on the production
    mesh, on meta, once a process for each cell."""
    mesh = make_abstract_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg, mesh=mesh, model_axis=mesh.shape["model"], device="meta")
    batch, _ = input_specs(cfg, shape, mesh=mesh, model=model)
    return tp_step_costs(model, batch, mesh)


@functools.lru_cache(maxsize=None)
def _tp_meta_serve(cfg, shape: ShapeConfig, multi_pod: bool) -> dict:
    """The counts of rank 0's tensor-parallel prefill or decode step on the
    production mesh, on meta, once a process for each cell."""
    mesh = make_abstract_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg, mesh=mesh, model_axis=mesh.shape["model"], device="meta")
    return tp_serve_costs(model, mesh, shape.kind, shape.global_batch, shape.seq_len)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, overrides: dict = None,
             save: bool = True, out_dir: Path | str | None = None,
             cfg: ModelConfig | None = None, shape: ShapeConfig | None = None) -> dict:
    """One cell: the skip of ``shape_applicable``, or the result described in
    the module's docstring, written as JSON under ``out_dir`` with ``save``.
    ``cfg`` and ``shape`` stand in for ``ARCHS[arch]`` and ``SHAPES[shape_name]``
    where given (the tests' smoke configs at small shapes)."""
    cfg = _cfg_with(cfg or ARCHS[arch], overrides)
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": why}

    mesh = make_abstract_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    chips = mesh.size
    t0 = time.perf_counter()
    model = build_model(cfg, mesh=mesh, model_axis=mesh.shape["model"], device="meta")
    layout = model.layout()
    opt_cfg = AdamWConfig()
    is_train = shape.kind == "train"
    n_params = PM.param_count(layout)

    # ---- production: JAX's layout on the stand-in mesh, state alone
    params_abs = PM.abstract(layout, cfg.dtype)
    weights = _shard_bytes(params_abs, PM.specs(layout), mesh)
    batch_abs, batch_spec = input_specs(cfg, shape, mesh=mesh, model=model)
    prod = {"weights_bytes": weights, "grad_bytes": weights if is_train else 0,
            "opt_state_bytes": (_shard_bytes(abstract_opt_state(layout, opt_cfg),
                                             opt_state_specs(layout, mesh, opt_cfg), mesh)
                                if is_train else 0),
            "input_bytes": _shard_bytes(batch_abs, batch_spec, mesh)}
    prod["state_bytes"] = sum(prod.values())
    prod["fits_80gb"] = prod["state_bytes"] <= HBM_PER_CHIP
    prod["executed"] = model.tensor_parallel
    if prod["executed"]:
        tp = (_tp_meta_step if is_train else _tp_meta_serve)(cfg, shape, multi_pod)
        prod["step_peak_above_state_bytes"] = tp["peak_above_start_bytes"]
        prod["total_bytes"] = tp["peak_bytes"]
        prod["fits_80gb"] = prod["total_bytes"] <= HBM_PER_CHIP
        prod["step"] = {k: tp[k] for k in ("flops", "traffic_bytes", "collective_bytes",
                                           "collectives", "kernels", "start_bytes")}

    # ---- data_parallel: every chip a data rank, ZeRO-1 over all of them
    dp_mesh = AbstractMesh((chips, 1), ("data", "model"))
    rows = -(-shape.global_batch // chips)
    counts, in_bytes = _meta_step(cfg, shape, rows, mesh.shape["model"])
    dp = {"rows_per_rank": rows, "weights_bytes": _bytes(params_abs),
          "opt_state_bytes": (_shard_bytes(abstract_opt_state(layout, opt_cfg),
                                           opt_state_specs(layout, dp_mesh, opt_cfg), dp_mesh)
                              if is_train else 0),
          "input_bytes": in_bytes,
          "step_peak_above_state_bytes": counts["peak_above_start_bytes"]}
    dp["total_bytes"] = (dp["weights_bytes"] + dp["opt_state_bytes"] + dp["input_bytes"]
                         + dp["step_peak_above_state_bytes"])
    dp["fits_80gb"] = dp["total_bytes"] <= HBM_PER_CHIP
    dp_cell = analytic_cell(cfg, shape, f"{chips}x1", n_params=n_params) if is_train else None
    report = RooflineReport(
        arch=arch, shape=shape_name, mesh=f"{chips}x1", chips=chips,
        hlo_flops_per_chip=counts["flops"], hlo_bytes_per_chip=counts["traffic_bytes"],
        collective_bytes_per_chip=dp_cell.collective_bytes_per_chip if dp_cell else 0.0,
        collectives=dp_cell.collectives if dp_cell else {},
        model_flops=model_flops(cfg, shape, n_params, cfg.vocab * cfg.d_model,
                                _active_params(cfg, n_params)),
        memory_per_device=float(dp["total_bytes"]))
    dp["roofline"] = report.to_dict()
    dp["counted"] = {k: counts[k] for k in ("flops", "traffic_bytes", "matmul_flops",
                                            "aten_bytes", "kernel_flops", "kernel_bytes",
                                            "kernels", "aten_ops")}
    result = {
        "status": "ok", "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "device": "meta", "count_s": round(time.perf_counter() - t0, 1),
        "hardware": "NVIDIA H100 SXM5 80GB (roofline constants)",
        "n_params": n_params, "remat": cfg.remat,
        "model_flops": report.model_flops,
        "counted_flops_per_chip": counts["flops"],
        "counted_bytes_per_chip": counts["traffic_bytes"],
        "fits_80gb": dp["fits_80gb"], "hbm_per_chip": HBM_PER_CHIP,
        "production": prod, "data_parallel": dp,
    }
    if is_train:
        # the production mesh as the table names it: data (pod x data) x model
        analytic = analytic_cell(cfg, shape, f"{chips // mesh.shape['model']}x"
                                 f"{mesh.shape['model']}", n_params=n_params)
        result["analytic"] = analytic.to_dict()
        # the whole batch's work on both sides: the busy ranks' counted steps
        # against the analytic cell's FLOPs a chip times its chips
        busy = -(-shape.global_batch // rows)
        result["counted_over_analytic_flops"] = (
            counts["flops"] * busy / (analytic.hlo_flops_per_chip * analytic.chips))
    if save:
        out = Path(out_dir) if out_dir is not None else RESULTS_DIR
        out.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape_name}__{mesh_name}"
        if overrides:
            tag += "__" + "_".join(f"{k}-{v}" for k, v in sorted(overrides.items()))
        (out / f"{tag}.json").write_text(json.dumps(result, indent=1, default=str))
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="the dry-run on the meta device")
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides, e.g. --override n_layers=2")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR,
                    help="directory of the cells' JSON files")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = {"True": True, "False": False}.get(v, v)
        if isinstance(overrides[k], str) and overrides[k].lstrip("-").isdigit():
            overrides[k] = int(overrides[k])

    meshes = []
    if args.mesh in ("single", "both") or (args.mesh is None and not args.multi_pod):
        meshes.append(False)
    if args.mesh in ("multi", "both") or args.multi_pod:
        meshes.append(True)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if (args.all or not args.shape) else [args.shape]
    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]

    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch:24s} {shape:12s} {'2x16x16' if mp else '16x16':8s}"
        try:
            r = run_cell(arch, shape, multi_pod=mp, overrides=overrides or None,
                         out_dir=args.out)
            if r["status"] == "skipped":
                print(f"SKIP {tag} ({r['reason'][:60]})", flush=True)
            else:
                dp, prod = r["data_parallel"], r["production"]
                total = prod.get("total_bytes", prod["state_bytes"])
                print(f"OK   {tag} count={r['count_s']:6.1f}s "
                      f"flops/chip={r['counted_flops_per_chip']:.3e} "
                      f"state/rank={prod['state_bytes'] / 1e9:.2f}GB "
                      f"{'step' if prod['executed'] else 'state'}/rank={total / 1e9:.2f}GB "
                      f"({'fits' if prod['fits_80gb'] else 'over'}) "
                      f"dp={dp['total_bytes'] / 1e9:.2f}GB "
                      f"({'fits' if dp['fits_80gb'] else 'over'}) "
                      f"bottleneck={dp['roofline']['bottleneck']}", flush=True)
        except Exception as err:
            failures += 1
            print(f"FAIL {tag} {type(err).__name__}: {str(err)[:200]}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
