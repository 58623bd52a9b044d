"""The deterministic roofline table at the H100's constants: per-(arch x shape x mesh) step time.

The compute plane's price of a training step, JAX's ``roofline/table.py``
with its arithmetic in the same order and the card's constants
(:mod:`repro_torch.roofline.analysis`).  Each cell prices one training step
of one architecture on one ``data x model`` mesh as

    step_time = max(compute, memory, collective)

with the three terms assembled from the port's own pieces:

* **compute** — ``6*N*D`` matmul FLOPs (:func:`~repro_torch.roofline.analysis
  .model_flops`, N from the port's model layouts) plus the attention/scan
  kernel FLOPs from the kernel cost estimates (:mod:`repro_torch.kernels.cost`),
  over ``chips * PEAK_FLOPS``;
* **memory** — per-chip HBM traffic: weight reads (fwd+bwd), AdamW
  optimizer-state sweep, activation reads/writes
  (``ACT_PASSES * layers * tokens/dp * d_model`` bytes) and the kernels'
  tiled ``bytes_accessed``, over ``HBM_BW``;
* **collective** — ring gradient all-reduce over the data axis plus
  tensor-parallel activation all-reduces over the model axis (raw per-chip
  byte sum), over ``collective_bw(chips)``: NVLink within one 8-chip node,
  the NIC beyond.

Determinism: every term is closed-form arithmetic over the frozen
``ModelConfig``/``ShapeConfig`` dataclasses and the layouts' parameter
counts — no RNG, no wall clock, no hash iteration order
(``json.dumps(sort_keys=True)``).  Regenerating the table under any
``PYTHONHASHSEED`` gives ``h100_table.json`` (beside this module) byte for
byte; ``--check`` holds the committed file to that.  The layouts are built
on the meta device: no weight is drawn.

CLI::

    PYTHONPATH=src python -m repro_torch.roofline.table --write   # refresh the table
    PYTHONPATH=src python -m repro_torch.roofline.table --check   # drift gate
    PYTHONPATH=src python -m repro_torch.roofline.table --digest  # its sha256
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path
from typing import Optional

from ..configs import ARCHS, SHAPES, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.cost import (
    KernelCost,
    ZERO_COST,
    flash_attention_cost,
    mlstm_scan_cost,
    ssd_scan_cost,
)
from .analysis import (
    COLLECTIVE_RULE,
    HBM_BW,
    NIC_BW,
    NVLINK_BW,
    NVLINK_CHIPS,
    PEAK_FLOPS,
    RooflineReport,
    model_flops,
)

SCHEMA_VERSION = 1
DTYPE_BYTES = 2                    # bf16 weights/activations
#: AdamW per-parameter HBM bytes per step: f32 m, v and master each read +
#: written, plus the bf16 gradient read and weight write (8*4 + 2*2 = 36).
OPT_BYTES_PER_PARAM = 36.0
#: activation traffic: block in/out tensors touched across fwd, bwd and the
#: remat re-forward, ~4 HBM-visible tensors per block per pass
ACT_PASSES = 12.0
#: resident HBM per parameter: bf16 weights + grads, f32 m/v/master
RESIDENT_BYTES_PER_PARAM = 16.0

#: meshes priced in the committed table, "<data>x<model>" (chips = d*m)
TABLE_MESHES = ("4x4", "16x16", "64x4", "128x4")
TABLE_SHAPES = ("train_4k",)

#: the committed H100 table, inside the package
DEFAULT_TABLE_PATH = Path(__file__).resolve().parent / "h100_table.json"


def mesh_dims(mesh: str) -> tuple[int, int]:
    """``"64x4"`` -> ``(data=64, model=4)``."""
    try:
        d, m = mesh.split("x")
        dp, mp = int(d), int(m)
    except ValueError:
        raise ValueError(f"mesh must look like '<data>x<model>', got {mesh!r}") from None
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh axes must be >= 1, got {mesh!r}")
    return dp, mp


def cell_key(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}|{shape}|{mesh}"


def _remat_extra_fwd(cfg: ModelConfig) -> float:
    """Extra forward passes paid by the remat policy (dots/full ~= one)."""
    return 0.0 if cfg.remat == "none" else 1.0


def _active_params(cfg: ModelConfig, n_params: int) -> int:
    """Per-token active parameters (MoE: only top_k + shared experts run)."""
    if cfg.moe is None:
        return n_params
    moe = cfg.moe
    n_moe_layers = cfg.n_layers - (1 if moe.first_dense else 0)
    expert_params = 3 * cfg.d_model * moe.d_expert
    inactive = max(0, moe.n_experts - moe.top_k) * expert_params * n_moe_layers
    return n_params - inactive


def kernel_cost(cfg: ModelConfig, shape: ShapeConfig) -> KernelCost:
    """Forward attention/scan kernel cost of one whole-model step (global)."""
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    kc = ZERO_COST
    if cfg.family in ("dense", "moe", "vlm"):
        per_layer = flash_attention_cost(
            B, cfg.n_heads, S, S, hd,
            causal=True, window=cfg.sliding_window,
            block_q=cfg.q_block, block_k=cfg.kv_block,
        )
        kc = kc + per_layer.scale(cfg.n_layers)
    elif cfg.family == "encdec":
        enc = flash_attention_cost(
            B, cfg.n_heads, S, S, hd, causal=False,
            block_q=cfg.q_block, block_k=cfg.kv_block,
        )
        dec_self = flash_attention_cost(
            B, cfg.n_heads, S, S, hd, causal=True,
            block_q=cfg.q_block, block_k=cfg.kv_block,
        )
        cross = flash_attention_cost(
            B, cfg.n_heads, S, S, hd, causal=False,
            block_q=cfg.q_block, block_k=cfg.kv_block,
        )
        kc = (
            kc
            + enc.scale(cfg.encdec.n_encoder_layers)
            + (dec_self + cross).scale(cfg.n_layers)
        )
    elif cfg.family == "ssm":
        # xLSTM: matrix-memory scan in every mLSTM block (the sLSTM blocks'
        # recurrence is elementwise — its projections already sit in 6*N*D)
        inner = cfg.ssm.expand * cfg.d_model
        dv = inner // cfg.n_heads
        dqk = dv // 2
        n_mlstm = cfg.n_layers - cfg.n_layers // cfg.ssm.slstm_every
        per_layer = mlstm_scan_cost(B, cfg.n_heads, S, dqk, dv, chunk=cfg.ssm.chunk)
        kc = kc + per_layer.scale(n_mlstm)
    elif cfg.family == "hybrid":
        # Hymba: every block runs SWA attention (a few layers global) in
        # parallel with Mamba-2 SSD heads
        hb = cfg.hybrid
        n_global = len(hb.global_layers)
        n_swa = cfg.n_layers - n_global
        swa = flash_attention_cost(
            B, cfg.n_heads, S, S, hd,
            causal=True, window=hb.sliding_window,
            block_q=cfg.q_block, block_k=cfg.kv_block,
        )
        full = flash_attention_cost(
            B, cfg.n_heads, S, S, hd, causal=True,
            block_q=cfg.q_block, block_k=cfg.kv_block,
        )
        chd = (cfg.ssm.expand * cfg.d_model) // hb.n_ssm_heads
        ssd = ssd_scan_cost(
            B, hb.n_ssm_heads, S, chd, cfg.ssm.state_dim, chunk=cfg.ssm.chunk
        )
        kc = kc + swa.scale(n_swa) + full.scale(n_global) + ssd.scale(cfg.n_layers)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return kc


def _total_layers(cfg: ModelConfig) -> int:
    n = cfg.n_layers
    if cfg.encdec is not None:
        n += cfg.encdec.n_encoder_layers
    return n


def analytic_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh: str,
    *,
    n_params: Optional[int] = None,
) -> RooflineReport:
    """Price one (arch x shape x mesh) cell; pass ``n_params`` to skip building the layout."""
    dp, mp = mesh_dims(mesh)
    chips = dp * mp
    if n_params is None:
        n_params = param_count(cfg, model_axis=mp)

    B, S = shape.global_batch, shape.seq_len
    tokens = float(B * S) if shape.kind != "decode" else float(B)
    embed_params = cfg.vocab * cfg.d_model
    # tie_embeddings shares the LM-head matrix with the (non-FLOP) embedding
    # lookup; count its matmul work by re-adding it after the embed subtract
    head_params = embed_params if cfg.tie_embeddings else 0
    active = _active_params(cfg, n_params)
    useful_flops = model_flops(
        cfg, shape, n_params + head_params, embed_params, active + head_params
    )

    is_train = shape.kind == "train"
    extra_fwd = _remat_extra_fwd(cfg) if is_train else 0.0
    # 6*N*D = 2 fwd + 4 bwd passes; remat re-runs the forward once more
    matmul_flops = useful_flops * (1.0 + extra_fwd / 3.0)
    kc = kernel_cost(cfg, shape)
    # kernel forward cost -> training cost: fwd + ~2x bwd (+ remat re-fwd)
    kernel_factor = (3.0 + extra_fwd) if is_train else 1.0
    flops_pc = (matmul_flops + kc.flops * kernel_factor) / chips

    # ---- per-chip HBM traffic -------------------------------------------
    params_pc = n_params / mp            # weights sharded over the model axis
    tokens_pc = tokens / dp              # batch sharded over the data axis
    layers = _total_layers(cfg)
    weight_bytes = 2.0 * params_pc * DTYPE_BYTES
    opt_bytes = OPT_BYTES_PER_PARAM * params_pc if is_train else 0.0
    act_bytes = ACT_PASSES * layers * tokens_pc * cfg.d_model * DTYPE_BYTES
    kernel_bytes = kc.bytes_accessed * kernel_factor / chips
    bytes_pc = weight_bytes + opt_bytes + act_bytes + kernel_bytes

    # ---- per-chip collective bytes --------------------------------------
    grad_ar = 2.0 * (dp - 1) / dp * params_pc * DTYPE_BYTES if is_train else 0.0
    tp_passes = 4.0 if is_train else 2.0     # 2 all-reduces/layer fwd (+bwd)
    tp_ar = tp_passes * layers * tokens_pc * cfg.d_model * DTYPE_BYTES * (mp - 1) / mp
    coll_pc = grad_ar + tp_ar

    return RooflineReport(
        arch=cfg.arch,
        shape=shape.name,
        mesh=mesh,
        chips=chips,
        hlo_flops_per_chip=flops_pc,
        hlo_bytes_per_chip=bytes_pc,
        collective_bytes_per_chip=coll_pc,
        collectives={"grad-all-reduce": grad_ar, "tp-all-reduce": tp_ar},
        model_flops=useful_flops,
        memory_per_device=params_pc * RESIDENT_BYTES_PER_PARAM,
    )


_PARAM_COUNT_CACHE: dict[tuple[str, int], int] = {}


def param_count(cfg: ModelConfig, *, model_axis: int = 16) -> int:
    """Total parameters of ``cfg`` from the port's model layout (built on meta)."""
    key = (cfg.arch, model_axis)
    if key not in _PARAM_COUNT_CACHE:
        from ..models import params as PM            # lazy: the models import the kernels
        from ..models.registry import build_model

        model = build_model(cfg, model_axis=model_axis, device="meta")
        _PARAM_COUNT_CACHE[key] = int(PM.param_count(model.layout()))
    return _PARAM_COUNT_CACHE[key]


def generate_table(
    archs=None,
    shapes=TABLE_SHAPES,
    meshes=TABLE_MESHES,
) -> dict:
    """The full calibration table as a canonical-ready dict."""
    names = sorted(archs) if archs is not None else sorted(ARCHS)
    cells: dict[str, dict] = {}
    for name in names:
        cfg = ARCHS[name]
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            ok, _why = shape_applicable(cfg, shape)
            if not ok:
                continue
            for mesh in meshes:
                dp, mp = mesh_dims(mesh)
                if shape.global_batch % dp != 0:
                    continue                 # batch must shard the data axis
                report = analytic_cell(cfg, shape, mesh)
                cell = report.to_dict()
                cell["n_params"] = param_count(cfg, model_axis=mp)
                cell["tokens_per_step"] = shape.global_batch * shape.seq_len
                cell["items_per_step"] = shape.global_batch
                cells[cell_key(name, shape_name, mesh)] = cell
    return {
        "schema_version": SCHEMA_VERSION,
        "hardware": {
            "chip": "NVIDIA H100 SXM5 80GB",
            "peak_flops_per_chip": PEAK_FLOPS,
            "hbm_bw": HBM_BW,
            "nvlink_bw": NVLINK_BW,
            "nic_bw": NIC_BW,
            "nvlink_max_chips": NVLINK_CHIPS,
            "collective_bw_rule": COLLECTIVE_RULE,
            "source": "NVIDIA H100 Tensor Core GPU datasheet (SXM5)",
        },
        "cells": cells,
    }


def table_json(table: dict) -> str:
    """Canonical byte representation (sorted keys, fixed indent)."""
    return json.dumps(table, sort_keys=True, indent=1) + "\n"


def table_digest(table: dict) -> str:
    return hashlib.sha256(table_json(table).encode()).hexdigest()


def write_table(path: Optional[Path] = None, **kw) -> Path:
    path = Path(path) if path is not None else DEFAULT_TABLE_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(table_json(generate_table(**kw)))
    return path


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--out", type=Path, default=DEFAULT_TABLE_PATH,
        help="table path (default: the committed h100_table.json)",
    )
    ap.add_argument("--write", action="store_true", help="regenerate the table file")
    ap.add_argument(
        "--check", action="store_true",
        help="regenerate and fail (exit 1) if the file on disk differs",
    )
    ap.add_argument("--digest", action="store_true", help="print the table sha256")
    args = ap.parse_args(argv)

    if args.check:
        fresh = table_json(generate_table())
        on_disk = args.out.read_text() if args.out.exists() else ""
        if fresh != on_disk:
            print(f"H100 roofline table drift: {args.out} is stale "
                  f"(regenerate with --write)", file=sys.stderr)
            return 1
        print(f"{args.out}: up to date ({len(fresh)} bytes)")
        return 0
    if args.digest:
        print(table_digest(generate_table()))
        return 0
    if args.write:
        path = write_table(args.out)
        print(f"wrote {path}")
        return 0
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
