"""The cells at sizes a CPU test holds: every configuration's widths cut, the
program in float32 on the CPU, and limits that float32 on both sides keeps
well inside."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "phi4-mini-3.8b": {
        "file": {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "vocab_size": 256, "num_hidden_layers": 2},
        "assumed": {"head_dim": 16},
        "port": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                 "d_ff": 128, "vocab": 256},
    },
    "deepseek-v2-lite-16b.L4": {
        "file": {"hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
                 "num_key_value_heads": 4, "vocab_size": 256, "num_hidden_layers": 3,
                 "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                 "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
                 "moe_intermediate_size": 32},
        "assumed": {"head_dim": 24},
        "port": {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 24,
                 "d_ff": 32, "vocab": 256,
                 "moe": {"n_experts": 8, "top_k": 2, "d_expert": 32, "first_dense_ff": 96},
                 "mla": {"kv_lora_rank": 32, "qk_nope_dim": 16, "qk_rope_dim": 8,
                         "v_head_dim": 16}},
    },
}

TRAFFIC = {"batch": 2, "seq_len": 16, "n_items": 64, "items_per_chunk": 4}
LIMITS = {"data_mismatches": 0, "loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3,
          "grad_diff": 1e-3}


def tiny_cell(workload: str, dtype: str = "float32") -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` at the CPU's size."""
    import sys

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from hoardbench import bench

    cell = copy.deepcopy(bench.load_cell(workload))
    cfg = cell["config"]
    t = TINY[cfg["name"]]
    cfg.update(t["file"])
    cfg["assumed"] = {**cfg["assumed"], **t["assumed"], "dtype": dtype}
    cfg["port"] = {"arch": cfg["port"]["arch"],
                   "overrides": {**cfg["port"]["overrides"], **t["port"], "dtype": dtype}}
    cell["traffic"] = {**cell["traffic"], **TRAFFIC}
    cell["limits"] = dict(LIMITS)
    json.dumps(cell)
    return cell
