"""The readings that the check's limits are set from, on the card at the
cell's own size, in one process.

    python3 hoardbench/control.py --workload <name> --seeds 1 2 ... \\
        [--control 3] [--fault 3] --out chiprun_out/<file>.jsonl

For each seed: the program's checked steps (``bench.run_cell`` with no
window) against the float32 reference, the lower readings.  For the first
``--control`` seeds also the control: the reference in float8 (every
product's operands rounded to e4m3, one scale a tensor) put in the
program's place against the float32 reference, the upper readings.  For the
first ``--fault`` seeds a planted fault in the reference put in the
program's place: half of each batch left out, the mean taken over the rest.
A state left unchanged reads 1 on ``change_gap`` and needs no run; a token
altered in the loader is caught exactly by ``data_mismatches``.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from hoardbench import bench, check  # noqa: E402


def _as_program(readings: dict):
    return check.ProgramReadings(losses=readings["losses"], grad=readings["grad"],
                                 change=readings["change"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = bench.load_cell(args.workload)
    os.environ.update(cell["config"].get("environment", {}))
    import torch

    dev = torch.device("cuda")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    keys = ("loss_gap", "grad_gap", "change_gap", "grad_leaf", "change_leaf", "grad_leaves",
            "change_leaves", "grad_diff", "grad_diff_leaf", "grad_diff_leaves")
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        run = bench.run_cell(cell, seed, 0, False, t_start=t0, keep_grads=True)
        ref = run["checks"]["ref"]
        rec = {"seed": seed, "kind": "program",
               **{k: run["checks"]["gaps"][k] for k in keys},
               "data_mismatches": run["checks"]["numbers"]["data_mismatches"][0],
               "program_losses": run["prog"].losses, "reference_losses": ref["losses"]}
        rows = [rec]
        if i < args.control:
            fp8 = check.reference_readings(cell["config"], cell["traffic"], seed, dev, "fp8",
                                           compare_to=ref["grad_tensors"])
            g = check.gaps(_as_program(fp8), ref, fp8["grad_diff_norms"])
            rows.append({"seed": seed, "kind": "control_fp8", **{k: g[k] for k in keys}})
        if i < args.fault:
            half = slice(0, cell["traffic"]["batch"] // 2)
            part = check.reference_readings(cell["config"], cell["traffic"], seed, dev,
                                            rows=half, compare_to=ref["grad_tensors"])
            g = check.gaps(_as_program(part), ref, part["grad_diff_norms"])
            rows.append({"seed": seed, "kind": "fault_half_batch", **{k: g[k] for k in keys}})
        for r in rows:
            r["wall_s"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
            with open(out, "a") as f:
                f.write(json.dumps(r) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
