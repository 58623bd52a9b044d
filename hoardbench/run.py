"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 hoardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.  Exits non-zero with no result when no CUDA
card is there, when the run fails, or when the process holds a module of
JAX or of the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from hoardbench import bench  # noqa: E402

#: caches of compilers that the program may use, at fixed paths in the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/hoardbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/hoardbench/triton"}
#: one host thread for the CPU's own arithmetic: the host's work here is the
#: dispatch of the card's, on the main thread, beside other tenants' processes
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = bench.load_cell(args.workload)
    for k, v in CACHE_DIRS.items():
        os.environ[k] = str(ROOT / v)
    os.environ.update(THREADS)
    os.environ.update(cell["config"].get("environment", {}))

    import torch

    torch.set_num_threads(1)

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hoardbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = bench.forbidden_modules()
    if found:
        print(f"hoardbench: the process holds {found} once the window closed", file=sys.stderr)
        return 3
    res = bench.result(cell, out, bool(args.trace))
    for name, (value, limit) in res["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
