"""Runs of one cell in a row, one process each, as the check runs them.

    python3 hoardbench/series.py --workload <name> --seeds 11 12 13 --seconds 30 \\
        [--trace 0|1] [--out chiprun_out/<file>.jsonl]

Prints the card's name and power limit, then each run's last line, its exit
code and its wall seconds; with ``--out`` also appends them there as JSON
lines, with the end of each run's standard error.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    info = card()
    print(f"card: {info}", flush=True)
    bad = 0
    for seed in args.seeds:
        cmd = [sys.executable, str(HERE / "run.py"), "--workload", args.workload, "--seed",
               str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        last = lines[-1] if lines else ""
        rec = {"workload": args.workload, "seed": seed, "seconds": args.seconds,
               "trace": args.trace, "rc": p.returncode, "wall_s": wall, "card": info,
               "last_line": last, "stderr_tail": p.stderr[-3000:]}
        bad += p.returncode != 0
        print(json.dumps({k: rec[k] for k in ("seed", "trace", "rc", "wall_s")}), flush=True)
        print(last if p.returncode == 0 else p.stderr[-3000:], flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
