"""On the card: one short run of each cell through the benchmark's command,
correct, with every metric the cell declares.

    python3 -m pytest -q hoardbench/tests -m card      # on an H100
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_short_run_is_correct(card, workload, trace):
    p = subprocess.run([sys.executable, "hoardbench/run.py", "--workload", workload, "--seed",
                        str(2**31 + 101), "--seconds", "3", "--trace", str(trace)],
                       capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind] if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
