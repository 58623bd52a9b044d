"""The control at a size the CPU holds: the reference computed in float8
(every product's operands and gradients in e4m3) put in the program's place
reads at least three times further from the float32 reference than the bf16
program does, on the number that the cell's limits hold it by (the limits
themselves are set from readings at the cell's own size on the card,
``control.py``)."""

import pytest
import torch

from _tiny import tiny_cell

#: the number that separates the control in each cell (``PERF.md`` §2)
SEPARATING = {"phi4-mini-3.8b.train.2x1024": "grad_gap",
              "deepseek-v2-lite-16b.L4.train.4x4096": "grad_diff"}


@pytest.mark.parametrize("workload", sorted(SEPARATING))
@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_control_reads_further_than_the_program(workload, seed):
    from hoardbench import bench, check

    cell = tiny_cell(workload, "bfloat16")
    run = bench.run_cell(cell, seed, 0, False, t_start=0.0, device="cpu", keep_grads=True)
    ref = run["checks"]["ref"]
    fp8 = check.reference_readings(cell["config"], cell["traffic"], seed, torch.device("cpu"),
                                   "fp8", compare_to=ref["grad_tensors"])
    control = check.gaps(check.ProgramReadings(losses=fp8["losses"], grad=fp8["grad"],
                                               change=fp8["change"]), ref,
                         fp8["grad_diff_norms"])
    key = SEPARATING[workload]
    assert control[key] >= 3 * run["checks"]["gaps"][key], (control[key],
                                                            run["checks"]["gaps"][key])


def test_fp8_rounding_is_coarser_than_bf16():
    from hoardbench.reference.model import _fp8

    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = ((_fp8(x) - x).abs() / x.abs().clamp_min(1e-3)).median()
    e16 = ((x.bfloat16().float() - x).abs() / x.abs().clamp_min(1e-3)).median()
    assert e8 > 8 * e16
