"""Model FLOPs of the window's steps (``flops.py``: forward and backward, no
recompute) over the window's time, as a share of the bf16 dense peak."""

import importlib

flops = importlib.import_module("hoardbench.flops")


def read(run):
    per_token = flops.flops_per_token(run.config, run.traffic["seq_len"])
    return 100 * per_token * run.window.tokens / run.window.seconds / flops.PEAK_BF16_FLOPS
