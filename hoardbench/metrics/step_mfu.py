"""The whole step's share of the bf16 dense peak, read in the traced run
beside the kernels' roofline: ``mfu``'s reading of that run's window."""

import importlib

read = importlib.import_module("hoardbench.metrics.mfu").read
