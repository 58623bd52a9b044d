"""The roofline at the H100's constants, and the port's step counter.

* :mod:`.analysis` — ``RooflineReport`` and ``model_flops`` (JAX's) at the
  H100 SXM's rates;
* :mod:`.table` — the deterministic table of analytic cells
  (``analytic_cell``, ``generate_table``, ``h100_table.json``);
* :mod:`.count` — one step's FLOPs, traffic, kernel calls and live-bytes
  peak as PyTorch dispatches it: the counterpart of JAX's HLO walk.
"""
