"""PyTorch and CUDA port of the Hoard reproduction's model-serving path.

``repro_torch`` stands beside the JAX package ``repro`` and is held against it
on the same inputs and weights.  It imports ``torch``, ``numpy`` and the
standard library only.  The kernels that the JAX package wrote in Pallas for a
TPU are hand-written CUDA kernels for Hopper (``sm_90a``) here, built from
``kernels/csrc`` at first use.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and raises
when CUDA is asked for and missing; see :mod:`repro_torch.device`.
"""

__version__ = "0.1.0"
