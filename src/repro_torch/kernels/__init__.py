"""Hand-written Hopper kernels with their plain PyTorch versions.

``ops`` dispatches on the tensor's device: CUDA launches the kernel built by
``build`` from ``csrc/``, the CPU takes the plain version in ``ref``.  Each
kernel module keeps a ``launches`` count of its kernel launches.
"""

from . import decode_attention, ops, ref, rmsnorm, swiglu

KERNEL_MODULES = (rmsnorm, swiglu, decode_attention)

__all__ = ["KERNEL_MODULES", "decode_attention", "ops", "ref", "rmsnorm", "swiglu"]
