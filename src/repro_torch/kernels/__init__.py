"""Hand-written Hopper kernels with their plain PyTorch versions.

``ops`` dispatches on the tensor's device: CUDA launches the kernel built by
``build`` from ``csrc/``, the CPU takes the plain version in ``ref``.  Each
kernel module keeps a ``launches`` count of its kernel launches.
"""

from . import (
    decode_attention,
    flash_attention,
    flash_attention_bwd,
    mlstm_scan,
    mlstm_scan_bwd,
    ops,
    ref,
    rmsnorm,
    rmsnorm_bwd,
    ssd_scan,
    ssd_scan_bwd,
    swiglu,
    swiglu_bwd,
)

KERNEL_MODULES = (rmsnorm, swiglu, decode_attention, flash_attention, flash_attention_bwd,
                  rmsnorm_bwd, swiglu_bwd, mlstm_scan, mlstm_scan_bwd, ssd_scan, ssd_scan_bwd)

__all__ = ["KERNEL_MODULES", "decode_attention", "flash_attention", "flash_attention_bwd",
           "mlstm_scan", "mlstm_scan_bwd", "ops", "ref", "rmsnorm", "rmsnorm_bwd", "ssd_scan",
           "ssd_scan_bwd", "swiglu", "swiglu_bwd"]
