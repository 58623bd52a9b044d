"""Device resolution for the port's entry points.

The default device is ``"cuda"``.  When CUDA is not available and the caller
did not ask for the CPU, :func:`resolve` raises instead of carrying on quietly
on the CPU.  ``"meta"`` (tensors with shapes and dtypes but no storage) is
taken only when the caller names it: the dry-run (``launch/dryrun.py``) runs
the card's path there without a card.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """Return the ``torch.device`` to run on; raise if it cannot be used."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda', 'cpu' or 'meta'")
    return dev
