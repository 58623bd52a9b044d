"""The run's weights, drawn from ``--seed`` on the device.

Each leaf of the reference's layout (``reference.model.layout``) is one draw
from a generator of its own, seeded from the run's seed and the leaf's name:
normal in float32 times the leaf's scale (the fan-in's inverse square root,
or 0.02 for the embedding, the head and the router, as the program's
``params._init_leaf`` scales them), or ones for a norm's gamma, then cast to
the type the weights are served in.  One call draws a leaf, so any leaf can
be drawn again alone (:func:`draw_leaf`), and the same seed gives the same
weights to the program and to the reference.
"""

from __future__ import annotations

import hashlib

import torch

from .reference.model import layout, leaves, tree_from


def leaf_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw_leaf(spec, seed: int, name: str, device, dtype) -> torch.Tensor:
    shape, init, std = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    out = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return out.mul_(std).to(dtype)


def draw(cfg: dict, seed: int, device, dtype) -> dict:
    """The whole tree, nested as the program takes it."""
    return tree_from({name: draw_leaf(spec, seed, name, device, dtype)
                      for name, spec in leaves(layout(cfg))})
