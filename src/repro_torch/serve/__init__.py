"""Serving of the port: the batched decode engine, and flash decoding across
the ranks of a mesh (sequence-parallel decode attention)."""

from .engine import ServeConfig, ServingEngine
from .flash_decoding import make_flash_decode

__all__ = ["ServeConfig", "ServingEngine", "make_flash_decode"]
