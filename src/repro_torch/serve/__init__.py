"""Serving of the port: the batched decode engine."""

from .engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
