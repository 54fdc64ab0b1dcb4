"""Serving of the port: the continuous-batching engine (dense slab)."""

from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
