"""Serving runtime: the C-NMT-routed tiered serving engine."""

from repro_torch.runtime.engine import CollaborativeEngine, RequestResult, Tier

__all__ = ["CollaborativeEngine", "Tier", "RequestResult"]
