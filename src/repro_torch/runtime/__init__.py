"""Serving runtime: the C-NMT-routed tiered serving engine and the LM
generation sessions that serve as its tiers."""

from repro_torch.runtime.engine import CollaborativeEngine, RequestResult, Tier
from repro_torch.runtime.serving import (
    GenerationSession,
    TierFaultError,
    build_executor,
)

__all__ = ["CollaborativeEngine", "Tier", "RequestResult",
           "GenerationSession", "TierFaultError", "build_executor"]
