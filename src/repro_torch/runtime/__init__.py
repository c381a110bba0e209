"""Serving runtime: prefill/decode steps, generation sessions, and the
C-NMT-routed tiered serving engine."""

from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    TierFaultError,
    build_executor,
    make_batched_tier_executor,
    make_faulty_executor,
    make_prefill_step,
    make_serve_step,
    make_split_tier_executors,
    make_tier_executor,
)
from repro_torch.runtime.engine import CollaborativeEngine, Tier, RequestResult

__all__ = [
    "ContinuousGenerationSession",
    "GenerationSession",
    "TierFaultError",
    "build_executor",
    "make_batched_tier_executor",
    "make_faulty_executor",
    "make_prefill_step",
    "make_serve_step",
    "make_split_tier_executors",
    "make_tier_executor",
    "CollaborativeEngine",
    "Tier",
    "RequestResult",
]
