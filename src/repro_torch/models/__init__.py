"""Model registry: the paper's NMT pairs by name."""

from repro_torch.models.registry import ResolvedModel, available, resolve

__all__ = ["ResolvedModel", "available", "resolve"]
