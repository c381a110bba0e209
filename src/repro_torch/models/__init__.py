"""Model registry and the big-LM stack: the paper's NMT pairs and the
recurrent LMs (rwkv6-3b, zamba2-1.2b) by name.  The LM itself is
:class:`repro_torch.models.model.LM`."""

from repro_torch.models.registry import ResolvedModel, available, resolve

__all__ = ["ResolvedModel", "available", "resolve"]
