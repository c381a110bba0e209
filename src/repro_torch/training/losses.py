"""Loss functions for the LM stack.

Port of ``repro/training/losses.py`` for the families the port has:
the MTP branch waits for the MTP configurations (the port's ``LM``
refuses them), and ``aux_loss`` is the LM's (0 without MoE layers).
"""

from __future__ import annotations

import torch


def _token_ce(logits, targets, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss(model, batch, *, aux_weight: float = 0.001):
    """Causal-LM cross entropy + the MoE load-balance aux term.

    batch: {"tokens": (B,S), "targets": (B,S)[, "mask"]} tensors on the
    model's device.  Returns (loss, metrics dict)."""
    out = model.train_logits(batch["tokens"])
    ce = _token_ce(out["logits"], batch["targets"], batch.get("mask"))
    loss = ce + aux_weight * out["aux_loss"]
    return loss, {"ce": ce, "aux": out["aux_loss"], "loss": loss}
