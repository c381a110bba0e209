"""Loss functions for the LM stack.

Port of ``repro/training/losses.py``: the causal-LM cross entropy, the
MoE load-balance term (``aux_loss``, 0 without MoE layers) and, for a
model with multi-token prediction (deepseek-v3), the MTP cross entropy.
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


def lm_loss(model, batch, *, aux_weight: float = 0.001,
            mtp_weight: float = 0.3):
    """Causal-LM cross entropy + the MoE load-balance aux term + the MTP
    cross entropy where the model predicts token t+2.

    batch: {"tokens": (B,S), "targets": (B,S)[, "mask", "frames"]}
    tensors on the model's device; an encoder-decoder's ``frames`` (B,T,D)
    go to its encoder.  Returns (loss, metrics dict)."""
    kw = {"frames": batch["frames"]} if "frames" in batch else {}
    out = model.train_logits(batch["tokens"], **kw)
    mask = batch.get("mask")
    ce = _token_ce(out["logits"], batch["targets"], mask)
    loss = ce + aux_weight * out["aux_loss"]
    metrics = {"ce": ce, "aux": out["aux_loss"]}
    if "mtp_logits" in out:
        # MTP predicts token t+2: targets shifted one step more, the last
        # two positions (whose t+2 wraps around) masked
        mtp_targets = torch.roll(batch["targets"], -1, dims=1)
        valid = torch.ones_like(mtp_targets, dtype=torch.float32)
        valid[:, -2:] = 0.0
        if mask is not None:
            valid = valid * mask
        mtp_ce = _token_ce(out["mtp_logits"], mtp_targets, valid)
        loss = loss + mtp_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    metrics["loss"] = loss
    return loss, metrics
