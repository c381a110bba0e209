"""Loss functions for the LM stack.

Port of ``repro/training/losses.py``: the causal-LM cross entropy, the
MoE load-balance term (``aux_loss``, 0 without MoE layers) and, for a
model with multi-token prediction (deepseek-v3), the MTP cross entropy.

A :class:`~repro_torch.runtime.sharded.ShardedLM` whose ranks split the
batch's rows returns each rank's rows' logits only.  Each rank then
takes the sum of its rows' token cross entropies over the whole batch's
count of valid tokens (the count all-reduced over the batch ranks, with
no gradient): the batch ranks' gradients of these add up to the whole
batch's mean, as the parameter gathers' backward and ``sync_grads`` sum
them.  The reported ``ce``, ``mtp_ce`` and ``loss`` are the whole
batch's, the same on every rank, from one detached all_reduce.  The
loss is never all-reduced through a differentiable collective: its
backward would sum over the ranks once more.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _token_nll(logits, targets):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


def _token_ce(logits, targets, mask=None):
    nll = _token_nll(logits, targets)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _split_ces(terms, group):
    """Cross entropies of (logits, targets, mask) terms over this rank's
    rows of a batch split over ``group``: (each term's sum over the
    whole batch's count, to differentiate; each term's whole-batch mean,
    detached and the same on every rank)."""
    sums, counts = [], []
    for logits, targets, mask in terms:
        nll = _token_nll(logits, targets)
        if mask is None:
            sums.append(nll.sum())
            # a fill on the device: a CUDA graph captures no host copy
            counts.append(nll.new_full((), float(nll.numel())))
        else:
            sums.append((nll * mask).sum())
            counts.append(mask.sum().float())
    # one all_reduce of every term's count and sum, outside autograd
    totals = torch.stack(counts + [s.detach() for s in sums])
    dist.all_reduce(totals, op=dist.ReduceOp.SUM, group=group)
    n = len(terms)
    count = torch.clamp(totals[:n], min=1.0)
    return ([s / c for s, c in zip(sums, count)],
            list(totals[n:] / count))


def lm_loss(model, batch, *, aux_weight: float = 0.001,
            mtp_weight: float = 0.3):
    """Causal-LM cross entropy + the MoE load-balance aux term + the MTP
    cross entropy where the model predicts token t+2.

    batch: {"tokens": (B,S), "targets": (B,S)[, "mask", "frames"]}
    tensors on the model's device; an encoder-decoder's ``frames`` (B,T,D)
    go to its encoder.  Returns (loss to differentiate, metrics dict); on
    a sharded LM whose ranks split the rows the loss is this rank's
    rows' share and the metrics are the whole batch's."""
    kw = {"frames": batch["frames"]} if "frames" in batch else {}
    out = model.train_logits(batch["tokens"], **kw)
    group = getattr(model, "batch_group", None)
    cut = model.local_rows if group is not None else (lambda t: t)
    targets, mask = cut(batch["targets"]), cut(batch.get("mask"))
    terms = [(out["logits"], targets, mask)]
    if "mtp_logits" in out:
        # MTP predicts token t+2: targets shifted one step more, the last
        # two positions (whose t+2 wraps around) masked
        mtp_targets = torch.roll(targets, -1, dims=1)
        valid = torch.ones_like(mtp_targets, dtype=torch.float32)
        valid[:, -2:] = 0.0
        if mask is not None:
            valid = valid * mask
        terms.append((out["mtp_logits"], mtp_targets, valid))
    if group is None:
        ces = whole = [_token_ce(*t) for t in terms]
    else:
        ces, whole = _split_ces(terms, group)
    aux = out["aux_loss"]

    def total(ce):
        t = ce[0] + aux_weight * aux
        return t + mtp_weight * ce[1] if len(ce) > 1 else t

    loss = total(ces)
    metrics = {"ce": whole[0], "aux": aux,
               "loss": loss if group is None else total(whole)}
    if len(terms) > 1:
        metrics["mtp_ce"] = whole[1]
    return loss, metrics
