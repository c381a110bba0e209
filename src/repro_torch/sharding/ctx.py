"""Process-global sharding hooks for the layers.

Port of ``repro/sharding/ctx.py``.  Layers are sharding-agnostic; the
sharded runtime (:mod:`repro_torch.runtime.sharded`) installs a hook
around the calls that need one:

* a :class:`SeqShard` around a decode step whose attention caches stay
  split over their sequence axis: GQA decode then takes
  :func:`repro_torch.models.layers.attention.attn_decode_seq_sharded`,
  each rank attending to its own cache slots through ``flash_decode``
  and the ranks merging their softmax states, O(B*H*D) traffic per layer
  instead of gathering the cache;
* a :class:`BatchShard` around a training forward whose rows are split
  over ranks: :func:`batch_mean` then averages a per-rank mean over the
  ranks that split the batch, so the MoE load-balance loss, a product of
  two means over the tokens, is the whole batch's (the reference's
  ``set_batch_constrainer`` hook serves GSPMD the same way: one place
  where a layer learns how the batch is split).  A layer checkpointed
  with ``torch.utils.checkpoint`` recomputes in the backward, after the
  forward removed its :class:`BatchShard`: :func:`recompute_context`
  puts the forward's back for the recompute.

Unset, nothing changes: single-device runs never touch
``torch.distributed``.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class SeqShard(NamedTuple):
    group: Any                    # the process group that splits the slots
    axis: str                     # its mesh axis
    batch_axes: Tuple[str, ...]   # the mesh axes that split the rows


_DECODE_SEQ_SHARD: Optional[SeqShard] = None


def set_decode_seq_shard(info: Optional[SeqShard]) -> None:
    """A :class:`SeqShard` or None."""
    global _DECODE_SEQ_SHARD
    _DECODE_SEQ_SHARD = info


def decode_seq_shard() -> Optional[SeqShard]:
    return _DECODE_SEQ_SHARD


class BatchShard(NamedTuple):
    group: Any                    # the ranks that split the rows
    size: int                     # their number


_BATCH_SHARD: Optional[BatchShard] = None


def set_batch_shard(info: Optional[BatchShard]) -> None:
    """A :class:`BatchShard` or None."""
    global _BATCH_SHARD
    _BATCH_SHARD = info


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over the ranks of ``group`` (all_reduce SUM /
    size).  Backward: the incoming gradient / size, with no collective.
    Every rank computes the same loss on the same averaged value, so each
    holds the same upstream gradient already; summing it over the ranks,
    as ``torch.distributed.nn.functional.all_reduce``'s backward does,
    would count it ``size`` times."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.size = size
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / size

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.size, None, None


def batch_mean(x):
    """``x``, a mean over this rank's rows, averaged over the ranks that
    split the batch (each holds as many rows): the whole batch's mean.
    ``x`` itself unless a :class:`BatchShard` is installed."""
    if _BATCH_SHARD is None:
        return x
    return _BatchMean.apply(x, _BATCH_SHARD.group, _BATCH_SHARD.size)


@contextlib.contextmanager
def _batch_shard_as(info: Optional[BatchShard]):
    global _BATCH_SHARD
    saved, _BATCH_SHARD = _BATCH_SHARD, info
    try:
        yield
    finally:
        _BATCH_SHARD = saved


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: (the forward's
    context, the recompute's), the recompute under the
    :class:`BatchShard` installed when the forward ran (so a recomputed
    MoE layer takes its means over the whole batch again, with the same
    collectives)."""
    return contextlib.nullcontext(), _batch_shard_as(_BATCH_SHARD)
