"""Process-global decode-sharding hook.

Port of ``repro/sharding/ctx.py``'s sequence-shard half.  Layers are
sharding-agnostic; the sharded runtime (:mod:`repro_torch.runtime.sharded`)
installs a :class:`SeqShard` around a decode step whose attention caches
stay split over their sequence axis, and GQA decode then takes
:func:`repro_torch.models.layers.attention.attn_decode_seq_sharded`: each
rank attends to its own cache slots through ``flash_decode`` and the
ranks merge their softmax states, O(B*H*D) traffic per layer instead of
gathering the cache.  Unset, nothing changes: single-device runs never
touch ``torch.distributed``.

The reference's batch constrainer (``set_batch_constrainer``) pins
layer-internal tensors for GSPMD; the port runs each rank on its own
rows, so nothing here calls for it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple


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
