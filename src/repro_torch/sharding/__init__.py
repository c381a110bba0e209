"""Sharding policies: the partition specs of parameters, optimizer
state, batches and decode states over a device mesh."""

from repro_torch.sharding.policy import (
    MeshShape,
    ShardingPolicy,
    batch_specs,
    decode_state_specs,
    make_policy,
    mesh_shape,
    param_specs,
    to_placements,
    train_state_specs,
)

__all__ = [
    "MeshShape",
    "ShardingPolicy",
    "make_policy",
    "mesh_shape",
    "param_specs",
    "batch_specs",
    "decode_state_specs",
    "train_state_specs",
    "to_placements",
]
