"""PartitionSpec policy: the baseline FSDP+TP(+EP) layout.

Port of ``repro/sharding/policy.py``, with the same rules and names.

Axes
----
* ``model``: tensor parallel: attention heads / FFN width / experts.
* ``data``: batch data-parallel and the FSDP shard axis for parameters
  and optimizer moments (ZeRO-3 style: a layer's parameters are gathered
  just before it runs, see :mod:`repro_torch.runtime.sharded`).
* ``pod``: multi-host: extends both the batch axis and the FSDP axis.

Rules are name-based over the reference's parameter paths, with a
divisibility guard: an axis is only assigned if the dimension divides
evenly; otherwise the dimension is replicated.

A spec is a plain tuple with one entry per tensor dimension: ``None``, or
the tuple of axis names the dimension is split over (the major axis
first), as ``jax.sharding.PartitionSpec`` holds them.  The policy reads
only the mesh's axis names and sizes (:class:`MeshShape`), so specs can
be computed with no process group, for shapes on the ``meta`` device.

The reference stacks a group's layers along a leading ``count`` axis;
the port holds one module per layer (``groups.<g>.<layer>.*``).  A
layer's spec is the reference's spec of the stacked leaf with its
leading entry, always ``None``, removed; :func:`param_specs` finds each
name's leaf through :func:`repro_torch.convert.reference_leaves`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.convert import reference_leaves
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import TrainState

Spec = Tuple[Optional[Tuple[str, ...]], ...]

# weight names whose LAST TWO dims are (in=fsdp, out=model)
_TP_OUT = {
    "q", "k", "v", "g", "xq", "xk", "xv", "q_down", "q_up", "kv_down",
    "k_up", "v_up", "in_proj", "rk", "kk", "w_down", "w_up", "gate", "up",
}
# weight names whose LAST TWO dims are (in=model, out=fsdp)
_TP_IN = {"o", "xo", "out_proj", "down", "vv"}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """What a policy reads of a mesh: its axis names and their sizes."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (named dims), of a
    :class:`MeshShape`, or of a ``(sizes, axis_names)`` pair."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshShape(tuple(names), tuple(int(s) for s in mesh.shape))
    sizes, names = mesh
    return MeshShape(tuple(names), tuple(int(s) for s in sizes))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: MeshShape
    # logical axis assignments (each a spec entry)
    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    seq_axes: Tuple[str, ...] = ("model",)   # decode-cache sequence axis
    shard_batch: bool = True                 # False for batch=1 shapes

    def axis_size(self, axes: Tuple[str, ...]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def _fit(self, axes: Tuple[str, ...], dim: int):
        return axes if axes and dim % self.axis_size(axes) == 0 else None

    def batch(self, dim: int):
        if not self.shard_batch:
            return None
        return self._fit(self.batch_axes, dim)

    def fsdp(self, dim: int):
        return self._fit(self.fsdp_axes, dim)

    def model(self, dim: int):
        return self._fit(self.model_axes, dim)

    def seq(self, dim: int):
        return self._fit(self.seq_axes, dim)


def make_policy(mesh, *, batch_size: int, layout: str = "tp",
                fsdp: bool = True) -> ShardingPolicy:
    """Baseline layouts.

    * ``tp``: batch over (pod, data); tensor-parallel weights, vocab and
      the decode cache's sequence over ``model``; FSDP over (data, pod).
    * ``ddp``: no tensor parallelism: batch over as many axes as divide
      it (up to pod*data*model), FSDP over (data, pod).  Right for
      models whose head counts don't divide the TP axis (rwkv6's 40
      heads, whisper's 20) and for small models where TP gathers
      dominate.

    ``fsdp=False`` keeps the weights TP-sharded but replicated across
    ``data``.  ``mesh`` is anything :func:`mesh_shape` takes.
    """
    mesh = mesh_shape(mesh)
    axes = set(mesh.axis_names)
    fsdp_axes = tuple(a for a in ("data", "pod") if a in axes) if fsdp else ()
    if layout == "tp":
        batch_axes = tuple(a for a in ("pod", "data") if a in axes)
        model_axes: Tuple[str, ...] = ("model",)
    elif layout == "ddp":
        model_axes = ()
        batch_axes = ()
        for cand in (("pod", "data", "model"), ("pod", "data"),
                     ("data", "model"), ("data",)):
            cand = tuple(a for a in cand if a in axes)
            if cand and batch_size % math.prod(
                    mesh.shape[a] for a in cand) == 0:
                batch_axes = cand
                break
    else:
        raise ValueError(layout)
    pol = ShardingPolicy(mesh=mesh, batch_axes=batch_axes,
                         fsdp_axes=fsdp_axes, model_axes=model_axes,
                         seq_axes=model_axes, shard_batch=True)
    if not batch_axes or batch_size % pol.axis_size(batch_axes):
        # batch=1 long-context shape: replicate the batch, shard seq instead
        pol = dataclasses.replace(
            pol, shard_batch=False,
            seq_axes=model_axes or tuple(a for a in ("model",) if a in axes))
    return pol


def _spec_for_param(pol: ShardingPolicy, names, shape) -> Spec:
    """The reference's rule for the leaf at path ``names`` (dict keys, a
    list index as ``"[i]"``) of shape ``shape``."""
    nd = len(shape)
    # leaf name = nearest containing weight name ("w" leaves live in dicts
    # named after the projection)
    owner = None
    for n in reversed(names):
        if n not in ("w", "b", "g"):
            owner = n
            break
    leafname = names[-1] if names else ""

    def pad(tail):
        return tuple([None] * (nd - len(tail)) + tail)

    if owner == "embed" and leafname == "w":           # (V, D)
        return pad([pol.model(shape[-2]), pol.fsdp(shape[-1])])
    if owner == "lm_head" and leafname == "w":         # (D, V): V = TP axis
        return pad([pol.fsdp(shape[-2]), pol.model(shape[-1])])
    if owner == "router":
        return pad([pol.fsdp(shape[-2]), None])
    if owner in ("experts_gate", "experts_up", "experts_down") \
            and leafname == "w":
        # MoE expert-stacked weights (E, D, F)/(E, F, D): experts = model
        if owner == "experts_down":
            return pad([pol.model(shape[-3]), None, pol.fsdp(shape[-1])])
        return pad([pol.model(shape[-3]), pol.fsdp(shape[-2]), None])
    if owner in _TP_IN and nd >= 2 and leafname == "w":
        return pad([pol.model(shape[-2]), pol.fsdp(shape[-1])])
    if owner in _TP_OUT and nd >= 2 and leafname == "w":
        return pad([pol.fsdp(shape[-2]), pol.model(shape[-1])])
    if leafname == "conv_w" and nd >= 2:
        return pad([None, pol.model(shape[-1])])
    # norms, biases, scalars, mix coefficients, u/w0/a_log/...: replicate
    return (None,) * nd


def param_specs(pol: ShardingPolicy, model) -> Dict[str, Spec]:
    """Each parameter name of the LM ``model`` (real or on the ``meta``
    device) with its spec: the reference's spec of the leaf it belongs
    to, without the stacked ``count`` axis."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    specs = {}
    for name, leaf in reference_leaves(model).items():
        shape = tuple(params[name].shape)
        names = [f"[{k}]" if isinstance(k, int) else k for k in leaf.path]
        if leaf.layer is None:
            specs[name] = _spec_for_param(pol, names, shape)
            continue
        count = (cfg.layer_plan[leaf.path[1]].count if leaf.path[0] == "groups"
                 else cfg.encoder.num_layers)
        spec = _spec_for_param(pol, names, (count,) + shape)
        if spec[0] is not None:
            raise ValueError(f"{name}: the reference splits its layer axis "
                             f"({spec}), which a per-layer module cannot hold")
        specs[name] = spec[1:]
    return specs


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples; ``path``
    holds the dict keys and list indices on the way."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def batch_specs(pol: ShardingPolicy, batch) -> Any:
    """Input batch (a tree of tensors): shard the leading batch dim,
    replicate the rest."""

    def spec(path, leaf):
        if leaf.dim() == 0:
            return ()
        return (pol.batch(leaf.shape[0]),) + (None,) * (leaf.dim() - 1)

    return _tree_map(spec, batch)


def decode_state_specs(pol: ShardingPolicy, state) -> Any:
    """Decode state (``LM.prefill`` / ``init_decode_state``'s tree): batch
    over ``data``; the cache's SEQUENCE over the model axis (flash-decode
    style: attention contracts over the split axis and the shards merge
    their softmax states), SSM/RWKV state heads over ``model`` when they
    fit."""

    def spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        shape = leaf.shape
        if name in ("k", "v"):            # (count,B,S,Hkv,Dh)
            return (None, pol.batch(shape[1]), pol.seq(shape[2]), None, None)
        if name in ("xk", "xv"):          # (count,B,T,Hkv,Dh) cross-attn
            return (None, pol.batch(shape[1]), None, None, None)
        if name in ("ckv", "kpe"):        # (count,B,S,rank)
            return (None, pol.batch(shape[1]), pol.seq(shape[2]), None)
        if name in ("ssm", "wkv"):        # (count,B,H,P,N) / (count,B,H,P,P)
            return (None, pol.batch(shape[1]), pol.model(shape[2]), None,
                    None)
        if name in ("conv", "shift_tm", "shift_cm"):
            return (None, pol.batch(shape[1])) + (None,) * (leaf.dim() - 2)
        if name == "pos":                 # (B,)
            return (pol.batch(shape[0]),)
        if name == "enc_mask":            # (B,T)
            return (pol.batch(shape[0]), None)
        return (None,) * leaf.dim()

    return _tree_map(spec, state)


def train_state_specs(pol: ShardingPolicy, model) -> TrainState:
    """TrainState(params, AdamWState(step, mu, nu)) of ``model``'s
    parameters: the moments mirror the parameters."""
    specs = param_specs(pol, model)
    return TrainState(params=specs,
                      opt=AdamWState(step=(), mu=dict(specs),
                                     nu=dict(specs)))


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``None`` → none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, spec: Spec) -> list:
    """One ``Shard(dim)`` / ``Replicate()`` per mesh dimension, for
    ``distribute_tensor`` / ``DTensor.from_local``: the mesh dimension of
    each axis the spec names at tensor dim ``dim`` shards that dim.

    DTensor splits a dim over its mesh dimensions in mesh order, JAX in
    the entry's order.  They agree for every entry whose axes follow the
    mesh's order (all of them on a 2-D ``(data, model)`` mesh); on a
    ``(pod, data, model)`` mesh the FSDP entry ``("data", "pod")`` puts
    another block of the same size on each rank, so a rank's bytes and
    the gathered whole are the same."""
    names = mesh_shape(mesh).axis_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            out[names.index(axis)] = Shard(dim)
    return out
