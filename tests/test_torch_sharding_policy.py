"""The port's sharding policy against the reference's, with no process
group.

For every ``ARCH_NAMES`` configuration at full size (JAX side:
``jax.eval_shape`` of the parameters and the decode state on a
device-free mesh description; port side: the LM and its decode state on
the ``meta`` device), on the meshes (2, 2), (2, 4), (16, 16) and
(2, 16, 16), for layouts ``tp``, ``ddp`` and ``auto`` and batch sizes 1
and 8: ``make_policy``'s axes, ``infer_layout``, ``param_specs`` (a
layer's spec is the reference's stacked leaf's without its leading
``None``), ``batch_specs`` and ``decode_state_specs`` equal the
reference's.  Specs are compared as tuples of axis-name tuples, one per
tensor dimension.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_NAMES as J_ARCH_NAMES
from repro.configs import get_config as j_get_config
from repro.models.model import LM as JLM
from repro.runtime import sharded as j_sharded
from repro.sharding import policy as jpol
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import reference_leaves
from repro_torch.models.model import LM
from repro_torch.runtime.sharded import infer_layout
from repro_torch.sharding import policy as pol
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import TrainState
from _torch_threads import cap_threads

cap_threads()

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUTS, BATCHES, MAX_LEN = ("tp", "ddp", "auto"), (1, 8), 64


def _norm(spec, nd):
    """A spec as a tuple of axis-name tuples, padded to ``nd`` dims."""
    out = [() if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    return tuple(out + [()] * (nd - len(out)))


@functools.lru_cache(maxsize=None)
def _jax(name):
    jm = JLM(j_get_config(name))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    states = {b: jax.eval_shape(lambda b=b: jm.init_decode_state(
        None, b, MAX_LEN)) for b in BATCHES}
    return params, states


@functools.lru_cache(maxsize=None)
def _port(name):
    model = LM(get_config(name), device="meta")
    return model, {b: model.init_decode_state(b, MAX_LEN) for b in BATCHES}


def _jax_mesh(key):
    shape, names = MESHES[key]
    return AbstractMesh(shape, names)


def _jax_layout_mesh(key):
    """What the reference's ``infer_layout`` reads of a mesh."""
    shape, names = MESHES[key]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, np.int8))


def _policies(name, key):
    """((layout, batch) -> (JAX policy, port policy)), auto resolved."""
    cfg = get_config(name)
    out = {}
    for layout in LAYOUTS:
        want = (j_sharded.infer_layout(j_get_config(name),
                                       _jax_layout_mesh(key))
                if layout == "auto" else layout)
        got = infer_layout(cfg, MESHES[key]) if layout == "auto" else layout
        assert got == want, (name, key)
        for b in BATCHES:
            out[layout, b] = (jpol.make_policy(_jax_mesh(key), batch_size=b,
                                               layout=want),
                              pol.make_policy(MESHES[key], batch_size=b,
                                              layout=got))
    return out


def _flat(tree, is_leaf=None):
    """{path tuple (dict keys, list indices, a named tuple's field
    names): leaf} of a JAX pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        out[tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name",
                                                                None)))
                  for k in path)] = leaf
    return out


def _flat_port(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat_port(sub, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _flat_port(sub, path + (i,)).items()}
    return {path: tree}


_IS_SPEC = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_policy_and_param_specs_match_the_reference(name, key):
    assert tuple(ARCH_NAMES) == tuple(J_ARCH_NAMES)
    params, _ = _jax(name)
    model, _ = _port(name)
    leaves = reference_leaves(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for (layout, b), (jp, tp) in _policies(name, key).items():
        for field in ("batch_axes", "fsdp_axes", "model_axes", "seq_axes",
                      "shard_batch"):
            assert getattr(tp, field) == getattr(jp, field), (layout, b,
                                                              field)
        if b != BATCHES[0]:
            continue                   # the parameters' specs ignore batch
        want = {jax.tree_util.keystr(path): s for path, s in
                jax.tree_util.tree_flatten_with_path(
                    jpol.param_specs(jp, params), is_leaf=_IS_SPEC)[0]}
        got = pol.param_specs(tp, model)
        assert set(got) == set(shapes)
        assert {leaves[n].keystr for n in got} == set(want)
        for pname, spec in got.items():
            leaf = leaves[pname]
            ref = _norm(want[leaf.keystr], leaf.ndim(torch.empty(
                shapes[pname], device="meta")))
            if leaf.layer is not None:
                assert ref[0] == (), (pname, ref)
                ref = ref[1:]
            assert _norm(spec, len(shapes[pname])) == ref, (pname, layout)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_batch_and_decode_state_specs_match_the_reference(name, key):
    _, j_states = _jax(name)
    _, states = _port(name)
    for (layout, b), (jp, tp) in _policies(name, key).items():
        want = _flat(jpol.decode_state_specs(jp, j_states[b]),
                     is_leaf=_IS_SPEC)
        shapes = _flat(j_states[b])
        got = _flat_port(pol.decode_state_specs(tp, states[b]))
        assert set(got) == set(want), (layout, b)
        for path, spec in got.items():
            nd = len(shapes[path].shape)
            assert _norm(spec, nd) == _norm(want[path], nd), (path, layout,
                                                               b)
        j_batch = {"tokens": jax.ShapeDtypeStruct((b, 16), np.int32),
                   "mask": jax.ShapeDtypeStruct((b, 16), np.float32),
                   "step": jax.ShapeDtypeStruct((), np.int32)}
        batch = {"tokens": torch.empty((b, 16), dtype=torch.int32,
                                       device="meta"),
                 "mask": torch.empty((b, 16), device="meta"),
                 "step": torch.empty((), device="meta")}
        want = jpol.batch_specs(jp, j_batch)
        got = pol.batch_specs(tp, batch)
        for k in batch:
            nd = batch[k].dim()
            assert _norm(got[k], nd) == _norm(want[k], nd), (k, layout, b)


def test_train_state_specs_mirror_the_parameters():
    model, _ = _port("qwen3-8b")
    p = pol.make_policy(MESHES["2x4"], batch_size=8)
    specs = pol.train_state_specs(p, model)
    assert isinstance(specs, TrainState) and isinstance(specs.opt,
                                                        AdamWState)
    assert specs.opt.step == ()
    assert specs.params == specs.opt.mu == specs.opt.nu \
        == pol.param_specs(p, model)


def test_to_placements_name_one_placement_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = pol.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert pol.to_placements(mesh, (None, ("model",))) == [
        Replicate(), Replicate(), Shard(1)]
    assert pol.to_placements(mesh, (("pod", "data"), None)) == [
        Shard(0), Shard(0), Replicate()]
    assert pol.to_placements(mesh, ()) == [Replicate()] * 3
