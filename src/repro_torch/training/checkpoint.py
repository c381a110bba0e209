"""Checkpoints in the reference's format: one ``.npz`` per tree, one
array per leaf, keyed by the leaf's ``jax.tree_util.keystr`` path, plus
a JSON ``__manifest__``.

Port of ``repro/training/checkpoint.py``, without JAX: the key strings
are built here, as ``keystr`` builds them (``['params']['dec'][0]``
for dict keys and list indices, ``.mu`` for a NamedTuple's field), and
dicts are walked in sorted key order, as JAX flattens them.  A tree is
nested dicts, lists, tuples and NamedTuples of numpy arrays or tensors;
the port's state reaches the reference's structure through
:func:`state_to_jax` (the converters' name map).  So a checkpoint that
``examples/train_nmt.py`` or ``repro.launch.train`` writes loads here,
and one written here loads with ``repro.training.checkpoint``.

The write is atomic (a temporary file, then ``os.replace``); loading
restores exact dtypes and shapes and raises ``KeyError`` on a missing
leaf and ``ValueError`` on a shape mismatch.

A bfloat16 leaf is written as the reference writes its
``ml_dtypes.bfloat16`` arrays: an ``.npy`` member of descr ``'<V2'``
holding the raw 16-bit patterns, and ``"dtype": "bfloat16"`` in the
manifest, byte for byte, with no ``ml_dtypes`` (numpy has no bfloat16;
the bits cross through an ``int16`` view).  Loading gives such a leaf
back as those bit patterns (``convert.BF16_BITS``), which the converters
and :func:`load_train_state` turn into ``torch.bfloat16`` tensors.
(The reference's own ``load_checkpoint`` cannot restore such a file:
``jax.numpy.asarray`` refuses a ``'|V2'`` array, ROADMAP C.)

:func:`save_train_state` / :func:`load_train_state` write and read a
model's ``TrainState`` in the reference's layout, and take a
:class:`~repro_torch.runtime.sharded.ShardedLM`'s state as well: saving
gathers its blocks (a collective) and rank 0 writes; loading cuts each
rank's blocks from the whole tensors in the file.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import (
    BF16_BITS,
    _params_to_jax,
    bf16_tensor,
    params_from_jax,
    reference_leaves,
)
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_loop import TrainState


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _leaves(node, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) pairs in the order ``tree_flatten_with_path``
    gives them; None is an empty subtree, as in JAX."""
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _leaves(node[key], f"{prefix}[{key!r}]")
    elif _is_namedtuple(node):
        for field in node._fields:
            yield from _leaves(getattr(node, field), f"{prefix}.{field}")
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            yield from _leaves(child, f"{prefix}[{i}]")
    else:
        yield prefix, node


# the descr ``np.save`` writes for ``ml_dtypes.bfloat16``; a plain
# ``np.dtype("V2")`` would write ``'|V2'``
_BF16_DESCR = "<V2"


def _numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the leaf as numpy, its manifest dtype): a bfloat16 tensor, an
    ``ml_dtypes.bfloat16`` array or bf16 bit patterns (``BF16_BITS``, as
    :func:`state_to_jax` gives them) as its bit patterns."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(BF16_BITS), "bfloat16"
        leaf = leaf.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        return a.view(BF16_BITS), "bfloat16"
    return a, str(a.dtype)


def _write_npz(path: str, members: Dict[str, Tuple[np.ndarray, str]]
               ) -> None:
    """``np.savez(path, **members)``'s bytes, a bfloat16 member's header
    with the descr ``ml_dtypes.bfloat16`` gives."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in members.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if dtype != "bfloat16":
                    np.lib.format.write_array(fid, np.asanyarray(arr),
                                              allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(fid, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": arr.shape})
                fid.write(np.ascontiguousarray(arr).tobytes())


def _rebuild(node, leaves: Iterator):
    """``node``'s structure with its leaves taken in order from
    ``leaves``."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {key: _rebuild(node[key], leaves) for key in sorted(node)}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild(getattr(node, f), leaves)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(child, leaves) for child in node)
    return next(leaves)


def save_checkpoint(path: str, tree, *, step: int | None = None) -> str:
    """Atomically write ``tree`` to ``path`` (.npz). Returns final path."""
    flat = {key: _numpy(leaf) for key, leaf in _leaves(tree)}
    manifest = {
        "step": step,
        "num_leaves": len(flat),
        "leaves": {k: {"shape": list(v.shape), "dtype": dtype}
                   for k, (v, dtype) in flat.items()},
    }
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    os.close(fd)
    try:
        _write_npz(tmp, {"__manifest__": (np.asarray(json.dumps(manifest)),
                                          "str"), **flat})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_checkpoint(path: str, like) -> Any:
    """Restore into the structure of ``like``; the leaves come back as
    numpy arrays, a bfloat16 leaf as its bit patterns (``BF16_BITS``)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__manifest__"}
    leaves = []
    for key, leaf in _leaves(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(np.shape(leaf))}")
        leaves.append(arr)
    return _rebuild(like, iter(leaves))


def checkpoint_step(path: str) -> int | None:
    with np.load(path, allow_pickle=False) as z:
        m = json.loads(str(z["__manifest__"]))
    return m.get("step")


def state_to_jax(model, params: Dict[str, torch.Tensor],
                 opt: AdamWState) -> Tuple[dict, AdamWState]:
    """The reference's pytrees of a training state: the parameters, and
    an ``AdamWState`` whose moments are keyed, shaped and transposed as
    the parameters' leaves (numpy leaves throughout, a bfloat16 one as
    its bit patterns, ``convert.BF16_BITS``)."""
    to_jax = lambda sd: _params_to_jax(model, sd, raw_bf16=True)[0]
    return to_jax(params), AdamWState(step=_numpy(opt.step)[0],
                                      mu=to_jax(opt.mu), nu=to_jax(opt.nu))


def state_from_jax(model, params_tree, opt_tree: AdamWState
                   ) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
    """The inverse of :func:`state_to_jax`: a state dict for ``model``
    and the port's ``AdamWState``, on ``model``'s device."""
    dev = model.device
    on_dev = lambda sd: {n: t.to(dev) for n, t in sd.items()}
    from_jax = lambda tree: on_dev(params_from_jax(model, tree))
    step = torch.as_tensor(np.asarray(opt_tree.step, np.int32), device=dev)
    return from_jax(params_tree), AdamWState(
        step=step, mu=from_jax(opt_tree.mu), nu=from_jax(opt_tree.nu))


def save_train_state(path: str, model, state: TrainState, *,
                     step: int | None = None) -> str:
    """Write ``model``'s ``state`` as the reference's ``TrainState``
    (``repro.training.checkpoint.load_checkpoint`` reads it).  For a
    sharded LM (one with ``whole_tensors``) every rank must call it: the
    parameters and moments are gathered whole, rank 0 writes, and the
    ranks meet at a barrier after the write."""
    params, mu, nu = state.params, state.opt.mu, state.opt.nu
    whole = getattr(model, "whole_tensors", None)
    if whole is not None:
        params, mu, nu = whole(params), whole(mu), whole(nu)
    if whole is None or dist.get_rank() == 0:
        tree = TrainState(*state_to_jax(model, params, AdamWState(
            step=state.opt.step, mu=mu, nu=nu)))
        save_checkpoint(path, tree, step=step)
    if whole is not None:
        dist.barrier()
    return path


@torch.no_grad()
def load_train_state(path: str, model, state: TrainState) -> TrainState:
    """Read a ``TrainState`` checkpoint in the reference's layout into
    ``state`` (``model``'s parameters and moments, in place); a sharded
    LM (one with ``block_of``) keeps this rank's block of each tensor.
    Raises ``KeyError`` on a missing leaf and ``ValueError`` on a shape
    mismatch."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__manifest__"}
    leaves = reference_leaves(model)
    cut = getattr(model, "block_of", None)
    for prefix, tensors in ((".params", state.params),
                            (".opt.mu", state.opt.mu),
                            (".opt.nu", state.opt.nu)):
        for name, t in tensors.items():
            leaf = leaves[name]
            key = prefix + leaf.keystr
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = flat[key] if leaf.layer is None else flat[key][leaf.layer]
            arr = arr.T if leaf.transpose else arr
            whole = (bf16_tensor(arr) if arr.dtype == BF16_BITS
                     else torch.as_tensor(arr)).contiguous()
            got = whole if cut is None else cut(name, whole)
            if tuple(got.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(got.shape)} vs {tuple(t.shape)}")
            t.copy_(got)
    state.opt.step.copy_(torch.as_tensor(flat[".opt.step"]))
    return state
