"""Carry the reference's weights across to the port.

``jax.random`` and ``torch.Generator`` draw different numbers from the
same seed, so the port never re-draws a reference model's weights: it
converts the reference's parameter pytree instead.  The pytree arrives
as nested dicts/lists of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def marian_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of :class:`repro_torch.nmt.transformer.MarianTransformer`
    from the reference ``MarianTransformer.init`` pytree.

    The reference's ``dense`` is ``x @ w + b`` with ``w`` of shape
    (d_in, d_out); ``nn.Linear`` stores its weight as (d_out, d_in), so
    every dense weight is transposed.  Layer-norm ``g``/``b`` become
    ``weight``/``bias``; embeddings keep their (vocab, d_model) layout.
    Load the result with ``model.load_state_dict(...)``.
    """
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["w"]).T.contiguous()
        sd[f"{prefix}.bias"] = _t(p["b"])

    def layer_norm(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["g"])
        sd[f"{prefix}.bias"] = _t(p["b"])

    def mha(prefix, p):
        for part in ("q", "k", "v", "o"):
            dense(f"{prefix}.{part}", p[part])

    def ffn(prefix, p):
        dense(f"{prefix}.inp", p["in"])
        dense(f"{prefix}.out", p["out"])

    for i, layer in enumerate(tree["enc"]):
        mha(f"enc.{i}.attn", layer["attn"])
        layer_norm(f"enc.{i}.ln1", layer["ln1"])
        ffn(f"enc.{i}.ffn", layer["ffn"])
        layer_norm(f"enc.{i}.ln2", layer["ln2"])
    for i, layer in enumerate(tree["dec"]):
        mha(f"dec.{i}.self_attn", layer["self"])
        layer_norm(f"dec.{i}.ln1", layer["ln1"])
        mha(f"dec.{i}.cross", layer["cross"])
        layer_norm(f"dec.{i}.ln2", layer["ln2"])
        ffn(f"dec.{i}.ffn", layer["ffn"])
        layer_norm(f"dec.{i}.ln3", layer["ln3"])
    sd["src_embed.weight"] = _t(tree["src_embed"])
    sd["tgt_embed.weight"] = _t(tree["tgt_embed"])
    dense("out", tree["out"])
    return sd


def _flatten(prefix: str, node, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, dict):
        for key, child in node.items():
            _flatten(f"{prefix}.{key}" if prefix else str(key), child, out)
    else:
        out[prefix] = np.asarray(node)


def lm_params_from_jax(tree, cfg) -> Dict[str, torch.Tensor]:
    """State dict of :class:`repro_torch.models.model.LM` from the
    reference ``LM.init`` pytree (numpy leaves).

    Parameter names are the reference's tree paths.  Each group's tree is
    stacked along a leading ``count`` axis (``jax.vmap`` over the layer
    inits); it is cut into one entry per layer, ``groups.<g>.<layer>.*``.
    ``shared_attn``, ``embed``, ``lm_head`` and ``final_norm`` carry across
    as they are.  Every tensor is used as given (float32), never redrawn.
    Load the result with ``model.load_state_dict(...)``.
    """
    unknown = set(tree) - {"embed", "final_norm", "lm_head", "groups",
                           "shared_attn"}
    if unknown:
        raise NotImplementedError(
            f"parameters {sorted(unknown)} belong to layers not ported yet")
    if len(tree["groups"]) != len(cfg.layer_plan):
        raise ValueError(f"{len(tree['groups'])} groups in the tree, "
                         f"{len(cfg.layer_plan)} in the config")
    flat: Dict[str, np.ndarray] = {}
    for key in ("embed", "final_norm", "lm_head", "shared_attn"):
        if key in tree:
            _flatten(key, tree[key], flat)
    for gi, (g, gtree) in enumerate(zip(cfg.layer_plan, tree["groups"])):
        group: Dict[str, np.ndarray] = {}
        _flatten("", gtree, group)
        for name, stacked in group.items():
            if stacked.shape[0] != g.count:
                raise ValueError(f"group {gi} leaf {name} stacks "
                                 f"{stacked.shape[0]} layers, expected "
                                 f"{g.count}")
            for li in range(g.count):
                flat[f"groups.{gi}.{li}.{name}"] = stacked[li]
    return {name: _t(a) for name, a in flat.items()}
