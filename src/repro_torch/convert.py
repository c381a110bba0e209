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
