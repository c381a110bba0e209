"""Carry weights between the reference's parameter pytrees and the port.

``jax.random`` and ``torch.Generator`` draw different numbers from the
same seed, so the port never re-draws a reference model's weights: it
converts the reference's parameter pytree instead.  The pytree arrives
as nested dicts/lists of numpy arrays (``jax.tree.map(np.asarray,
params)`` on the JAX side), so this module needs no JAX.

The ``*_params_to_jax`` functions go the other way: a port state dict
(parameters, or anything keyed like them, such as AdamW moments) to a
numpy pytree with the reference's keys, shapes and transposes, plus the
``jax.tree_util.keystr`` path of each port name's leaf.  Both directions
read one name map, :func:`reference_leaves`, which the optimizer also
reads for the reference's weight-decay rule (a leaf's rank, where a
stacked LM group adds one) and the checkpoints for their keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _t_keep(a) -> torch.Tensor:
    """A leaf as a tensor of its own dtype: float32, or JAX's bfloat16,
    which reaches numpy as ``ml_dtypes.bfloat16`` (``torch.from_numpy``
    refuses it) and crosses as its 16-bit pattern, bit for bit, as does a
    checkpoint's bf16 leaf (:data:`BF16_BITS`)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        return bf16_tensor(a)
    return _t(a)


# numpy has no bfloat16: a bf16 leaf kept as its raw 16-bit patterns
BF16_BITS = np.dtype("V2")


def _numpy(tensor: torch.Tensor, *, raw_bf16: bool = False) -> np.ndarray:
    """A host copy of ``tensor`` as numpy, a bfloat16 one as
    ``ml_dtypes.bfloat16`` (what ``np.asarray`` of a JAX bf16 array
    gives) or, with ``raw_bf16``, as :data:`BF16_BITS` (no ``ml_dtypes``
    needed: the checkpoints' route), bit for bit."""
    t = tensor.detach().to("cpu", copy=True)
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy()
    if raw_bf16:
        return bits.view(BF16_BITS)
    import ml_dtypes     # JAX's own numpy dtypes; needed only to go there
    return bits.view(ml_dtypes.bfloat16)


def bf16_tensor(a: np.ndarray) -> torch.Tensor:
    """The bfloat16 tensor of an array of bf16 bit patterns
    (:data:`BF16_BITS`, or ``ml_dtypes.bfloat16``), bit for bit."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def _dense(sd, prefix, p) -> None:
    """The reference's ``dense`` is ``x @ w + b`` with ``w`` of shape
    (d_in, d_out); ``nn.Linear`` stores its weight as (d_out, d_in)."""
    sd[f"{prefix}.weight"] = _t(p["w"]).T.contiguous()
    sd[f"{prefix}.bias"] = _t(p["b"])


def _cell(sd, prefix, p) -> None:
    """An LSTM or GRU cell's ``wx``/``wh``/``b``, in the reference's
    layout, which the port's cells keep."""
    for name in ("wx", "wh", "b"):
        sd[f"{prefix}.{name}"] = _t(p[name])


def _embeddings(sd, tree) -> None:
    sd["src_embed.weight"] = _t(tree["src_embed"])
    sd["tgt_embed.weight"] = _t(tree["tgt_embed"])


def marian_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of :class:`repro_torch.nmt.transformer.MarianTransformer`
    from the reference ``MarianTransformer.init`` pytree.

    Every dense weight is transposed to ``nn.Linear``'s (d_out, d_in).
    Layer-norm ``g``/``b`` become ``weight``/``bias``; embeddings keep
    their (vocab, d_model) layout.  Load the result with
    ``model.load_state_dict(...)``.
    """
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix, p):
        _dense(sd, prefix, p)

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
    _embeddings(sd, tree)
    dense("out", tree["out"])
    return sd


def gru_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of :class:`repro_torch.nmt.gru.GRUSeq2Seq` from the
    reference ``GRUSeq2Seq.init`` pytree: dense weights transposed, the
    cells' ``wx``/``wh``/``b`` as they are.  Load the result with
    ``model.load_state_dict(...)``."""
    sd: Dict[str, torch.Tensor] = {}
    _embeddings(sd, tree)
    _cell(sd, "enc", tree["enc"])
    _cell(sd, "dec", tree["dec"])
    _dense(sd, "out", tree["out"])
    return sd


def bilstm_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """State dict of :class:`repro_torch.nmt.lstm.BiLSTMSeq2Seq` from the
    reference ``BiLSTMSeq2Seq.init`` pytree: dense weights transposed,
    the cells' ``wx``/``wh``/``b`` as they are.  Load the result with
    ``model.load_state_dict(...)``."""
    sd: Dict[str, torch.Tensor] = {}
    _embeddings(sd, tree)
    for i, layer in enumerate(tree["enc"]):
        _cell(sd, f"enc.{i}.fwd", layer["fwd"])
        _cell(sd, f"enc.{i}.bwd", layer["bwd"])
        _dense(sd, f"enc.{i}.proj", layer["proj"])
    for i, p in enumerate(tree["dec"]):
        _cell(sd, f"dec.{i}", p)
    _dense(sd, "attn_combine", tree["attn_combine"])
    _dense(sd, "out", tree["out"])
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
    ``shared_attn``, ``embed``, ``lm_head`` (absent with tied embeddings),
    ``final_norm``, whisper's ``encoder.final_norm`` and deepseek-v3's
    ``mtp`` (``proj``, ``norm`` and one unstacked ``block``) carry across
    as they are; whisper's encoder layers are stacked like a group and
    become ``encoder.layers.<layer>.*``.  qwen3's qk-norm scales
    (``mixer.q_norm.g`` / ``mixer.k_norm.g``), the cross-attention leaves
    (``mixer.xq`` .. ``mixer.xo``, ``ln_x``), the MoE leaves
    (``ffn.router``, ``ffn.experts_*``, ``ffn.shared.*``) and the eight MLA
    leaves are per-layer leaves like any other.  Every tensor is used as
    given, in its own dtype (the bfloat16 leaves of a reference
    ``LM(param_dtype=jnp.bfloat16)`` bit for bit, for the port's
    ``LM(param_dtype=torch.bfloat16)``), never redrawn.  Load the result with
    ``model.load_state_dict(...)``.
    """
    unknown = set(tree) - {"embed", "final_norm", "lm_head", "groups",
                           "shared_attn", "mtp", "encoder"}
    if unknown:
        raise ValueError(f"unknown parameters {sorted(unknown)}")
    if len(tree["groups"]) != len(cfg.layer_plan):
        raise ValueError(f"{len(tree['groups'])} groups in the tree, "
                         f"{len(cfg.layer_plan)} in the config")
    flat: Dict[str, np.ndarray] = {}
    for key in ("embed", "final_norm", "lm_head", "shared_attn", "mtp"):
        if key in tree:
            _flatten(key, tree[key], flat)
    stacks = [(f"groups.{gi}", g.count, gtree)
              for gi, (g, gtree) in enumerate(zip(cfg.layer_plan,
                                                  tree["groups"]))]
    if "encoder" in tree:
        _flatten("encoder.final_norm", tree["encoder"]["final_norm"], flat)
        stacks.append(("encoder.layers", cfg.encoder.num_layers,
                       tree["encoder"]["layers"]))
    for prefix, count, stree in stacks:
        group: Dict[str, np.ndarray] = {}
        _flatten("", stree, group)
        for name, stacked in group.items():
            if stacked.shape[0] != count:
                raise ValueError(f"{prefix} leaf {name} stacks "
                                 f"{stacked.shape[0]} layers, expected "
                                 f"{count}")
            for li in range(count):
                flat[f"{prefix}.{li}.{name}"] = stacked[li]
    return {name: _t_keep(a) for name, a in flat.items()}


# ------------------------------------------------------ port -> reference --
@dataclasses.dataclass(frozen=True)
class Leaf:
    """Where a port parameter lives in the reference's pytree.

    ``path`` holds dict keys (str) and list indices (int); ``transpose``
    marks an ``nn.Linear`` weight, stored (d_out, d_in) against the
    reference's (d_in, d_out); ``layer`` is the index along the leading
    ``count`` axis of a stacked LM group's leaf, None where the leaf is
    the tensor itself."""

    path: Tuple
    transpose: bool = False
    layer: Optional[int] = None

    @property
    def keystr(self) -> str:
        """``jax.tree_util.keystr`` of the leaf's path."""
        return "".join(f"[{k!r}]" for k in self.path)

    def ndim(self, tensor: torch.Tensor) -> int:
        """The rank of the reference's leaf (stacking adds an axis)."""
        return tensor.dim() + (self.layer is not None)


def _key(part: str):
    return int(part) if part.isdigit() else part


_NMT_RENAMES = {"self_attn": "self", "inp": "in"}


def _nmt_leaf(name: str) -> Leaf:
    """The NMT models' names: ``nn.Linear`` weight/bias are ``w`` (d_in,
    d_out)/``b``, a layer norm's are ``g``/``b``, an embedding's weight is
    the leaf itself, the RNN cells' ``wx``/``wh``/``b`` keep their names."""
    parts = name.split(".")
    *mod, last = parts
    path = tuple(_key(_NMT_RENAMES.get(p, p)) for p in mod)
    if mod[-1] in ("src_embed", "tgt_embed"):
        return Leaf(path)
    if mod[-1].startswith("ln"):
        return Leaf(path + ({"weight": "g", "bias": "b"}[last],))
    if last == "weight":
        return Leaf(path + ("w",), transpose=True)
    return Leaf(path + ({"bias": "b"}.get(last, last),))


def _lm_leaf(name: str) -> Leaf:
    """The LM's names are the reference's paths; ``groups.<g>.<layer>.*``
    is layer ``layer`` of group ``g``'s stacked leaf, and
    ``encoder.layers.<layer>.*`` layer ``layer`` of the encoder's."""
    parts = name.split(".")
    if parts[0] == "groups":
        return Leaf(("groups", int(parts[1])) + tuple(parts[3:]),
                    layer=int(parts[2]))
    if parts[:2] == ["encoder", "layers"]:
        return Leaf(("encoder", "layers") + tuple(parts[3:]),
                    layer=int(parts[2]))
    return Leaf(tuple(parts))


def _is_lm(model) -> bool:
    return hasattr(getattr(model, "cfg", None), "layer_plan")


def reference_leaves(model) -> Dict[str, Leaf]:
    """Each parameter name of ``model`` (one of the port's three NMT
    models or an LM) with its place in the reference's pytree."""
    leaf = _lm_leaf if _is_lm(model) else _nmt_leaf
    return {name: leaf(name) for name, _ in model.named_parameters()}


def _put(tree, path, value) -> None:
    """Set ``tree[path] = value``, making the dicts and lists on the way
    (a list's entries are dicts in every model here)."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def _to_jax(sd, leaf_of, tree, raw_bf16: bool = False
            ) -> Tuple[dict, Dict[str, str]]:
    stacks: Dict[Tuple, Dict[int, np.ndarray]] = {}
    paths: Dict[str, str] = {}
    for name, tensor in sd.items():
        leaf = leaf_of(name)
        a = _numpy(tensor, raw_bf16=raw_bf16)
        if leaf.transpose:
            a = np.ascontiguousarray(a.T)
        if leaf.layer is None:
            _put(tree, leaf.path, a)
        else:
            stacks.setdefault(leaf.path, {})[leaf.layer] = a
        paths[name] = leaf.keystr
    for path, layers in stacks.items():
        _put(tree, path, np.stack([layers[i] for i in range(len(layers))]))
    return tree, paths


def marian_params_to_jax(sd) -> Tuple[dict, Dict[str, str]]:
    """The inverse of :func:`marian_params_from_jax`: the reference
    ``MarianTransformer.init`` pytree (numpy leaves) from a port state
    dict, and each name's keystr path."""
    return _to_jax(sd, _nmt_leaf, {})


def gru_params_to_jax(sd) -> Tuple[dict, Dict[str, str]]:
    """The inverse of :func:`gru_params_from_jax`."""
    return _to_jax(sd, _nmt_leaf, {})


def bilstm_params_to_jax(sd) -> Tuple[dict, Dict[str, str]]:
    """The inverse of :func:`bilstm_params_from_jax`."""
    return _to_jax(sd, _nmt_leaf, {})


def lm_params_to_jax(sd, cfg) -> Tuple[dict, Dict[str, str]]:
    """The inverse of :func:`lm_params_from_jax`: each group's layers
    stacked along a leading ``count`` axis again, a shared-attention
    group's place in ``groups`` an empty dict, as the reference's."""
    return _lm_to_jax(sd, cfg)


def _lm_to_jax(sd, cfg, raw_bf16: bool = False):
    return _to_jax(sd, _lm_leaf,
                   {"groups": [{} for _ in cfg.layer_plan]}, raw_bf16)


def params_to_jax(model, sd=None) -> Tuple[dict, Dict[str, str]]:
    """The reference pytree of ``sd`` (default: ``model``'s parameters),
    by ``model``'s family; bfloat16 leaves as ``ml_dtypes.bfloat16``."""
    return _params_to_jax(model, sd)


def _params_to_jax(model, sd=None, raw_bf16: bool = False
                   ) -> Tuple[dict, Dict[str, str]]:
    """:func:`params_to_jax`; with ``raw_bf16`` the bfloat16 leaves as
    :data:`BF16_BITS` (no ``ml_dtypes``: the checkpoints' route)."""
    sd = dict(model.named_parameters()) if sd is None else sd
    if _is_lm(model):
        return _lm_to_jax(sd, model.cfg, raw_bf16)
    return _to_jax(sd, _nmt_leaf, {}, raw_bf16)


def params_from_jax(model, tree) -> Dict[str, torch.Tensor]:
    """The port state dict of the reference pytree ``tree``, by
    ``model``'s family."""
    if _is_lm(model):
        return lm_params_from_jax(tree, model.cfg)
    name = type(model).__name__
    return {"MarianTransformer": marian_params_from_jax,
            "GRUSeq2Seq": gru_params_from_jax,
            "BiLSTMSeq2Seq": bilstm_params_from_jax}[name](tree)
