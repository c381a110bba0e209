"""Model registry: the paper's NMT pairs by name.

Port of the NMT half of ``repro/models/registry.py``, with the same
name normalization and scale rules:

* ``"cnmt:en-zh"`` / ``"cnmt:zh-en"`` / bare ``"en-zh"`` — the paper's
  evaluated NMT combination for that language pair (§III); direction is
  normalized, so both orders name the same registered model.
* ``scale`` shrinks widths and layers (``scale=1`` is the paper's size).

This slice builds the Marian transformer only.  ``"cnmt:de-en"`` (BiLSTM)
and ``"cnmt:fr-en"`` (GRU) and the big-LM names raise
``NotImplementedError`` until their slices land.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.nmt.common import TransformerConfig
from repro_torch.nmt.registry import PAPER_MODELS
from repro_torch.nmt.transformer import MarianTransformer

# the big-LM architectures the reference registry resolves
LM_NAMES = ("rwkv6-3b", "whisper-large-v3", "moonshot-v1-16b-a3b",
            "qwen3-moe-30b-a3b", "zamba2-1.2b", "qwen3-32b",
            "deepseek-v3-671b", "deepseek-67b", "qwen3-8b", "chameleon-34b")


@dataclasses.dataclass(frozen=True)
class ResolvedModel:
    """What :func:`resolve` hands back: the instantiated model (weights
    drawn from ``seed``) plus enough metadata to route it."""
    name: str                 # canonical registry name
    family: str               # "nmt"
    model: object             # MarianTransformer
    cfg: object               # its config object
    pair: Optional[str] = None   # language pair


def _normalize_pair(pair: str) -> str:
    if pair in PAPER_MODELS:
        return pair
    rev = "-".join(reversed(pair.split("-")))
    if rev in PAPER_MODELS:
        return rev
    raise KeyError(
        f"unknown language pair {pair!r}; have {sorted(PAPER_MODELS)}")


def nmt_config(dataset: str, *, scale: float = 1.0, vocab: int = 8000,
               max_decode_len: int = 256) -> TransformerConfig:
    """The paper's model configuration for ``dataset`` (§III).

    ``scale`` shrinks widths/layers (scale=1 is the paper's size); the
    rules are the reference's, so both packages build the same shapes.
    """
    family, hp, pair = PAPER_MODELS[dataset]
    if family != "marian":
        raise NotImplementedError(
            f"the {family} model of {pair!r} is not ported yet: the RNN "
            "models come in the slice after the Marian one")
    s = lambda v: max(8, int(v * scale))
    heads = min(8, max(2, int(8 * scale)))
    d_model = max(heads * 8, (s(hp["d_model"]) // heads) * heads)
    return TransformerConfig(
        vocab_src=vocab, vocab_tgt=vocab,
        d_model=d_model, heads=heads,
        d_ff=s(hp["d_ff"]),
        enc_layers=max(1, int(hp["enc_layers"] * min(scale * 2, 1.0))),
        dec_layers=max(1, int(hp["dec_layers"] * min(scale * 2, 1.0))),
        max_decode_len=max_decode_len,
    )


def available() -> Tuple[str, ...]:
    """Canonical names this registry resolves."""
    return tuple(f"cnmt:{p}" for p, (fam, _, _) in PAPER_MODELS.items()
                 if fam == "marian")


def resolve(name: str, *, scale: float = 1.0, vocab: int = 8000,
            max_decode_len: int = 256, device=None,
            seed: int = 0) -> ResolvedModel:
    """Resolve a model name to an instantiated model on ``device``
    (``cuda`` unless the caller asks for ``"cpu"``), its weights drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    key = name.strip()
    if key.startswith("cnmt:") or key in PAPER_MODELS or (
            "-".join(reversed(key.split("-"))) in PAPER_MODELS):
        pair = _normalize_pair(key.split(":", 1)[-1])
        cfg = nmt_config(pair, scale=scale, vocab=vocab,
                         max_decode_len=max_decode_len)
        model = MarianTransformer(cfg, device=device, seed=seed)
        return ResolvedModel(name=f"cnmt:{pair}", family="nmt",
                             model=model, cfg=cfg, pair=pair)
    if key.replace("_", "-") in LM_NAMES:
        raise NotImplementedError(
            f"{name!r} is a big-LM tier; the LM stack is ported in a later "
            "slice")
    raise KeyError(
        f"unknown model {name!r}; available: {', '.join(available())}")
