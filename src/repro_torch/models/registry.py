"""One model registry: the paper's NMT pairs and big-stack LMs by name.

Port of ``repro/models/registry.py``, with the same name normalization
and scale rules:

* ``"cnmt:en-zh"`` / ``"cnmt:zh-en"`` / bare ``"en-zh"`` — the paper's
  evaluated NMT combination for that language pair (§III); direction is
  normalized, so both orders name the same registered model.  ``scale``
  shrinks widths and layers (``scale=1`` is the paper's size).
* ``"rwkv6-3b"`` / ``"rwkv6_3b"`` / ``"zamba2-1.2b"`` — a big
  :class:`~repro_torch.models.model.LM` from ``repro_torch.configs``;
  underscores normalize to hyphens.  ``size="smoke"`` (default) builds
  the reduced CPU variant, ``size="full"`` the assigned configuration.

Unlike the reference, :func:`resolve` returns the model with its weights
already drawn (from ``seed``, on ``device``).  It builds the paper's
three NMT models (BiLSTM de-en, GRU fr-en, Marian en-zh) and the two
recurrent LMs; the other eight LM names raise ``NotImplementedError``
until their slices land.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.nmt.common import RNNConfig, TransformerConfig
from repro_torch.nmt.gru import GRUSeq2Seq
from repro_torch.nmt.lstm import BiLSTMSeq2Seq
from repro_torch.nmt.registry import PAPER_MODELS
from repro_torch.nmt.transformer import MarianTransformer

_NMT_CLASSES = {"bilstm": BiLSTMSeq2Seq, "gru": GRUSeq2Seq,
                "marian": MarianTransformer}

# repro_torch.configs and models.model are imported where they are used:
# repro_torch.configs imports repro_torch.models.config, so a module-level
# import here would be circular through the repro_torch.models package.


@dataclasses.dataclass(frozen=True)
class ResolvedModel:
    """What :func:`resolve` hands back: the instantiated model (weights
    drawn from ``seed``) plus enough metadata to route it."""
    name: str                 # canonical registry name
    family: str               # "nmt" | "lm"
    model: object             # BiLSTM/GRU/Marian seq2seq or LM
    cfg: object               # its config object
    pair: Optional[str] = None   # language pair (nmt only)


def _normalize_pair(pair: str) -> str:
    if pair in PAPER_MODELS:
        return pair
    rev = "-".join(reversed(pair.split("-")))
    if rev in PAPER_MODELS:
        return rev
    raise KeyError(
        f"unknown language pair {pair!r}; have {sorted(PAPER_MODELS)}")


def nmt_config(dataset: str, *, scale: float = 1.0, vocab: int = 8000,
               max_decode_len: int = 256):
    """The paper's model configuration for ``dataset`` (§III): an
    :class:`RNNConfig` for the BiLSTM and the GRU, a
    :class:`TransformerConfig` for Marian.

    ``scale`` shrinks widths (and Marian's layers; an RNN's ``layers`` is
    not scaled); scale=1 is the paper's size.  The rules are the
    reference's, so both packages build the same shapes.
    """
    family, hp, _ = PAPER_MODELS[dataset]
    s = lambda v: max(8, int(v * scale))
    if family in ("bilstm", "gru"):
        return RNNConfig(vocab_src=vocab, vocab_tgt=vocab,
                         embed=s(hp["embed"]), hidden=s(hp["hidden"]),
                         layers=hp["layers"], max_decode_len=max_decode_len)
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
    from repro_torch.configs import PORTED
    return tuple(f"cnmt:{p}" for p in PAPER_MODELS) + PORTED


def resolve(name: str, *, size: str = "smoke",
            # NMT knobs (ignored for LM names)
            scale: float = 1.0, vocab: int = 8000, max_decode_len: int = 256,
            device=None, seed: int = 0) -> ResolvedModel:
    """Resolve a model name to an instantiated model on ``device``
    (``cuda`` unless the caller asks for ``"cpu"``), its weights drawn
    from a ``torch.Generator`` seeded with ``seed``.  For LM names
    ``size`` picks ``smoke_config`` ("smoke") or ``get_config``
    ("full")."""
    from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
    from repro_torch.models.model import LM

    if size not in ("smoke", "full"):
        raise ValueError(f"size must be 'smoke' or 'full', got {size!r}")
    key = name.strip()
    if key.startswith("cnmt:") or key in PAPER_MODELS or (
            "-".join(reversed(key.split("-"))) in PAPER_MODELS):
        pair = _normalize_pair(key.split(":", 1)[-1])
        cfg = nmt_config(pair, scale=scale, vocab=vocab,
                         max_decode_len=max_decode_len)
        model = _NMT_CLASSES[PAPER_MODELS[pair][0]](cfg, device=device,
                                                    seed=seed)
        return ResolvedModel(name=f"cnmt:{pair}", family="nmt",
                             model=model, cfg=cfg, pair=pair)
    arch = key.replace("_", "-")
    if arch in ARCH_NAMES:
        cfg = smoke_config(arch) if size == "smoke" else get_config(arch)
        return ResolvedModel(name=arch, family="lm",
                             model=LM(cfg, device=device, seed=seed), cfg=cfg)
    raise KeyError(
        f"unknown model {name!r}; available: {', '.join(available())}")
