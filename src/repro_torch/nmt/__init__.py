"""The paper's NMT models (§III), ported to PyTorch.

This slice carries the Marian transformer (OPUS-100 EN-ZH in the
paper); the BiLSTM (DE-EN) and the GRU (FR-EN) come in a later slice.

The model exposes: ``encode``, ``init_cache``, ``decode_step``,
``make_translate`` (greedy host loop, wall-clock linear in M) and
``make_translate_batched`` (the batched device loop that serving uses).
"""

from repro_torch.nmt.common import (
    TransformerConfig,
    batched_greedy_decode,
    greedy_decode,
)
from repro_torch.nmt.registry import PAPER_MODELS
from repro_torch.nmt.transformer import MarianTransformer, make_executors

__all__ = [
    "TransformerConfig",
    "batched_greedy_decode",
    "greedy_decode",
    "MarianTransformer",
    "PAPER_MODELS",
    "make_executors",
]
