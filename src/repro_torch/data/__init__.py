"""Data substrate: synthetic parallel corpora, tokenizer, batching."""

from repro_torch.data.synthetic import (
    LanguagePair,
    LANGUAGE_PAIRS,
    ParallelCorpus,
    make_corpus,
)
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.pipeline import (
    TokenBatcher,
    padded_batches,
    bucket_by_length,
    lm_batches,
)

__all__ = [
    "LanguagePair",
    "LANGUAGE_PAIRS",
    "ParallelCorpus",
    "make_corpus",
    "HashTokenizer",
    "TokenBatcher",
    "padded_batches",
    "bucket_by_length",
    "lm_batches",
]
