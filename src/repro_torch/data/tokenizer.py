"""Deterministic hash tokenizer stub.

Real NMT stacks ship a learned subword vocabulary (BPE/SentencePiece).
That artifact is orthogonal to everything this framework studies (latency
scheduling, sharding, kernels), so we provide a deterministic stand-in
with the same *interface*: text <-> int32 ids, special ids, stable across
processes (no Python hash randomization).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
NUM_SPECIAL = 4


class HashTokenizer:
    """Whitespace-split words -> stable bucket ids in [NUM_SPECIAL, vocab)."""

    def __init__(self, vocab_size: int = 32000):
        if vocab_size <= NUM_SPECIAL:
            raise ValueError("vocab too small")
        self.vocab_size = vocab_size

    def _word_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.blake2s(w.encode("utf-8"), digest_size=8).digest(), "little")
        return NUM_SPECIAL + h % (self.vocab_size - NUM_SPECIAL)

    def encode(self, text: str, *, add_bos: bool = False, add_eos: bool = True) -> List[int]:
        ids = [self._word_id(w) for w in text.split()]
        if add_bos:
            ids = [BOS_ID] + ids
        if add_eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        # hash buckets are not invertible; emit placeholder word forms
        out = []
        for i in ids:
            if i == EOS_ID:
                break
            if i in (PAD_ID, BOS_ID):
                continue
            out.append(f"<w{int(i)}>" if i != UNK_ID else "<unk>")
        return " ".join(out)
