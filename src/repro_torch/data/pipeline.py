"""Batching / bucketing pipeline for training and serving.

* :func:`bucket_by_length` — groups ragged sequences into length buckets to
  minimize padding waste (standard NMT practice; matters for the RNN
  models whose compute is linear in padded length).
* :func:`padded_batches` — seq2seq batches: (src, src_mask, tgt_in,
  tgt_out, tgt_mask) with BOS/EOS handling.
* :func:`lm_batches` — decoder-only LM batches (tokens, targets) used by
  the big-model training driver.
* :class:`TokenBatcher` — stateful length-bucketing batcher used by the
  serving engine (real padded token batches) and the discrete-event
  simulator (length-only requests) to group concurrent requests of
  similar length into sub-linear-cost decode batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID


def bucket_by_length(
    lengths: Sequence[int], boundaries: Sequence[int]
) -> Dict[int, List[int]]:
    """index -> bucket assignment; bucket b holds len <= boundaries[b]."""
    buckets: Dict[int, List[int]] = {b: [] for b in range(len(boundaries) + 1)}
    for i, L in enumerate(lengths):
        b = int(np.searchsorted(boundaries, L))
        buckets[b].append(i)
    return {b: idx for b, idx in buckets.items() if idx}


def _pad_to(arrs: List[np.ndarray], width: int) -> np.ndarray:
    out = np.full((len(arrs), width), PAD_ID, dtype=np.int32)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a[:width]
    return out


def padded_batches(
    src: List[np.ndarray],
    tgt: List[np.ndarray],
    *,
    batch_size: int,
    max_len: int = 256,
    boundaries: Sequence[int] = (16, 32, 64, 128),
    seed: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Bucketed, padded seq2seq batches.

    tgt_in is BOS-shifted, tgt_out EOS-terminated; masks are 1 on real
    tokens. Yields dicts of int32/float32 arrays.
    """
    rng = np.random.default_rng(seed)
    buckets = bucket_by_length([len(s) for s in src], boundaries)
    order = []
    for b, idxs in buckets.items():
        idxs = np.asarray(idxs)
        rng.shuffle(idxs)
        for i in range(0, len(idxs), batch_size):
            chunk = idxs[i : i + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                continue
            order.append(chunk)
    rng.shuffle(order)
    for chunk in order:
        s = [np.concatenate([src[i][:max_len - 1], [EOS_ID]]) for i in chunk]
        t = [tgt[i][: max_len - 1] for i in chunk]
        sw = max(len(x) for x in s)
        tw = max(len(x) + 1 for x in t)
        src_pad = _pad_to(s, sw)
        tgt_in = _pad_to([np.concatenate([[BOS_ID], x]) for x in t], tw)
        tgt_out = _pad_to([np.concatenate([x, [EOS_ID]]) for x in t], tw)
        yield {
            "src": src_pad,
            "src_mask": (src_pad != PAD_ID).astype(np.float32),
            "tgt_in": tgt_in,
            "tgt_out": tgt_out,
            "tgt_mask": (tgt_out != PAD_ID).astype(np.float32),
        }


def lm_batches(
    token_stream: np.ndarray, *, batch_size: int, seq_len: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Pack a flat token stream into (B, S) LM batches with next-token targets."""
    rng = np.random.default_rng(seed)
    tokens_per_batch = batch_size * (seq_len + 1)
    n_batches = len(token_stream) // tokens_per_batch
    starts = rng.permutation(n_batches)
    for b in starts:
        chunk = token_stream[b * tokens_per_batch : (b + 1) * tokens_per_batch]
        chunk = chunk.reshape(batch_size, seq_len + 1)
        yield {"tokens": chunk[:, :-1].astype(np.int32),
               "targets": chunk[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class TokenBatcher:
    """Greedy length-aware batcher for the serving engine and simulator.

    Collects pending requests and emits batches whose padded token count
    stays under ``max_tokens_per_batch`` — the standard continuous-batching
    admission rule.  Requests can carry real token arrays (serving: the
    batch is emitted padded, ready for a batched decode) or just a length
    (discrete-event simulation: only the bucketing decision matters) —
    :meth:`next_batch_ids` serves both, :meth:`next_batch` requires
    tokens.
    """

    max_batch: int = 32
    max_tokens_per_batch: int = 8192

    def __post_init__(self):
        # (req_id, tokens-or-None, length), kept sorted lazily by length
        self._pending: List[Tuple[int, Optional[np.ndarray], int]] = []

    def add(self, req_id: int, tokens: Optional[np.ndarray] = None, *,
            length: Optional[int] = None) -> None:
        if tokens is not None:
            arr = np.asarray(tokens, np.int32)
            self._pending.append((req_id, arr, len(arr)))
        elif length is not None:
            self._pending.append((req_id, None, int(length)))
        else:
            raise ValueError("pass tokens or length")

    def __len__(self) -> int:
        return len(self._pending)

    def _take(self) -> List[Tuple[int, Optional[np.ndarray], int]]:
        """Pop the next length-bucketed batch off the pending list."""
        # sort by length so one batch pads minimally
        self._pending.sort(key=lambda kv: kv[2])
        take: List[Tuple[int, Optional[np.ndarray], int]] = []
        width = 0
        while self._pending and len(take) < self.max_batch:
            cand = self._pending[0]
            w = max(width, cand[2])
            if take and w * (len(take) + 1) > self.max_tokens_per_batch:
                break
            take.append(self._pending.pop(0))
            width = w
        return take

    def next_batch_ids(self) -> Tuple[List[int], int] | None:
        """(request ids, padded width) of the next batch; None when empty.

        Works for length-only requests — the discrete-event simulator's
        drain path, where no real token arrays exist.
        """
        if not self._pending:
            return None
        take = self._take()
        return [r for r, _, _ in take], max(L for _, _, L in take)

    def next_batch(self) -> Tuple[List[int], np.ndarray] | None:
        """(request ids, padded (b, width) token batch); None when empty."""
        if not self._pending:
            return None
        take = self._take()
        width = max(L for _, _, L in take)
        ids = [r for r, _, _ in take]
        return ids, _pad_to([t for _, t, _ in take], width)
