"""The paper's NMT models (§III), ported to PyTorch.

* :class:`BiLSTMSeq2Seq`      — 2-layer BiLSTM encoder + attention LSTM
                                decoder, hidden 500 (IWSLT'14 DE-EN in
                                the paper).
* :class:`GRUSeq2Seq`         — single-layer GRU encoder/decoder, hidden
                                256 (OPUS-100 FR-EN).
* :class:`MarianTransformer`  — Marian-style encoder-decoder transformer
                                (OPUS-100 EN-ZH).

Every model exposes ``encode``, ``decode_step``, ``make_translate``
(greedy host loop, wall-clock linear in M), ``make_translate_batched``
(the batched device loop that serving uses) and the two legs of a split
placement, ``make_encode_states`` and ``make_decode_from_states``.
"""

from repro_torch.nmt.common import (
    EncoderStates,
    RNNConfig,
    TransformerConfig,
    batched_greedy_decode,
    greedy_decode,
)
from repro_torch.nmt.gru import GRUSeq2Seq
from repro_torch.nmt.lstm import BiLSTMSeq2Seq
from repro_torch.nmt.registry import PAPER_MODELS
from repro_torch.nmt.transformer import MarianTransformer, make_executors

__all__ = [
    "EncoderStates",
    "RNNConfig",
    "TransformerConfig",
    "batched_greedy_decode",
    "greedy_decode",
    "BiLSTMSeq2Seq",
    "GRUSeq2Seq",
    "MarianTransformer",
    "PAPER_MODELS",
    "make_executors",
]
