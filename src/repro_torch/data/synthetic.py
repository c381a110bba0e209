"""Synthetic parallel corpora with the length statistics the paper exploits.

No internet access -> IWSLT'14 / OPUS-100 are not downloadable.  What the
paper *uses* from those corpora is their (N, M) joint length distribution
(Fig. 3) plus token sequences for exercising real models.  This module
generates corpora matching the published statistics:

* DE-EN (IWSLT'14): spoken-language TED-style, short sentences, German
  slightly longer than English -> gamma ~ 0.95, tight correlation.
* FR-EN (OPUS-100): French more verbose than English -> gamma ~ 0.85
  (paper: "gamma < 1 ... lower verbosity of English w.r.t. French").
* EN-ZH (OPUS-100): Chinese much more compact -> gamma ~ 0.70.

Lengths: N ~ clipped lognormal (corpus-typical right-skewed shape);
M = gamma*N + delta + heteroscedastic noise (std grows with N, matching
the widening bands in paper Fig. 3).  A configurable fraction of
wrongly-matched outlier pairs reproduces the misalignment noise the paper
pre-filters with ParaCrawl rules [21].

Token sequences are drawn i.i.d. zipf over the vocabulary — enough to
exercise/time real models (latency depends on lengths, not token values)
and to train the small NMT models on a learnable copy/stretch task.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LanguagePair:
    name: str
    gamma: float          # verbosity slope  (M ~ gamma*N + delta)
    delta: float          # offset
    noise_base: float     # M noise std at N=0
    noise_slope: float    # heteroscedastic growth of M noise with N
    mean_log_n: float     # lognormal params of N
    std_log_n: float
    min_len: int = 1
    max_len: int = 200
    outlier_frac: float = 0.01
    vocab_src: int = 32000
    vocab_tgt: int = 32000


# Calibrated to reproduce the qualitative Fig. 3 panels.
LANGUAGE_PAIRS: Dict[str, LanguagePair] = {
    "de-en": LanguagePair("de-en", gamma=0.95, delta=0.8, noise_base=1.0,
                          noise_slope=0.06, mean_log_n=2.7, std_log_n=0.55),
    "fr-en": LanguagePair("fr-en", gamma=0.85, delta=0.5, noise_base=0.8,
                          noise_slope=0.05, mean_log_n=2.9, std_log_n=0.60),
    "en-zh": LanguagePair("en-zh", gamma=0.70, delta=1.2, noise_base=1.2,
                          noise_slope=0.08, mean_log_n=2.9, std_log_n=0.60),
}


@dataclasses.dataclass
class ParallelCorpus:
    pair: LanguagePair
    n: np.ndarray        # input lengths
    m_real: np.ndarray   # ground-truth reference output lengths
    m_out: np.ndarray    # lengths the NMT model actually emits
    src: Optional[list] = None   # token id arrays (ragged), lazily built
    tgt: Optional[list] = None

    def __len__(self) -> int:
        return int(self.n.size)

    def split(self, k: int) -> Tuple["ParallelCorpus", "ParallelCorpus"]:
        """Head-k / rest split (characterization vs evaluation sets, §III)."""
        def cut(x, a, b):
            return None if x is None else x[a:b]
        return (
            ParallelCorpus(self.pair, self.n[:k], self.m_real[:k], self.m_out[:k],
                           cut(self.src, 0, k), cut(self.tgt, 0, k)),
            ParallelCorpus(self.pair, self.n[k:], self.m_real[k:], self.m_out[k:],
                           cut(self.src, k, None), cut(self.tgt, k, None)),
        )


def make_corpus(
    pair: str | LanguagePair,
    size: int,
    *,
    seed: int = 0,
    with_tokens: bool = False,
    model_len_noise: float = 1.5,
) -> ParallelCorpus:
    """Sample a corpus of ``size`` (N, M_real, M_out) triples.

    ``m_out`` deviates from ``m_real`` with std ``model_len_noise`` —
    the NMT model's translation length differs slightly from the
    reference's ("M_real may in general differ from the output length M
    produced by the NMT model", §III).
    """
    lp = LANGUAGE_PAIRS[pair] if isinstance(pair, str) else pair
    rng = np.random.default_rng(seed)

    n = np.clip(
        np.round(rng.lognormal(lp.mean_log_n, lp.std_log_n, size)),
        lp.min_len, lp.max_len,
    )
    noise_std = lp.noise_base + lp.noise_slope * n
    m_real = lp.gamma * n + lp.delta + rng.standard_normal(size) * noise_std
    m_real = np.clip(np.round(m_real), lp.min_len, lp.max_len)

    # wrongly-matched pairs: M drawn independently of N (pre-filter fodder)
    n_out = int(lp.outlier_frac * size)
    if n_out:
        idx = rng.choice(size, n_out, replace=False)
        m_real[idx] = np.clip(
            np.round(rng.lognormal(lp.mean_log_n, lp.std_log_n, n_out)),
            lp.min_len, lp.max_len,
        )

    m_out = np.clip(
        np.round(m_real + rng.standard_normal(size) * model_len_noise),
        lp.min_len, lp.max_len,
    )

    src = tgt = None
    if with_tokens:
        # zipf-ish unigram draws; reserve ids 0..3 for pad/bos/eos/unk
        def draw(lengths, vocab):
            out = []
            for L in lengths.astype(int):
                r = rng.zipf(1.3, size=L)
                out.append(np.minimum(r + 3, vocab - 1).astype(np.int32))
            return out
        src = draw(n, lp.vocab_src)
        tgt = draw(m_out, lp.vocab_tgt)

    return ParallelCorpus(lp, n, m_real, m_out, src, tgt)
