"""Output-length estimation: the linear N->M mapping of paper §II-B.

The paper's key enabler for collaborative seq2seq inference is that the
(unknown) output length M of a translation correlates strongly with the
(known) input length N, and that a *linear* model

    M_hat = gamma * N + delta                                   (Eq. 2, inner)

fitted per language pair reaches R^2 ~ 0.99 (paper Fig. 3).  gamma captures
relative verbosity of the language pair (gamma < 1 for FR->EN, EN->ZH;
~1 for DE->EN), delta a constant offset.

This module implements the paper's estimator (:class:`LinearN2M`), the
Naive baseline (:class:`MeanN2M`, M_hat = corpus mean, paper §III), and
three beyond-paper estimators the paper's conclusion calls for ("more
advanced output length estimation methods"):

* :class:`RidgeN2M`   — L2-regularized fit, stable for tiny corpora.
* :class:`HuberN2M`   — robust to mis-aligned sentence pairs (the outliers
  the paper removes by pre-filtering; Huber handles them without a filter).
* :class:`BucketN2M`  — piecewise (per-N-bucket) conditional mean/quantile,
  captures mild nonlinearity at extreme lengths; an optional quantile knob
  lets the scheduler hedge latency-critical decisions.

All estimators share fit(N, M) / predict(N) and are deterministic given
their inputs.  Arithmetic is numpy float32 where the JAX reference
computes in float32 (its ``jnp`` default); inputs of any dtype, Python
ints included, are cast to float32 explicitly, because numpy would
otherwise promote ``int * float`` to float64 where JAX gives float32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def prefilter_pairs(
    n: np.ndarray,
    m: np.ndarray,
    *,
    max_len: int = 200,
    max_ratio: float = 3.0,
    min_len: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """ParaCrawl-style corpus pre-filtering (paper §III, ref [21]).

    Removes wrongly-matched sentence pairs before fitting gamma/delta:
    pairs where either side is empty/too long, or where the length ratio
    exceeds ``max_ratio`` in either direction.
    """
    n = np.asarray(n, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    if n.shape != m.shape:
        raise ValueError(f"N/M shape mismatch: {n.shape} vs {m.shape}")
    keep = (
        (n >= min_len)
        & (m >= min_len)
        & (n <= max_len)
        & (m <= max_len)
        & (m <= max_ratio * n)
        & (n <= max_ratio * m)
    )
    return n[keep], m[keep]


@dataclasses.dataclass
class LinearN2M:
    """The paper's estimator: ordinary-least-squares M_hat = gamma*N + delta.

    gamma/delta depend only on the language pair (paper §II-B) — they are
    fitted once on ground-truth (N, M_real) corpus pairs and reused for
    every device and model.
    """

    gamma: float = 1.0
    delta: float = 0.0

    def fit(self, n, m) -> "LinearN2M":
        n = np.asarray(n, np.float32)
        m = np.asarray(m, np.float32)
        if n.size < 2:
            raise ValueError("need >= 2 pairs to fit a line")
        a = np.stack([n, np.ones_like(n)], axis=1)
        coef, *_ = np.linalg.lstsq(a, m, rcond=None)
        self.gamma = float(coef[0])
        self.delta = float(coef[1])
        return self

    def predict(self, n):
        n = np.asarray(n).astype(np.float32)
        return np.float32(self.gamma) * n + np.float32(self.delta)

    # --- quality metrics reported in the paper's Fig. 3 caption -----------
    def r2(self, n, m) -> float:
        n = np.asarray(n, np.float32)
        m = np.asarray(m, np.float32)
        pred = self.predict(n)
        ss_res = np.sum((m - pred) ** 2)
        ss_tot = np.sum((m - np.mean(m)) ** 2)
        return float(1.0 - ss_res / np.maximum(ss_tot, np.float32(1e-12)))

    def mse(self, n, m) -> float:
        pred = self.predict(np.asarray(n, np.float32))
        return float(np.mean((np.asarray(m, np.float32) - pred) ** 2))


@dataclasses.dataclass
class MeanN2M:
    """The Naive baseline of paper §III: M_hat = mean output length.

    Ignores N entirely; used to quantify the value of the N->M mapping.
    """

    mean_m: float = 0.0

    def fit(self, n, m) -> "MeanN2M":
        self.mean_m = float(np.mean(np.asarray(m, np.float32)))
        return self

    def predict(self, n):
        n = np.asarray(n)
        return np.full(n.shape, self.mean_m, dtype=np.float32)


@dataclasses.dataclass
class RidgeN2M(LinearN2M):
    """L2-regularized linear fit (beyond paper): stable under tiny corpora."""

    lam: float = 1.0

    def fit(self, n, m) -> "RidgeN2M":
        n = np.asarray(n, np.float32)
        m = np.asarray(m, np.float32)
        a = np.stack([n, np.ones_like(n)], axis=1)
        ata = a.T @ a + np.float32(self.lam) * np.eye(2, dtype=a.dtype)
        atb = a.T @ m
        coef = np.linalg.solve(ata, atb)
        self.gamma = float(coef[0])
        self.delta = float(coef[1])
        return self


@dataclasses.dataclass
class HuberN2M(LinearN2M):
    """Huber-loss robust linear fit via IRLS (beyond paper).

    Handles wrongly-matched pairs without the explicit pre-filter the paper
    applies; with heavy outliers this recovers the inlier line.
    """

    huber_delta: float = 5.0
    iters: int = 50

    def fit(self, n, m) -> "HuberN2M":
        n = np.asarray(n, np.float32)
        m = np.asarray(m, np.float32)
        a = np.stack([n, np.ones_like(n)], axis=1)
        # init from OLS
        coef, *_ = np.linalg.lstsq(a, m, rcond=None)
        hd = np.float32(self.huber_delta)
        for _ in range(self.iters):
            resid = m - a @ coef
            absr = np.abs(resid)
            w = np.where(absr <= hd, np.float32(1.0),
                         hd / np.maximum(absr, np.float32(1e-9)))
            aw = a * w[:, None]
            coef = np.linalg.solve(
                a.T @ aw + np.float32(1e-9) * np.eye(2, dtype=np.float32),
                aw.T @ m)
        self.gamma = float(coef[0])
        self.delta = float(coef[1])
        return self


@dataclasses.dataclass
class BucketN2M:
    """Per-N-bucket conditional mean/quantile estimator (beyond paper).

    Splits N into ``n_buckets`` equal-width buckets and stores the
    ``quantile`` of M in each; prediction falls back to the fitted global
    line outside observed support. quantile=0.5 is a robust conditional
    median; quantile>0.5 gives a pessimistic estimate that lets the
    scheduler hedge against under-predicting M (useful because the latency
    cost of under-predicting is asymmetric when the edge is slow).
    """

    n_buckets: int = 32
    quantile: float = 0.5

    def __post_init__(self):
        self._edges: np.ndarray | None = None
        self._values: np.ndarray | None = None
        self._fallback = LinearN2M()

    def fit(self, n, m) -> "BucketN2M":
        n = np.asarray(n, np.float64)
        m = np.asarray(m, np.float64)
        self._fallback.fit(n, m)
        lo, hi = float(n.min()), float(n.max())
        if hi <= lo:
            hi = lo + 1.0
        self._edges = np.linspace(lo, hi, self.n_buckets + 1)
        idx = np.clip(np.digitize(n, self._edges) - 1, 0, self.n_buckets - 1)
        values = np.zeros(self.n_buckets)
        for b in range(self.n_buckets):
            sel = m[idx == b]
            if sel.size:
                values[b] = np.quantile(sel, self.quantile)
            else:
                mid = 0.5 * (self._edges[b] + self._edges[b + 1])
                values[b] = float(self._fallback.predict(mid))
        self._values = values
        return self

    def predict(self, n):
        n_arr = np.atleast_1d(np.asarray(n, np.float64))
        if self._edges is None:
            raise RuntimeError("BucketN2M not fitted")
        idx = np.clip(np.digitize(n_arr, self._edges) - 1, 0, self.n_buckets - 1)
        out = self._values[idx]
        # extrapolate with the global line outside support
        below = n_arr < self._edges[0]
        above = n_arr > self._edges[-1]
        if below.any() or above.any():
            lin = np.asarray(self._fallback.predict(n_arr))
            out = np.where(below | above, lin, out)
        res = np.asarray(out, np.float32)
        return res if np.ndim(n) else res[0]
