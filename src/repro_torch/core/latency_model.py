"""Per-device execution-time planes: T_exe,i(N, M) of paper Eq. (2).

The paper models inference latency of a seq2seq model on device *i* as a
plane over input length N and output length M:

    T_exe,i = alpha_N,i * N + alpha_M,i * M + beta_i

* RNN encoder/decoder: both slopes positive (strict step dependency).
* Transformer on a parallel device: alpha_N ~ 0 for short inputs (encoder
  parallelizes), alpha_M > 0 and dominant (autoregressive masked decode).

Coefficients come from a once-for-all offline characterization (paper
§II-B last para).  Two calibration paths are provided:

* measured   — fit on (N, M, T) samples from real runs
               (``repro_torch.core.calibration`` produces them);
* analytical — beyond paper: derive the plane from a roofline cost model
               (FLOPs/byte terms per token) so the scheduler can price
               hardware it does not run on; see
               :meth:`LinearLatencyModel.from_roofline`.

Arithmetic is numpy **float32** wherever the JAX reference computes in
float32 (its ``jnp`` default): the fit, ``predict`` and ``r2``.  A
float64 ``predict`` would flip Eq. (1) decisions at ties against the
reference, so every operand is cast explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LinearLatencyModel:
    """T(N, M) = alpha_n * N + alpha_m * M + beta   (seconds)."""

    alpha_n: float = 0.0
    alpha_m: float = 0.0
    beta: float = 0.0

    def fit(self, n, m, t) -> "LinearLatencyModel":
        """Least-squares fit on characterization samples (paper: 10k/device)."""
        n = np.asarray(n, np.float32)
        m = np.asarray(m, np.float32)
        t = np.asarray(t, np.float32)
        a = np.stack([n, m, np.ones_like(n)], axis=1)
        coef, *_ = np.linalg.lstsq(a, t, rcond=None)
        self.alpha_n = float(coef[0])
        self.alpha_m = float(coef[1])
        self.beta = float(coef[2])
        return self

    def predict(self, n, m):
        # float32 throughout, one rounding per op, in the reference's order
        n = np.asarray(n, np.float32)
        m = np.asarray(m, np.float32)
        return (np.float32(self.alpha_n) * n + np.float32(self.alpha_m) * m
                + np.float32(self.beta))

    def predict_legs(self, n, m):
        """Split the plane into (encode, decode) leg predictions.

        The alpha_n·N term is encoder work, the alpha_m·M term is
        autoregressive decode work, and beta (framework/dispatch
        overhead) is paid once per leg when the legs run on different
        tiers — so each leg carries half of it.  By construction
        ``sum(predict_legs(n, m)) == predict(n, m)`` up to float
        association: a whole-request placement prices identically
        whether viewed as one plane or two legs on the same tier.
        """
        n = np.asarray(n, np.float64)
        m = np.asarray(m, np.float64)
        t_enc = self.alpha_n * n + 0.5 * self.beta
        t_dec = self.alpha_m * m + 0.5 * self.beta
        return t_enc, t_dec

    def r2(self, n, m, t) -> float:
        t = np.asarray(t, np.float32)
        pred = self.predict(n, m)
        ss_res = np.sum((t - pred) ** 2)
        ss_tot = np.sum((t - np.mean(t)) ** 2)
        return float(1.0 - ss_res / np.maximum(ss_tot, np.float32(1e-12)))

    def scaled(self, factor: float) -> "LinearLatencyModel":
        """A device `factor`x faster (e.g. cloud = edge / speedup)."""
        return LinearLatencyModel(
            self.alpha_n / factor, self.alpha_m / factor, self.beta / factor
        )

    @classmethod
    def from_roofline(
        cls,
        *,
        prefill_flops_per_token: float,
        decode_flops_per_token: float,
        decode_bytes_per_token: float,
        peak_flops: float,
        hbm_bw: float,
        overhead_s: float = 0.0,
        mfu: float = 0.4,
    ) -> "LinearLatencyModel":
        """Beyond paper: build the plane analytically from roofline terms.

        Per input token the encoder/prefill is compute-bound:
            alpha_n = prefill_flops_per_token / (mfu * peak_flops)
        Per output token the autoregressive decode step is
        max(compute, memory)-bound:
            alpha_m = max(decode_flops / (mfu*peak), decode_bytes / hbm_bw)

        This is how the serving engine prices a tier it cannot measure:
        the terms come from the model's FLOP and byte counts per token.
        """
        alpha_n = prefill_flops_per_token / (mfu * peak_flops)
        alpha_m = max(
            decode_flops_per_token / (mfu * peak_flops),
            decode_bytes_per_token / hbm_bw,
        )
        return cls(alpha_n=alpha_n, alpha_m=alpha_m, beta=overhead_s)


@dataclasses.dataclass
class DeviceProfile:
    """A compute tier the scheduler can map an inference onto.

    ``noise_frac`` models run-to-run latency variation (load, DVFS, ...):
    the *true* execution time drawn in the simulator is
    ``T * (1 + noise_frac * eps)`` with eps ~ N(0,1) truncated at +-3.
    The paper's Fig. 2a shows exactly such bands around the linear fit.
    """

    name: str
    model: LinearLatencyModel
    noise_frac: float = 0.05

    def true_time(self, n, m, rng: np.random.Generator) -> np.ndarray:
        base = np.asarray(self.model.predict(n, m))
        eps = np.clip(rng.standard_normal(base.shape), -3.0, 3.0)
        return np.maximum(base * (1.0 + self.noise_frac * eps), 1e-6)

    def true_leg_times(self, n, m, rng: np.random.Generator):
        """Noisy (encode, decode) leg times for a split placement.

        Each leg draws its own truncated-normal perturbation — the two
        legs of a partitioned request run at different wall-clock times
        (often on different tiers), so their load/DVFS noise is
        independent, unlike :meth:`true_time`'s single draw.
        """
        enc, dec = self.model.predict_legs(n, m)
        enc = np.asarray(enc, np.float64)
        dec = np.asarray(dec, np.float64)
        eps_e = np.clip(rng.standard_normal(enc.shape), -3.0, 3.0)
        eps_d = np.clip(rng.standard_normal(dec.shape), -3.0, 3.0)
        return (np.maximum(enc * (1.0 + self.noise_frac * eps_e), 1e-6),
                np.maximum(dec * (1.0 + self.noise_frac * eps_d), 1e-6))


def bytes_for_tokens(n_tokens, bytes_per_token: int = 2) -> np.ndarray:
    """Paper §II: dictionary-index encoding needs <= 2 bytes/token."""
    return np.asarray(n_tokens) * bytes_per_token


@dataclasses.dataclass(frozen=True)
class ActivationCostModel:
    """Wire size of a model's encoder states for cross-tier shipping.

    Whole-request offload ships *tokens* (~2 bytes each, see
    :func:`bytes_for_tokens`); a split placement ships *activations* —
    the encoder's output states, ``n x d_model`` floats plus a small
    per-sequence overhead (source lengths, masks).  That is 3-4 orders
    of magnitude fatter per token, which is exactly why the scheduler
    must price it per model instead of reusing the token byte count.
    """

    d_model: int
    dtype_bytes: int = 4
    per_seq_overhead_bytes: int = 0

    def payload_bytes(self, n) -> np.ndarray:
        return (np.asarray(n, np.float64) * self.d_model * self.dtype_bytes
                + self.per_seq_overhead_bytes)
