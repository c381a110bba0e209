"""Offline device characterization (paper §II-B last paragraph / §III).

The paper fits each device's T_exe plane on 10k inferences with inputs held
out from the 100k evaluation set.  Here:

* :func:`measure_seq2seq` times a real seq2seq model over a grid of input
  lengths (the model's own greedy decoder determines M), and returns
  (N, M, T) samples.  The clock is the host's ``perf_counter``, so the
  ``translate`` it times must return only once the device has finished:
  the port's executors return host ints and numpy arrays, whose copy off
  the card waits for the last kernel.
* :func:`fit_device` least-squares-fits the (N, M, T) plane.
* :func:`make_edge_cloud_pair` synthesizes the paper's two-tier setup from
  one set of measurements: the *edge* device carries the measured plane
  (optionally scaled) and the *cloud* is ``speedup``x faster — mirroring
  the Jetson-TX2-vs-Titan-XP gap (the paper's Fig. 2a slopes differ by
  roughly this factor).  Relative speed is the modelled quantity,
  exactly like the paper's simulated network.
* :func:`device_from_roofline` prices a tier from its FLOP and byte
  counts per token against a device's peaks (NVIDIA H100 by default) —
  beyond paper.
* :func:`measure_batched_seq2seq` + :func:`fit_batch_overhead` calibrate
  the sub-linear batched-decode model  T(b) = T1 + o·(b−1)  that the
  batched serving tiers use (beyond paper): the plane comes from the
  single-sequence grid, the per-extra-sequence overhead ``o`` from a
  batch-size sweep at fixed (N, M).
* :class:`OnlineCalibrator` closes the loop at serve time (beyond paper):
  it accumulates observed (N, M_out, T_exe) completions per tier and
  periodically refits both the scheduler's per-tier planes and the
  LinearN2M length regressor, so a drifting device (thermal throttling,
  noisy neighbors) or a mis-fit offline plane self-corrects online.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel


def measure_seq2seq(
    translate: Callable[[np.ndarray], Tuple[int, np.ndarray]],
    lengths: Sequence[int],
    *,
    reps: int = 3,
    warmup: int = 1,
    seed: int = 0,
    vocab: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Time ``translate(tokens) -> (m_out, _)`` over a grid of input lengths.

    Returns (N, M, T_seconds) sample arrays, one per (length, rep).
    The first ``warmup`` calls per length are discarded (kernel build,
    allocator and cache warm-up).
    """
    rng = np.random.default_rng(seed)
    ns, ms, ts = [], [], []
    for n in lengths:
        tokens = rng.integers(1, vocab, size=(int(n),), dtype=np.int32)
        for r in range(warmup + reps):
            t0 = time.perf_counter()
            m_out, _ = translate(tokens)
            dt = time.perf_counter() - t0
            if r >= warmup:
                ns.append(float(n))
                ms.append(float(m_out))
                ts.append(dt)
    return np.asarray(ns), np.asarray(ms), np.asarray(ts)


def measure_seq2seq_grid(
    translate_forced: Callable[[np.ndarray, int], Tuple[int, np.ndarray]],
    n_lengths: Sequence[int],
    m_lengths_for: Callable[[int], Sequence[int]],
    *,
    reps: int = 2,
    warmup: int = 1,
    seed: int = 0,
    vocab: int = 1000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Characterize T(N, M) on a CONTROLLED grid with real execution.

    ``translate_forced(tokens, m)`` must decode exactly ``m`` tokens
    (``greedy_decode(forced_len=...)``).  The paper fits the plane on 10k
    natural translations; an untrained model's natural output length is
    degenerate, so the grid sweep supplies the (N, M) coverage while the
    per-call wall-clock stays a real model measurement.
    """
    rng = np.random.default_rng(seed)
    ns, ms, ts = [], [], []
    for n in n_lengths:
        tokens = rng.integers(1, vocab, size=(int(n),), dtype=np.int32)
        warmed = False
        for m in m_lengths_for(int(n)):
            for r in range(warmup + reps) if not warmed else range(reps):
                t0 = time.perf_counter()
                m_out, _ = translate_forced(tokens, int(m))
                dt = time.perf_counter() - t0
                if warmed or r >= warmup:
                    ns.append(float(n))
                    ms.append(float(m_out))
                    ts.append(dt)
            warmed = True
    return np.asarray(ns), np.asarray(ms), np.asarray(ts)


def fit_device(
    name: str, n: np.ndarray, m: np.ndarray, t: np.ndarray, *, noise_frac: float = 0.05
) -> DeviceProfile:
    model = LinearLatencyModel().fit(n, m, t)
    return DeviceProfile(name=name, model=model, noise_frac=noise_frac)


def measure_batched_seq2seq(
    translate_batch: Callable[[np.ndarray, int], object],
    batch_sizes: Sequence[int],
    *,
    n_len: int = 16,
    m_len: int = 16,
    reps: int = 2,
    warmup: int = 1,
    seed: int = 0,
    vocab: int = 1000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Time ``translate_batch(tokens_2d, forced_len)`` over a batch-size grid.

    The single-sequence grid (:func:`measure_seq2seq_grid`) characterizes
    the T_exe(N, M) plane; this sweep holds (N, M) fixed and varies only
    the batch size b, measuring the *marginal* cost of each extra
    sequence in a padded decode batch.  Returns (b, T_seconds) samples
    for :func:`fit_batch_overhead`.
    """
    rng = np.random.default_rng(seed)
    bs, ts = [], []
    for b in batch_sizes:
        tokens = rng.integers(1, vocab, size=(int(b), n_len), dtype=np.int32)
        for r in range(warmup + reps):
            t0 = time.perf_counter()
            translate_batch(tokens, m_len)
            dt = time.perf_counter() - t0
            if r >= warmup:
                bs.append(float(b))
                ts.append(dt)
    return np.asarray(bs), np.asarray(ts)


def fit_batch_overhead(b: np.ndarray, t: np.ndarray) -> Tuple[float, float]:
    """Fit the sub-linear batch latency model  T(b) = T1 + o * (b - 1).

    Least-squares on (batch size, batch wall-clock) samples from
    :func:`measure_batched_seq2seq`; returns ``(t_base_s,
    per_seq_overhead_s)`` with the overhead clamped non-negative (same
    physical constraint as the plane slopes).  ``per_seq_overhead_s``
    plugs directly into ``SimTier`` / ``Tier`` / ``SchedTier``.
    """
    b = np.asarray(b, np.float64)
    t = np.asarray(t, np.float64)
    if b.size < 2 or np.ptp(b) == 0:
        raise ValueError("need samples at >= 2 distinct batch sizes")
    a = np.stack([np.ones_like(b), b - 1.0], axis=1)
    coef, *_ = np.linalg.lstsq(a, t, rcond=None)
    return float(coef[0]), float(max(coef[1], 0.0))


def make_edge_cloud_pair(
    n: np.ndarray,
    m: np.ndarray,
    t: np.ndarray,
    *,
    speedup: float = 5.0,
    edge_scale: float = 1.0,
    edge_noise: float = 0.05,
    cloud_noise: float = 0.08,
) -> Tuple[DeviceProfile, DeviceProfile]:
    """Edge = measured plane (x ``edge_scale``), cloud = ``speedup``x faster.

    cloud_noise > edge_noise reflects the shared, loaded server (the
    paper's Titan fit has visibly wider bands: MSE 1.2 ms vs 0.13 ms).
    """
    base = LinearLatencyModel().fit(n, m, t)
    # physical constraint: per-token costs cannot be negative (tiny-scale
    # CPU measurements can produce a slightly negative alpha_N from noise)
    base.alpha_n = max(base.alpha_n, 0.0)
    base.alpha_m = max(base.alpha_m, 0.0)
    edge = DeviceProfile("edge-gw", base.scaled(1.0 / edge_scale), edge_noise)
    cloud = DeviceProfile("cloud-server", base.scaled(speedup / edge_scale), cloud_noise)
    return edge, cloud


class OnlineCalibrator:
    """Online feedback refitting for the multi-tier scheduler.

    ``record`` ingests one completed request's observation; every
    ``interval`` records it reports a refit as due, and ``refit``
    re-estimates (in place):

    * each tier's T_exe plane from its last ``window`` (N, M, T) samples
      (skipped below ``min_samples`` — a tier that never wins keeps its
      offline plane), with per-token slopes clamped non-negative exactly
      like the offline fit; and
    * the shared LinearN2M gamma/delta from the pooled (N, M_out) pairs.

    The caller owns which model objects get mutated — pass copies if the
    originals double as ground truth (the DES does exactly that).
    """

    def __init__(self, n_tiers: int, *, interval: int = 256,
                 min_samples: int = 16, window: int = 4096):
        if interval < 1:
            raise ValueError("interval must be >= 1")
        self.interval = interval
        self.min_samples = max(int(min_samples), 3)
        self._samples = [collections.deque(maxlen=window)
                         for _ in range(n_tiers)]
        self._since_refit = 0
        self.n_recorded = 0
        self.n_refits = 0
        self.n_excluded = 0

    def record(self, tier: int, n: float, m_out: float, t_exe_s: float,
               ok: bool = True) -> bool:
        """Ingest one completion; True when a refit is due.

        ``ok=False`` marks a failed/timed-out request: its ``t_exe_s``
        is a timeout artifact, not a device measurement, and its
        ``m_out`` is whatever the failure left behind — feeding either
        into the plane fit or the N→M regressor would corrupt the
        latency model, so the sample is counted (``n_excluded``) and
        dropped without advancing the refit clock.
        """
        if not ok:
            self.n_excluded += 1
            return False
        self._samples[tier].append((float(n), float(m_out), float(t_exe_s)))
        self.n_recorded += 1
        self._since_refit += 1
        return self._since_refit >= self.interval

    def refit(self, models: Sequence[LinearLatencyModel],
              n2m=None) -> Dict[str, float]:
        """Refit tier planes (and optionally the N->M regressor) in place."""
        self._since_refit = 0
        refit_tiers = 0
        for k, model in enumerate(models):
            samples = self._samples[k]
            if len(samples) < self.min_samples:
                continue
            n, m, t = (np.asarray(col) for col in zip(*samples))
            model.fit(n, m, t)
            model.alpha_n = max(model.alpha_n, 0.0)
            model.alpha_m = max(model.alpha_m, 0.0)
            refit_tiers += 1
        pooled = [s for tier in self._samples for s in tier]
        if n2m is not None and len(pooled) >= 2:
            n, m, _ = (np.asarray(col) for col in zip(*pooled))
            if np.ptp(n) > 0:          # degenerate single-N pools: keep fit
                n2m.fit(n, m)
        self.n_refits += 1
        return {"refit_tiers": float(refit_tiers),
                "pooled_samples": float(len(pooled)),
                "n_refits": float(self.n_refits)}


def device_from_roofline(
    name: str,
    *,
    prefill_flops_per_token: float,
    decode_flops_per_token: float,
    decode_bytes_per_token: float,
    # NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 outside the tensor
    # cores (the port computes in float32) and 3.35 TB/s of HBM3
    peak_flops: float = 67e12,
    hbm_bw: float = 3.35e12,
    chips: int = 1,
    overhead_s: float = 0.002,
    mfu: float = 0.4,
    noise_frac: float = 0.05,
) -> DeviceProfile:
    """Beyond paper: a DeviceProfile priced from dry-run roofline terms."""
    model = LinearLatencyModel.from_roofline(
        prefill_flops_per_token=prefill_flops_per_token / chips,
        decode_flops_per_token=decode_flops_per_token / chips,
        decode_bytes_per_token=decode_bytes_per_token / chips,
        peak_flops=peak_flops,
        hbm_bw=hbm_bw,
        overhead_s=overhead_s,
        mfu=mfu,
    )
    return DeviceProfile(name=name, model=model, noise_frac=noise_frac)
