"""Arrival-process generators for the load-generation harness.

Port of ``repro/core/arrivals.py`` (numpy only; same seeds, same
streams).

The paper evaluates C-NMT by replaying a recorded request stream; the
MLPerf-loadgen-shaped harness (``benchmarks/loadgen.py``) needs the
arrival *process* itself to be a first-class, swappable object.  This
module holds the generators shared by the harness, the DES
(:func:`repro_torch.core.simulator.make_trace_stream`) and the tests:

* :func:`poisson_arrivals`    — open-loop Poisson (MLPerf "Server"):
  i.i.d. exponential inter-arrival gaps at a constant rate.
* :func:`bursty_arrivals`     — open-loop nonhomogeneous Poisson with a
  sinusoidal (diurnal-shaped) rate modulation, sampled by thinning:
  candidate arrivals are drawn at the peak rate and accepted with
  probability rate(t)/peak — the standard exact method for
  time-varying Poisson processes.
* :func:`save_trace` / :func:`load_trace` — JSON persistence for
  recorded or synthetic arrival traces, so a trace-replay run is
  reproducible bit-for-bit from a file (Python's ``json`` round-trips
  float64 exactly).

Closed-loop arrivals have no generator here by design: the next issue
time *is* the previous completion, so the harness derives them from the
engine's completion callback (``CollaborativeEngine.on_complete``) and
can record the realized times as a trace for the DES twin.

Every generator is deterministic given its ``seed`` (NumPy
``default_rng``; no global state), which the tests pin: same seed ⇒
bit-identical trace.  All times are in seconds from the start of the
run, strictly increasing.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np


def poisson_arrivals(rate_hz: float, size: int, *,
                     seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Open-loop Poisson arrival times (seconds, strictly increasing).

    ``rate_hz`` is the mean arrival rate; gaps are i.i.d.
    ``Exponential(1/rate_hz)`` starting from ``t0``.  Deterministic
    given ``seed``.
    """
    if rate_hz <= 0:
        raise ValueError("rate_hz must be positive")
    if size < 0:
        raise ValueError("size must be >= 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=size)
    return t0 + np.cumsum(gaps)


def diurnal_rate(t, base_rate_hz: float, peak_factor: float,
                 period_s: float) -> np.ndarray:
    """Instantaneous rate of the bursty process at time ``t`` (seconds).

    A raised-cosine modulation between ``base_rate_hz`` (trough, at
    t = 0 mod period) and ``base_rate_hz * peak_factor`` (peak, at
    t = period/2 mod period) — one "day" per ``period_s``.  Exposed so
    tests can check the thinning sampler actually tracks it.
    """
    t = np.asarray(t, np.float64)
    shape = 0.5 * (1.0 - np.cos(2.0 * math.pi * t / period_s))
    return base_rate_hz * (1.0 + (peak_factor - 1.0) * shape)


def bursty_arrivals(size: int, *, base_rate_hz: float,
                    peak_factor: float = 4.0, period_s: float = 60.0,
                    seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """Bursty/diurnal arrivals: nonhomogeneous Poisson via thinning.

    Candidates are drawn as a homogeneous Poisson process at the peak
    rate ``base_rate_hz * peak_factor`` and accepted with probability
    ``diurnal_rate(t)/peak`` — exact sampling of the modulated process.
    Returns the first ``size`` accepted arrival times (seconds,
    strictly increasing).  Deterministic given ``seed``.
    """
    if base_rate_hz <= 0:
        raise ValueError("base_rate_hz must be positive")
    if peak_factor < 1.0:
        raise ValueError("peak_factor must be >= 1 (1 = plain Poisson)")
    if period_s <= 0:
        raise ValueError("period_s must be positive")
    rng = np.random.default_rng(seed)
    lam_max = base_rate_hz * peak_factor
    out = np.empty(size, np.float64)
    got = 0
    t = t0
    while got < size:
        # draw candidate gaps in blocks; thinning keeps the accepted ones
        block = max(size - got, 64)
        gaps = rng.exponential(1.0 / lam_max, size=block)
        u = rng.random(block)
        for g, ui in zip(gaps, u):
            t += g
            if ui * lam_max < diurnal_rate(t - t0, base_rate_hz,
                                           peak_factor, period_s):
                out[got] = t
                got += 1
                if got == size:
                    break
    return out


# ------------------------------------------------------------- trace I/O --
_TRACE_VERSION = 1


def save_trace(path, arrival_s, *, meta: Optional[dict] = None) -> None:
    """Persist an arrival trace as JSON (``{"version", "arrival_s",
    "meta"}``).  Float64 values round-trip exactly through ``json``, so
    ``load_trace(save_trace(...))`` is bit-identical — the trace-replay
    exactness contract the tests pin."""
    arr = np.asarray(arrival_s, np.float64)
    if arr.ndim != 1:
        raise ValueError("arrival_s must be 1-D")
    if arr.size and np.any(np.diff(arr) < 0):
        raise ValueError("arrival times must be non-decreasing")
    payload = {"version": _TRACE_VERSION,
               "arrival_s": arr.tolist(),
               "meta": meta or {}}
    with open(path, "w") as f:
        json.dump(payload, f)


def load_trace(path) -> np.ndarray:
    """Load a trace written by :func:`save_trace`; returns the float64
    arrival times exactly as saved."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or "arrival_s" not in payload:
        raise ValueError(f"{path}: not an arrival trace file")
    arr = np.asarray(payload["arrival_s"], np.float64)
    if arr.size and np.any(np.diff(arr) < 0):
        raise ValueError(f"{path}: arrival times must be non-decreasing")
    return arr
