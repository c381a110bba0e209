"""Connection profiles: time-varying round-trip-time traces (paper Fig. 4).

The paper replays two real RIPE-Atlas RTT traces (meas 1437285, probe 6222,
2018-05-03; CP1 = 3-7 pm, CP2 = 7:30-12:30 am) with a constant symmetric
100 Mbps bandwidth.  RIPE Atlas is not reachable offline, so this module
*generates* traces with the same qualitative structure the paper relies on:

* a slowly-wandering baseline (mean-reverting Ornstein-Uhlenbeck process —
  models congestion drift over hours),
* sporadic heavy-tailed spikes (lognormal bursts — models transient
  congestion / route flaps),
* CP1 has a higher mean and heavier spikes than CP2 (the paper notes CP1
  "is slower on average", making cloud offload sub-optimal more often).

Traces are deterministic given the seed, making experiments repeatable —
the property the paper obtained by replaying recorded traces.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass
class ConnectionProfile:
    """A replayable RTT trace + constant symmetric bandwidth.

    ``rtt_s``/``times_s`` sample the RTT (seconds) on a uniform grid;
    lookups interpolate.  ``bandwidth_bps`` is the paper's constant
    100 Mbps unless overridden.
    """

    name: str
    times_s: np.ndarray
    rtt_s: np.ndarray
    bandwidth_bps: float = 100e6

    def rtt_at(self, t) -> np.ndarray:
        """RTT seen by a request issued at simulation time ``t`` (seconds).

        Wraps around the trace end so arbitrarily long request streams can
        be replayed against a finite trace, as the paper does with its
        4-5 hour windows.
        """
        t = np.asarray(t, np.float64)
        period = float(self.times_s[-1])
        return np.interp(np.mod(t, period), self.times_s, self.rtt_s)

    def tx_time(self, t, payload_bytes) -> np.ndarray:
        """T_tx for a request at time t: RTT + serialization delay.

        The paper models T_tx as dominated by the RTT (token payloads are
        ~2 bytes/token, §II-B); we keep the exact bandwidth term anyway.
        """
        return self.rtt_at(t) + np.asarray(payload_bytes, np.float64) * 8.0 / self.bandwidth_bps

    @property
    def mean_rtt(self) -> float:
        return float(self.rtt_s.mean())


def _ou_trace(
    rng: np.random.Generator,
    *,
    duration_s: float,
    dt_s: float,
    mean: float,
    reversion: float,
    vol: float,
    spike_rate_hz: float,
    spike_scale: float,
    floor: float,
) -> np.ndarray:
    n = int(duration_s / dt_s) + 1
    x = np.empty(n)
    x[0] = mean
    sq = vol * np.sqrt(dt_s)
    noise = rng.standard_normal(n - 1)
    for i in range(1, n):
        x[i] = x[i - 1] + reversion * (mean - x[i - 1]) * dt_s + sq * noise[i - 1]
    # heavy-tailed congestion spikes with exponential decay (~30 s)
    n_spikes = rng.poisson(spike_rate_hz * duration_s)
    t_grid = np.arange(n) * dt_s
    for _ in range(n_spikes):
        t0 = rng.uniform(0, duration_s)
        amp = spike_scale * rng.lognormal(0.0, 0.75)
        tau = rng.uniform(10.0, 45.0)
        x += amp * np.exp(-np.maximum(t_grid - t0, 0.0) / tau) * (t_grid >= t0)
    return np.maximum(x, floor)


def make_profile(name: str, *, seed: int = 0, duration_s: float = 4 * 3600.0,
                 dt_s: float = 1.0, bandwidth_bps: float = 100e6) -> ConnectionProfile:
    """Build CP1/CP2 analogs of the paper's Fig. 4.

    CP1 (afternoon, 3-7 pm): congested — mean RTT ~90 ms, frequent heavy
    spikes to several hundred ms.
    CP2 (morning, 7:30-12:30 am): clean — mean RTT ~35 ms, rare mild spikes.
    """
    # crc32, not hash(): Python string hashing is salted per process, which
    # silently broke the "deterministic given the seed" contract across runs
    rng = np.random.default_rng(
        np.uint32(zlib.crc32(f"{name}:{seed}".encode()) % (2**32)))
    if name.lower() in ("cp1", "profile1"):
        rtt = _ou_trace(
            rng, duration_s=duration_s, dt_s=dt_s,
            mean=0.090, reversion=0.02, vol=0.004,
            spike_rate_hz=1.5 / 60.0, spike_scale=0.120, floor=0.015,
        )
    elif name.lower() in ("cp2", "profile2"):
        rtt = _ou_trace(
            rng, duration_s=duration_s, dt_s=dt_s,
            mean=0.035, reversion=0.05, vol=0.0015,
            spike_rate_hz=0.3 / 60.0, spike_scale=0.040, floor=0.008,
        )
    else:
        raise ValueError(f"unknown profile {name!r} (use 'cp1' or 'cp2')")
    times = np.arange(rtt.size) * dt_s
    return ConnectionProfile(name=name.lower(), times_s=times, rtt_s=rtt,
                             bandwidth_bps=bandwidth_bps)
