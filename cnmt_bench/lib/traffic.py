"""The one traffic generator: every mix is a JSON file under
``cnmt_bench/traffic/`` that this module reads.

Frozen copies, in numpy, of what the program under test also has (so a
change to the program cannot move the yardstick):

* the (N, M) length law of ``repro_torch/data/synthetic.py``
  (``make_corpus``): N a clipped lognormal, M = gamma N + delta plus
  noise whose spread grows with N, a share of misaligned pairs whose M is
  drawn apart from N, and the model's own length noise on top;
* the RTT traces of ``repro_torch/core/profiles.py`` (``make_profile``:
  an Ornstein-Uhlenbeck baseline with decaying lognormal spikes);
* the Poisson gaps of ``repro_torch/core/arrivals.py``.

Every seed gets the same multiset of lengths and of inter-arrival gaps,
drawn once from the mix's own ``pool_seed``; ``--seed`` only orders them
and draws the token ids.  So two seeds ask for the same work, and the
spread between runs is the system's, not the traffic's.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterator, List, Optional

import numpy as np

FIRST_TOKEN = 4          # ids 0-3 are PAD, BOS, EOS, UNK


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of one run seed."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def length_pool(law: Dict, size: int) -> tuple:
    """``size`` (N, M) pairs of the mix's length law, from its
    ``pool_seed``: ``make_corpus``'s arithmetic, with N's and M's clips
    taken from the mix."""
    rng = np.random.default_rng(int(law["pool_seed"]))
    n = np.clip(np.round(rng.lognormal(law["n_mean_log"], law["n_std_log"],
                                       size)),
                law["n_min"], law["n_max"])
    noise_std = law["m_noise_base"] + law["m_noise_slope"] * n
    m_real = law["m_gamma"] * n + law["m_delta"] \
        + rng.standard_normal(size) * noise_std
    m_real = np.clip(np.round(m_real), law["m_min"], law["m_max"])
    n_out = int(law["outlier_frac"] * size)
    if n_out:
        idx = rng.choice(size, n_out, replace=False)
        m_real[idx] = np.clip(
            np.round(rng.lognormal(law["n_mean_log"], law["n_std_log"],
                                   n_out)),
            law["m_min"], law["m_max"])
    m_out = np.clip(
        np.round(m_real + rng.standard_normal(size) * law["model_len_noise"]),
        law["m_min"], law["m_max"])
    return n.astype(np.int64), m_out.astype(np.int64)


@dataclasses.dataclass
class Request:
    """One request: its source tokens, the output length the traffic asks
    for (``m``), and for an open loop the second it is due."""

    rid: int
    tokens: np.ndarray
    m: int
    due_s: float = 0.0


def _tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(FIRST_TOKEN, vocab, size=int(n)).astype(np.int32)


def backlog(mix: Dict, seed: int, vocab: int, *, stream: int = 0
            ) -> Iterator[List[Request]]:
    """A closed loop's backlog, ``mix["per_call"]`` requests at a time:
    the pool in an order drawn from ``seed``, again in a new order each
    time it runs out.  ``stream`` separates the warm-up's draws from the
    window's."""
    law = mix["lengths"]
    n, m = length_pool(law, int(law["pool_size"]))
    rng = rng_for(seed, 1 + stream)
    order = rng.permutation(n.size)
    pos, rid = 0, 0
    per_call = int(mix["per_call"])
    while True:
        call = []
        for _ in range(per_call):
            if pos == order.size:
                order, pos = rng.permutation(n.size), 0
            i = order[pos]
            pos += 1
            call.append(Request(rid, _tokens(rng, n[i], vocab), int(m[i])))
            rid += 1
        yield call


def schedule(mix: Dict, seed: int, vocab: int, seconds: float, *,
             rate_hz: Optional[float] = None, stream: int = 0
             ) -> List[Request]:
    """An open loop's requests over ``seconds``: round(rate x seconds)
    requests whose lengths and Poisson gaps are the pool's, the gaps
    scaled so that the last request is due at ``seconds``, both in an
    order drawn from ``seed``."""
    law = mix["lengths"]
    rate = float(mix["arrival"]["rate_hz"] if rate_hz is None else rate_hz)
    count = max(1, int(round(rate * seconds)))
    if count > int(law["pool_size"]):
        raise ValueError(f"{count} requests asked of a pool of "
                         f"{law['pool_size']}")
    n, m = length_pool(law, int(law["pool_size"]))
    gaps = np.random.default_rng(int(mix["arrival"]["gap_seed"])) \
        .exponential(1.0 / rate, size=count)
    gaps *= seconds / gaps.sum()
    rng = rng_for(seed, 101 + stream)
    pick = rng.permutation(count)
    due = np.cumsum(gaps[rng.permutation(count)])
    return [Request(j, _tokens(rng, n[i], vocab), int(m[i]), float(due[j]))
            for j, i in enumerate(pick)]


# ------------------------------------------------------------ RTT traces --
_PROFILES = {
    # make_profile's CP1 (congested afternoon) and CP2 (clean morning)
    "cp1": dict(mean=0.090, reversion=0.02, vol=0.004,
                spike_rate_hz=1.5 / 60.0, spike_scale=0.120, floor=0.015),
    "cp2": dict(mean=0.035, reversion=0.05, vol=0.0015,
                spike_rate_hz=0.3 / 60.0, spike_scale=0.040, floor=0.008),
}


class RttTrace:
    """A replayable RTT trace on a 1 s grid, interpolated, wrapping at
    its end (``ConnectionProfile.rtt_at``)."""

    def __init__(self, name: str, seed: int, duration_s: float,
                 dt_s: float = 1.0):
        p = _PROFILES[name]
        rng = np.random.default_rng(
            np.uint32(zlib.crc32(f"{name}:{seed}".encode()) % (2**32)))
        n = int(duration_s / dt_s) + 1
        x = np.empty(n)
        x[0] = p["mean"]
        sq = p["vol"] * np.sqrt(dt_s)
        noise = rng.standard_normal(n - 1)
        for i in range(1, n):
            x[i] = (x[i - 1] + p["reversion"] * (p["mean"] - x[i - 1]) * dt_s
                    + sq * noise[i - 1])
        n_spikes = rng.poisson(p["spike_rate_hz"] * duration_s)
        t_grid = np.arange(n) * dt_s
        for _ in range(n_spikes):
            t0 = rng.uniform(0, duration_s)
            amp = p["spike_scale"] * rng.lognormal(0.0, 0.75)
            tau = rng.uniform(10.0, 45.0)
            x += (amp * np.exp(-np.maximum(t_grid - t0, 0.0) / tau)
                  * (t_grid >= t0))
        self.times_s = t_grid
        self.rtt_s = np.maximum(x, p["floor"])

    def rtt_at(self, t: float) -> float:
        period = float(self.times_s[-1])
        return float(np.interp(np.mod(t, period), self.times_s, self.rtt_s))
