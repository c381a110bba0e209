"""Fault injection + fault-tolerance primitives for collaborative serving.

C-NMT's premise is offloading across an unreliable edge–cloud boundary,
yet the baseline engine and DES assume tiers never crash and links never
flap.  This module is the shared vocabulary both consume:

* :class:`FaultSchedule` — a deterministic, declarative description of
  what goes wrong and when: tier outage windows (crash → restart), link
  degradation episodes (RTT spikes, bandwidth collapse, blackhole →
  timeout) and straggler windows (execution-time multipliers).  The
  schedule is *ground truth* for injection — the serving system never
  routes on it; it only experiences it through timeouts and failures.
  :meth:`FaultSchedule.random` draws a seeded random schedule so sweeps
  are reproducible.
* :class:`RetryPolicy` — per-request timeouts plus bounded retry with
  exponential backoff and deterministic jitter.  ``retry=None`` is the
  no-retry baseline: a failed request is simply lost, which is exactly
  what the pre-fault-tolerance engine did implicitly.
* :class:`CircuitBreaker` — the per-tier health belief the dispatcher
  *does* route on: open after ``failure_threshold`` consecutive
  failures, half-open probe after ``reset_timeout_s``, close again on a
  probe success.  Open breakers feed the scheduler's candidate mask
  (``decide(..., exclude=...)``), which yields the degradation ladder
  split → whole-remote → edge-only → shed for free: excluding unhealthy
  tiers from the argmin leaves the best *reachable* placement, and when
  every tier is dark the caller sheds with a ``retry_after_s`` hint.

Everything here is plain float arithmetic over virtual time — the real
engine and the discrete-event simulator consume the same objects, so a
failover policy tuned in the DES transfers to the engine unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# circuit-breaker states
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"


@dataclasses.dataclass(frozen=True)
class TierOutage:
    """Tier ``tier`` is dead (crashed / unreachable) on [start_s, end_s):
    in-flight work there fails, new dispatches are refused."""

    tier: int
    start_s: float
    end_s: float

    def __post_init__(self):
        if self.end_s <= self.start_s:
            raise ValueError("outage needs end_s > start_s")
        if self.tier < 0:
            raise ValueError("tier must be >= 0")

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """Degradation episode on tier ``tier``'s client link.

    ``rtt_factor``/``bandwidth_factor`` scale the true link during the
    window (RTT spike = factor > 1, bandwidth collapse = factor < 1);
    ``blackhole=True`` means packets vanish silently — a dispatch over
    the link only fails after the full request ``timeout_s`` elapses
    (the most expensive failure mode to detect).
    """

    tier: int
    start_s: float
    end_s: float
    rtt_factor: float = 1.0
    bandwidth_factor: float = 1.0
    blackhole: bool = False

    def __post_init__(self):
        if self.end_s <= self.start_s:
            raise ValueError("link fault needs end_s > start_s")
        if self.rtt_factor <= 0 or self.bandwidth_factor <= 0:
            raise ValueError("link factors must be positive")

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


@dataclasses.dataclass(frozen=True)
class Straggler:
    """Tier ``tier`` runs ``slowdown``x slower on [start_s, end_s)
    (thermal throttling, noisy neighbor) — degraded, not failed."""

    tier: int
    start_s: float
    end_s: float
    slowdown: float = 1.0

    def __post_init__(self):
        if self.end_s <= self.start_s:
            raise ValueError("straggler window needs end_s > start_s")
        if self.slowdown < 1.0:
            raise ValueError("slowdown must be >= 1")

    def active(self, t: float) -> bool:
        return self.start_s <= t < self.end_s


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """The full injected-fault timeline for one run (immutable).

    An empty schedule is valid and injects nothing — the fault-tolerant
    code paths are pinned bit-for-bit identical to the fault-free ones
    under it (tests enforce this), so arming the machinery is free.
    """

    outages: Tuple[TierOutage, ...] = ()
    link_faults: Tuple[LinkFault, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "outages", tuple(self.outages))
        object.__setattr__(self, "link_faults", tuple(self.link_faults))
        object.__setattr__(self, "stragglers", tuple(self.stragglers))

    @property
    def empty(self) -> bool:
        return not (self.outages or self.link_faults or self.stragglers)

    # ---------------------------------------------------------- queries --
    def tier_down(self, tier: int, t: float) -> bool:
        return any(o.tier == tier and o.active(t) for o in self.outages)

    def link_blackhole(self, tier: int, t: float) -> bool:
        return any(f.tier == tier and f.blackhole and f.active(t)
                   for f in self.link_faults)

    def link_factors(self, tier: int, t: float) -> Tuple[float, float]:
        """(rtt_factor, bandwidth_factor) of the active degradation
        episodes on tier's client link (compounded when they overlap)."""
        rtt_f, bw_f = 1.0, 1.0
        for f in self.link_faults:
            if f.tier == tier and f.active(t) and not f.blackhole:
                rtt_f *= f.rtt_factor
                bw_f *= f.bandwidth_factor
        return rtt_f, bw_f

    def slowdown(self, tier: int, t: float) -> float:
        s = 1.0
        for w in self.stragglers:
            if w.tier == tier and w.active(t):
                s *= w.slowdown
        return s

    def outage_events(self) -> List[Tuple[float, str, int]]:
        """Sorted (time, 'down'|'up', tier) crash/restart edges — what a
        discrete-event simulator schedules to fail in-flight work."""
        ev = []
        for o in self.outages:
            ev.append((o.start_s, "down", o.tier))
            ev.append((o.end_s, "up", o.tier))
        for f in self.link_faults:
            if f.blackhole:        # recovery edge re-arms half-open probes
                ev.append((f.start_s, "link_down", f.tier))
                ev.append((f.end_s, "link_up", f.tier))
        ev.sort()
        return ev

    def horizon_s(self) -> float:
        """Last fault edge (0.0 for an empty schedule)."""
        ends = [w.end_s for w in
                (*self.outages, *self.link_faults, *self.stragglers)]
        return max(ends) if ends else 0.0

    # ------------------------------------------------------ constructors --
    @staticmethod
    def random(n_tiers: int, duration_s: float, *, seed: int = 0,
               outage_rate_hz: float = 1.0 / 600.0,
               mean_outage_s: float = 30.0,
               blackhole_rate_hz: float = 0.0,
               mean_blackhole_s: float = 20.0,
               protect_tiers: Sequence[int] = (0,)) -> "FaultSchedule":
        """Seeded random schedule: per-tier Poisson outage starts with
        exponential durations (and optionally blackhole link episodes),
        skipping ``protect_tiers`` (default: tier 0, the local edge —
        the degradation ladder needs somewhere to land)."""
        rng = np.random.default_rng(seed)
        outages, links = [], []
        for k in range(n_tiers):
            if k in protect_tiers:
                continue
            t = float(rng.exponential(1.0 / outage_rate_hz)) \
                if outage_rate_hz > 0 else math.inf
            while t < duration_s:
                dur = float(rng.exponential(mean_outage_s))
                outages.append(TierOutage(k, t, t + max(dur, 1.0)))
                t += dur + float(rng.exponential(1.0 / outage_rate_hz))
            if blackhole_rate_hz > 0:
                t = float(rng.exponential(1.0 / blackhole_rate_hz))
                while t < duration_s:
                    dur = float(rng.exponential(mean_blackhole_s))
                    links.append(LinkFault(k, t, t + max(dur, 1.0),
                                           blackhole=True))
                    t += dur + float(rng.exponential(1.0 / blackhole_rate_hz))
        return FaultSchedule(outages=tuple(outages),
                             link_faults=tuple(links))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + deterministic jitter.

    ``timeout_s`` is the per-attempt response timeout — how long a
    blackholed dispatch hangs before the client gives up.  A crashed
    tier refuses the connection much faster (``fail_fast_s``, the RST
    path).  ``backoff(attempt, rng)`` returns the wait before re-try
    number ``attempt`` (0-based): base · factor^attempt, capped, with
    ±``jitter_frac`` multiplicative jitter drawn from ``rng`` so
    synchronized retry storms decorrelate (seed the rng to keep runs
    deterministic).  ``replay_shed`` lets the DES model clients that
    honor the ``retry_after_s`` backpressure hint by re-submitting.
    """

    max_retries: int = 3
    timeout_s: float = 1.0
    fail_fast_s: float = 0.05
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    jitter_frac: float = 0.1
    replay_shed: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.timeout_s <= 0 or self.fail_fast_s <= 0:
            raise ValueError("timeouts must be positive")
        if not 0.0 <= self.jitter_frac < 1.0:
            raise ValueError("jitter_frac must be in [0, 1)")

    def detect_s(self, blackhole: bool) -> float:
        """Time to *notice* a failed attempt: a silent blackhole costs
        the full timeout; a refused connection fails fast."""
        return self.timeout_s if blackhole else self.fail_fast_s

    def backoff(self, attempt: int, rng: np.random.Generator) -> float:
        b = min(self.backoff_base_s * self.backoff_factor ** attempt,
                self.backoff_max_s)
        if self.jitter_frac > 0.0:
            b *= 1.0 + self.jitter_frac * (2.0 * float(rng.random()) - 1.0)
        return b


@dataclasses.dataclass
class CircuitBreaker:
    """Per-tier health belief: CLOSED → (k consecutive failures) → OPEN
    → (reset_timeout_s) → HALF_OPEN probe → CLOSED on success, OPEN on
    failure.  ``allow(now)`` is the dispatch gate; exactly one request
    passes in HALF_OPEN (the probe) until it resolves."""

    failure_threshold: int = 3
    reset_timeout_s: float = 1.0

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if self.reset_timeout_s <= 0:
            raise ValueError("reset_timeout_s must be positive")
        self.state = CLOSED
        self._consecutive = 0
        self._opened_at = -math.inf
        self.n_opens = 0
        self.n_probes = 0

    def allow(self, now_s: float) -> bool:
        """May a request be dispatched to this tier right now?  An OPEN
        breaker whose cool-down elapsed transitions to HALF_OPEN and
        admits the caller as the probe."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN and \
                now_s - self._opened_at >= self.reset_timeout_s:
            self.state = HALF_OPEN
            self.n_probes += 1
            return True
        return False      # OPEN cooling down, or HALF_OPEN probe in flight

    def record_failure(self, now_s: float) -> bool:
        """Ingest one failed attempt; True when this trips the breaker
        (CLOSED past the threshold, or a failed HALF_OPEN probe)."""
        self._consecutive += 1
        if self.state == HALF_OPEN or (
                self.state == CLOSED
                and self._consecutive >= self.failure_threshold):
            self.state = OPEN
            self._opened_at = now_s
            self.n_opens += 1
            return True
        if self.state == OPEN:
            self._opened_at = now_s      # refresh cool-down under load
        return False

    def record_success(self) -> bool:
        """Ingest one successful completion; True when it *recovers* the
        tier (HALF_OPEN/OPEN → CLOSED) — the caller's cue to invalidate
        stale link state (``TxEstimator.invalidate``)."""
        recovered = self.state != CLOSED
        self.state = CLOSED
        self._consecutive = 0
        return recovered

    def time_to_probe(self, now_s: float) -> float:
        """Seconds until a half-open probe would be admitted (0 when
        dispatch is already allowed) — feeds ``retry_after_s``."""
        if self.state != OPEN:
            return 0.0
        return max(self._opened_at + self.reset_timeout_s - now_s, 0.0)


def make_breakers(n_tiers: int,
                  template: Optional[CircuitBreaker] = None
                  ) -> List[CircuitBreaker]:
    """One independent breaker per tier, cloned from ``template``."""
    t = template if template is not None else CircuitBreaker()
    return [CircuitBreaker(failure_threshold=t.failure_threshold,
                           reset_timeout_s=t.reset_timeout_s)
            for _ in range(n_tiers)]
