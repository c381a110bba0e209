"""Request-stream simulators: the paper's analytic replay (§III) and a
queue-aware discrete-event extension for N-tier serving.

Port of ``repro/core/simulator.py``: numpy only, so the same seeds give
bitwise-equal streams and results in both packages.

Analytic replay (paper-faithful, :func:`simulate`)
--------------------------------------------------
* 100k requests replayed against a time-varying RTT trace (Fig. 4) with
  constant symmetric 100 Mbps bandwidth;
* T_exe planes fitted on held-out characterization samples (10k/device);
* T_tx known to the scheduler only through timestamped samples of
  *offloaded* requests (§II-C) — stale whenever traffic stays local;
* Oracle sees true times (ideal lower bound), Naive uses the corpus-mean
  output length; GW/Server are the static baselines;
* requests are independent (no queueing), as in the paper.

Sequential for estimate-based policies (the T_tx estimate evolves with
past offloading decisions — this coupling is the interesting dynamics)
and vectorized for static/oracle baselines.

Discrete-event loop (beyond paper, :func:`simulate_des`)
--------------------------------------------------------
The paper's replay treats every request as independent; under real
traffic tiers saturate.  ``simulate_des`` runs an event-driven loop —
arrival / start / finish events over N :class:`SimTier`\\ s, each a
bounded-FIFO multi-server station with its own ground-truth latency
plane and (for remote tiers) its own RTT trace — driven by a
:class:`MultiTierScheduler` whose queue term comes from per-tier
predicted-backlog bookkeeping.  Poisson arrivals (:func:`make_poisson_stream`)
turn the Fig. 4 experiment into a load sweep; an optional
:class:`OnlineCalibrator` refits planes and the N->M regressor from
observed completions every K requests.  At zero load (every completion
before the next arrival, empty queues) the DES reproduces the analytic
replay decision-for-decision on the same seed — the invariant tests pin
it.

Batched continuous serving: a tier with ``batch_size`` b > 1 drains its
FIFO backlog in length-bucketed batches (via
:class:`~repro_torch.data.pipeline.TokenBatcher`): whenever one of its servers
frees up it starts up to b queued requests together, the batch costing

    T_batch = max_i T_exe,true(N_i, M_i) + per_seq_overhead_s * (b - 1)

— one decode pass over the padded batch plus a per-extra-sequence
overhead, the standard sub-linear continuous-batching model.  All batch
members start and finish together.  ``batch_size=1`` takes the exact
single-request code path, so the zero-load DES≡analytic invariant
is untouched.

CONTINUOUS in-flight batching (``SimTier(continuous=True)``): the
block-to-completion barrier goes away — each server becomes
``batch_size`` SLOTS, a request occupies one slot for

    T_i = T_exe,true(N_i, M_i) + per_seq_overhead_s * (slots live at start)

and finishes *independently* (its own finish event frees the slot for
the next FIFO request immediately), mirroring
:meth:`~repro_torch.runtime.engine.CollaborativeEngine.serve_continuous`'s
slot table.  At zero load no slot neighbours exist, so the duration is
exactly the solo draw — the zero-load DES≡analytic invariant holds for
continuous tiers too.

Deadline-aware admission (SLO): ``RequestStream.slo_s`` optionally
attaches a relative deadline to each request (``inf`` = none).  A
request whose preferred tier is full is re-routed to the cheapest tier
with space whose *predicted completion* (now + T_queue + T_tx + T_exe)
meets the deadline; if no tier can, the request is **shed** instead of
force-enqueued, and requests whose deadline has already expired by the
time a server would start them are shed at drain.  Requests without
deadlines keep the plain reroute/force-enqueue behaviour bit-for-bit.
``DESResult.summary()`` reports SLO attainment, shed counts and
sustained throughput alongside the latency percentiles.
"""

from __future__ import annotations

import dataclasses
import heapq
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.calibration import OnlineCalibrator
from repro_torch.core.faults import (
    CircuitBreaker,
    FaultSchedule,
    RetryPolicy,
    make_breakers,
)
from repro_torch.core.latency_model import DeviceProfile, bytes_for_tokens
from repro_torch.core.profiles import ConnectionProfile
from repro_torch.core.scheduler import (
    CLOUD,
    EDGE,
    CNMTScheduler,
    MultiTierScheduler,
    OracleScheduler,
    StaticScheduler,
)
from repro_torch.core.tx_estimator import TxEstimator
from repro_torch.data.pipeline import TokenBatcher


def _as_slo_array(slo_s, k: int) -> Optional[np.ndarray]:
    """Normalize a scalar/array SLO spec to a float64 array (inf = none)."""
    if slo_s is None:
        return None
    arr = np.broadcast_to(np.asarray(slo_s, np.float64), (k,)).copy()
    if np.any(arr <= 0):
        raise ValueError("slo_s must be positive (use inf for no deadline)")
    return arr


@dataclasses.dataclass
class RequestStream:
    """Arrival times + input/output lengths for one experiment.

    ``m_out`` is the length of the translation the NMT model *actually
    produces* (drives true compute time and response payload); ``m_real``
    is the ground-truth reference length (used only to fit gamma/delta,
    as in the paper: "computed on the ground-truth (N, M_real) pairs").
    ``slo_s`` (beyond paper) optionally carries a per-request relative
    deadline in seconds (``inf`` = no deadline); the DES sheds requests
    it predicts cannot meet their deadline instead of queueing them.
    """

    t_arrival_s: np.ndarray
    n: np.ndarray
    m_out: np.ndarray
    m_real: np.ndarray
    slo_s: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.n.size)


def make_stream(n, m_out, m_real, *, duration_s: float, seed: int = 0,
                slo_s=None) -> RequestStream:
    """Spread requests over the trace window with arrival jitter."""
    rng = np.random.default_rng(seed)
    k = len(n)
    base = np.arange(k) * (duration_s / k)
    jitter = rng.uniform(0, duration_s / k, size=k)
    return RequestStream(
        t_arrival_s=base + jitter,
        n=np.asarray(n, np.float64),
        m_out=np.asarray(m_out, np.float64),
        m_real=np.asarray(m_real, np.float64),
        slo_s=_as_slo_array(slo_s, k),
    )


def make_poisson_stream(n, m_out, m_real, *, rate_hz: float,
                        seed: int = 0, slo_s=None) -> RequestStream:
    """Poisson arrivals at ``rate_hz`` (exponential inter-arrival gaps) —
    the load-sweep counterpart of :func:`make_stream`.  ``slo_s`` (scalar
    or per-request array) attaches relative deadlines."""
    if rate_hz <= 0:
        raise ValueError("rate_hz must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=len(n))
    return RequestStream(
        t_arrival_s=np.cumsum(gaps),
        n=np.asarray(n, np.float64),
        m_out=np.asarray(m_out, np.float64),
        m_real=np.asarray(m_real, np.float64),
        slo_s=_as_slo_array(slo_s, len(n)),
    )


def make_trace_stream(arrival_s, n, m_out, m_real=None, *,
                      slo_s=None) -> RequestStream:
    """Trace-replay arrivals: the exact arrival instants of a recorded
    (or synthetic) trace, in seconds.

    This is the DES-twin entry point of the load-generation harness
    (``benchmarks/loadgen.py``): the SAME arrival trace the real
    :class:`~repro_torch.runtime.engine.CollaborativeEngine` was driven with
    — including the *realized* issue times of a closed-loop run — is
    replayed through :func:`simulate_des`, so modelled-vs-real drift is
    measurable per scenario.  ``arrival_s`` is used verbatim (no
    jitter, no re-seeding): the emitted ``t_arrival_s`` is bit-for-bit
    the trace, which the tests pin.  ``m_real`` defaults to ``m_out``
    when the trace carries only realized output lengths.
    """
    t = np.asarray(arrival_s, np.float64)
    if t.ndim != 1:
        raise ValueError("arrival_s must be 1-D")
    if len(t) != len(n) or len(t) != len(m_out):
        raise ValueError("arrival_s / n / m_out length mismatch")
    if t.size and np.any(np.diff(t) < 0):
        raise ValueError("trace arrival times must be non-decreasing")
    if m_real is None:
        m_real = m_out
    return RequestStream(
        t_arrival_s=t,
        n=np.asarray(n, np.float64),
        m_out=np.asarray(m_out, np.float64),
        m_real=np.asarray(m_real, np.float64),
        slo_s=_as_slo_array(slo_s, len(t)),
    )


@dataclasses.dataclass
class SimulationResult:
    """Outcome of one analytic replay (:func:`simulate`).

    All times are seconds of *ground truth* (the drawn execution + true
    T_tx the request experienced), not the scheduler's estimates; the
    policy only influenced which tier each request ran on.  ``total_s``
    is the paper's Table-I objective (sum of per-request latencies).
    """

    policy: str
    device: np.ndarray       # per-request EDGE/CLOUD
    latency_s: np.ndarray    # per-request true latency (seconds)
    offload_frac: float      # fraction of requests sent to CLOUD
    total_s: float           # sum of latencies (Table I objective)

    def vs(self, other: "SimulationResult") -> float:
        """Percentage execution-time variation vs a baseline (Table I)."""
        return 100.0 * (self.total_s - other.total_s) / other.total_s


def _true_times(
    stream: RequestStream,
    profile: ConnectionProfile,
    edge: DeviceProfile,
    cloud: DeviceProfile,
    seed: int,
    bytes_per_token: int = 2,
):
    """Draw the ground-truth latencies every policy is evaluated against."""
    rng_e = np.random.default_rng(seed + 1)
    rng_c = np.random.default_rng(seed + 2)
    t_edge = edge.true_time(stream.n, stream.m_out, rng_e)
    t_cloud_exec = cloud.true_time(stream.n, stream.m_out, rng_c)
    payload = bytes_for_tokens(stream.n + stream.m_out, bytes_per_token)
    t_tx = profile.tx_time(stream.t_arrival_s, payload)
    return t_edge, t_cloud_exec + t_tx, t_tx


def simulate(
    policy,
    stream: RequestStream,
    profile: ConnectionProfile,
    edge: DeviceProfile,
    cloud: DeviceProfile,
    *,
    seed: int = 0,
    tx_estimator: Optional[TxEstimator] = None,
    probe_interval_s: Optional[float] = None,
) -> SimulationResult:
    """Replay the request stream under one mapping policy.

    ``probe_interval_s`` (beyond paper) lets the gateway refresh its RTT
    estimate with a cheap ping when no request was offloaded recently;
    None reproduces the paper-faithful timestamp-only mechanism.
    """
    t_edge_true, t_cloud_true, t_tx_true = _true_times(stream, profile, edge, cloud, seed)

    if isinstance(policy, StaticScheduler):
        dev = policy.decide_batch(stream.n, None)
    elif isinstance(policy, OracleScheduler):
        dev = policy.decide_batch(t_edge_true, t_cloud_true)
    elif isinstance(policy, CNMTScheduler):
        dev = _simulate_online(
            policy, stream, profile, t_tx_true,
            tx_estimator=tx_estimator, probe_interval_s=probe_interval_s,
        )
    else:
        raise TypeError(f"unknown policy {policy!r}")

    latency = np.where(dev == EDGE, t_edge_true, t_cloud_true)
    return SimulationResult(
        policy=policy.name,
        device=dev,
        latency_s=latency,
        offload_frac=float(np.mean(dev == CLOUD)),
        total_s=float(latency.sum()),
    )


def _simulate_online(
    policy: CNMTScheduler,
    stream: RequestStream,
    profile: ConnectionProfile,
    t_tx_true: np.ndarray,
    *,
    tx_estimator: Optional[TxEstimator],
    probe_interval_s: Optional[float],
) -> np.ndarray:
    """Sequential replay: the T_tx estimate is coupled to past decisions."""
    est = tx_estimator or TxEstimator(init_rtt_s=float(profile.rtt_at(0.0)),
                                      bandwidth_bps=profile.bandwidth_bps)
    n_req = len(stream)
    dev = np.empty(n_req, dtype=np.int32)
    bpt = policy.bytes_per_token
    last_probe = -np.inf
    # Pre-extract plane coefficients & vectorize the (state-free) M_hat:
    # ~100x faster than per-request jnp dispatch.
    em, cm = policy.edge.model, policy.cloud.model
    m_hats = np.maximum(np.asarray(policy.n2m.predict(stream.n), np.float64), 1.0)
    for i in range(n_req):
        t_now = float(stream.t_arrival_s[i])
        n_i = float(stream.n[i])
        m_hat = float(m_hats[i])
        t_e = em.alpha_n * n_i + em.alpha_m * m_hat + em.beta
        payload = (n_i + m_hat) * bpt
        if probe_interval_s is not None and t_now - last_probe >= probe_interval_s:
            est.observe(t_now, float(profile.rtt_at(t_now)))
            last_probe = t_now
        t_tx_hat = est.tx_time(t_now, payload)
        t_c = cm.alpha_n * n_i + cm.alpha_m * m_hat + cm.beta + t_tx_hat
        gap = t_c - t_e
        if abs(gap) <= policy.hedge_margin_s:
            dev[i] = EDGE
        else:
            dev[i] = EDGE if t_e <= t_c else CLOUD
        if dev[i] == CLOUD:
            # response returns with timestamps -> fresh RTT sample (§II-C)
            est.observe(t_now, float(profile.rtt_at(t_now)))
    return dev


def table1_row(
    *,
    dataset: str,
    stream: RequestStream,
    profile: ConnectionProfile,
    edge: DeviceProfile,
    cloud: DeviceProfile,
    cnmt: CNMTScheduler,
    naive: CNMTScheduler,
    seed: int = 0,
    probe_interval_s: Optional[float] = None,
) -> Dict[str, Dict[str, float]]:
    """One dataset x one connection profile block of paper Table I.

    Returns {policy: {"vs_gw": %, "vs_server": %, "vs_oracle": %,
                      "offload_frac": f, "total_s": T}} for Naive and C-NMT.
    Negative percentages = execution-time reduction (as in the paper).
    """
    res = {}
    gw = simulate(StaticScheduler(EDGE), stream, profile, edge, cloud, seed=seed)
    server = simulate(StaticScheduler(CLOUD), stream, profile, edge, cloud, seed=seed)
    oracle = simulate(OracleScheduler(), stream, profile, edge, cloud, seed=seed)
    for pol in (naive, cnmt):
        r = simulate(pol, stream, profile, edge, cloud, seed=seed,
                     probe_interval_s=probe_interval_s)
        res[pol.name] = {
            "vs_gw": r.vs(gw),
            "vs_server": r.vs(server),
            "vs_oracle": r.vs(oracle),
            "offload_frac": r.offload_frac,
            "total_s": r.total_s,
        }
    res["_baselines"] = {
        "gw_total_s": gw.total_s,
        "server_total_s": server.total_s,
        "oracle_total_s": oracle.total_s,
        "oracle_offload_frac": oracle.offload_frac,
        "dataset": dataset,
        "profile": profile.name,
    }
    return res


# ===================================================================== DES --
_ARRIVAL, _FINISH, _XARR = 0, 1, 2   # _XARR: encoder states arrive at
                                     # a split plan's decode tier
_DOWN, _UP, _RETRY = 3, 4, 5         # fault edges + retry re-dispatches


@dataclasses.dataclass
class SimTier:
    """Ground truth for one tier in the discrete-event simulator.

    A bounded-FIFO multi-server station: ``servers`` concurrent requests
    (or batches) execute, up to ``queue_capacity`` more wait (None =
    unbounded), and a request routed to a full tier is re-routed to the
    next-best tier with space (counted in ``DESResult.overflow``).
    ``link`` is the tier's RTT trace; None marks the local tier (no T_tx,
    and no §II-C samples).

    ``batch_size`` > 1 turns each server into a continuous-batching
    worker: when it frees up it drains up to ``batch_size`` queued
    requests as one length-bucketed batch (a :class:`TokenBatcher` with
    ``max_batch_tokens`` as its padded-token budget) whose true duration
    is  max over members of the solo execution draw plus
    ``per_seq_overhead_s`` per extra member — all members finish
    together.  ``batch_size=1`` is the exact unbatched station.

    ``continuous=True`` removes the block-to-completion barrier: each
    server is ``batch_size`` independent SLOTS, a request occupies one
    slot for its solo draw plus ``per_seq_overhead_s`` per slot live at
    its start, and frees the slot the moment it finishes (FIFO refill) —
    the DES twin of the engine's ``serve_continuous`` slot table.
    """

    name: str
    profile: DeviceProfile
    servers: int = 1
    queue_capacity: Optional[int] = None
    link: Optional[ConnectionProfile] = None
    batch_size: int = 1
    per_seq_overhead_s: float = 0.0
    max_batch_tokens: Optional[int] = None
    continuous: bool = False

    def __post_init__(self):
        if self.servers < 1:
            raise ValueError("servers must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.per_seq_overhead_s < 0:
            raise ValueError("per_seq_overhead_s must be >= 0")
        if self.continuous and self.max_batch_tokens is not None:
            raise ValueError("continuous tiers admit per-slot, not "
                             "per-token-budget batches")


@dataclasses.dataclass
class DESResult:
    """Per-request ground truth of one :func:`simulate_des` run.

    All ``*_s`` arrays are seconds; latency decomposes exactly as
    ``latency_s == wait_s + exec_s + tx_s`` for served requests (the
    invariant tests pin it, including the two-leg split path) and is
    NaN for shed ones.  Everything here is ground truth — what actually
    happened in the event loop — not the scheduler's predictions; the
    scheduler's beliefs only influenced ``tier``.  ``summary()`` is the
    stable reporting surface the benchmarks consume (adding keys is
    allowed, renaming/removing them is a breaking change).
    """

    policy: str
    tier_names: List[str]
    tier: np.ndarray          # per-request tier index (-1 = shed unadmitted)
    t_arrival_s: np.ndarray
    t_start_s: np.ndarray     # execution start (arrival + queue wait)
    t_finish_s: np.ndarray    # execution end
    wait_s: np.ndarray        # T_queue actually experienced
    tx_s: np.ndarray          # true T_tx (0 for local tiers)
    exec_s: np.ndarray        # true T_exe (batch duration for batched tiers)
    latency_s: np.ndarray     # wait + exec + tx (NaN for shed requests)
    overflow: np.ndarray      # per-tier count of forced enqueues (all full)
    shed: Optional[np.ndarray] = None   # per-request deadline-shed flags
    slo_s: Optional[np.ndarray] = None  # relative deadlines (inf = none)
    events: Optional[List] = None   # (time, kind, req, tier) as processed
    # fault-tolerance extras (None unless faults/retry were armed)
    attempts: Optional[np.ndarray] = None       # dispatches per request
    retry_after_s: Optional[np.ndarray] = None  # backpressure hint on shed
    fault_stats: Optional[Dict] = None          # availability/retry/... keys

    @property
    def served(self) -> np.ndarray:
        """Boolean mask of requests that actually executed (not shed)."""
        if self.shed is None:
            return np.ones(len(self.tier), bool)
        return ~self.shed

    @property
    def total_s(self) -> float:
        return float(self.latency_s[self.served].sum())

    def tier_frac(self) -> Dict[str, float]:
        r = max(len(self.tier), 1)
        return {name: float(np.sum(self.tier == k)) / r
                for k, name in enumerate(self.tier_names)}

    def p95_latency_s(self) -> float:
        return float(np.percentile(self.latency_s[self.served], 95))

    def slo_attainment(self) -> float:
        """Fraction of deadline-carrying requests that completed within
        their deadline (shed requests count as missed); 1.0 when no
        request carried a deadline (vacuously attained)."""
        if self.slo_s is None:
            return 1.0
        has_dl = np.isfinite(self.slo_s)
        if not has_dl.any():
            return 1.0
        met = self.served & np.where(
            np.isnan(self.latency_s), False, self.latency_s <= self.slo_s)
        return float(met[has_dl].sum() / has_dl.sum())

    def throughput_rps(self) -> float:
        """Served requests per second of makespan (sustained throughput)."""
        served = self.served
        if not served.any():
            return 0.0
        span = float(self.t_finish_s[served].max()
                     - self.t_arrival_s.min())
        return float(served.sum()) / span if span > 0 else float("inf")

    def summary(self) -> Dict[str, float]:
        srv = self.served
        lat = self.latency_s[srv]
        wait = self.wait_s[srv]
        if lat.size == 0:              # everything shed: no latency stats
            lat = wait = np.array([np.nan])
        out = {
            "requests": float(len(self.tier)),
            "served": float(srv.sum()),
            "mean_latency_s": float(lat.mean()),
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "mean_wait_s": float(wait.mean()),
            "max_wait_s": float(wait.max()),
            "overflow": float(self.overflow.sum()),
            "shed": float(len(self.tier) - srv.sum()),
            "slo_attainment": self.slo_attainment(),
            "throughput_rps": self.throughput_rps(),
        }
        if self.fault_stats is not None:
            out.update(self.fault_stats)
        return out


def simulate_des(
    scheduler: MultiTierScheduler,
    stream: RequestStream,
    tiers: Sequence[SimTier],
    *,
    seed: int = 0,
    bytes_per_token: Optional[int] = None,
    calibrator: Optional[OnlineCalibrator] = None,
    collect_events: bool = False,
    inter_links: Optional[Dict] = None,
    faults: Optional[FaultSchedule] = None,
    retry: Optional[RetryPolicy] = None,
    breaker: Optional[CircuitBreaker] = None,
) -> DESResult:
    """Event-driven replay of ``stream`` over N queued tiers.

    Ground truth mirrors :func:`simulate`: per-tier execution times are
    drawn vectorized with ``default_rng(seed + 1 + k)`` (tier 0 = edge,
    tier 1 = cloud reproduces ``_true_times`` exactly) and true T_tx
    comes from each tier's own trace at the request's arrival time.
    Tiers with ``batch_size`` > 1 serve length-bucketed batches whose
    duration is the max of the members' solo draws plus the per-sequence
    overhead (see :class:`SimTier`).

    The scheduler sees queues only through its batch-aware
    :meth:`~repro_torch.core.scheduler.MultiTierScheduler.queue_delay` term
    (its own predicted backlog ÷ effective service rate) and sees each
    link only through §II-C timestamped samples that become available —
    and are timestamped — when an offloaded request *completes* (the RTT
    value is the one the request actually experienced; completions
    arriving out of order cannot rewind the estimator).  ``calibrator``
    (optional) receives every completion and refits the scheduler's
    planes + N->M regressor whenever its interval elapses — pass
    scheduler-owned model copies, not the ground-truth profiles.

    Requests carrying a finite ``stream.slo_s`` deadline are admitted
    only where the predicted completion meets it, shed otherwise (see
    module docstring); without deadlines admission is the plain rule, exactly.

    ``inter_links`` maps directed tier pairs ``(e, k)`` to ground-truth
    :class:`~repro_torch.core.profiles.ConnectionProfile` traces for the
    encoder-state hop of a split placement.  When it is provided *and*
    the scheduler is split-ready (links + activation + allow_split), the
    DES runs two-leg service: the encode leg occupies tier ``e``, a
    transfer event delivers the states after a one-way ship time, and
    the decode leg queues at tier ``k`` from its own arrival instant.
    Client up/down legs are priced one-way and added post-hoc, exactly
    like whole-request T_tx.  With splits disabled the run is bit-for-bit
    identical to the single-leg simulator.

    Fault injection: ``faults`` schedules tier outages, link
    degradation/blackholes and straggler windows.  A crash fails all
    in-flight AND queued work at the tier; a dispatch to a down (or
    blackholed) tier fails after the detection time.  ``retry`` bounds
    re-dispatches with exponential backoff + jitter and arms the
    per-tier circuit breakers (cloned from ``breaker``) that mask
    unhealthy tiers out of the placement argmin; ``retry=None`` is the
    no-retry baseline — failed work is simply lost.  ``retry.replay_shed``
    additionally replays deadline-shed requests after their
    ``retry_after_s`` backpressure hint.  Split plans are
    disabled while a non-empty schedule is armed (the engine, not the
    DES, models mid-plan decode failover).  With ``faults=None`` — or an
    EMPTY schedule — every path below is pinned bit-for-bit identical to
    the fault-free simulator (tests enforce it).
    """
    k_tiers = len(tiers)
    if k_tiers != len(scheduler.tiers):
        raise ValueError("scheduler/tier count mismatch")
    n_req = len(stream)
    bpt = scheduler.bytes_per_token if bytes_per_token is None \
        else bytes_per_token

    # ground truth, drawn exactly like the analytic replay
    true_exec = [t.profile.true_time(stream.n, stream.m_out,
                                     np.random.default_rng(seed + 1 + k))
                 for k, t in enumerate(tiers)]
    payload_true = bytes_for_tokens(stream.n + stream.m_out, bpt)
    true_tx = [np.zeros(n_req) if t.link is None
               else t.link.tx_time(stream.t_arrival_s, payload_true)
               for t in tiers]

    # ---- split (two-leg) placement support ------------------------------
    # Everything below is gated on ``split_enabled``; with splits disabled
    # (no inter_links, or a scheduler without links/activation/allow_split)
    # the run is bit-for-bit identical to the single-leg simulator.
    # ---- fault-tolerance state ------------------------------------------
    # ``ft`` gates every injection branch; an EMPTY schedule leaves it off
    # so arming the machinery cannot perturb a fault-free run.  Breakers
    # (routing belief) exist only under a retry policy — ``retry=None``
    # is the pre-fault-tolerance baseline where failures just lose work.
    ft = faults is not None and not faults.empty
    use_breakers = ft and retry is not None
    breakers = make_breakers(k_tiers, breaker) if use_breakers else None
    replay_armed = retry is not None and retry.replay_shed
    arm_extras = faults is not None or retry is not None
    rng_retry = np.random.default_rng(seed + 7777)
    down = [False] * k_tiers
    outstanding: List[set] = [set() for _ in range(k_tiers)]
    req_failed: List[set] = [set() for _ in range(n_req)]
    attempts = np.zeros(n_req, np.int64)
    retries_used = np.zeros(n_req, np.int64)
    replays_used = np.zeros(n_req, np.int64)
    retry_after_v = np.full(n_req, np.nan)
    tx_override = np.full(n_req, np.nan)
    fault_failures = np.zeros(k_tiers, np.int64)
    n_retries = n_replays = fault_lost = 0
    retry_req: Dict = {}
    _detect = (retry if retry is not None else RetryPolicy()).detect_s

    want_split = (
        inter_links is not None and len(inter_links) > 0
        and getattr(scheduler, "_split_ready", None) is not None
        and scheduler._split_ready())
    split_enabled = want_split and not ft
    if want_split and ft:
        # The DES has no mid-plan decode-leg
        # failover model (the engine does — see runtime/engine.py
        # `_submit_split`), so a non-empty FaultSchedule downgrades every
        # request to whole placements.  Warn instead of silently
        # degrading; the limitation is documented in docs/architecture.md.
        warnings.warn(
            "simulate_des: split placement is disabled while a non-empty "
            "FaultSchedule is armed — the DES does not model mid-plan "
            "decode-leg failover (the engine does); requests fall back to "
            "whole placements.  See docs/architecture.md.",
            RuntimeWarning, stacklevel=2)
    leg_of = np.zeros(n_req, np.int8)   # 0 whole, 1 encode leg, 2 decode leg
    split_mask = np.zeros(n_req, bool)
    split_enc = np.full(n_req, -1, np.int32)
    split_dec = np.full(n_req, -1, np.int32)
    up_v = np.zeros(n_req)     # client uplink, one-way (added post-hoc)
    ship_v = np.zeros(n_req)   # encoder-state transfer (simulated in-line)
    down_v = np.zeros(n_req)   # client downlink, one-way (added post-hoc)
    true_enc: List[np.ndarray] = []
    true_dec: List[np.ndarray] = []
    if split_enabled:
        for k, t in enumerate(tiers):
            te, td = t.profile.true_leg_times(
                stream.n, stream.m_out, np.random.default_rng(seed + 101 + k))
            true_enc.append(te)
            true_dec.append(td)

    # absolute deadlines (inf = none); None disables every deadline branch
    deadline_abs = None
    if stream.slo_s is not None and np.any(np.isfinite(stream.slo_s)):
        deadline_abs = np.asarray(stream.t_arrival_s, np.float64) \
            + np.asarray(stream.slo_s, np.float64)

    def m_hats_vec():
        return np.maximum(
            np.asarray(scheduler.n2m.predict(stream.n), np.float64), 1.0)

    m_hats = m_hats_vec()

    # per-tier station state; a continuous tier's concurrency unit is a
    # SLOT (servers x batch_size of them), a batched tier's is a server
    busy = [0] * k_tiers
    slots = [t.servers * t.batch_size if t.continuous else t.servers
             for t in tiers]
    queues: List[List[int]] = [[] for _ in range(k_tiers)]
    qhead = [0] * k_tiers                 # pop index (amortized O(1) FIFO)
    batchers = [TokenBatcher(max_batch=t.batch_size,
                             max_tokens_per_batch=t.max_batch_tokens
                             if t.max_batch_tokens is not None else 1 << 40)
                if t.batch_size > 1 and not t.continuous else None
                for t in tiers]
    pred_backlog = np.zeros(k_tiers)      # scheduler-predicted work in system
    in_system = [0] * k_tiers             # admitted-but-unfinished count
    pred_exec = np.zeros(n_req)           # predicted T_exe at the chosen tier

    tier_of = np.full(n_req, -1, np.int32)
    t_start = np.zeros(n_req)
    t_finish = np.zeros(n_req)
    exec_used = np.zeros(n_req)           # actual service duration
    shed = np.zeros(n_req, bool)
    overflow = np.zeros(k_tiers, np.int64)
    events: Optional[List] = [] if collect_events else None

    heap = [(float(stream.t_arrival_s[i]), i, _ARRIVAL, -1)
            for i in range(n_req)]
    heapq.heapify(heap)
    seq = n_req  # tie-break counter for events pushed during the run
    if ft:
        # outage edges become first-class events: _DOWN fails in-flight
        # and queued work at the tier, _UP merely flips the ground truth
        # back (the router rediscovers it via half-open probes)
        for t_ev, kind_ev, k_ev in faults.outage_events():
            if kind_ev == "down":
                heapq.heappush(heap, (float(t_ev), seq, _DOWN, int(k_ev)))
            elif kind_ev == "up":
                heapq.heappush(heap, (float(t_ev), seq, _UP, int(k_ev)))
            else:
                continue   # link episodes are sampled at dispatch time
            seq += 1

    def start(i: int, k: int, now: float) -> None:
        nonlocal seq
        if split_enabled and leg_of[i] == 1:
            base = float(true_enc[k][i])
        elif split_enabled and leg_of[i] == 2:
            base = float(true_dec[k][i])
        else:
            base = float(true_exec[k][i])
        # continuous slot admission: the solo draw pays the per-sequence
        # overhead once per slot already live at its start (zero at zero
        # load, so the solo path stays bit-for-bit)
        dur = base \
            + (tiers[k].per_seq_overhead_s * busy[k]
               if tiers[k].continuous else 0.0)
        if ft:
            s = faults.slowdown(k, now)
            if s != 1.0:           # straggler window: degraded, not failed
                dur = dur * s
            # reset first so a retry on a clean (or link-less) tier
            # clears an override left by a degraded earlier attempt
            tx_override[i] = np.nan
            if tiers[k].link is not None:
                # the true T_tx this request pays reflects the link's
                # degradation episode at its (possibly retried) start
                rf, bf = faults.link_factors(k, now)
                if rf != 1.0 or bf != 1.0:
                    tx_override[i] = (
                        float(tiers[k].link.rtt_at(
                            float(stream.t_arrival_s[i]))) * rf
                        + float(payload_true[i]) * 8.0
                        / (tiers[k].link.bandwidth_bps * bf))
        busy[k] += 1
        if split_enabled and leg_of[i] == 2:
            exec_used[i] += dur   # decode leg stacks on the encode leg
        else:
            t_start[i] = now
            exec_used[i] = dur
        fin = now + dur
        heapq.heappush(heap, (fin, seq, _FINISH, k))
        seq += 1
        finish_req[(fin, seq - 1)] = i
        if ft:
            outstanding[k].add((fin, seq - 1))

    def start_batch(ids: List[int], k: int, now: float) -> None:
        nonlocal seq
        busy[k] += 1
        dur = max(float(true_exec[k][i]) for i in ids) \
            + tiers[k].per_seq_overhead_s * (len(ids) - 1)
        if ft:
            s = faults.slowdown(k, now)
            if s != 1.0:
                dur = dur * s
        for i in ids:
            t_start[i] = now
            exec_used[i] = dur
        fin = now + dur
        heapq.heappush(heap, (fin, seq, _FINISH, k))
        seq += 1
        finish_req[(fin, seq - 1)] = tuple(ids)
        if ft:
            outstanding[k].add((fin, seq - 1))

    finish_req: Dict = {}
    xfer_req: Dict = {}

    def shed_request(i: int, k: int, now: float, admitted: bool) -> None:
        """Deadline miss: drop ``i`` (predicted or certain to miss)."""
        shed[i] = True
        if admitted:                       # leaving the tier's backlog
            pred_backlog[k] = max(pred_backlog[k] - pred_exec[i], 0.0)
            in_system[k] -= 1
        if events is not None:
            events.append((now, "shed", i, k))

    def waiting(k: int) -> int:
        if batchers[k] is not None:
            return len(batchers[k])
        return len(queues[k]) - qhead[k]

    def has_space(k: int) -> bool:
        cap = tiers[k].queue_capacity
        return cap is None or waiting(k) < cap or busy[k] < slots[k]

    def drain(k: int, now: float) -> None:
        """Fill freed servers of tier k from its waiting line, shedding
        queued requests whose deadline already expired (they would
        certainly miss; dropping them protects the rest)."""
        if batchers[k] is not None:
            while busy[k] < slots[k] and len(batchers[k]) > 0:
                ids, _ = batchers[k].next_batch_ids()
                if deadline_abs is not None:
                    live = [i for i in ids if deadline_abs[i] >= now]
                    for i in ids:
                        if deadline_abs[i] < now:
                            shed_request(i, k, now, admitted=True)
                    ids = live
                if ids:
                    start_batch(ids, k, now)
        else:
            while busy[k] < slots[k] and waiting(k) > 0:
                j = queues[k][qhead[k]]
                qhead[k] += 1
                if qhead[k] > 1024 and qhead[k] * 2 > len(queues[k]):
                    queues[k] = queues[k][qhead[k]:]
                    qhead[k] = 0
                if deadline_abs is not None and deadline_abs[j] < now:
                    shed_request(j, k, now, admitted=True)
                    continue
                start(j, k, now)

    # ---- fault-tolerance helpers (all no-ops when ft is off) ------------
    def push_retry(i: int, t: float) -> None:
        nonlocal seq
        heapq.heappush(heap, (t, seq, _RETRY, -1))
        retry_req[(t, seq)] = i
        seq += 1

    def breaker_mask(now: float) -> set:
        """Tiers the routing belief refuses to dispatch to right now
        (an OPEN breaker past its cool-down admits the caller as the
        half-open probe, so probing happens through normal dispatch)."""
        if not use_breakers:
            return set()
        return {j for j in range(k_tiers) if not breakers[j].allow(now)}

    def probe_after(now: float) -> float:
        if not use_breakers:
            return 0.0
        return min(b.time_to_probe(now) for b in breakers)

    def fault_shed(i: int, now: float, retry_after: float) -> None:
        nonlocal fault_lost
        shed[i] = True
        fault_lost += 1
        retry_after_v[i] = retry_after
        if events is not None:
            events.append((now, "fault_shed", i, -1))

    def fail_attempt(i: int, k: int, now: float, blackhole: bool) -> None:
        """One failed dispatch/in-flight attempt on tier k: trip the
        breaker, then either schedule the bounded retry (after the
        detection time + backoff with jitter) or lose the request —
        ``retry=None`` is the no-retry baseline."""
        nonlocal n_retries
        fault_failures[k] += 1
        req_failed[i].add(k)
        if use_breakers:
            breakers[k].record_failure(now)
        detect = _detect(blackhole)
        if events is not None:
            events.append((now, "fault", i, k))
        if retry is not None and retries_used[i] < retry.max_retries:
            retries_used[i] += 1
            n_retries += 1
            push_retry(i, now + detect
                       + retry.backoff(int(retries_used[i]) - 1, rng_retry))
        else:
            fault_shed(i, now + detect, probe_after(now + detect))

    def dispatch(i: int, now: float) -> None:
        """Route + admit one (possibly re-tried/replayed) request — the
        plain arrival body, with unhealthy tiers masked out of the argmin
        and injected failures intercepting the dispatch."""
        nonlocal n_replays
        if arm_extras:
            attempts[i] += 1
        qd = [scheduler.queue_delay(k, pred_backlog[k], in_system[k],
                                    tiers[k].servers)
              for k in range(k_tiers)]
        excl = None
        if ft:
            mask = set(req_failed[i]) | breaker_mask(now)
            if len(mask) >= k_tiers:
                # this request has failed everywhere once — its history
                # may be stale (a tier can have restarted), so keep only
                # the breaker belief
                mask = breaker_mask(now)
            if len(mask) >= k_tiers:
                # every tier dark: graceful degradation bottoms out here
                fault_shed(i, now, probe_after(now))
                return
            excl = frozenset(mask) if mask else None
        d = (scheduler.decide_plan_fast(float(stream.n[i]),
                                        float(m_hats[i]), now, qd,
                                        exclude=excl)
             if split_enabled else
             scheduler.decide_fast(float(stream.n[i]), float(m_hats[i]),
                                   now, qd, exclude=excl))
        k = d.tier
        if split_enabled and d.plan is not None and d.plan.is_split:
            e, kd = d.plan.encode_tier, d.plan.decode_tier
            # two-leg service needs plain (unbatched, non-continuous)
            # stations on both legs, a ground-truth inter-tier link,
            # no deadline, and room on both stations
            eligible = (
                (e, kd) in inter_links
                and batchers[e] is None and not tiers[e].continuous
                and batchers[kd] is None and not tiers[kd].continuous
                and (deadline_abs is None
                     or not np.isfinite(deadline_abs[i]))
                and has_space(e) and has_space(kd))
            if eligible:
                n_i = float(stream.n[i])
                if tiers[e].link is not None:
                    up_v[i] = (float(tiers[e].link.rtt_at(now)) / 2.0
                               + n_i * bpt * 8.0
                               / tiers[e].link.bandwidth_bps)
                if tiers[kd].link is not None:
                    down_v[i] = (float(tiers[kd].link.rtt_at(now)) / 2.0
                                 + float(stream.m_out[i]) * bpt * 8.0
                                 / tiers[kd].link.bandwidth_bps)
                inter = inter_links[(e, kd)]
                ship_v[i] = (
                    float(inter.rtt_at(now)) / 2.0
                    + float(scheduler.activation.payload_bytes(n_i))
                    * 8.0 / inter.bandwidth_bps)
                leg_of[i] = 1
                split_mask[i] = True
                split_enc[i] = e
                split_dec[i] = kd
                tier_of[i] = kd   # reported tier = decode placement
                m_e = scheduler.tiers[e].model
                pred_exec[i] = max(m_e.alpha_n * n_i + 0.5 * m_e.beta,
                                   0.0)
                pred_backlog[e] += pred_exec[i]
                in_system[e] += 1
                if events is not None:
                    events.append((now, "arrival", i, e))
                if busy[e] < slots[e]:
                    start(i, e, now)
                else:
                    queues[e].append(i)
                return
            # degrade to the best whole placement
            k = scheduler._select(list(d.t_pred))
        if not has_space(k):
            ranked = sorted(range(k_tiers), key=lambda j: d.t_pred[j])
            if excl is not None:
                # unhealthy tiers are not re-route targets either
                ranked = [j for j in ranked if j not in excl]
            dl = None if deadline_abs is None else float(deadline_abs[i])
            if dl is None or not np.isfinite(dl):
                # plain semantics: next-best tier with space, else force
                for j in ranked:
                    if has_space(j):
                        k = j
                        break
                else:
                    overflow[k] += 1  # everything full: force-enqueue
            else:
                # deadline-aware: cheapest tier with space whose
                # predicted completion meets the deadline; else shed
                # (force-enqueue only if the preferred full tier is
                # still predicted to make it).
                spaced = [j for j in ranked if has_space(j)]
                feasible = [j for j in spaced
                            if now + d.t_pred[j] <= dl]
                if feasible:
                    k = feasible[0]
                elif not spaced and now + d.t_pred[k] <= dl:
                    overflow[k] += 1
                else:
                    # retry-after backpressure: a client
                    # honoring the hint re-submits after the predicted
                    # queue drain instead of losing the request outright
                    ra = max(min(qd), 0.0)
                    if (replay_armed
                            and replays_used[i] < retry.max_retries):
                        ra = max(ra, retry.backoff_base_s)
                        if now + ra <= dl:
                            replays_used[i] += 1
                            n_replays += 1
                            retry_after_v[i] = ra
                            if events is not None:
                                events.append((now, "backpressure", i, k))
                            push_retry(i, now + ra)
                            return
                    retry_after_v[i] = ra
                    shed_request(i, k, now, admitted=False)
                    return
        if ft and (down[k] or (tiers[k].link is not None
                               and faults.link_blackhole(k, now))):
            # injected failure at dispatch: the schedule is ground truth
            # the router only experiences through this failed attempt
            fail_attempt(i, k, now, blackhole=not down[k])
            return
        tier_of[i] = k
        pe = (scheduler.tiers[k].model.alpha_n * float(stream.n[i])
              + scheduler.tiers[k].model.alpha_m * float(m_hats[i])
              + scheduler.tiers[k].model.beta)
        pred_exec[i] = max(pe, 0.0)
        pred_backlog[k] += pred_exec[i]
        in_system[k] += 1
        if events is not None:
            events.append((now, "arrival", i, k))
        if busy[k] < slots[k]:
            if batchers[k] is not None:
                start_batch([i], k, now)
            else:
                start(i, k, now)
        elif batchers[k] is not None:
            batchers[k].add(i, length=int(stream.n[i]))
        else:
            queues[k].append(i)

    while heap:
        now, sq, kind, k_fin = heapq.heappop(heap)
        if kind == _ARRIVAL:
            dispatch(sq, now)
        elif kind == _RETRY:
            i = retry_req.pop((now, sq))
            if events is not None:
                events.append((now, "retry", i, -1))
            dispatch(i, now)
        elif kind == _DOWN:
            k = k_fin
            down[k] = True
            if events is not None:
                events.append((now, "tier_down", -1, k))
            # the crash fails everything in flight at the tier...
            for key in sorted(outstanding[k]):
                done = finish_req.pop(key, None)
                if done is None:
                    continue
                busy[k] -= 1
                for i in (done if isinstance(done, tuple) else (done,)):
                    pred_backlog[k] = max(pred_backlog[k] - pred_exec[i],
                                          0.0)
                    in_system[k] -= 1
                    fail_attempt(i, k, now, blackhole=False)
            outstanding[k].clear()
            # ...and everything still queued there dies with it
            doomed: List[int] = []
            if batchers[k] is not None:
                while len(batchers[k]) > 0:
                    ids, _ = batchers[k].next_batch_ids()
                    doomed.extend(ids)
            else:
                doomed = queues[k][qhead[k]:]
                queues[k] = []
                qhead[k] = 0
            for i in doomed:
                pred_backlog[k] = max(pred_backlog[k] - pred_exec[i], 0.0)
                in_system[k] -= 1
                fail_attempt(i, k, now, blackhole=False)
        elif kind == _UP:
            down[k_fin] = False   # half-open probing rediscovers the tier
            if events is not None:
                events.append((now, "tier_up", -1, k_fin))
        elif kind == _XARR:
            # encoder states reached the decode tier: queue the second leg
            i = xfer_req.pop((now, sq))
            k = k_fin
            leg_of[i] = 2
            m_d = scheduler.tiers[k].model
            pred_exec[i] = max(
                m_d.alpha_m * float(m_hats[i]) + 0.5 * m_d.beta, 0.0)
            pred_backlog[k] += pred_exec[i]
            in_system[k] += 1
            if events is not None:
                events.append((now, "xfer", i, k))
            if busy[k] < slots[k]:
                start(i, k, now)
            else:
                queues[k].append(i)
        else:
            done = finish_req.pop((now, sq), None)
            if done is None:
                continue   # voided: its tier crashed while it ran
            members = done if isinstance(done, tuple) else (done,)
            k = k_fin
            busy[k] -= 1
            if ft:
                outstanding[k].discard((now, sq))
            if use_breakers and breakers[k].record_success():
                # breaker recovery: the link estimators warmed during the
                # episode describe a network that no longer exists
                st = scheduler.tiers[k]
                if st.tx is not None:
                    st.tx.invalidate()
                if getattr(scheduler, "links", None) is not None:
                    scheduler.links.invalidate(k)
            for i in members:
                if split_enabled and leg_of[i] == 1:
                    # encode leg done: ship the activations; completion
                    # bookkeeping waits for the decode leg
                    pred_backlog[k] = max(pred_backlog[k] - pred_exec[i],
                                          0.0)
                    in_system[k] -= 1
                    if events is not None:
                        events.append((now, "encode_done", i, k))
                    if tiers[k].link is not None:
                        scheduler.observe_rtt(
                            k, now, float(tiers[k].link.rtt_at(
                                float(stream.t_arrival_s[i]))))
                    x_at = now + float(ship_v[i])
                    heapq.heappush(heap,
                                   (x_at, seq, _XARR, int(split_dec[i])))
                    seq += 1
                    xfer_req[(x_at, seq - 1)] = i
                    continue
                t_finish[i] = now
                pred_backlog[k] = max(pred_backlog[k] - pred_exec[i], 0.0)
                in_system[k] -= 1
                if events is not None:
                    events.append((now, "finish", i, k))
                arr = float(stream.t_arrival_s[i])
                if tiers[k].link is not None:
                    # §II-C: the response carries timestamps -> RTT sample
                    # for this tier's link.  The RTT *value* is the one the
                    # request experienced (trace at its arrival); the sample
                    # is timestamped `now`, when the response came back —
                    # timestamping it at arrival let out-of-order
                    # completions rewind the estimator's clock.
                    rtt_obs = float(tiers[k].link.rtt_at(arr))
                    if ft:
                        rf, _bf = faults.link_factors(k, float(t_start[i]))
                        if rf != 1.0:
                            rtt_obs *= rf   # degraded episode: the sample
                            # the response really carried (§II-C)
                    scheduler.observe_rtt(k, now, rtt_obs)
                if split_enabled and leg_of[i] == 2:
                    # completed split: feed the inter-tier link estimator;
                    # leg samples are half-planes, so skip the calibrator
                    e = int(split_enc[i])
                    scheduler.links.observe(
                        e, k, now, float(inter_links[(e, k)].rtt_at(arr)))
                    continue
                if calibrator is not None:
                    due = calibrator.record(k, float(stream.n[i]),
                                            float(stream.m_out[i]),
                                            float(true_exec[k][i]))
                    if due:
                        calibrator.refit([t.model for t in scheduler.tiers],
                                         scheduler.n2m)
                        m_hats = m_hats_vec()
            drain(k, now)

    rows = np.arange(n_req)
    ok = ~shed & (tier_of >= 0)
    safe_tier = np.where(tier_of >= 0, tier_of, 0)
    tx_s = np.where(ok, np.stack(true_tx)[safe_tier, rows], 0.0)
    if ft:
        # requests served during a link-degradation episode paid the
        # degraded transfer, not the trace baseline
        tx_s = np.where(ok & ~np.isnan(tx_override), tx_override, tx_s)
    exec_s = np.where(ok, exec_used, 0.0)
    wait = np.where(ok, t_start - stream.t_arrival_s, 0.0)
    latency = np.where(ok, wait + exec_s + tx_s, np.nan)
    if split_enabled and split_mask.any():
        # split requests: tx = up + ship + down (all one-way); latency
        # follows the event timeline (which embeds ship and both waits)
        # plus the post-hoc client legs; wait is the residual so the
        # latency = wait + exec + tx invariant holds by construction
        sm = split_mask & ok
        tx_s = np.where(sm, up_v + ship_v + down_v, tx_s)
        latency = np.where(
            sm, (t_finish - stream.t_arrival_s) + up_v + down_v, latency)
        wait = np.where(sm, latency - exec_s - tx_s, wait)
    fault_stats = None
    if arm_extras:
        served = int(ok.sum())
        span = max(float(stream.t_arrival_s[-1]) if n_req else 0.0, 1e-9)
        n_good = served
        if stream.slo_s is not None:
            slo = np.asarray(stream.slo_s, np.float64)
            n_good = int((ok & (latency <= slo)).sum())
        fault_stats = {
            "availability": served / max(n_req, 1),
            "fault_failures": float(fault_failures.sum()),
            "retries": float(n_retries),
            "replays": float(n_replays),
            "fault_lost": float(fault_lost),
            "failover_served": float(int((ok & (attempts > 1)).sum())),
            "breaker_opens": (float(sum(b.n_opens for b in breakers))
                              if use_breakers else 0.0),
            "goodput_rps": n_good / span,
        }
    return DESResult(
        policy=scheduler.name,
        tier_names=[t.name for t in tiers],
        tier=tier_of,
        t_arrival_s=np.asarray(stream.t_arrival_s, np.float64),
        t_start_s=t_start,
        t_finish_s=t_finish,
        wait_s=wait,
        tx_s=tx_s,
        exec_s=exec_s,
        latency_s=latency,
        overflow=overflow,
        shed=shed,
        slo_s=None if stream.slo_s is None
        else np.asarray(stream.slo_s, np.float64),
        events=events,
        attempts=attempts if arm_extras else None,
        retry_after_s=retry_after_v if arm_extras else None,
        fault_stats=fault_stats,
    )
