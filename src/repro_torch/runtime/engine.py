"""N-tier collaborative serving engine: the C-NMT decision rule
generalized to a fleet of heterogeneous compute tiers with per-tier
queues — the production integration of ``repro_torch.core``.

Each :class:`Tier` is one place an inference can run (on-device NPU,
edge gateway, regional pod, central cloud, ...) and carries

* a latency plane (``DeviceProfile`` — measured by ``core.calibration``
  or priced from dry-run rooflines via ``device_from_roofline``),
* optionally a REAL executor callable (built by
  :func:`repro_torch.runtime.serving.build_executor` — over an LM's
  ``GenerationSession``, or the two legs of an NMT model's split with
  ``kind="split"`` — or, for a Marian tier's translate path, by
  :func:`repro_torch.nmt.transformer.make_executors`) — the engine then
  measures actual wall-clock; without
  one the tier is MODELLED and the engine simulates the latency (how
  tiers that are not run locally participate, mirroring the paper's
  simulated network + real inference testbed),
* optionally a live link (``rtt_fn``) — its T_tx is tracked through
  §II-C timestamped samples of *offloaded* requests only, one
  :class:`TxEstimator` per link,
* a concurrency limit (``servers``) and a bounded FIFO queue
  (``queue_capacity``) — the engine keeps per-tier occupancy in virtual
  time, so a busy tier's queue delay enters the decision rule:

      d_tgt = argmin_k [ T_queue,k + T_tx,k + T_exe,k(N, M_hat) ]

With two tiers (local edge + one cloud behind a link) and empty queues
this reduces exactly to paper Eq. (1)/(2); the regression tests pin the
reduction bit-for-bit against the two-tier engine semantics.  An optional
online-feedback loop (``refit_interval``) refits the scheduler's planes
and the N->M regressor from observed completions every K requests.

Batched continuous serving (beyond paper): a tier with ``batch_size``
b > 1 coalesces requests in virtual time — while a server is busy,
arrivals assigned to it accumulate into the next not-yet-started batch
(up to b members) and start together when the server frees; a batch of
b costs  max member execution + ``per_seq_overhead_s``·(b−1)  (the
sub-linear continuous-batching model, same formula as the DES).  A
member's reported latency reflects the batch state at its own admission;
``batch_size=1`` keeps the exact unbatched virtual-time bookkeeping.

REAL batched execution: a tier carrying a ``batched_executor`` (from
:func:`repro_torch.runtime.serving.build_executor` with
``kind="batched"``, or Marian's
:func:`repro_torch.nmt.transformer.make_executors`) serves
:meth:`CollaborativeEngine.submit_batch` — concurrent arrivals routed
to it are drained through a length-bucketed
:class:`~repro_torch.data.pipeline.TokenBatcher` into padded blocks of up to
``batch_size`` sequences, each block runs as ONE batched generate (the
compiled-scan decode path), and every member gets its own
``(m_out, tokens)`` plus the measured batch wall-clock in its latency —
execution finally matches the batch-aware occupancy accounting instead
of only being modelled by it.

CONTINUOUS in-flight batching: a tier carrying a ``continuous_session``
(a :class:`~repro_torch.runtime.serving.ContinuousGenerationSession`, or
any object with its ``admit``/``step``/``live_count``/``free_slots``
protocol) serves
:meth:`CollaborativeEngine.serve_continuous` — an event loop over a
virtual arrival schedule where the batch is re-formed BETWEEN decode
steps: finished rows evict and free their slot immediately, and queued
requests prefill into the freed slots of the live batch (EDF across
deadline values, FIFO within a deadline class).  Admission reuses the
same deadline-aware shed/reroute rule as ``submit`` with slot-table
space standing in for server space; each tier's virtual clock advances
by its *measured* prefill/step wall time, so reported latencies are
real compute under the modelled arrival process.  ``refill=False``
degenerates to block-to-completion scheduling (admit only into an
empty table) — the baseline the continuous benchmark compares against.

Deadline-aware admission (SLO): ``submit(..., deadline_s=...)`` attaches
a relative deadline.  When the chosen tier is full the engine re-routes
to the cheapest tier with space whose predicted total meets the
deadline, and **sheds** the request (``RequestResult.shed``) when no
tier can — instead of the blind force-enqueue used for deadline-less
requests.  ``stats()`` reports SLO attainment and shed counts alongside
the latency percentiles.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.calibration import OnlineCalibrator
from repro_torch.core.faults import (
    OPEN,
    CircuitBreaker,
    FaultSchedule,
    RetryPolicy,
    make_breakers,
)
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.core.latency_model import (
    ActivationCostModel,
    DeviceProfile,
    bytes_for_tokens,
)
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.scheduler import (
    MultiTierDecision,
    MultiTierScheduler,
    PlacementPlan,
    SchedTier,
)
from repro_torch.core.tx_estimator import LinkModel, TxEstimator
from repro_torch.runtime import telemetry


@dataclasses.dataclass
class Tier:
    """One compute tier (device NPU / edge gateway / regional pod / cloud).

    ``rtt_fn(now) -> rtt_seconds`` marks a REMOTE tier (a ConnectionProfile's
    ``rtt_at`` in experiments; a real prober in deployment); None marks a
    local tier.  ``servers`` bounds concurrent executions (batches); up
    to ``queue_capacity`` further requests wait in FIFO order (None =
    unbounded).

    ``batch_size`` > 1 makes each server a continuous-batching worker:
    queued requests coalesce (in virtual time) into batches of up to
    ``batch_size`` that start together when the server frees, a batch of
    b costing  max member exec + ``per_seq_overhead_s``·(b−1).  The
    overhead is calibratable from batched timing grids
    (``repro_torch.core.calibration.fit_batch_overhead``).

    ``batched_executor`` (``(block (b,w), lengths) -> [(m_out, tokens)]``,
    built by :func:`repro_torch.runtime.serving.build_executor` with
    ``kind="batched"`` or by Marian's
    :func:`repro_torch.nmt.transformer.make_executors`)
    makes execution itself batched: ``submit_batch`` drains concurrent
    arrivals into length-bucketed blocks of up to ``batch_size`` and runs
    each block as one real batched generate.  Per-request ``executor``
    calls (``submit``) stay per-sequence.
    """

    profile: DeviceProfile
    executor: Optional[Callable] = None   # tokens -> (m_out, out_tokens)
    name: Optional[str] = None
    rtt_fn: Optional[Callable[[float], float]] = None
    servers: int = 1
    queue_capacity: Optional[int] = None
    bandwidth_bps: float = 100e6
    batch_size: int = 1
    per_seq_overhead_s: float = 0.0
    batched_executor: Optional[Callable] = None   # (block, lengths) -> [...]
    # ContinuousGenerationSession — marks the tier for serve_continuous's
    # in-flight batching (slot-table space replaces server space there)
    continuous_session: Optional[object] = None
    # Split-placement legs (serving.build_executor kind="split"): the
    # tier can run just the encoder (tokens -> EncoderStates) and/or just
    # the decoder (EncoderStates -> (m_out, tokens)).  Both tiers of a
    # split plan need their respective leg for REAL execution; otherwise
    # the engine models the leg times from the profile planes.
    encode_executor: Optional[Callable] = None
    decode_executor: Optional[Callable] = None

    def __post_init__(self):
        if self.name is None:
            self.name = self.profile.name
        if self.servers < 1:
            raise ValueError("servers must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")

    def run(self, tokens: np.ndarray, m_hat: float,
            rng: np.random.Generator) -> tuple[int, float]:
        """Execute one request on this tier: returns
        ``(output_len_tokens, execution_seconds)``.

        With a real ``executor`` the time is measured wall-clock and
        ``m_out`` is the model's actual output length (ground truth);
        without one the tier is MODELLED — the time is drawn around the
        profile's plane at the *predicted* ``m_hat`` (an estimator
        input), and ``m_out`` is ``round(m_hat)``.  Exactly one of the
        two paths runs; the engine's accounting downstream is identical
        for both.
        """
        if self.executor is not None:
            t0 = time.perf_counter()
            m_out, _ = self.executor(tokens)
            return int(m_out), time.perf_counter() - t0
        # modelled: draw the true time around the plane at predicted M
        t = float(self.profile.true_time(float(len(tokens)), m_hat, rng))
        return int(max(round(m_hat), 1)), t


class _TierOccupancy:
    """Virtual-time FIFO bookkeeping for one tier: ``free_at`` holds each
    server's next-free time; assigned-but-not-started requests count
    against the bounded queue.

    With ``batch_size`` > 1 each server coalesces assignments: the last
    batch scheduled on a server stays *open* while its start time is
    still in the future, and new assignments join it (extending its
    finish by the max-exec/overhead rule) instead of queueing behind it.
    A joining member's reported service time is the batch duration as of
    its join — earlier members keep the (shorter) duration they saw,
    a deliberately causal per-request accounting.
    """

    def __init__(self, servers: int, batch_size: int = 1,
                 per_seq_overhead_s: float = 0.0):
        self.free_at = [0.0] * servers      # per-server next-free time
        self.batch_size = batch_size
        self.per_seq = per_seq_overhead_s
        # per-server open tail batch: [start, base_exec_max, count]
        self._tail: List[Optional[list]] = [None] * servers
        self.inflight: List[tuple] = []     # (start, finish), pruned lazily

    def _prune(self, now: float) -> None:
        self.inflight = [(s, f) for s, f in self.inflight if f > now]

    def queue_delay(self, now: float) -> float:
        d = min(self.free_at) - now
        return d if d > 0.0 else 0.0

    def free_servers(self, now: float) -> int:
        return sum(1 for f in self.free_at if f <= now)

    def queue_len(self, now: float) -> int:
        self._prune(now)
        return sum(1 for s, _ in self.inflight if s > now)

    def assign(self, now: float, exec_s: float) -> tuple[float, float]:
        """FIFO-assign one request; returns (wait, service_s) — the
        T_queue it experiences and the duration of the service (solo
        exec, or its batch's duration as of joining)."""
        self._prune(now)                 # keep inflight bounded over time
        if self.batch_size > 1:
            open_idx = [s for s, t in enumerate(self._tail)
                        if t is not None and t[0] > now
                        and t[2] < self.batch_size]
            if open_idx:
                s = min(open_idx, key=lambda j: self._tail[j][0])
                tail = self._tail[s]
                tail[1] = max(tail[1], exec_s)
                tail[2] += 1
                service = tail[1] + self.per_seq * (tail[2] - 1)
                finish = tail[0] + service
                self.free_at[s] = finish
                self.inflight.append((tail[0], finish))
                return tail[0] - now, service
        idx = min(range(len(self.free_at)), key=self.free_at.__getitem__)
        earliest = self.free_at[idx]
        wait = earliest - now
        if wait <= 0.0:
            wait = 0.0
        start = now + wait
        finish = start + exec_s
        self.free_at[idx] = finish
        if self.batch_size > 1:
            # a future-start batch stays open for joins; a batch that
            # started immediately is already running and cannot be joined
            self._tail[idx] = [start, exec_s, 1] if start > now else None
        self.inflight.append((start, finish))
        return wait, exec_s

    def assign_batch(self, now: float, exec_s: float,
                     count: int) -> tuple[float, float]:
        """Book one REAL batch of ``count`` members, measured to take
        ``exec_s``, on the earliest-free server; every member shares the
        (wait, service).  The batch is closed — it started as a unit, so
        later virtual-time arrivals queue behind it instead of joining."""
        self._prune(now)
        idx = min(range(len(self.free_at)), key=self.free_at.__getitem__)
        wait = max(self.free_at[idx] - now, 0.0)
        start = now + wait
        finish = start + exec_s
        self.free_at[idx] = finish
        self._tail[idx] = None
        self.inflight.extend([(start, finish)] * count)
        return wait, exec_s


@dataclasses.dataclass
class RequestResult:
    """One request's terminal record (served or shed).

    All ``*_s`` fields are seconds of the engine's virtual clock;
    ``latency_s`` is what the client experienced end to end (queue wait
    + execution + link legs + any retry delays), ground truth rather
    than the scheduler's prediction — the prediction that routed the
    request is preserved in ``decision``.  Appending fields (with
    defaults) is backward-compatible; the existing fields are pinned by
    the bit-for-bit engine-semantics tests.
    """

    req_id: int
    device: int           # tier index (EDGE/CLOUD for the 2-tier config);
                          # -1 when the request was shed
    n: int
    m_out: int
    latency_s: float      # queue wait + execution + (tx if offloaded);
                          # NaN when shed
    decision: MultiTierDecision
    wait_s: float = 0.0
    tier_name: str = ""
    # free-form client label (e.g. loadgen's scenario/workload-mix tag);
    # never read by routing — observability only
    tag: Optional[str] = None
    deadline_s: Optional[float] = None   # relative SLO, None = no deadline
    shed: bool = False    # dropped by deadline-aware admission control
    # the executed placement; None on the scalar path, whole(device) or
    # split(e, d) when the plan-aware scheduler routed the request —
    # ``device`` stays the DECODE tier either way
    plan: Optional[PlacementPlan] = None
    # fault-tolerance bookkeeping: dispatch attempts consumed (1 = clean
    # first-try service), tiers that failed this request along the way,
    # and — on shed responses — the backpressure hint telling the client
    # when re-submitting is predicted to succeed
    attempts: int = 1
    failed_tiers: tuple = ()
    retry_after_s: Optional[float] = None

    @property
    def slo_met(self) -> Optional[bool]:
        """True/False for deadline-carrying requests, None otherwise."""
        if self.deadline_s is None:
            return None
        return (not self.shed) and self.latency_s <= self.deadline_s


class CollaborativeEngine:
    """Queue-aware N-tier serving under the generalized C-NMT rule.

    Construct with ``tiers=[...]``, each Tier carrying its own ``rtt_fn``
    when remote.  (The reference's deprecated ``edge=, cloud=, rtt_fn=``
    keywords are not carried over: the port has no callers of them.)

    ``refit_interval`` (beyond paper) closes the feedback loop: every K
    completed requests an :class:`OnlineCalibrator` refits the
    scheduler's per-tier planes and the LinearN2M regressor from the
    observed (N, M_out, T_exe) samples; the scheduler then operates on
    its own model copies so ground-truth tier profiles stay untouched.
    """

    def __init__(self, *, n2m: LinearN2M,
                 tiers: Sequence[Tier],
                 bytes_per_token: int = 2,
                 hedge_margin_s: float = 0.0,
                 seed: int = 0,
                 refit_interval: Optional[int] = None,
                 links: Optional[LinkModel] = None,
                 inter_rtt_fns: Optional[Dict] = None,
                 activation: Optional[ActivationCostModel] = None,
                 allow_split: bool = False,
                 explore_eps: float = 0.0,
                 faults: Optional[FaultSchedule] = None,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.tiers: List[Tier] = list(tiers)
        if not self.tiers:
            raise ValueError("need at least one tier")

        sched_tiers = []
        for t in self.tiers:
            model = t.profile.model
            if refit_interval is not None:
                model = dataclasses.replace(model)   # scheduler-owned copy
            tx = None
            if t.rtt_fn is not None:
                tx = TxEstimator(init_rtt_s=float(t.rtt_fn(0.0)),
                                 bandwidth_bps=t.bandwidth_bps)
            sched_tiers.append(SchedTier(
                t.name, model, tx, batch_size=t.batch_size,
                per_seq_overhead_s=t.per_seq_overhead_s))
        n2m_model = dataclasses.replace(n2m) if refit_interval is not None \
            else n2m
        self.scheduler = MultiTierScheduler(
            sched_tiers, n2m_model, bytes_per_token=bytes_per_token,
            hedge_margin_s=hedge_margin_s,
            links=links, activation=activation, allow_split=allow_split,
            explore_eps=explore_eps, explore_seed=seed)
        self.calibrator = None if refit_interval is None else \
            OnlineCalibrator(len(self.tiers), interval=refit_interval)
        # ground-truth RTT processes for inter-tier links, keyed (i, j);
        # the scheduler's LinkModel holds the *estimators* those feed
        self._inter_rtt_fns = dict(inter_rtt_fns or {})
        self.split_count = 0

        self._occ = [_TierOccupancy(t.servers, t.batch_size,
                                    t.per_seq_overhead_s)
                     for t in self.tiers]
        self.rng = np.random.default_rng(seed)
        self.results: List[RequestResult] = []
        # completion callback (loadgen hook): invoked with each terminal
        # RequestResult — after any fault-tolerant retry adjustments —
        # once per request, in completion order for ``submit`` and in
        # request order for the batch/continuous entry points.  Closed-
        # loop load generators hang their next-issue logic off it.
        # ``None`` (default) is a strict no-op: no behaviour change.
        self.on_complete: Optional[Callable[[RequestResult], None]] = None
        self.rejected = np.zeros(len(self.tiers), np.int64)
        self.shed_count = np.zeros(len(self.tiers), np.int64)
        self._t0 = time.perf_counter()
        self._next_id = 0

        # -- fault tolerance ---------------------------------------------
        # ``faults`` is injection ground truth the dispatcher never routes
        # on; routing health comes from the per-tier breakers.  Arming
        # either knob switches ``submit`` to the retry/failover dispatch
        # loop; with an empty schedule that loop is pinned bit-for-bit
        # identical to the plain path (tests enforce it).
        self.faults = faults
        self.retry = retry
        self._ft = faults is not None or retry is not None \
            or breaker is not None
        self.breakers = make_breakers(len(self.tiers), breaker) \
            if self._ft else None
        # retry jitter draws from a dedicated stream so arming faults
        # never perturbs ``self.rng``'s modelled-execution draws
        self._fault_rng = np.random.default_rng(seed + 0x5EED) \
            if self._ft else None
        self.fault_failures = np.zeros(len(self.tiers), np.int64)
        self.retry_count = 0        # re-dispatches after a failed attempt
        self.failover_count = 0     # served requests that needed >1 attempt
        self.fault_lost = 0         # shed because retries ran out / expired
        self.decode_failovers = 0   # split decode legs re-homed mid-plan

    # convenience handles for the 2-tier configuration ---------------------
    @property
    def edge(self) -> Tier:
        return self.tiers[0]

    @property
    def cloud(self) -> Tier:
        return self.tiers[1]

    @property
    def tx(self) -> Optional[TxEstimator]:
        """First remote tier's link estimator (the §II-C state)."""
        for st in self.scheduler.tiers:
            if st.tx is not None:
                return st.tx
        return None

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _notify(self, res: RequestResult,
                tag: Optional[str]) -> RequestResult:
        """Terminal-result hook tail: attach the client's ``tag`` and
        fire ``on_complete``.  Called exactly once per request by the
        public entry points, after all latency adjustments."""
        if tag is not None:
            res.tag = tag
        if self.on_complete is not None:
            self.on_complete(res)
        return res

    # ------------------------------------------------------------- submit --
    def submit(self, tokens: np.ndarray, *, now_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               tag: Optional[str] = None) -> RequestResult:
        """Route and (virtually) serve one request.

        ``deadline_s`` is a relative SLO (seconds from ``now_s``): the
        deadline-aware admission path may shed the request (returned
        with ``shed=True`` and NaN latency) when no tier is predicted to
        meet it.  ``tag`` is a free-form client label copied onto the
        result (per-request tagging for load generators); routing never
        reads it.  ``on_complete`` (if set) fires with the final result
        before this returns.

        With fault tolerance armed (``faults``/``retry``/``breaker``)
        dispatch goes through the bounded-retry failover loop: a failed
        attempt trips the tier's circuit breaker, waits out the detection
        timeout + backoff, and re-runs the placement decision with
        unhealthy tiers excluded — the degradation ladder split →
        whole-remote → edge-only → shed.
        """
        now = self._now() if now_s is None else now_s
        if self._ft:
            res = self._submit_ft(tokens, now, deadline_s)
        else:
            res = self._submit_once(tokens, now, deadline_s)
        return self._notify(res, tag)

    def _submit_once(self, tokens: np.ndarray, now: float,
                     deadline_s: Optional[float]) -> RequestResult:
        """The fault-free dispatch path (the plain `submit` body)."""
        n = int(len(tokens))
        qd = [occ.queue_delay(now) for occ in self._occ]
        if self.scheduler._split_ready():
            d = self.scheduler.decide_plan(n, now, qd)
        else:
            d = self.scheduler.decide(n, now, qd)
        k = self._admit(d, now, deadline_s)
        if k < 0:                       # shed: never enters any queue
            return self._shed(n, d, deadline_s,
                              retry_after_s=self._retry_after(now))
        if (d.plan is not None and d.plan.is_split
                and k == d.plan.decode_tier
                and self._has_space(d.plan.encode_tier, now)):
            return self._submit_split(np.asarray(tokens, np.int32), d, now,
                                      deadline_s)
        tier = self.tiers[k]
        m_out, exec_s = tier.run(tokens, d.m_hat, self.rng)
        wait, service_s = self._occ[k].assign(now, exec_s)
        return self._complete(k, d, n, m_out, exec_s, wait, service_s, now,
                              deadline_s)

    # ---------------------------------------------- fault-tolerant submit --
    def _injected_failure(self, k: int, t: float) -> Optional[str]:
        """Injection check at dispatch: 'down' (crashed tier — connection
        refused, fails fast), 'blackhole' (silent packet loss on the
        client link — fails only after the full timeout), or None."""
        if self.faults is None:
            return None
        if self.faults.tier_down(k, t):
            return "down"
        if self.tiers[k].rtt_fn is not None \
                and self.faults.link_blackhole(k, t):
            return "blackhole"
        return None

    def _record_failure(self, k: int, t: float) -> None:
        self.fault_failures[k] += 1
        self.breakers[k].record_failure(t)

    def _record_success(self, k: int) -> None:
        """Successful completion on tier k; on breaker recovery
        (OPEN/HALF_OPEN → CLOSED) the tier's link state is stale by
        construction — an estimate warmed before/through the outage —
        so it is invalidated wholesale (satellite: TxEstimator reset)."""
        if not self.breakers[k].record_success():
            return
        st = self.scheduler.tiers[k]
        if st.tx is not None:
            st.tx.invalidate()
        if self.scheduler.links is not None:
            self.scheduler.links.invalidate(k)

    def _retry_after(self, now: float) -> float:
        """Backpressure hint for shed responses: predicted
        seconds until SOME tier could accept work — the best over tiers
        of queue drain, plus the breaker's probe cool-down when open."""
        best = math.inf
        for k, occ in enumerate(self._occ):
            t = occ.queue_delay(now)
            if self.breakers is not None and self.breakers[k].state == OPEN:
                t = max(t, self.breakers[k].time_to_probe(now))
            best = min(best, t)
        return best if math.isfinite(best) else 0.0

    def _submit_ft(self, tokens: np.ndarray, now: float,
                   deadline_s: Optional[float]) -> RequestResult:
        """Bounded-retry failover dispatch (tentpole).

        Per attempt: mask = this request's already-failed tiers ∪ tiers
        whose breaker refuses dispatch; re-run the placement decision
        excluding the mask; on an injected (or real executor) failure,
        trip the breaker, advance the virtual clock by the detection
        time + exponential backoff with jitter, and go again.  The
        request is shed when every tier is masked (with a
        ``retry_after_s`` hint), when the retry budget runs out, or when
        its deadline expires mid-retry."""
        n = int(len(tokens))
        now0 = now
        t = now
        budget = 0 if self.retry is None else self.retry.max_retries
        failed: list = []           # order preserved for the result record
        attempts = 0
        while True:
            attempts += 1
            mask = set(failed)
            mask.update(k for k in range(len(self.tiers))
                        if not self.breakers[k].allow(t))
            if len(mask) >= len(self.tiers):
                # every tier dark: shed with the backpressure hint
                self.fault_lost += 1
                d = MultiTierDecision(0, tuple([math.inf] * len(self.tiers)),
                                      self.scheduler.m_hat(n))
                return self._shed(n, d, deadline_s,
                                  retry_after_s=self._retry_after(t),
                                  attempts=attempts,
                                  failed_tiers=tuple(failed))
            exclude = frozenset(mask) if mask else None
            qd = [occ.queue_delay(t) for occ in self._occ]
            if self.scheduler._split_ready():
                d = self.scheduler.decide_plan(n, t, qd, exclude=exclude)
            else:
                d = self.scheduler.decide(n, t, qd, exclude=exclude)
            rem_dl = None if deadline_s is None \
                else deadline_s - (t - now0)
            if rem_dl is not None and rem_dl <= 0.0:
                self.fault_lost += 1
                return self._shed(n, d, deadline_s,
                                  retry_after_s=self._retry_after(t),
                                  attempts=attempts,
                                  failed_tiers=tuple(failed))
            allowed = (lambda j, m=frozenset(mask): j not in m) \
                if mask else None
            k = self._admit(d, t, rem_dl, allowed=allowed)
            if k < 0:               # admission shed (queues, not faults)
                return self._shed(n, d, deadline_s,
                                  retry_after_s=self._retry_after(t),
                                  attempts=attempts,
                                  failed_tiers=tuple(failed))
            if (d.plan is not None and d.plan.is_split
                    and k == d.plan.decode_tier
                    and self._injected_failure(d.plan.encode_tier, t) is None
                    and self._has_space(d.plan.encode_tier, t)):
                res = self._submit_split(np.asarray(tokens, np.int32), d, t,
                                         deadline_s)
                # res.device is the tier that actually decoded — the
                # planned one, or the failover target when it died mid-plan
                return self._finish_ft(res, res.device, t, now0, attempts,
                                       failed)
            tier = self.tiers[k]
            fail = self._injected_failure(k, t)
            m_out = exec_s = None
            if fail is None:
                try:
                    m_out, exec_s = tier.run(tokens, d.m_hat, self.rng)
                except Exception:
                    fail = "down"   # a real executor raising = crashed
            if fail is not None:
                self._record_failure(k, t)
                failed.append(k)
                detect = RetryPolicy().detect_s(fail == "blackhole") \
                    if self.retry is None \
                    else self.retry.detect_s(fail == "blackhole")
                if attempts > budget:
                    self.fault_lost += 1
                    return self._shed(n, d, deadline_s,
                                      retry_after_s=self._retry_after(
                                          t + detect),
                                      attempts=attempts,
                                      failed_tiers=tuple(failed))
                t = t + detect + self.retry.backoff(attempts - 1,
                                                    self._fault_rng)
                self.retry_count += 1
                continue
            if self.faults is not None:
                s = self.faults.slowdown(k, t)
                if s != 1.0:        # straggler window: degraded, not failed
                    exec_s *= s
            wait, service_s = self._occ[k].assign(t, exec_s)
            res = self._complete(k, d, n, m_out, exec_s, wait, service_s, t,
                                 deadline_s)
            return self._finish_ft(res, k, t, now0, attempts, failed)

    def _finish_ft(self, res: RequestResult, k: int, t: float, now0: float,
                   attempts: int, failed: list) -> RequestResult:
        """Shared success tail of the failover loop: breaker/link-state
        bookkeeping plus folding the retry delays into the latency."""
        self._record_success(k)
        # combine with what _submit_split already recorded (a decode-leg
        # failover inside the plan counts as its own extra attempt)
        res.attempts += attempts - 1
        res.failed_tiers = tuple(failed) + res.failed_tiers
        if t != now0:               # detection + backoff time is real
            res.latency_s += t - now0
        if res.attempts > 1:
            self.failover_count += 1
        return res

    # -------------------------------------------------------- split plans --
    def _ship_time(self, e: int, k: int, now: float,
                   payload_bytes: float) -> float:
        """True one-way activation-shipping time e→k, feeding the link's
        estimator when a ground-truth RTT process is registered."""
        fn = self._inter_rtt_fns.get((e, k))
        est = self.scheduler.links.link(e, k)
        if fn is not None:
            rtt = float(fn(now))
            bw = est.bandwidth_bps if est is not None else 100e6
            if self.faults is not None:
                # an inter-tier hop degrades when EITHER endpoint's link
                # is in an episode; overlapping episodes compound
                for end in (e, k):
                    rf, bf = self.faults.link_factors(end, now)
                    if rf != 1.0 or bf != 1.0:
                        rtt *= rf
                        bw *= bf
            if est is not None:
                self.scheduler.links.observe(e, k, now, rtt)
            return rtt / 2.0 + payload_bytes * 8.0 / bw
        # no truth process: the estimate is the model (multi-hop included)
        return self.scheduler.links.tx_time(e, k, now, payload_bytes,
                                            one_way=True)

    def _client_leg(self, k: int, now: float, tokens: float) -> float:
        """One-way client-link time for ``tokens`` tokens to/from tier k
        (0 for a local tier): rtt/2 + serialization."""
        tier = self.tiers[k]
        if tier.rtt_fn is None:
            return 0.0
        rtt = float(tier.rtt_fn(now))
        bw = tier.bandwidth_bps
        if self.faults is not None:
            rf, bf = self.faults.link_factors(k, now)
            if rf != 1.0 or bf != 1.0:
                rtt *= rf
                bw *= bf
        tx = self.scheduler.tiers[k].tx
        if tx is not None:
            tx.observe(now, rtt)
        payload = float(bytes_for_tokens(tokens, self.scheduler.bytes_per_token))
        return rtt / 2.0 + payload * 8.0 / bw

    def _submit_split(self, tokens: np.ndarray, d: MultiTierDecision,
                      now: float, deadline_s: Optional[float]
                      ) -> RequestResult:
        """Execute a split plan: encode on tier e, ship the encoder
        states over the e→d link, decode on tier d.  Both legs' occupancy
        is charged (the decode leg joining tier d's virtual queue at its
        states-arrival time), and every traversed link feeds its RTT
        estimator.  With real split executors on both tiers the leg times
        are measured wall-clock and the payload is the states' actual
        wire size; otherwise legs are modelled from the profile planes
        (``DeviceProfile.true_leg_times``) and the payload priced by the
        scheduler's ActivationCostModel."""
        plan = d.plan
        e, k = plan.encode_tier, plan.decode_tier
        enc_tier = self.tiers[e]
        n = int(len(tokens))
        real = (enc_tier.encode_executor is not None
                and self.tiers[k].decode_executor is not None)
        if real:
            t0 = time.perf_counter()
            states = enc_tier.encode_executor(tokens)
            t_enc = time.perf_counter() - t0
            payload = float(states.payload_bytes())
        else:
            states = None
            t_enc = float(enc_tier.profile.true_leg_times(
                float(n), d.m_hat, self.rng)[0])
            payload = float(self.scheduler.activation.payload_bytes(n))
        if self.faults is not None:
            s = self.faults.slowdown(e, now)
            if s != 1.0:
                t_enc *= s

        up = self._client_leg(e, now, n)
        wait_e, svc_e = self._occ[e].assign(now, t_enc)
        ship = self._ship_time(e, k, now, payload)
        dec_arrival = now + up + wait_e + svc_e + ship

        # decode-leg failover (tentpole): the planned decode tier died
        # while the encoder states were in flight.  The states survive at
        # the ENCODE tier, so recovery re-ships them to a healthy decode
        # target (possibly tier e itself — decode-local) instead of
        # re-running the whole request from the prompt.
        k_exec, dec_dispatch, extra, failed_dec = k, dec_arrival, 0.0, ()
        if self._ft:
            fail = self._injected_failure(k, dec_arrival)
            if fail is not None:
                self._record_failure(k, dec_arrival)
                pol = self.retry if self.retry is not None else RetryPolicy()
                detect = pol.detect_s(fail == "blackhole")
                k2 = -1 if self.retry is None else \
                    self._decode_failover_target(e, k, dec_arrival + detect,
                                                 real, d.m_hat, payload)
                if k2 < 0:          # no retries, or nowhere healthy left
                    self.fault_lost += 1
                    return self._shed(
                        n, d, deadline_s,
                        retry_after_s=self._retry_after(dec_arrival + detect),
                        attempts=2, failed_tiers=(k,))
                backoff = pol.backoff(0, self._fault_rng)
                t2 = dec_arrival + detect + backoff
                reship = 0.0 if k2 == e else \
                    self._ship_time(e, k2, t2, payload)
                k_exec, dec_dispatch = k2, t2 + reship
                extra = detect + backoff + reship
                failed_dec = (k,)
                self.decode_failovers += 1
                self.retry_count += 1

        dec_tier = self.tiers[k_exec]
        if real and dec_tier.decode_executor is not None:
            t0 = time.perf_counter()
            m_out, _ = dec_tier.decode_executor(states)
            t_dec = time.perf_counter() - t0
            m_out = int(m_out)
        else:
            t_dec = float(dec_tier.profile.true_leg_times(
                float(n), d.m_hat, self.rng)[1])
            m_out = int(max(round(d.m_hat), 1))
        if self.faults is not None:
            s = self.faults.slowdown(k_exec, dec_dispatch)
            if s != 1.0:
                t_dec *= s

        wait_d, svc_d = self._occ[k_exec].assign(dec_dispatch, t_dec)
        down = self._client_leg(k_exec, now, m_out)
        latency = up + wait_e + svc_e + ship + extra + wait_d + svc_d + down

        res = RequestResult(self._next_id, k_exec, n, m_out, latency, d,
                            wait_s=wait_e + wait_d, tier_name=dec_tier.name,
                            deadline_s=deadline_s,
                            plan=(plan if k_exec == k
                                  else PlacementPlan.split(e, k_exec)),
                            attempts=2 if failed_dec else 1,
                            failed_tiers=failed_dec)
        self._next_id += 1
        self.results.append(res)
        self.split_count += 1
        # calibrator feedback skipped: leg samples are half-planes
        # (alpha_n-only / alpha_m-only) and would corrupt the full fit
        return res

    def _decode_failover_target(self, e: int, k_failed: int, t: float,
                                need_real: bool, m_hat: float,
                                payload: float) -> int:
        """Cheapest healthy tier to re-home a split plan's decode leg on:
        predicted queue drain + states re-ship + decode-leg cost.  With
        REAL split executors only decode-capable tiers can consume the
        shipped states, so those are preferred; -1 when nothing healthy
        remains (caller sheds)."""
        cands = [j for j in range(len(self.tiers))
                 if j != k_failed and self.breakers[j].allow(t)
                 and self._injected_failure(j, t) is None]
        if not cands:
            return -1
        if need_real:
            real_c = [j for j in cands
                      if self.tiers[j].decode_executor is not None]
            if real_c:
                cands = real_c

        def cost(j: int) -> float:
            st = self.scheduler.tiers[j]
            t_dec = st.model.alpha_m * m_hat + 0.5 * st.model.beta
            ship = 0.0 if j == e else self.scheduler.links.tx_time(
                e, j, t, payload, one_way=True)
            return self._occ[j].queue_delay(t) + ship + t_dec

        return min(cands, key=cost)

    def _shed(self, n: int, d: MultiTierDecision,
              deadline_s: Optional[float], *,
              retry_after_s: Optional[float] = None,
              attempts: int = 1,
              failed_tiers: tuple = ()) -> RequestResult:
        res = RequestResult(self._next_id, -1, n, 0, float("nan"), d,
                            deadline_s=deadline_s, shed=True,
                            attempts=attempts, failed_tiers=failed_tiers,
                            retry_after_s=retry_after_s)
        self._next_id += 1
        self.results.append(res)
        return res

    def _complete(self, k: int, d: MultiTierDecision, n: int, m_out: int,
                  exec_s: float, wait: float, service_s: float, now: float,
                  deadline_s: Optional[float]) -> RequestResult:
        """Shared completion bookkeeping: link terms, result record,
        online-calibration feedback.  ``exec_s`` is the execution sample
        fed to the calibrator (for a real batch: the batch wall-clock,
        an upper bound on the member's solo cost — feedback noise the
        refit's robust plane fit tolerates)."""
        tier = self.tiers[k]
        if tier.rtt_fn is not None:
            rtt = float(tier.rtt_fn(now))
            payload = float(bytes_for_tokens(
                n + m_out, self.scheduler.bytes_per_token))
            tx = self.scheduler.tiers[k].tx
            bw = tx.bandwidth_bps
            if self.faults is not None:
                # degradation episode on the client link: the TRUE rtt
                # spikes / bandwidth collapses; the estimator observes
                # the degraded value — that is what measurement sees
                rf, bf = self.faults.link_factors(k, now)
                if rf != 1.0 or bf != 1.0:
                    rtt *= rf
                    bw *= bf
            net = service_s + rtt + payload * 8.0 / bw
            # §II-C timestamp mechanism, per link.  Stamped with the
            # submit clock (monotone across calls): this synchronous
            # engine ingests the sample when it resolves the request, and
            # a completion-time stamp would let one long request park the
            # estimator's clock in the virtual future, making the stale
            # guard drop every faster request's sample until then.
            tx.observe(now, rtt)
        else:
            net = service_s
        latency = wait + net

        res = RequestResult(self._next_id, k, n, m_out, latency, d,
                            wait_s=wait, tier_name=tier.name,
                            deadline_s=deadline_s,
                            plan=(PlacementPlan.whole(k)
                                  if d.plan is not None else None))
        self._next_id += 1
        self.results.append(res)
        if self.calibrator is not None:
            if self.calibrator.record(k, n, m_out, exec_s):
                self.calibrator.refit(
                    [st.model for st in self.scheduler.tiers],
                    self.scheduler.n2m)
        return res

    # -------------------------------------------------------- submit_batch --
    def submit_batch(self, requests: Sequence[np.ndarray], *,
                     now_s: Optional[float] = None,
                     deadline_s: Optional[float] = None,
                     tag: Optional[str] = None,
                     ) -> List[RequestResult]:
        """Route and serve a slot of CONCURRENT requests with real
        batched execution.

        Each request is routed/admitted individually (same decision rule
        and deadline shedding as :meth:`submit`); requests landing on the
        same tier are drained through a length-bucketed
        :class:`TokenBatcher` into padded blocks of up to that tier's
        ``batch_size`` and — where the tier carries a
        ``batched_executor`` — each block runs as ONE real batched
        generate whose measured wall-clock is booked as a single batch
        occupancy (``assign_batch``).  Tiers without a batched executor
        fall back to the per-request path.  Results come back in request
        order.

        Concurrent-slot semantics: all members are decided at the same
        ``now`` (they arrived together), but earlier same-slot members
        COUNT against the bounded queues (``pending``), so a slot cannot
        oversubscribe a capacity the sequential path would enforce.
        Deadline feasibility still uses slot-start predictions — the
        queueing a member induces on its batch peers shows up in their
        measured latency, not in their admission test.

        With :mod:`~repro_torch.runtime.telemetry`'s spans on, the call
        is a ``repro_torch.engine.submit_batch`` span holding ``route``
        (the decide/admit loop), ``batch`` (the batcher's work),
        ``execute`` (one block's ``batched_executor`` call, a block of
        its own, with ``rows``, ``width`` and the ``requests``' indices
        in this call) and ``complete`` (a block's completion bookkeeping,
        and the results' notification at the end).
        """
        with telemetry.span("repro_torch.engine.submit_batch"):
            return self._submit_batch(requests, now_s, deadline_s, tag)

    def _submit_batch(self, requests, now_s, deadline_s, tag):
        now = self._now() if now_s is None else now_s
        if self._ft:
            # fault-tolerant batch serving degenerates to per-request
            # failover dispatch: a member's failure/retry timeline is
            # per-request state a shared batched generate cannot carry
            return [self._notify(self._submit_ft(np.asarray(t, np.int32),
                                                 now, deadline_s), tag)
                    for t in requests]
        results: List[Optional[RequestResult]] = [None] * len(requests)
        groups: Dict[int, List[tuple]] = {}
        pending = [0] * len(self.tiers)
        split_ready = self.scheduler._split_ready()
        with telemetry.span("repro_torch.engine.route"):
            for i, tokens in enumerate(requests):
                tokens = np.asarray(tokens, np.int32)
                n = int(len(tokens))
                qd = [occ.queue_delay(now) for occ in self._occ]
                d = (self.scheduler.decide_plan(n, now, qd) if split_ready
                     else self.scheduler.decide(n, now, qd))
                k = self._admit(d, now, deadline_s, pending)
                if k < 0:
                    results[i] = self._shed(n, d, deadline_s)
                    continue
                pending[k] += 1
                if (d.plan is not None and d.plan.is_split
                        and k == d.plan.decode_tier
                        and self._has_space(d.plan.encode_tier, now,
                                            pending)):
                    # split members run per-request: their decode leg
                    # enters tier k's virtual queue at its own
                    # states-arrival time, which a shared batch block
                    # could not represent
                    results[i] = self._submit_split(tokens, d, now,
                                                    deadline_s)
                    continue
                groups.setdefault(k, []).append((i, tokens, d))

        for k, members in groups.items():
            tier = self.tiers[k]
            if tier.batched_executor is None:
                for i, toks, d in members:
                    m_out, exec_s = tier.run(toks, d.m_hat, self.rng)
                    wait, service_s = self._occ[k].assign(now, exec_s)
                    results[i] = self._complete(
                        k, d, len(toks), m_out, exec_s, wait, service_s,
                        now, deadline_s)
                continue
            with telemetry.span("repro_torch.engine.batch"):
                # keyed by the request's index in this call
                tb = TokenBatcher(max_batch=max(tier.batch_size, 1))
                member = {}
                for i, toks, d in members:
                    tb.add(i, toks)
                    member[i] = (toks, d)
            while True:
                with telemetry.span("repro_torch.engine.batch"):
                    nb = tb.next_batch()
                if nb is None:
                    break
                ids, block = nb
                lens = [len(member[i][0]) for i in ids]
                with telemetry.span("repro_torch.engine.execute", block=True,
                                    rows=len(ids), width=block.shape[1],
                                    requests=ids) as run:
                    t0 = time.perf_counter()
                    outs = tier.batched_executor(block, lens)
                    exec_s = time.perf_counter() - t0
                with telemetry.span("repro_torch.engine.complete",
                                    block=run.block):
                    wait, service_s = self._occ[k].assign_batch(
                        now, exec_s, len(ids))
                    for i, (m_out, _) in zip(ids, outs):
                        toks, d = member[i]
                        results[i] = self._complete(
                            k, d, len(toks), int(m_out), exec_s, wait,
                            service_s, now, deadline_s)
        with telemetry.span("repro_torch.engine.complete"):
            return [self._notify(r, tag) for r in results]

    # ---------------------------------------------------- serve_continuous --
    def serve_continuous(self, requests: Sequence[np.ndarray], *,
                         arrival_s: Optional[Sequence[float]] = None,
                         deadline_s: Union[None, float,
                                           Sequence[Optional[float]]] = None,
                         max_new: int = 16,
                         refill: bool = True) -> List[RequestResult]:
        """Serve a virtual arrival schedule with CONTINUOUS in-flight
        batching on every tier that carries a ``continuous_session``.

        The event loop interleaves three things per tier step:

        1. requests whose ``arrival_s`` has passed are routed
           (``scheduler.decide`` with live backlog estimates) and admitted
           under the same deadline-aware shed/reroute rule as ``submit``
           — slot-table space (free slots, then the bounded wait queue)
           standing in for server space;
        2. freed slots are refilled from the tier's wait queue — EDF
           across deadline values, FIFO within a deadline class — by
           prefilling the dequeued prompts INTO the live batch;
        3. one decode step runs over the whole slot table; rows that
           finish evict and complete at the tier's clock.

        Each continuous tier's virtual clock advances by its *measured*
        prefill/step wall-clock, so latencies are real compute laid onto
        the modelled arrival process (warm the session's shapes first
        when benchmarking — compiles are billed to the requests that
        trigger them).  Tiers without a session serve routed requests
        through the usual virtual-time path, so mixed fleets work.

        ``refill=False`` is the block-to-completion baseline: a
        tier admits only into an EMPTY table, and the block runs until
        every member finished.  ``deadline_s`` is a scalar applied to all
        requests or a per-request sequence.  Results come back in request
        order; shed requests carry a shed record (``shed=True``).
        """
        sessions = {k: t.continuous_session
                    for k, t in enumerate(self.tiers)
                    if t.continuous_session is not None}
        if not sessions:
            raise ValueError("serve_continuous needs at least one tier "
                             "with a continuous_session")
        n_req = len(requests)
        if arrival_s is None:
            arrival_s = [0.0] * n_req
        if deadline_s is None or isinstance(deadline_s, (int, float)):
            deadlines = [deadline_s] * n_req
        else:
            deadlines = list(deadline_s)
        order = sorted(range(n_req), key=lambda i: (arrival_s[i], i))
        results: List[Optional[RequestResult]] = [None] * n_req
        # per-tier wait queue: (deadline-class key, fifo seq, req, ...)
        queues: Dict[int, list] = {k: [] for k in sessions}
        tclock = {k: 0.0 for k in sessions}   # tier virtual clock
        svc_ewma = {k: 0.0 for k in sessions}
        inflight: Dict[int, tuple] = {}       # req -> (k, d, n, arr, dl, t_admit)
        seq = 0
        ptr = 0
        now = 0.0

        def queue_est(k: int) -> float:
            if k not in sessions:
                return self._occ[k].queue_delay(now)
            s = sessions[k]
            if s.free_slots > len(queues[k]):
                return max(tclock[k] - now, 0.0)
            waves = 1 + len(queues[k]) // max(s.max_slots, 1)
            return max(tclock[k] - now, 0.0) + svc_ewma[k] * waves

        def drain(k: int) -> None:
            """Refill free slots of tier k from its wait queue, then run
            one decode step; completions land at the advanced clock."""
            s = sessions[k]
            if queues[k] and (refill or s.live_count == 0):
                take = min(s.free_slots, len(queues[k]))
                if take:
                    wave = [heapq.heappop(queues[k]) for _ in range(take)]
                    t0 = time.perf_counter()
                    s.admit([w[3] for w in wave], max_new=max_new,
                            req_ids=[w[2] for w in wave])
                    tclock[k] = now + (time.perf_counter() - t0)
                    for _, _, i, toks, d, arr, dl in wave:
                        inflight[i] = (k, d, len(toks), arr, dl, now)
            if s.live_count:
                t0 = time.perf_counter()
                _, finished = s.step()
                tclock[k] = max(tclock[k], now) + (time.perf_counter() - t0)
                for rid, m_out, _toks in finished:
                    k2, d, n, arr, dl, t_adm = inflight.pop(rid)
                    wait = t_adm - arr
                    service = tclock[k] - t_adm
                    svc_ewma[k] = service if svc_ewma[k] == 0.0 else \
                        0.8 * svc_ewma[k] + 0.2 * service
                    results[rid] = self._complete(
                        k2, d, n, m_out, service, wait, service,
                        tclock[k], dl)

        while ptr < n_req or inflight or any(queues.values()):
            cand = [tclock[k] for k in sessions
                    if queues[k] or sessions[k].live_count]
            if ptr < n_req:
                cand.append(arrival_s[order[ptr]])
            now = max(now, min(cand))

            while ptr < n_req and arrival_s[order[ptr]] <= now:
                i = order[ptr]
                ptr += 1
                toks = np.asarray(requests[i], np.int32).reshape(-1)
                n = int(len(toks))
                dl = deadlines[i]
                qd = [queue_est(j) for j in range(len(self.tiers))]
                d = self.scheduler.decide(n, now, qd)

                def cont_space(j: int, n: int = n) -> bool:
                    if j not in sessions:
                        return self._has_space(j, now)
                    s = sessions[j]
                    if n + max_new > s.max_len or n == 0:
                        return False      # cannot fit this tier's table
                    cap = self.tiers[j].queue_capacity
                    backlog = len(queues[j]) - s.free_slots
                    return cap is None or backlog < cap

                k = self._admit(d, now, dl, has_space=cont_space)
                if k < 0 or (k in sessions and not cont_space(k)):
                    # deadline-less overflow keeps _admit's "keep the
                    # choice" semantics for server tiers, but a slot
                    # table has nowhere to force-enqueue an oversized
                    # prompt — record the drop instead of crashing
                    results[i] = self._shed(n, d, dl)
                    continue
                if k in sessions:
                    vocab = sessions[k].model.cfg.vocab_size
                    dl_key = dl if dl is not None else math.inf
                    heapq.heappush(queues[k],
                                   (dl_key, seq, i, np.minimum(toks, vocab - 1),
                                    d, now, dl))
                    seq += 1
                else:
                    m_out, exec_s = self.tiers[k].run(toks, d.m_hat, self.rng)
                    wait, service_s = self._occ[k].assign(now, exec_s)
                    results[i] = self._complete(k, d, n, m_out, exec_s,
                                                wait, service_s, now, dl)

            for k in sessions:
                if tclock[k] <= now and (queues[k]
                                         or sessions[k].live_count):
                    drain(k)
        return [self._notify(r, None) for r in results]  # type: ignore[return-value]

    def _admit(self, d: MultiTierDecision, now: float,
               deadline_s: Optional[float] = None,
               pending: Optional[List[int]] = None,
               has_space: Optional[Callable[[int], bool]] = None,
               allowed: Optional[Callable[[int], bool]] = None) -> int:
        """Bounded-FIFO admission: re-route from a full tier to the
        next-best tier with space; if everything is full, keep the choice
        and count the rejection.  Deadline-carrying requests re-route
        only to tiers predicted to meet the deadline and are shed
        (returns -1) when none can — predicted-completion-vs-deadline
        instead of blind force-enqueue.

        ``pending`` (per-tier counts) charges same-slot members already
        admitted by ``submit_batch`` against the bounded queues, so one
        concurrent slot cannot oversubscribe a capacity the sequential
        ``submit`` path would have enforced.  ``has_space`` overrides the
        space predicate per tier index — ``serve_continuous`` plugs in
        slot-table occupancy (free slots + bounded wait queue) for its
        continuous tiers while keeping this exact shed/reroute rule."""
        space = has_space if has_space is not None else \
            (lambda j: self._has_space(j, now, pending))
        if allowed is not None:
            # fault-tolerant dispatch: a masked (unhealthy) tier is never
            # a re-route target, not even as deadline-less force-enqueue
            base = space
            space = lambda j: allowed(j) and base(j)   # noqa: E731
        k = d.tier
        if space(k):
            return k
        ranked = sorted(range(len(self.tiers)), key=lambda j: d.t_pred[j])
        if deadline_s is None:
            for j in ranked:
                if space(j):
                    return j
            self.rejected[k] += 1
            return k
        spaced = [j for j in ranked if space(j)]
        feasible = [j for j in spaced if d.t_pred[j] <= deadline_s]
        if feasible:
            return feasible[0]
        if not spaced and d.t_pred[k] <= deadline_s:
            self.rejected[k] += 1       # full everywhere but still on time
            return k
        self.shed_count[k] += 1
        return -1

    def _has_space(self, k: int, now: float,
                   pending: Optional[List[int]] = None) -> bool:
        cap = self.tiers[k].queue_capacity
        extra = 0 if pending is None else pending[k]
        if cap is None:
            return True
        # same-slot pending members first fill the ACTUALLY-free batch
        # slots (free servers x batch_size), then charge the bounded
        # queue — mirroring what sequential submits would enforce
        slots = (self._occ[k].free_servers(now)
                 * max(self.tiers[k].batch_size, 1))
        if slots and extra < slots:
            return True          # a server (batch slot) is free right now
        return self._occ[k].queue_len(now) + extra - slots < cap

    # ------------------------------------------------------------- stats --
    def stats(self) -> Dict[str, object]:
        """Aggregate serving stats.  Latency percentiles and routing
        fractions are over *served* requests; ``shed`` counts the
        deadline-dropped ones and ``slo_attainment`` is the fraction of
        deadline-carrying requests that completed within their deadline
        (1.0 when none carried a deadline)."""
        if not self.results:
            return {}
        served = [r for r in self.results if not r.shed]
        n_shed = len(self.results) - len(served)
        with_dl = [r for r in self.results if r.deadline_s is not None]
        slo = 1.0 if not with_dl else \
            float(sum(bool(r.slo_met) for r in with_dl)) / len(with_dl)
        if not served:
            out = {"requests": len(self.results), "shed": n_shed,
                   "slo_attainment": slo}
            if self._ft:
                out.update(self._fault_stats(0))
            return out
        lat = np.array([r.latency_s for r in served])
        wait = np.array([r.wait_s for r in served])
        dev = np.array([r.device for r in served])
        remote = np.array([t.rtt_fn is not None for t in self.tiers])
        tx = self.tx
        out = {
            "requests": len(self.results),
            "total_latency_s": float(lat.sum()),
            "mean_latency_s": float(lat.mean()),
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p95_latency_s": float(np.percentile(lat, 95)),
            "mean_wait_s": float(wait.mean()),
            "offload_frac": float(np.mean(remote[dev])),
            "tier_frac": {t.name: float(np.mean(dev == k))
                          for k, t in enumerate(self.tiers)},
            "rejected": int(self.rejected.sum()),
            "shed": n_shed,
            "slo_attainment": slo,
            "split": self.split_count,
            "tx_estimate_s": 0.0 if tx is None else tx.rtt(0.0),
        }
        if self._ft:
            out.update(self._fault_stats(len(served)))
        return out

    def _fault_stats(self, n_served: int) -> Dict[str, object]:
        """Fault-tolerance observability (only reported when armed)."""
        return {
            "availability": (n_served / len(self.results)
                             if self.results else 1.0),
            "fault_failures": int(self.fault_failures.sum()),
            "retries": self.retry_count,
            "failovers": self.failover_count,
            "decode_failovers": self.decode_failovers,
            "fault_lost": self.fault_lost,
            "breaker_opens": sum(b.n_opens for b in self.breakers),
            "breaker_probes": sum(b.n_probes for b in self.breakers),
            "mean_attempts": (float(np.mean([r.attempts
                                             for r in self.results]))
                              if self.results else 1.0),
        }
