"""The C-NMT mapping decision — paper Eq. (1) and Eq. (2).

Per request with input length N, choose the execution tier:

    d_tgt = edge   if  T_exe,e(N, M_hat) <= T_tx + T_exe,c(N, M_hat)
            cloud  otherwise

with M_hat = gamma*N + delta from the length regressor.  The schedulers
here are *policies* over (request, online state); the actual experiment
loop lives in ``repro_torch.core.simulator`` and the production serving path in
``repro_torch.runtime.engine``.

Implemented policies
--------------------
* :class:`CNMTScheduler`   — the paper's technique (Eq. 1 + 2).
* :class:`NaiveScheduler`  — same rule but M_hat = corpus mean (paper §III).
* :class:`OracleScheduler` — lower bound: sees the *true* per-request times.
* :class:`StaticScheduler` — pure-edge ("GW") / pure-cloud ("Server").

Beyond paper
------------
* ``hedge_margin``: when the predicted edge/cloud gap is within ±margin of
  the break-even point, prefer the tier with lower variance (the edge —
  no network) — a cheap uncertainty-aware refinement of Eq. (1).
* batched vectorized ``decide_batch`` used by the analytic simulator.
* :class:`MultiTierScheduler` — the N-tier generalization used by the
  queue-aware serving engine and the discrete-event simulator:

      d_tgt = argmin_k [ T_queue,k + T_tx,k + T_exe,k(N, M_hat) ]

  Each :class:`SchedTier` carries its own latency plane and (for remote
  tiers) its own :class:`TxEstimator`; ``T_queue`` comes from the
  caller's occupancy bookkeeping, made batch-aware by
  :meth:`MultiTierScheduler.queue_delay` when a tier serves requests in
  length-bucketed batches (predicted backlog ÷ effective service rate).
  With exactly two tiers (local edge + remote cloud), empty queues and
  ``batch_size=1`` this reduces *bit-for-bit* to
  :meth:`CNMTScheduler.decide` — the paper's Eq. (1) is the N=2 special
  case, and the regression tests pin that equivalence.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency_model import (
    ActivationCostModel,
    DeviceProfile,
    LinearLatencyModel,
    bytes_for_tokens,
)
from repro_torch.core.length_regressor import LinearN2M, MeanN2M
from repro_torch.core.tx_estimator import LinkModel, TxEstimator

EDGE = 0
CLOUD = 1


@dataclasses.dataclass
class Decision:
    """One two-tier routing decision (paper Eq. (1)).

    ``t_edge_pred``/``t_cloud_pred`` are the scheduler's *predicted*
    totals in seconds (estimator outputs — plane at (N, M̂) plus, for
    the cloud, the estimated T_tx), not measured ground truth; ``m_hat``
    is the N→M regressor's predicted output length in tokens.
    """

    device: int           # EDGE or CLOUD
    t_edge_pred: float    # seconds, predicted
    t_cloud_pred: float   # seconds, predicted (includes predicted T_tx)
    m_hat: float          # tokens, predicted output length


class BaseScheduler:
    name = "base"

    def decide(self, n: int, now_s: float, tx: TxEstimator) -> Decision:
        """Route one request of ``n`` input tokens arriving at ``now_s``
        seconds, reading the link only through ``tx`` (the §II-C
        estimator state)."""
        raise NotImplementedError


@dataclasses.dataclass
class CNMTScheduler(BaseScheduler):
    """Paper Eq. (1): compare edge plane vs cloud plane + T_tx at (N, M_hat)."""

    edge: DeviceProfile
    cloud: DeviceProfile
    n2m: LinearN2M
    bytes_per_token: int = 2
    hedge_margin_s: float = 0.0   # 0 => paper-faithful
    name: str = "c-nmt"

    def decide(self, n: int, now_s: float, tx: TxEstimator) -> Decision:
        """Paper Eq. (1) for one request: edge plane vs cloud plane +
        estimated T_tx at (N, M̂), all in seconds.  This exact float op
        order is the compatibility contract the N=2
        :class:`MultiTierScheduler` reduction is pinned against
        bit-for-bit (tests/test_multitier.py)."""
        m_hat = float(np.asarray(self.n2m.predict(float(n))))
        m_hat = max(m_hat, 1.0)
        t_e = float(np.asarray(self.edge.model.predict(float(n), m_hat)))
        payload = float(bytes_for_tokens(n + m_hat, self.bytes_per_token))
        t_c = float(np.asarray(self.cloud.model.predict(float(n), m_hat)))
        t_c_tot = t_c + tx.tx_time(now_s, payload)
        gap = t_c_tot - t_e  # >0 => edge wins
        if abs(gap) <= self.hedge_margin_s:
            device = EDGE  # hedge: local execution has no network variance
        else:
            device = EDGE if t_e <= t_c_tot else CLOUD
        return Decision(device, t_e, t_c_tot, m_hat)

    def decide_batch(self, n: np.ndarray, rtt: np.ndarray,
                     bandwidth_bps: float = 100e6) -> np.ndarray:
        """Vectorized Eq. (1) for the analytic simulator.

        ``rtt`` is the scheduler's RTT estimate per request; the payload
        serialization term is added here at ``bandwidth_bps``.  Both are
        link properties, so they travel together as arguments (the
        stateful paths read them from the TxEstimator instead — pass the
        link's configured bandwidth, e.g. ``profile.bandwidth_bps``, to
        stay consistent with them; the default is the paper's 100 Mbps).
        Returns an int array of EDGE/CLOUD.
        """
        n = np.asarray(n, np.float64)
        m_hat = np.maximum(np.asarray(self.n2m.predict(n), np.float64), 1.0)
        t_e = np.asarray(self.edge.model.predict(n, m_hat), np.float64)
        payload = bytes_for_tokens(n + m_hat, self.bytes_per_token)
        t_tx = np.asarray(rtt, np.float64) + payload * 8.0 / bandwidth_bps
        t_c = np.asarray(self.cloud.model.predict(n, m_hat), np.float64) + t_tx
        gap = t_c - t_e
        dev = np.where(t_e <= t_c, EDGE, CLOUD)
        if self.hedge_margin_s > 0:
            dev = np.where(np.abs(gap) <= self.hedge_margin_s, EDGE, dev)
        return dev.astype(np.int32)


def NaiveScheduler(edge: DeviceProfile, cloud: DeviceProfile, n_corpus, m_corpus,
                   **kw) -> CNMTScheduler:
    """Paper §III 'Naive': identical mapping rule, M_hat = corpus average."""
    s = CNMTScheduler(edge=edge, cloud=cloud,
                      n2m=MeanN2M().fit(n_corpus, m_corpus), **kw)
    s.name = "naive"
    return s


@dataclasses.dataclass
class SchedTier:
    """What the scheduler *believes* about one tier.

    ``model`` is the T_exe,k(N, M) plane (measured, roofline-priced, or
    online-refit); ``tx`` is the tier's link estimator — ``None`` marks a
    local tier (no network hop, no T_tx term, lowest variance).

    ``batch_size``/``per_seq_overhead_s`` describe the tier's believed
    batched-service behaviour: each server drains up to ``batch_size``
    queued requests per decode pass, a batch of b similar requests taking

        T_batch = T_exe(max N, max M_hat) + per_seq_overhead_s * (b - 1)

    (sub-linear in b; ``per_seq_overhead_s`` is calibratable from batched
    timing grids, see ``repro_torch.core.calibration.fit_batch_overhead``).
    These feed the batch-aware T_queue term in
    :meth:`MultiTierScheduler.queue_delay`; ``batch_size=1`` reduces to
    the unbatched behaviour exactly.
    """

    name: str
    model: LinearLatencyModel
    tx: Optional[TxEstimator] = None
    batch_size: int = 1
    per_seq_overhead_s: float = 0.0

    @property
    def is_local(self) -> bool:
        return self.tx is None


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Where each leg of a request runs — the generalized decision space.

    The paper's Eq. (1) picks *one* tier per request; the plan
    abstraction grows that to "which cut point": ``whole(k)`` runs both
    legs on tier k (the paper's case), ``split(e, d)`` runs the encoder
    on tier e, ships the encoder states over the e→d link, and decodes
    on tier d.  ``split(k, k)`` *is* ``whole(k)`` — same frozen
    dataclass value, zero transfer cost — so the whole-request rule is
    literally the diagonal of the plan space.
    """

    encode_tier: int
    decode_tier: int

    @classmethod
    def whole(cls, tier: int) -> "PlacementPlan":
        return cls(tier, tier)

    @classmethod
    def split(cls, encode_tier: int, decode_tier: int) -> "PlacementPlan":
        return cls(encode_tier, decode_tier)

    @property
    def is_split(self) -> bool:
        return self.encode_tier != self.decode_tier


@dataclasses.dataclass
class MultiTierDecision:
    """One N-tier routing decision.

    ``t_pred`` holds the scheduler's per-tier predicted totals in
    seconds (T_queue + T_tx + T_exe at (N, M̂) — estimator outputs, with
    excluded tiers priced at ``inf``); admission/reroute logic ranks on
    it downstream.  ``m_hat`` is the predicted output length in tokens.
    """

    tier: int                  # index into the scheduler's tier list
    t_pred: Tuple[float, ...]  # per-tier predicted T_queue + T_tx + T_exe (s)
    m_hat: float               # tokens, predicted output length
    # Plan-aware extensions (None on the scalar decide paths): the chosen
    # placement, and the predicted total per evaluated plan.  ``tier``
    # stays the *decode* tier of the plan so existing per-tier admission
    # and reroute logic keeps working unchanged.
    plan: Optional[PlacementPlan] = None
    plan_t_pred: Optional[Dict[PlacementPlan, float]] = None


class MultiTierScheduler(BaseScheduler):
    """N-tier generalization of Eq. (1):

        d_tgt = argmin_k [ T_queue,k + T_tx,k + T_exe,k(N, M_hat) ]

    ``hedge_margin_s`` generalizes the 2-tier hedge: among tiers whose
    predicted total is within the margin of the minimum, prefer the
    fastest *local* tier (no network variance).  With tiers
    ``[edge(local), cloud(remote)]`` and zero queue delays this picks the
    same device as :meth:`CNMTScheduler.decide` bit-for-bit (same float32
    prediction path, same float op order).
    """

    def __init__(self, tiers: Sequence[SchedTier], n2m: LinearN2M, *,
                 bytes_per_token: int = 2, hedge_margin_s: float = 0.0,
                 links: Optional[LinkModel] = None,
                 activation: Optional[ActivationCostModel] = None,
                 allow_split: bool = False,
                 explore_eps: float = 0.0, explore_seed: int = 0,
                 name: str = "c-nmt-ntier"):
        if not tiers:
            raise ValueError("need at least one tier")
        self.tiers = list(tiers)
        self.n2m = n2m
        self.bytes_per_token = bytes_per_token
        self.hedge_margin_s = hedge_margin_s
        self.links = links
        self.activation = activation
        self.allow_split = allow_split
        self.explore_eps = explore_eps
        self._explore_rng = np.random.default_rng(explore_seed)
        self._since_pick = [0] * len(self.tiers)
        self.n_explored = 0
        self.name = name

    # ------------------------------------------------------------ helpers --
    def _split_ready(self) -> bool:
        """Split plans need a link matrix to price the inter-tier hop and
        an activation model to price the encoder-state payload."""
        return (self.allow_split and self.links is not None
                and self.activation is not None)

    def _explore_override(self, chosen: int,
                          exclude: Optional[frozenset] = None) -> int:
        """ε-greedy cold-start probing of starved tiers.

        A tier whose believed plane is too slow never wins the argmin,
        so `OnlineCalibrator` never sees samples from it and can never
        correct the belief — a self-sealing mis-calibration.  With
        probability ``explore_eps`` route the request to the tier that
        has gone longest without traffic instead of the argmin winner.
        With ``explore_eps == 0`` (the default) this returns immediately
        without touching the RNG or any counter, so all existing
        bit-for-bit decision pins are unaffected.
        """
        if self.explore_eps <= 0.0 or len(self.tiers) < 2:
            return chosen
        for i in range(len(self._since_pick)):
            self._since_pick[i] += 1
        if self._explore_rng.random() < self.explore_eps:
            # never probe an excluded (unhealthy) tier — exploration is
            # for mis-calibration recovery, not for hammering dead tiers
            cands = [i for i in range(len(self._since_pick))
                     if not exclude or i not in exclude]
            starved = max(cands, key=self._since_pick.__getitem__)
            if starved != chosen:
                self.n_explored += 1
                chosen = starved
        self._since_pick[chosen] = 0
        return chosen

    def _select(self, totals: Sequence[float]) -> int:
        """argmin with the local-preference hedge (see class docstring)."""
        best = 0
        for k in range(1, len(totals)):
            if totals[k] < totals[best]:
                best = k
        best_local = None
        for k in range(len(totals)):
            if self.tiers[k].is_local and (
                    best_local is None or totals[k] < totals[best_local]):
                best_local = k
        if best_local is not None and (
                totals[best_local] <= totals[best] + self.hedge_margin_s):
            return best_local
        return best

    def m_hat(self, n: float) -> float:
        """Predicted output length in tokens for ``n`` input tokens
        (N→M regressor, floored at 1 so plane predictions stay
        positive) — the estimator every T_exe term is priced at."""
        return max(float(np.asarray(self.n2m.predict(float(n)))), 1.0)

    def queue_delay(self, k: int, backlog_s: float, in_system: int,
                    servers: int) -> float:
        """Batch-aware T_queue,k: predicted backlog ÷ effective service rate.

        ``backlog_s`` is the sum of predicted per-sequence T_exe for the
        ``in_system`` requests queued or running at tier k, ``servers``
        its concurrency.  An unbatched tier drains one sequence per
        server at a time, so T_queue = backlog / servers (unbatched semantics,
        bit-for-bit).  A tier with batch size b amortizes a decode pass
        over up to b sequences: a batch costs roughly one mean sequence
        time T1 plus ``per_seq_overhead_s`` per extra member, so the
        effective work-drain speedup is  b·T1 / (T1 + o·(b−1))  and

            T_queue = backlog / (servers * speedup).
        """
        backlog = float(backlog_s)
        tier = self.tiers[k]
        b = tier.batch_size
        if b <= 1 or in_system <= 0 or backlog <= 0.0:
            return backlog / servers
        t1 = backlog / in_system
        t_batch = t1 + tier.per_seq_overhead_s * (b - 1)
        if t_batch <= 0.0:
            return 0.0
        speedup = b * t1 / t_batch
        return backlog / (servers * speedup)

    @staticmethod
    def _mask_totals(totals: List[float],
                     exclude: Optional[frozenset]) -> List[float]:
        """Candidate mask for fault-tolerant routing: excluded tiers
        (open circuit breakers, tiers that already failed this request)
        price at infinity so the argmin — and every downstream
        feasibility check ranked on ``t_pred`` — skips them.  ``exclude``
        falsy returns ``totals`` untouched (the bit-for-bit default)."""
        if not exclude:
            return totals
        return [math.inf if k in exclude else t
                for k, t in enumerate(totals)]

    # ----------------------------------------------------------- decisions --
    def decide(self, n: int, now_s: float,
               queue_delay_s: Optional[Sequence[float]] = None,
               *, exclude: Optional[frozenset] = None
               ) -> MultiTierDecision:
        """Single-request rule; ``queue_delay_s`` is the caller's per-tier
        T_queue estimate (0.0 for every tier when omitted).  ``exclude``
        removes unhealthy tiers from the candidate set (their predicted
        totals become ``inf``); the caller guarantees at least one tier
        stays eligible."""
        m_hat = self.m_hat(n)
        payload = float(bytes_for_tokens(n + m_hat, self.bytes_per_token))
        totals: List[float] = []
        for k, tier in enumerate(self.tiers):
            t_exe = float(np.asarray(tier.model.predict(float(n), m_hat)))
            t_tx = 0.0 if tier.tx is None else tier.tx.tx_time(now_s, payload)
            q = 0.0 if queue_delay_s is None else float(queue_delay_s[k])
            totals.append(t_exe + t_tx + q)
        totals = self._mask_totals(totals, exclude)
        pick = self._explore_override(self._select(totals), exclude)
        return MultiTierDecision(pick, tuple(totals), m_hat)

    def decide_fast(self, n: float, m_hat: float, now_s: float,
                    queue_delay_s: Optional[Sequence[float]] = None,
                    *, exclude: Optional[frozenset] = None
                    ) -> MultiTierDecision:
        """float64 closed-form fast path (no float32 plane call) for the
        discrete-event simulator — the same coefficient arithmetic as
        ``simulator._simulate_online``, so the empty-queue DES replay
        matches the analytic replay exactly."""
        totals = self._mask_totals(
            self._whole_totals_fast(n, m_hat, now_s, queue_delay_s), exclude)
        pick = self._explore_override(self._select(totals), exclude)
        return MultiTierDecision(pick, tuple(totals), m_hat)

    def _whole_totals_fast(self, n: float, m_hat: float, now_s: float,
                           queue_delay_s: Optional[Sequence[float]]
                           ) -> List[float]:
        """Per-tier whole-request totals, closed-form float64 — the exact
        arithmetic `decide_fast` has always used (op order pinned by the
        DES-vs-analytic equivalence tests)."""
        payload = (n + m_hat) * self.bytes_per_token
        totals: List[float] = []
        for k, tier in enumerate(self.tiers):
            m = tier.model
            t_exe = m.alpha_n * n + m.alpha_m * m_hat + m.beta
            t_tx = 0.0 if tier.tx is None else tier.tx.tx_time(now_s, payload)
            q = 0.0 if queue_delay_s is None else float(queue_delay_s[k])
            totals.append(t_exe + t_tx + q)
        return totals

    # -------------------------------------------------- placement plans --
    def plan_cost_fast(self, plan: PlacementPlan, n: float, m_hat: float,
                       now_s: float,
                       queue_delay_s: Optional[Sequence[float]] = None
                       ) -> float:
        """Predicted total latency of one placement plan (closed form).

        ``whole(k)`` (and therefore ``split(k, k)``) reproduces the
        `decide_fast` per-tier total bit-for-bit: same plane arithmetic,
        same token payload, same full-RTT tx term — the plan space's
        diagonal IS the paper's rule.  A genuine split pays:

            T_queue,e + up + T_enc,e + ship(e→d) + T_queue,d + T_dec,d + down

        where `up` ships N source tokens one-way over tier e's client
        link, `ship` moves the encoder states (n × d_model × dtype
        bytes) one-way over the e→d link (``math.inf`` when no path is
        registered, making the plan infeasible), and `down` returns
        M_hat output tokens one-way over tier d's client link.
        """
        if not plan.is_split:
            k = plan.decode_tier
            tier = self.tiers[k]
            m = tier.model
            t_exe = m.alpha_n * n + m.alpha_m * m_hat + m.beta
            payload = (n + m_hat) * self.bytes_per_token
            t_tx = 0.0 if tier.tx is None else tier.tx.tx_time(now_s, payload)
            q = 0.0 if queue_delay_s is None else float(queue_delay_s[k])
            return t_exe + t_tx + q
        e, d = plan.encode_tier, plan.decode_tier
        enc_tier, dec_tier = self.tiers[e], self.tiers[d]
        t_enc = enc_tier.model.alpha_n * n + 0.5 * enc_tier.model.beta
        t_dec = dec_tier.model.alpha_m * m_hat + 0.5 * dec_tier.model.beta
        up = 0.0 if enc_tier.tx is None else enc_tier.tx.tx_time(
            now_s, n * self.bytes_per_token, one_way=True)
        down = 0.0 if dec_tier.tx is None else dec_tier.tx.tx_time(
            now_s, m_hat * self.bytes_per_token, one_way=True)
        ship = self.links.tx_time(
            e, d, now_s, float(self.activation.payload_bytes(n)),
            one_way=True)
        q_e = 0.0 if queue_delay_s is None else float(queue_delay_s[e])
        q_d = 0.0 if queue_delay_s is None else float(queue_delay_s[d])
        return q_e + up + t_enc + ship + q_d + t_dec + down

    def _plan_decision(self, n: float, m_hat: float, now_s: float,
                       queue_delay_s: Optional[Sequence[float]],
                       totals: List[float],
                       exclude: Optional[frozenset] = None
                       ) -> MultiTierDecision:
        """Shared tail of the plan-aware decide paths: run the whole-
        request selection (hedge + exploration, unchanged), then let a
        split plan take over only when strictly cheaper.  Split plans
        touching an ``exclude``d tier are never considered — a leg on an
        unhealthy tier is a guaranteed failover."""
        k0 = self._select(totals)
        k = self._explore_override(k0, exclude)
        whole = PlacementPlan.whole(k)
        if not self._split_ready() or k != k0:
            # splits off, or exploration forced a tier: whole-request plan
            return MultiTierDecision(k, tuple(totals), m_hat, plan=whole)
        n_tiers = len(self.tiers)
        plan_costs: Dict[PlacementPlan, float] = {
            PlacementPlan.whole(j): totals[j] for j in range(n_tiers)}
        best_plan, best_cost = whole, totals[k]
        for e in range(n_tiers):
            for d in range(n_tiers):
                if e == d or (exclude and (e in exclude or d in exclude)):
                    continue
                p = PlacementPlan.split(e, d)
                c = self.plan_cost_fast(p, n, m_hat, now_s, queue_delay_s)
                plan_costs[p] = c
                if c < best_cost:      # strict: ties keep the whole plan
                    best_plan, best_cost = p, c
        return MultiTierDecision(best_plan.decode_tier, tuple(totals), m_hat,
                                 plan=best_plan, plan_t_pred=plan_costs)

    def decide_plan(self, n: int, now_s: float,
                    queue_delay_s: Optional[Sequence[float]] = None,
                    *, exclude: Optional[frozenset] = None
                    ) -> MultiTierDecision:
        """Plan-aware single-request rule (float32 prediction path).

        Whole-request totals use the exact `decide` arithmetic, so with
        splits disabled this is `decide` bit-for-bit (plus the chosen
        ``plan`` attached).  ``tier`` is always the plan's decode tier —
        per-tier admission/reroute logic downstream is unchanged.
        """
        m_hat = self.m_hat(n)
        payload = float(bytes_for_tokens(n + m_hat, self.bytes_per_token))
        totals: List[float] = []
        for k, tier in enumerate(self.tiers):
            t_exe = float(np.asarray(tier.model.predict(float(n), m_hat)))
            t_tx = 0.0 if tier.tx is None else tier.tx.tx_time(now_s, payload)
            q = 0.0 if queue_delay_s is None else float(queue_delay_s[k])
            totals.append(t_exe + t_tx + q)
        totals = self._mask_totals(totals, exclude)
        return self._plan_decision(float(n), m_hat, now_s, queue_delay_s,
                                   totals, exclude)

    def decide_plan_fast(self, n: float, m_hat: float, now_s: float,
                         queue_delay_s: Optional[Sequence[float]] = None,
                         *, exclude: Optional[frozenset] = None
                         ) -> MultiTierDecision:
        """Plan-aware closed-form rule for the DES: `decide_fast`
        bit-for-bit when splits are disabled."""
        totals = self._mask_totals(
            self._whole_totals_fast(n, m_hat, now_s, queue_delay_s), exclude)
        return self._plan_decision(n, m_hat, now_s, queue_delay_s, totals,
                                   exclude)

    def decide_batch(self, n: np.ndarray, rtt: np.ndarray) -> np.ndarray:
        """Vectorized empty-queue rule (analytic-simulator counterpart of
        :meth:`CNMTScheduler.decide_batch`): ``rtt`` is the per-request
        RTT estimate applied to every remote tier's link."""
        n = np.asarray(n, np.float64)
        m_hat = np.maximum(np.asarray(self.n2m.predict(n), np.float64), 1.0)
        payload = bytes_for_tokens(n + m_hat, self.bytes_per_token)
        totals = []
        for tier in self.tiers:
            t = np.asarray(tier.model.predict(n, m_hat), np.float64)
            if tier.tx is not None:
                t = t + (np.asarray(rtt, np.float64)
                         + payload * 8.0 / tier.tx.bandwidth_bps)
            totals.append(t)
        stack = np.stack(totals, axis=0)              # (K, R)
        tmin = stack.min(axis=0)
        pick = stack.argmin(axis=0)
        local_idx = [k for k, t in enumerate(self.tiers) if t.is_local]
        if local_idx:
            loc = stack[local_idx]                    # (L, R)
            lbest = loc.argmin(axis=0)
            use_local = loc.min(axis=0) <= tmin + self.hedge_margin_s
            pick = np.where(use_local, np.asarray(local_idx)[lbest], pick)
        return pick.astype(np.int32)

    # ------------------------------------------------------------ feedback --
    def observe_rtt(self, tier: int, now_s: float, rtt_s: float) -> None:
        """Feed a timestamped RTT sample from an offloaded completion into
        the tier's link estimator (§II-C, per link)."""
        tx = self.tiers[tier].tx
        if tx is not None:
            tx.observe(now_s, rtt_s)

    @classmethod
    def from_pair(cls, edge: DeviceProfile, cloud: DeviceProfile,
                  n2m: LinearN2M, tx: TxEstimator, *,
                  bytes_per_token: int = 2, hedge_margin_s: float = 0.0
                  ) -> "MultiTierScheduler":
        """The paper-faithful N=2 configuration: local edge + remote cloud
        sharing the caller's TxEstimator (regression-tested against
        :class:`CNMTScheduler`)."""
        return cls(
            [SchedTier(edge.name, edge.model, None),
             SchedTier(cloud.name, cloud.model, tx)],
            n2m, bytes_per_token=bytes_per_token,
            hedge_margin_s=hedge_margin_s)


@dataclasses.dataclass
class OracleScheduler(BaseScheduler):
    """Ideal lower bound (paper §III): picks the truly fastest device.

    Sees true execution times and the true T_tx of each request — immune to
    regression error, plane mis-fit and stale RTT estimates.
    """

    name: str = "oracle"

    def decide_batch(self, t_edge_true: np.ndarray, t_cloud_true_with_tx: np.ndarray) -> np.ndarray:
        return np.where(t_edge_true <= t_cloud_true_with_tx, EDGE, CLOUD).astype(np.int32)

    @staticmethod
    def decide_batch_multi(t_true_totals: np.ndarray) -> np.ndarray:
        """N-tier oracle: ``t_true_totals`` is (K, R) true per-tier latency
        (execution + tx) per request; picks the per-request argmin."""
        return np.argmin(np.asarray(t_true_totals), axis=0).astype(np.int32)


@dataclasses.dataclass
class StaticScheduler(BaseScheduler):
    """Pure-edge (GW) or pure-cloud (Server) baselines of paper Table I."""

    device: int = EDGE

    @property
    def name(self) -> str:
        return "gw" if self.device == EDGE else "server"

    def decide_batch(self, n: np.ndarray, rtt: np.ndarray) -> np.ndarray:
        return np.full(np.shape(n), self.device, dtype=np.int32)
