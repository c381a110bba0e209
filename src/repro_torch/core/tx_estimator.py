"""Online transmission-latency tracking (paper §II-C).

T_tx varies over time with connection quality.  The paper attaches
timestamps to every request/response exchanged with the cloud and keeps a
recent estimate; because single end-nodes translate sporadically, the edge
device is assumed to be a *gateway* aggregating many end-nodes, so samples
arrive almost continuously.

:class:`TxEstimator` implements that mechanism: it ingests timestamped RTT
observations (obtained for free from offloaded requests) and serves the
current estimate.  Two modes:

* ``ewma`` (default) — exponentially-weighted moving average, the usual
  network-RTT smoother; robust to single spikes.
* ``last``           — most recent sample (what a bare timestamp scheme
  gives you); kept as the paper-minimal variant.

A staleness guard (beyond paper): if no sample arrived for
``max_age_s``, the estimator injects a cheap synthetic probe sample —
modelling the gateway pinging the server — so decisions never rely on an
arbitrarily old estimate.  The simulator can disable probing to reproduce
the paper-faithful behaviour exactly.

Causal ordering: responses from concurrently offloaded requests can
return out of order (a short request issued later completes before a
long one issued earlier).  ``observe`` drops any sample timestamped
before the newest one already ingested (counted in ``n_stale``), so the
EWMA only ever moves forward in time and ``_last_update`` — which gates
the staleness probe — never runs backwards.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional


@dataclasses.dataclass
class TxEstimator:
    mode: str = "ewma"
    alpha: float = 0.3            # EWMA weight of the newest sample
    init_rtt_s: float = 0.050     # estimate before any sample arrives
    max_age_s: Optional[float] = None  # None = paper-faithful (no probing)
    bandwidth_bps: float = 100e6

    def __post_init__(self):
        if self.mode not in ("ewma", "last"):
            raise ValueError(f"unknown mode {self.mode!r}")
        self._estimate = self.init_rtt_s
        self._last_update: Optional[float] = None
        self.n_samples = 0
        self.n_probes = 0
        self.n_stale = 0
        self.n_invalidations = 0

    # -- ingestion ---------------------------------------------------------
    def observe(self, timestamp_s: float, rtt_s: float) -> None:
        """Record a timestamped RTT measurement from an offloaded request.

        Samples older than the newest already ingested are dropped (see
        module docstring): out-of-order completions must not rewind the
        estimator's notion of "now".
        """
        if rtt_s <= 0:
            raise ValueError("rtt must be positive")
        if self._last_update is not None and timestamp_s < self._last_update:
            self.n_stale += 1
            return
        if self.mode == "last" or self._last_update is None:
            self._estimate = rtt_s if self.mode == "last" else (
                rtt_s if self.n_samples == 0
                else (1 - self.alpha) * self._estimate + self.alpha * rtt_s
            )
        else:
            self._estimate = (1 - self.alpha) * self._estimate + self.alpha * rtt_s
        self._last_update = timestamp_s
        self.n_samples += 1

    def invalidate(self) -> None:
        """Forget accumulated link state after a known discontinuity
        (an outage episode ended, the route changed).

        The ``n_stale`` causal guard protects against out-of-ORDER
        samples; it cannot help when in-order *pre-outage* samples
        poison the estimate for the recovered link — an EWMA warmed on a
        congested route keeps predicting congestion long after failover
        ends.  Invalidation keeps the current estimate as the best
        available guess for queries, but resets the sample history so
        the FIRST post-recovery observation replaces it wholesale (the
        ``n_samples == 0`` bootstrap branch) instead of being blended at
        weight ``alpha``.  Callers: circuit-breaker recovery
        (OPEN→CLOSED) in the engine and the DES.
        """
        self._last_update = None
        self.n_samples = 0
        self.n_invalidations += 1

    # -- queries -----------------------------------------------------------
    def rtt(self, now_s: float, probe_fn=None) -> float:
        """Current RTT estimate; optionally refresh via probe when stale."""
        if (
            self.max_age_s is not None
            and probe_fn is not None
            and (self._last_update is None or now_s - self._last_update > self.max_age_s)
        ):
            self.observe(now_s, float(probe_fn(now_s)))
            self.n_probes += 1
        return self._estimate

    def tx_time(self, now_s: float, payload_bytes: float, probe_fn=None,
                *, one_way: bool = False) -> float:
        """T_tx estimate = RTT + payload serialization at the known bandwidth.

        ``one_way=True`` prices a single direction (``rtt/2`` + the same
        serialization term) — the cost of SHIPPING a payload to the
        other end without waiting for a response, which is what an
        inter-tier activation transfer pays (the decode leg continues on
        the receiving tier; nothing comes back over this link).
        """
        rtt = self.rtt(now_s, probe_fn)
        if one_way:
            rtt = rtt / 2.0
        return rtt + payload_bytes * 8.0 / self.bandwidth_bps


class LinkModel:
    """Pairwise tier-to-tier link matrix.

    The single gateway→cloud :class:`TxEstimator` of the paper covers
    exactly one hop.  Cross-tier model partitioning (encoder on tier i,
    decoder on tier j) needs the i→j leg priced too, and hierarchical
    topologies (device→edge→cloud) must pay *both* hops when no direct
    link exists.  ``LinkModel`` keeps one :class:`TxEstimator` per
    registered directed pair and composes multi-hop paths:

    * ``tx_time(i, j, ...)`` — 0.0 for ``i == j``; the direct link's
      estimate when registered; otherwise the cheapest relay path over
      registered links (each hop paying its own RTT + serialization);
      ``math.inf`` when no path exists (callers treat that plan as
      infeasible).
    * ``observe(i, j, now, rtt)`` — feed a timestamped RTT sample into
      the direct link's estimator (§II-C, per link).

    Estimators are per *direction*; ``add_link(..., symmetric=True)``
    (the default) registers the reverse direction with its own
    independent estimator so asymmetric routes can drift apart.
    """

    def __init__(self, n_tiers: int):
        if n_tiers < 1:
            raise ValueError("need at least one tier")
        self.n_tiers = n_tiers
        self._links: dict = {}

    def add_link(self, i: int, j: int, estimator: TxEstimator, *,
                 symmetric: bool = True) -> "LinkModel":
        if i == j:
            raise ValueError("a tier has no link to itself")
        for k in (i, j):
            if not (0 <= k < self.n_tiers):
                raise ValueError(f"tier index {k} out of range")
        self._links[(i, j)] = estimator
        if symmetric and (j, i) not in self._links:
            self._links[(j, i)] = dataclasses.replace(estimator)
        return self

    def link(self, i: int, j: int) -> Optional[TxEstimator]:
        return self._links.get((i, j))

    def has_path(self, i: int, j: int) -> bool:
        return math.isfinite(self.tx_time(i, j, 0.0, 0.0))

    def tx_time(self, i: int, j: int, now_s: float, payload_bytes: float,
                *, one_way: bool = False) -> float:
        """Predicted transfer time i→j; composes relay hops when no
        direct link is registered (device→edge→cloud pays both hops —
        each hop's RTT *and* a re-serialization of the payload)."""
        if i == j:
            return 0.0
        direct = self._links.get((i, j))
        if direct is not None:
            return direct.tx_time(now_s, payload_bytes, one_way=one_way)
        # Dijkstra over registered directed links (tiny K: fine)
        dist = {i: 0.0}
        frontier = [(0.0, i)]
        while frontier:
            d, u = heapq.heappop(frontier)
            if u == j:
                return d
            if d > dist.get(u, math.inf):
                continue
            for (a, b), est in self._links.items():
                if a != u:
                    continue
                nd = d + est.tx_time(now_s, payload_bytes, one_way=one_way)
                if nd < dist.get(b, math.inf):
                    dist[b] = nd
                    heapq.heappush(frontier, (nd, b))
        return math.inf

    def observe(self, i: int, j: int, now_s: float, rtt_s: float) -> None:
        est = self._links.get((i, j))
        if est is not None:
            est.observe(now_s, rtt_s)

    def invalidate(self, tier: int) -> int:
        """Invalidate every registered link touching ``tier`` (either
        direction) after its outage/recovery — see
        :meth:`TxEstimator.invalidate`.  Returns how many links reset."""
        n = 0
        for (a, b), est in self._links.items():
            if a == tier or b == tier:
                est.invalidate()
                n += 1
        return n
