"""The paper's contribution: collaborative-inference scheduling for NMT.

Pipeline (paper §II):
  1. ``length_regressor``  — linear N->M output-length estimate (Fig. 3).
  2. ``latency_model``     — linear T_exe(N, M) plane per device (Fig. 2).
  3. ``tx_estimator``      — online round-trip-time tracking (§II-C).
  4. ``scheduler``         — the CI decision rule, Eq. (1)+(2).
  5. ``profiles``          — RIPE-Atlas-like RTT connection profiles (Fig. 4).
  6. ``calibration``       — offline T_exe characterization (measured or
                             roofline-derived).
  7. ``faults``            — deterministic fault injection + retry/circuit
                             breaker policies for fault-tolerant serving
                             (beyond paper).
  8. ``simulator``         — the 100k-request experiment of §III and its
                             queue-aware discrete-event extension (DES).
  9. ``arrivals``          — seeded arrival processes for the DES and the
                             load generator.
"""

from repro_torch.core.length_regressor import (
    LinearN2M,
    RidgeN2M,
    HuberN2M,
    BucketN2M,
    MeanN2M,
    prefilter_pairs,
)
from repro_torch.core.latency_model import (
    ActivationCostModel,
    DeviceProfile,
    LinearLatencyModel,
)
from repro_torch.core.tx_estimator import LinkModel, TxEstimator
from repro_torch.core.calibration import OnlineCalibrator
from repro_torch.core.scheduler import (
    CNMTScheduler,
    MultiTierScheduler,
    MultiTierDecision,
    NaiveScheduler,
    OracleScheduler,
    PlacementPlan,
    SchedTier,
    StaticScheduler,
    EDGE,
    CLOUD,
)
from repro_torch.core.faults import (
    CircuitBreaker,
    FaultSchedule,
    LinkFault,
    RetryPolicy,
    Straggler,
    TierOutage,
)
from repro_torch.core.profiles import ConnectionProfile, make_profile
from repro_torch.core.arrivals import (
    bursty_arrivals,
    load_trace,
    poisson_arrivals,
    save_trace,
)
from repro_torch.core.simulator import (
    DESResult,
    RequestStream,
    SimTier,
    SimulationResult,
    make_poisson_stream,
    make_stream,
    make_trace_stream,
    simulate,
    simulate_des,
    table1_row,
)

__all__ = [
    "LinearN2M",
    "RidgeN2M",
    "HuberN2M",
    "BucketN2M",
    "MeanN2M",
    "prefilter_pairs",
    "ActivationCostModel",
    "LinearLatencyModel",
    "DeviceProfile",
    "LinkModel",
    "TxEstimator",
    "OnlineCalibrator",
    "PlacementPlan",
    "CNMTScheduler",
    "MultiTierScheduler",
    "MultiTierDecision",
    "NaiveScheduler",
    "OracleScheduler",
    "SchedTier",
    "StaticScheduler",
    "EDGE",
    "CLOUD",
    "CircuitBreaker",
    "FaultSchedule",
    "LinkFault",
    "RetryPolicy",
    "Straggler",
    "TierOutage",
    "ConnectionProfile",
    "make_profile",
    "bursty_arrivals",
    "load_trace",
    "poisson_arrivals",
    "save_trace",
    "DESResult",
    "RequestStream",
    "SimTier",
    "SimulationResult",
    "make_poisson_stream",
    "make_stream",
    "make_trace_stream",
    "simulate",
    "simulate_des",
    "table1_row",
]
