"""Quickstart: the C-NMT collaborative-inference decision in ~40 lines.

    python -m repro_torch.launch.quickstart --device cpu
    REPRO_SMOKE=1 python -m repro_torch.launch.quickstart

Port of ``examples/quickstart.py``.  Builds the paper's pipeline from the
public API: synthetic parallel corpus -> N->M length regressor ->
per-device latency planes -> the CI decision rule routing requests
between an edge gateway and a cloud server over a time-varying
connection.  All of it is numpy; no kernel runs.  ``REPRO_SMOKE=1``
shrinks the corpus from 20000 pairs to 2000.  It runs on ``cuda`` unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.core import (
    CNMTScheduler,
    DeviceProfile,
    LinearLatencyModel,
    LinearN2M,
    TxEstimator,
    prefilter_pairs,
)
from repro_torch.core.profiles import make_profile
from repro_torch.data.synthetic import make_corpus
from repro_torch.device import resolve_device

REQUESTS = ((0.0, 4), (10.0, 12), (20.0, 30), (30.0, 80), (40.0, 150))


def main(argv=None):
    """Returns ``{"n2m": (gamma, delta), "decisions": [Decision, ...]}``,
    one decision per ``(t_now, n)`` of :data:`REQUESTS`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    smoke = bool(int(os.environ.get("REPRO_SMOKE", "0")))

    # 1. fit the N->M length regressor on (pre-filtered) corpus pairs
    corpus = make_corpus("en-zh", 2000 if smoke else 20_000, seed=0)
    n, m = prefilter_pairs(corpus.n, corpus.m_real)
    n2m = LinearN2M().fit(n, m)
    print(f"N->M fit: gamma={n2m.gamma:.3f} delta={n2m.delta:.2f} "
          f"(paper Fig. 3: gamma<1 for EN->ZH)")

    # 2. device latency planes: T = alpha_N*N + alpha_M*M + beta  (Eq. 2)
    edge = DeviceProfile("edge-gw", LinearLatencyModel(5e-4, 9e-3, 0.010))
    cloud = DeviceProfile("cloud", edge.model.scaled(5.0))   # 5x faster

    # 3. the CI decision rule (Eq. 1) with online RTT tracking
    sched = CNMTScheduler(edge=edge, cloud=cloud, n2m=n2m)
    profile = make_profile("cp1", seed=0)
    tx = TxEstimator(init_rtt_s=float(profile.rtt_at(0.0)))

    print(f"\n{'N':>4s} {'M_hat':>6s} {'T_edge':>8s} {'T_cloud':>8s} route")
    decisions = []
    for t_now, n_in in REQUESTS:
        d = sched.decide(n_in, t_now, tx)
        decisions.append(d)
        print(f"{n_in:4d} {d.m_hat:6.1f} {d.t_edge_pred*1e3:7.1f}ms "
              f"{d.t_cloud_pred*1e3:7.1f}ms "
              f"{'EDGE' if d.device == 0 else 'CLOUD'}")
    return {"n2m": (n2m.gamma, n2m.delta), "decisions": decisions}


if __name__ == "__main__":
    main()
