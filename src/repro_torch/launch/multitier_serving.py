"""Three-tier collaborative serving: a REAL BiLSTM seq2seq at the edge
gateway between a modelled on-device NPU below it and a modelled
continuous-batching cloud pod above it, with live queue-aware C-NMT
routing and deadline-aware admission control.

    python -m repro_torch.launch.multitier_serving --device cpu
    REPRO_SMOKE=1 python -m repro_torch.launch.multitier_serving --scale 1.0

Port of ``examples/multitier_serving.py``.  The gateway's model and
plane are :mod:`repro_torch.launch.collaborative_serving`'s (the BiLSTM
de-en at ``--scale`` on ``--device``, calibrated from timed
``forced_len`` translations); the NPU is that plane at 1/3 the speed,
the pod 6x faster.  The generalized rule argmin_k [T_queue,k + T_tx,k +
T_exe,k(N, M_hat)] routes each of 300 requests; a mid-run burst (10
near-simultaneous arrivals) shows the queue term diverting traffic off
the busy gateway.  The cloud pod serves batches of up to 8 (sub-linear
batch cost), and a second, harsher Poisson burst arrives with a tight
per-request SLO: the engine sheds what no tier can finish in time, and
stats() reports SLO attainment.  ``REPRO_SMOKE=1`` shrinks the streams
from 300 and 200 requests to 60 and 40.  It runs on ``cuda`` unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.core.latency_model import DeviceProfile
from repro_torch.core.length_regressor import LinearN2M, prefilter_pairs
from repro_torch.core.profiles import make_profile
from repro_torch.data.synthetic import make_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.collaborative_serving import (add_args, calibrate,
                                                      edge_translates)
from repro_torch.runtime.engine import CollaborativeEngine, Tier


def main(argv=None, *, model=None):
    """Returns ``{"stats": stats after the main stream, "slo_stats": stats
    after the overload burst, "burst_tiers": [...], "slo": (served, met,
    shed)}``.  ``model`` replaces the resolved BiLSTM."""
    ap = argparse.ArgumentParser()
    add_args(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    smoke = bool(int(os.environ.get("REPRO_SMOKE", "0")))
    n_req = 60 if smoke else 300          # main stream length
    burst_at = n_req // 2                 # 10 back-to-back arrivals here
    n_slo = 40 if smoke else 200          # overload-burst length

    print("== calibrating the edge model (real measurements) ==")
    forced, executor = edge_translates(model, scale=args.scale,
                                       device=args.device)
    edge_prof, cloud_prof = calibrate(forced, 6.0)
    # the on-device NPU sits below the gateway: 3x slower, but zero network
    npu_prof = DeviceProfile("npu", edge_prof.model.scaled(1 / 3.0), 0.05)

    corpus = make_corpus("de-en", 2300, seed=2, with_tokens=True)
    fit, eval_ = corpus.split(2000)
    nf, mf = prefilter_pairs(fit.n, fit.m_real)
    n2m = LinearN2M().fit(nf, mf)
    lan = make_profile("cp2", seed=2)
    wan = make_profile("cp1", seed=2)

    engine = CollaborativeEngine(
        tiers=[
            Tier(npu_prof, name="npu", servers=1, queue_capacity=4),
            Tier(edge_prof, executor=executor,
                 name="edge-gw", rtt_fn=lambda t: float(lan.rtt_at(t)) * 0.1,
                 servers=1, queue_capacity=16),
            Tier(cloud_prof, name="cloud-pod",
                 rtt_fn=lambda t: float(wan.rtt_at(t)) * 0.2, servers=4,
                 queue_capacity=16, batch_size=8, per_seq_overhead_s=2e-3),
        ],
        n2m=n2m, seed=0, refit_interval=100)

    print(f"== streaming {n_req} requests (mid-run burst) ==")
    t0 = time.perf_counter()
    for i in range(n_req):
        # a burst of 10 back-to-back arrivals mid-run saturates the gateway
        now = burst_at * 0.5 + (i - burst_at) * 0.005 \
            if burst_at <= i < burst_at + 10 else i * 0.5
        engine.submit(eval_.src[i][:64], now_s=now)
    wall = time.perf_counter() - t0
    s = engine.stats()
    frac = "  ".join(f"{k}={v*100:.0f}%" for k, v in s["tier_frac"].items())
    print(f"  mean latency {s['mean_latency_s']*1e3:.1f}ms  "
          f"p95 {s['p95_latency_s']*1e3:.1f}ms  "
          f"mean wait {s['mean_wait_s']*1e3:.2f}ms  (wall {wall:.1f}s)")
    print(f"  routed: {frac}")
    burst = [r for r in engine.results
             if burst_at <= r.req_id < burst_at + 10]
    print(f"  burst tiers: {[r.tier_name for r in burst]}")
    print(f"  tx estimate now: {s['tx_estimate_s']*1e3:.1f}ms, "
          f"refits: {engine.calibrator.n_refits}")

    print("== Poisson overload burst with an 80 ms SLO (deadline shedding) ==")
    rate = 10_000.0
    rng = np.random.default_rng(5)
    t_burst = n_req * 0.5 + 50.0 + np.cumsum(
        rng.exponential(1 / rate, size=n_slo))
    slo_results = []
    for j, now in enumerate(t_burst):
        slo_results.append(engine.submit(eval_.src[100 + j % 200][:64],
                                         now_s=float(now), deadline_s=0.08))
    served = [r for r in slo_results if not r.shed]
    shed = [r for r in slo_results if r.shed]
    met = [r for r in served if r.slo_met]
    s2 = engine.stats()
    print(f"  burst of {len(slo_results)} @{rate:.0f}/s: served {len(served)} "
          f"({len(met)} within SLO), shed {len(shed)} "
          f"(admission predicted a certain miss)")
    print(f"  overall SLO attainment {s2['slo_attainment']*100:.1f}%  "
          f"shed total {s2['shed']}  "
          f"rejected(force-enqueued) {s2['rejected']}")
    return {"stats": s, "slo_stats": s2,
            "burst_tiers": [r.tier_name for r in burst],
            "slo": (len(served), len(met), len(shed)), "wall_s": wall}


if __name__ == "__main__":
    main()
