"""Fault-tolerant collaborative serving: outages, failover, breakers.

    python -m repro_torch.launch.fault_tolerant_serving --device cpu
    REPRO_SMOKE=1 python -m repro_torch.launch.fault_tolerant_serving

Port of ``examples/fault_tolerant_serving.py``.  Part 1 replays the same
request stream through the CollaborativeEngine twice against an injected
mid-run cloud outage (a deterministic :class:`FaultSchedule` — the DES
and the engine consume the same object):

* ``retry=None``  — the no-retry baseline: an attempt that hits the
  dead tier is lost after the detection time.
* ``retry=RetryPolicy()`` — failover: the failed attempt re-enters the
  router with the dead tier masked, the tier's circuit breaker opens
  after consecutive failures and steers later requests away up front,
  and a half-open probe rediscovers the tier once the outage ends.

Part 2 crashes a REAL executor: :func:`build_executor(kind="raw",
faults=...)` wraps the edge's ``tokens -> (m_out, out)`` callable so
chosen calls raise :class:`TierFaultError` through the engine's
execution boundary — the same failover loop catches it and re-dispatches
to the cloud.  All of it is numpy; no kernel runs.  ``REPRO_SMOKE=1``
shrinks the stream from 400 requests to 120.  It runs on ``cuda`` unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.core.faults import FaultSchedule, RetryPolicy, TierOutage
from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.profiles import make_profile
from repro_torch.device import resolve_device
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import TierFaultError, build_executor

RATE_HZ = 20.0


def toy_translate(tokens):
    # stand-in for a GenerationSession executor: echo-length "translation"
    return len(tokens), np.asarray(tokens, np.int32)


def main(argv=None):
    """Returns ``{"no-retry": stats, "failover": stats, "crash": stats}``:
    part 1's two engines' and part 2's ``stats()``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    n_req = 120 if bool(int(os.environ.get("REPRO_SMOKE", "0"))) else 400

    edge_prof = DeviceProfile("edge", LinearLatencyModel(2e-3, 8e-3, 0.01),
                              0.0)
    cloud_prof = DeviceProfile("cloud",
                               LinearLatencyModel(4e-4, 1.6e-3, 0.002), 0.0)
    profile = make_profile("cp2", seed=7)

    span = n_req / RATE_HZ
    faults = FaultSchedule(outages=(TierOutage(1, 0.2 * span, 0.6 * span),))
    print(f"== part 1: cloud outage {faults.outages[0].start_s:.1f}s -> "
          f"{faults.outages[0].end_s:.1f}s over a {span:.0f}s stream ==")

    def build(retry):
        return CollaborativeEngine(
            tiers=[Tier(edge_prof),
                   Tier(cloud_prof,
                        rtt_fn=lambda t: float(profile.rtt_at(t)))],
            n2m=LinearN2M(1.0, 0.0),
            seed=0, faults=faults, retry=retry)

    rng = np.random.default_rng(3)
    lengths = rng.integers(2, 200, n_req)
    stats = {}
    for name, retry in (("no-retry", None), ("failover", RetryPolicy())):
        eng = build(retry)
        for i, n in enumerate(lengths):
            eng.submit(np.zeros(int(n), np.int32), now_s=i / RATE_HZ)
        s = stats[name] = eng.stats()
        print(f"  {name:9s} availability={s['availability']:.3f} "
              f"lost={s['fault_lost']} retries={s['retries']} "
              f"failovers={s['failovers']} "
              f"breaker_opens={s['breaker_opens']} "
              f"mean_attempts={s['mean_attempts']:.3f}")

    print("== part 2: a REAL executor that crashes (TierFaultError) ==")
    crashing = build_executor(toy_translate, kind="raw", faults={1, 2},
                              fault_message="edge process killed")
    eng = CollaborativeEngine(
        tiers=[Tier(edge_prof, executor=crashing),
               # WAN so bad the edge always wins...
               Tier(cloud_prof, rtt_fn=lambda t: 5.0)],
        n2m=LinearN2M(1.0, 0.0),
        seed=0, retry=RetryPolicy())
    # ...except when its executor crashes: calls 1 and 2 raise inside
    # tier.run and the failover loop re-dispatches them to the cloud
    for i in range(4):
        r = eng.submit(np.zeros(4, np.int32), now_s=float(i))
        print(f"  req {i}: device={'edge' if r.device == 0 else 'cloud'} "
              f"attempts={r.attempts} failed_tiers={r.failed_tiers}")
    assert crashing.calls["faults"] == 2, crashing.calls
    stats["crash"] = eng.stats()
    try:
        build_executor(toy_translate, kind="raw", faults={0})(
            np.zeros(4, np.int32))
    except TierFaultError as e:
        print(f"  raw executor raise: {type(e).__name__}: {e}")
    print("done.")
    return stats


if __name__ == "__main__":
    main()
