"""Continuous in-flight batching vs block-to-completion, side by side.

    python -m repro_torch.launch.continuous_serving --device cpu
    REPRO_SMOKE=1 python -m repro_torch.launch.continuous_serving

Port of ``examples/continuous_serving.py``.  The same smoke-scale qwen3
LM (weights drawn from seed 0) serves the same Poisson arrival schedule
twice through ``CollaborativeEngine.serve_continuous``:

* ``refill=False`` — block-to-completion: a block of up to ``max_slots``
  prompts is admitted only when the slot table is EMPTY and runs until
  every member finishes, so one long sequence holds the whole block and
  arrivals wait a full block;
* ``refill=True`` — continuous batching: finished rows evict between
  decode steps and queued prompts prefill into the freed slots of the
  LIVE batch, so short requests leave in their own time.

Both runs execute real decode steps; the engine lays the measured
wall-clock onto the virtual arrival schedule, so the printed latencies
are comparable (absolute numbers vary with the machine).  ``REPRO_SMOKE=1``
shrinks the schedule from 32 requests to 10.  It runs on ``cuda`` unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.models.registry import resolve
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import ContinuousGenerationSession

MAX_SLOTS = 4
MAX_NEW = 10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n_req = 10 if bool(int(os.environ.get("REPRO_SMOKE", "0"))) else 32

    print("== building the slot-table session (smoke-scale qwen3 family) ==")
    r = resolve("qwen3-8b", size="smoke", device=args.device, seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, r.cfg.vocab_size,
                            size=int(rng.integers(2, 12))).astype(np.int32)
               for _ in range(n_req)]
    arrivals = np.cumsum(rng.exponential(1 / 30.0, n_req))
    npu = DeviceProfile("npu", LinearLatencyModel(0.0, 0.0, 0.01), 0.0)

    stats = {}
    for refill in (False, True):
        session = ContinuousGenerationSession(
            r.model, max_slots=MAX_SLOTS,
            max_len=max(len(p) for p in prompts) + MAX_NEW + 8)
        # warm the admission shapes, then reset the table for the clean run
        session.serve(prompts, max_new=MAX_NEW, refill=refill)
        session.reset()
        engine = CollaborativeEngine(
            n2m=LinearN2M(1.0, 0.0),
            tiers=[Tier(npu, name="npu", servers=1, queue_capacity=256,
                        batch_size=MAX_SLOTS, continuous_session=session)],
            seed=7)
        engine.serve_continuous(prompts, arrival_s=arrivals,
                                max_new=MAX_NEW, refill=refill)
        s = stats[refill] = engine.stats()
        mode = "continuous (refill=True) " if refill \
            else "block-to-completion     "
        print(f"  {mode} p50={s['p50_latency_s']*1e3:7.1f}ms "
              f"p95={s['p95_latency_s']*1e3:7.1f}ms  "
              f"steps={session.n_steps} prefill waves={session.n_prefills} "
              f"peak live={session.peak_live}")
    return stats


if __name__ == "__main__":
    main()
