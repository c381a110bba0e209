"""End-to-end collaborative serving: REAL model at the edge, modelled
cloud tier, live C-NMT routing (the paper's testbed in miniature).

    python -m repro_torch.launch.collaborative_serving --device cpu
    REPRO_SMOKE=1 python -m repro_torch.launch.collaborative_serving \
        --scale 1.0

Port of ``examples/collaborative_serving.py``.  The edge gateway runs
the paper's BiLSTM de-en (``--scale``: 0.15 as the reference, 1.0 the
paper's width; weights drawn from seed 0) on ``--device``; its latency
plane is calibrated from timed ``forced_len`` translations, and the
cloud tier is that plane sped up 5x behind a replayed RTT trace.  200
requests (30 under ``REPRO_SMOKE=1``) stream through the
CollaborativeEngine.  It runs on ``cuda`` unless given ``--device cpu``.

The timed translate is the fused batched one at B=1: it returns host
arrays, whose copy off the card waits for the last kernel, so the clock
reads device time.  Corpus tokens above the model's 1000-word vocabulary
are clamped to its last id, as the reference's embedding gather clamps
them.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.core.calibration import (make_edge_cloud_pair,
                                          measure_seq2seq_grid)
from repro_torch.core.length_regressor import LinearN2M, prefilter_pairs
from repro_torch.core.profiles import make_profile
from repro_torch.data.synthetic import make_corpus
from repro_torch.device import resolve_device
from repro_torch.models.registry import resolve
from repro_torch.runtime.engine import CollaborativeEngine, Tier

VOCAB = 1000


def edge_translates(model=None, *, scale: float = 0.15, device=None):
    """``(forced, executor)`` of the BiLSTM de-en at ``scale`` on
    ``device`` (or of ``model``): ``forced(tokens, m) -> (m, tokens)``
    decodes exactly ``m`` tokens, ``executor(tokens) -> (m_out,
    tokens)`` is the greedy translate; both at B=1."""
    if model is None:
        model = resolve("cnmt:de-en", scale=scale, vocab=VOCAB,
                        max_decode_len=64, device=resolve_device(device),
                        seed=0).model
    translate = model.make_translate_batched()
    top = model.cfg.vocab_src - 1

    def forced(tokens, m):
        lens, out = translate(np.asarray(tokens, np.int32)[None], None, m)
        return int(lens[0]), out[0]

    def executor(tokens):
        lens, out = translate(np.minimum(np.asarray(tokens, np.int32),
                                         top)[None])
        m = int(lens[0])
        return m, out[0, :max(m, 1)]

    return forced, executor


def calibrate(forced, speedup: float):
    """The edge plane from forced-length translates on the reference's
    grid (N in 4..32, M in N/2, N, 2N), and the modelled cloud
    ``speedup`` x faster."""
    n, m, t = measure_seq2seq_grid(
        forced, (4, 8, 16, 32), lambda nn: [max(2, int(0.5 * nn)), nn, 2 * nn],
        reps=1, vocab=VOCAB)
    return make_edge_cloud_pair(n, m, t, speedup=speedup)


def add_args(ap):
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.15,
                    help="the BiLSTM's width (1.0: the paper's)")


def main(argv=None, *, model=None):
    """Returns ``{"stats": engine.stats(), "plane": (alpha_n, alpha_m,
    beta), "wall_s": ...}``.  ``model`` replaces the resolved BiLSTM."""
    ap = argparse.ArgumentParser()
    add_args(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    n_req = 30 if bool(int(os.environ.get("REPRO_SMOKE", "0"))) else 200

    print("== calibrating the edge model (real measurements) ==")
    forced, executor = edge_translates(model, scale=args.scale,
                                       device=args.device)
    edge_prof, cloud_prof = calibrate(forced, 5.0)
    pl = edge_prof.model
    print(f"  plane: aN={pl.alpha_n*1e3:.3f}ms aM={pl.alpha_m*1e3:.3f}ms "
          f"b={pl.beta*1e3:.1f}ms")

    corpus = make_corpus("de-en", 2200, seed=1, with_tokens=True)
    fit, eval_ = corpus.split(2000)
    nf, mf = prefilter_pairs(fit.n, fit.m_real)
    n2m = LinearN2M().fit(nf, mf)
    profile = make_profile("cp2", seed=1)

    # the tiny demo model is far faster than the paper's Jetson-scale
    # edge, so use a LAN-class link (RTT/5) to keep the edge/cloud
    # crossover inside the corpus length range
    engine = CollaborativeEngine(
        tiers=[Tier(edge_prof, executor=executor),
               # cloud is modelled (as the paper simulates)
               Tier(cloud_prof,
                    rtt_fn=lambda t: float(profile.rtt_at(t)) * 0.2)],
        n2m=n2m, seed=0)

    print(f"== streaming {n_req} requests through the gateway ==")
    t0 = time.perf_counter()
    for i in range(n_req):
        engine.submit(eval_.src[i][:64], now_s=i * 0.5)
    stats = engine.stats()
    wall = time.perf_counter() - t0
    print(f"  mean latency {stats['mean_latency_s']*1e3:.1f}ms  "
          f"p95 {stats['p95_latency_s']*1e3:.1f}ms  "
          f"offloaded {stats['offload_frac']*100:.0f}%  "
          f"(wall {wall:.1f}s)")
    print(f"  tx estimate now: {stats['tx_estimate_s']*1e3:.1f}ms")
    return {"stats": stats, "plane": (pl.alpha_n, pl.alpha_m, pl.beta),
            "wall_s": wall}


if __name__ == "__main__":
    main()
