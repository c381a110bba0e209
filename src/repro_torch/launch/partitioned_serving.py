"""Partitioned serving: encoder at the edge, decoder in the cloud.

    python -m repro_torch.launch.partitioned_serving --device cpu
    REPRO_SMOKE=1 python -m repro_torch.launch.partitioned_serving --scale 1.0

Port of ``examples/partitioned_serving.py``.  ``PlacementPlan``
generalizes C-NMT's whole-request tier choice: the scheduler may place
the encode and decode legs of ONE request on DIFFERENT tiers, shipping
the encoder states (n x d_model activations) over the inter-tier
backbone instead of paying the slow client<->cloud link for the whole
round trip.

Two parts:

1. The real split path on the paper's BiLSTM de-en (``--scale``: 0.15 as
   the reference, 1.0 the paper's width, 25.52 M parameters; weights
   drawn from seed 0): ``encode()`` at one tier produces an
   ``EncoderStates``, its exact wire payload is priced, and
   ``decode_from_states()`` at another tier finishes the translation —
   bit for bit the fused path.
2. A modelled A/B: the same request stream through a 3-tier engine with
   splits disabled vs enabled.  The winning plan (encode at the edge,
   decode in the cloud) shows up in the stats as a strict latency win.
   Numpy only, so its stats equal the reference's bitwise.

``REPRO_SMOKE=1`` shrinks the modelled stream from 400 requests to 60.
It runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.core.latency_model import (ActivationCostModel,
                                            DeviceProfile,
                                            LinearLatencyModel)
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.tx_estimator import LinkModel, TxEstimator
from repro_torch.device import resolve_device
from repro_torch.models.registry import resolve
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import build_executor

# device: no network, slow decode; edge: cheap encoder on a 5 ms LAN;
# cloud: 25x faster decode behind a 90 ms WAN.  A 100 Mbps backbone
# connects edge -> cloud: the classic split regime.
DEV = LinearLatencyModel(3e-4, 5e-3, 2e-3)
EDGE = LinearLatencyModel(2e-5, 2.5e-3, 4e-3)
CLOUD = LinearLatencyModel(1e-5, 1e-4, 2e-3)
BACKBONE_RTT, BACKBONE_BW = 4e-3, 1e9


def build_engine(allow_split: bool) -> CollaborativeEngine:
    links = LinkModel(3)
    links.add_link(1, 2, TxEstimator(init_rtt_s=BACKBONE_RTT,
                                     bandwidth_bps=BACKBONE_BW))
    return CollaborativeEngine(
        n2m=LinearN2M(1.0, 0.0),
        tiers=[
            Tier(DeviceProfile("dev", DEV, 0.05), name="dev"),
            Tier(DeviceProfile("edge", EDGE, 0.05), name="edge",
                 rtt_fn=lambda t: 5e-3, bandwidth_bps=200e6),
            Tier(DeviceProfile("cloud", CLOUD, 0.05), name="cloud",
                 rtt_fn=lambda t: 90e-3, bandwidth_bps=20e6),
        ],
        links=links,
        inter_rtt_fns={(1, 2): lambda t: BACKBONE_RTT},
        activation=ActivationCostModel(d_model=512, dtype_bytes=4),
        allow_split=allow_split,
        seed=0)


def main(argv=None, *, model=None):
    """Returns ``{"split": {...}, "whole-only": stats, "split-capable":
    stats}``: part 1's source, payload bytes, both paths' lengths and
    tokens (the fused path's whole row), then part 2's two ``stats()``.
    ``model`` replaces the resolved BiLSTM (a test passes one holding the
    reference's weights)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--scale", type=float, default=0.15,
                    help="the BiLSTM's width (1.0: the paper's)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_req = 60 if bool(int(os.environ.get("REPRO_SMOKE", "0"))) else 400

    # ------------------------------------------------------------ part 1
    print("== real split execution: encode -> EncoderStates -> decode ==")
    if model is None:
        model = resolve("cnmt:de-en", scale=args.scale, vocab=1000,
                        max_decode_len=48, device=device, seed=0).model
    encode_exec, decode_exec = build_executor(model, kind="split")
    fused = model.make_translate_batched()

    rng = np.random.default_rng(7)
    src = rng.integers(3, 1000, size=24).astype(np.int32)
    states = encode_exec(src)                      # "edge" leg
    payload = states.payload_bytes()               # what the backbone ships
    m_split, toks_split = decode_exec(states)      # "cloud" leg
    lens_f, toks_f = fused(src[None, :])
    m_fused = int(lens_f[0])
    same = (m_split == m_fused and np.array_equal(
        toks_split, toks_f[0, :max(m_fused, 1)]))
    print(f"  n={src.size} -> EncoderStates payload {payload} bytes "
          f"({payload / src.size:.0f} B/token)")
    print(f"  split decode: m={m_split}, fused: m={m_fused}, "
          f"tokens identical: {same}")
    assert same, "split path diverged from the fused path"

    # ------------------------------------------------------------ part 2
    print("== modelled 3-tier A/B: whole-only vs split-capable routing ==")
    lens = rng.integers(24, 160, n_req)
    arrivals = np.cumsum(rng.exponential(0.2, n_req))
    stats = {"split": {"src": src, "payload": payload, "m_split": m_split,
                       "tokens": toks_split, "m_fused": m_fused,
                       "fused_tokens": toks_f[0]}}
    for mode, split in (("whole-only", False), ("split-capable", True)):
        eng = build_engine(split)
        for i in range(n_req):
            toks = np.ones(int(lens[i]), np.int32)
            eng.submit(toks, now_s=float(arrivals[i]))
        s = stats[mode] = eng.stats()
        frac = "  ".join(f"{k}={v*100:.0f}%"
                         for k, v in s["tier_frac"].items())
        print(f"  {mode:14s} mean {s['mean_latency_s']*1e3:6.1f}ms  "
              f"p95 {s['p95_latency_s']*1e3:6.1f}ms  splits {s['split']}")
        print(f"  {'':14s} routed: {frac}")

    gain = (1.0 - stats["split-capable"]["mean_latency_s"]
            / stats["whole-only"]["mean_latency_s"]) * 100.0
    print(f"  split-capable routing cut mean latency by {gain:.1f}% "
          f"({stats['split-capable']['split']}/{n_req} requests split)")
    return stats


if __name__ == "__main__":
    main()
