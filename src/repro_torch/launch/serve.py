"""Serving driver: batched LM generation, or the LM as a real tier of the
C-NMT engine.

    python -m repro_torch.launch.serve --smoke --device cpu --tiered
    python -m repro_torch.launch.serve --arch zamba2-1.2b --tiered

Port of ``repro/launch/serve.py`` without ``--mesh`` (one card); the
architecture defaults to the reference's, qwen3-8b (``--smoke`` for its
reduced same-family configuration; without it the full width, ≈32.8 GB
of float32 weights on the card).  It resolves the LM (weights drawn from
``--seed``) and serves it through a
:class:`~repro_torch.runtime.serving.GenerationSession`.  With
``--tiered`` the session is the real ``edge`` tier of a
:class:`~repro_torch.runtime.engine.CollaborativeEngine` beside a
modelled ``cloud`` tier behind the cp2 RTT trace; requests arrive in
concurrent slots of 4 (``submit_batch``), so edge-routed members run as
real batched generates.  It runs on ``cuda`` unless given ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.profiles import make_profile
from repro_torch.models.registry import resolve
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import GenerationSession, build_executor


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_plain(sess: GenerationSession, vocab: int, *, requests: int = 16,
                max_new: int = 8, seed: int = 0) -> np.ndarray:
    """One batch of up to 8 prompts of 12 tokens, generated twice (cold,
    then warm); returns the tokens."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(4, vocab, (min(requests, 8), 12)).astype(np.int32)
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        out = sess.generate(prompts, max_new=max_new)
        _sync(sess.model.device)
        print(f"[serve] generated {out.shape} in "
              f"{time.perf_counter() - t0:.3f}s ({label})")
    return out


def serve_tiered(sess: GenerationSession, vocab: int, *, requests: int = 16,
                 max_new: int = 8, seed: int = 0, slot: int = 4):
    """The LM session as the real edge tier of a two-tier engine; prompts
    of 4-47 tokens arrive ``slot`` at a time.  Returns the engine."""
    rng = np.random.default_rng(seed)
    profile = make_profile("cp2", seed=seed)
    engine = CollaborativeEngine(
        tiers=[
            Tier(DeviceProfile("edge", LinearLatencyModel(1e-4, 2e-3, 5e-3)),
                 executor=build_executor(sess, kind="solo", max_new=max_new,
                                         vocab_clip=vocab),
                 batched_executor=build_executor(sess, kind="batched",
                                                 max_new=max_new,
                                                 vocab_clip=vocab),
                 batch_size=slot, name="edge"),
            Tier(DeviceProfile("pod", LinearLatencyModel(2e-5, 4e-4, 2e-3)),
                 name="cloud", rtt_fn=profile.rtt_at),
        ],
        n2m=LinearN2M(0.8, 1.0))
    for i in range(0, requests, slot):
        reqs = [rng.integers(4, vocab, (int(rng.integers(4, 48)),)).astype(
                    np.int32) for _ in range(min(slot, requests - i))]
        engine.submit_batch(reqs, now_s=float(i))
    s = engine.stats()
    print(f"[serve] {s['requests']} reqs, mean "
          f"{s['mean_latency_s'] * 1e3:.1f}ms, offload "
          f"{s['offload_frac'] * 100:.0f}%")
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--tiered", action="store_true",
                    help="route through the C-NMT engine")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    r = resolve(args.arch, size="smoke" if args.smoke else "full",
                device=args.device, seed=args.seed)
    sess = GenerationSession(r.model, max_len=64)
    kw = dict(requests=args.requests, max_new=args.max_new, seed=args.seed)
    if args.tiered:
        return serve_tiered(sess, r.cfg.vocab_size, **kw)
    return serve_plain(sess, r.cfg.vocab_size, **kw)


if __name__ == "__main__":
    main()
