"""Serving driver: batched LM generation, or the LM as a real tier of the
C-NMT engine.

    python -m repro_torch.launch.serve --smoke --device cpu --tiered
    python -m repro_torch.launch.serve --arch zamba2-1.2b --tiered
    torchrun --nproc-per-node=4 -m repro_torch.launch.serve --mesh 2x2 \
        --device cpu --smoke --tiered

Port of ``repro/launch/serve.py``; the
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

``--mesh DxM`` serves the LM sharded over a ``(data, model)`` mesh
(:func:`repro_torch.runtime.sharded.make_sharded_session`), under
``torchrun --nproc-per-node=D*M``: gloo on ``--device cpu``, NCCL on the
cards (one card: ``--mesh 1x1``).  Every call on a sharded session is a
collective, so rank 0 alone drives it (the engine, its measured times
and routes) and broadcasts each session call to the other ranks, which
follow until a stop message; an engine on every rank would book other
times, take other routes and hang a collective.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.profiles import make_profile
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import resolve
from repro_torch.runtime import graphs
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import GenerationSession, build_executor
from repro_torch.runtime.sharded import make_sharded_session


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


class Leader:
    """Rank 0's handle on a sharded session: each generate call is first
    broadcast to the other ranks, which make it too (:func:`follow`)."""

    def __init__(self, sess):
        self.sess = sess

    def __getattr__(self, name):
        return getattr(self.sess, name)

    def _call(self, name, *args, **kwargs):
        dist.broadcast_object_list([(name, args, kwargs)], src=0)
        return getattr(self.sess, name)(*args, **kwargs)

    def generate(self, *args, **kwargs):
        return self._call("generate", *args, **kwargs)

    def generate_with_lengths(self, *args, **kwargs):
        return self._call("generate_with_lengths", *args, **kwargs)

    def stop(self) -> None:
        dist.broadcast_object_list([None], src=0)


def follow(sess) -> None:
    """A follower rank: make each call rank 0 broadcasts, until it stops."""
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return
        name, args, kwargs = msg[0]
        getattr(sess, name)(*args, **kwargs)


def init_mesh(spec: str, device: str):
    """(device, mesh) of this ``torchrun`` rank for ``--mesh DxM``: the
    process group (gloo on the CPU, NCCL on the cards, 60 s timeout) and
    the ``(data, model)`` mesh over it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--mesh runs under torchrun: torchrun "
                           "--nproc-per-node=D*M -m repro_torch.launch.serve "
                           "--mesh DxM ...")
    d, m = (int(x) for x in spec.lower().split("x"))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=60))
    return dev, make_host_mesh((d, m), ("data", "model"), dev.type)


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
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="shard the LM over a (data, model) mesh, e.g. 2x2 "
                         "(under torchrun with D*M processes)")
    args = ap.parse_args(argv)

    device, mesh = (args.device, None) if args.mesh is None \
        else init_mesh(args.mesh, args.device)
    r = resolve(args.arch, size="smoke" if args.smoke else "full",
                device=device, seed=args.seed)
    kw = dict(requests=args.requests, max_new=args.max_new, seed=args.seed)
    serve = serve_tiered if args.tiered else serve_plain
    if mesh is None:
        return serve(GenerationSession(r.model, max_len=64),
                     r.cfg.vocab_size, **kw)
    sess = make_sharded_session(r.model, mesh, max_len=64,
                                batch_size=min(args.requests, 8))
    try:
        if dist.get_rank() != 0:
            return follow(sess)
        print(f"[serve] sharded over a {args.mesh} mesh, layout="
              f"{sess.layout}, {sess.model.local_bytes()} parameter bytes "
              "on rank 0")
        leader = Leader(sess)
        try:
            return serve(leader, r.cfg.vocab_size, **kw)
        finally:
            leader.stop()
    finally:
        graphs.release_all()     # before NCCL destroys its communicators
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
