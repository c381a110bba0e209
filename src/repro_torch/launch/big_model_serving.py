"""Serve big-stack architectures with batched requests, as two C-NMT
tiers.

    python -m repro_torch.launch.big_model_serving --device cpu
    REPRO_SMOKE=1 python -m repro_torch.launch.big_model_serving --size full
    torchrun --nproc-per-node=4 -m repro_torch.launch.big_model_serving \
        --device cpu

Port of ``examples/big_model_serving.py``.  Resolves qwen3-8b through
the model registry (``--size smoke``, the default as in the reference:
2 layers, d_model 256; ``--size full``: 8.19 B parameters, ~32.8 GB in
float32) and runs batched prefill + greedy decode through a
:class:`~repro_torch.runtime.serving.GenerationSession`, then routes a
request stream through the C-NMT engine with qwen3-8b as the cloud tier
and rwkv6-3b (O(1)-state decode; 3.07 B parameters at full size) as the
edge tier.  Weights are drawn from seeds 0 (qwen3-8b) and 1 (rwkv6-3b).
On the card, full size runs both at full width and depth, ~45 GB, with
qwen3-8b's prefill on ``flash_attention``, its decode on
``flash_decode`` and rwkv6-3b's prefill on ``rwkv6_wkv``.

Under a ``torch.distributed`` world of 4 (``torchrun``; gloo on
``--device cpu``, NCCL on the cards) the qwen3-8b session is sharded
over a 2x2 ``(data, model)`` mesh
(:func:`repro_torch.runtime.sharded.make_sharded_session`): same decode
tokens, more devices.  Rank 0 drives the engine and broadcasts each
sharded call, which the other ranks follow (``launch/serve.py``'s
``Leader`` / ``follow``).

``REPRO_SMOKE=1`` shrinks the routed stream from 20 requests to 6.  It
runs on ``cuda`` unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.profiles import make_profile
from repro_torch.device import resolve_device
from repro_torch.launch.serve import Leader, follow, init_mesh
from repro_torch.models.registry import resolve
from repro_torch.runtime import graphs
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import GenerationSession, build_executor
from repro_torch.runtime.sharded import make_sharded_session

MAX_LEN, MAX_NEW = 48, 8


def _world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _recorded(name, executor, routed):
    """``executor`` that also keeps ``(tier, tokens, m_out, out)`` of
    each call in ``routed``."""
    def run(tokens):
        m, out = executor(tokens)
        routed.append((name, np.asarray(tokens, np.int32), m, out))
        return m, out
    return run


def main(argv=None, *, cloud=None, edge=None):
    """Returns ``{"prompts", "tokens", "stats", "routed", "layout"}``: the
    batched generate's prompts and warm tokens, the engine's stats and
    each routed call's ``(tier, tokens, m_out, out)`` (on rank 0; None on
    the other ranks of a sharded run).  ``cloud`` / ``edge`` replace the
    resolved qwen3-8b / rwkv6-3b (a test passes models holding the
    reference's weights)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--size", default="smoke", choices=("smoke", "full"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_req = 6 if bool(int(os.environ.get("REPRO_SMOKE", "0"))) else 20

    mesh = own_group = None
    if _world() >= 4:
        own_group = not dist.is_initialized()
        if own_group:
            device, mesh = init_mesh("2x2", device.type)
        else:
            from repro_torch.launch.mesh import make_host_mesh
            mesh = make_host_mesh((2, 2), ("data", "model"), device.type)
    try:
        return _serve(args, device, n_req, mesh, cloud, edge)
    finally:
        if own_group:
            graphs.release_all()     # before NCCL destroys its communicators
            dist.destroy_process_group()


def _serve(args, device, n_req, mesh, cloud, edge):
    if cloud is None:
        cloud = resolve("qwen3-8b", size=args.size, device=device,
                        seed=0).model
    cfg = cloud.cfg
    leader = layout = None
    if mesh is not None:
        sharded = make_sharded_session(cloud, mesh, max_len=MAX_LEN,
                                       batch_size=4)
        layout = sharded.layout
        if dist.get_rank() != 0:
            follow(sharded)
            return None
        sess = leader = Leader(sharded)
    else:
        sess = GenerationSession(cloud, max_len=MAX_LEN)
    print(f"== batched serving with the big-model runtime ({args.size} "
          f"size) ==")
    if layout is not None:
        print(f"  qwen tier sharded over a 2x2 mesh (layout={layout})")
    try:
        return _route(args, device, n_req, sess, cfg, edge, layout)
    finally:
        if leader is not None:
            leader.stop()


def _route(args, device, n_req, sess, cfg, edge, layout):
    rng = np.random.default_rng(0)
    prompts = rng.integers(4, cfg.vocab_size, (4, 12)).astype(np.int32)
    t0 = time.perf_counter()
    out = sess.generate(prompts, max_new=MAX_NEW)
    print(f"  generated {out.shape} tokens in {time.perf_counter()-t0:.2f}s "
          f"(includes the first kernel launch)")
    t0 = time.perf_counter()
    out = sess.generate(prompts, max_new=MAX_NEW)
    print(f"  warm generate: {time.perf_counter()-t0:.3f}s for 4x8 tokens")

    print("\n== C-NMT routing between two model tiers ==")
    if edge is None:
        edge = resolve("rwkv6_3b", size=args.size, device=device,
                       seed=1).model          # underscores normalize too
    edge_sess = GenerationSession(edge, max_len=MAX_LEN)
    routed = []
    edge_exec = _recorded("edge-rwkv", build_executor(
        edge_sess, kind="solo", max_new=MAX_NEW,
        vocab_clip=edge.cfg.vocab_size), routed)
    cloud_exec = _recorded("pod-qwen", build_executor(
        sess, kind="solo", max_new=MAX_NEW, vocab_clip=cfg.vocab_size),
        routed)

    profile = make_profile("cp2", seed=3)
    engine = CollaborativeEngine(
        tiers=[
            Tier(DeviceProfile("edge-rwkv",
                               LinearLatencyModel(1e-4, 2e-3, 0.01)),
                 executor=edge_exec),
            Tier(DeviceProfile("pod-qwen",
                               LinearLatencyModel(2e-5, 4e-4, 0.002)),
                 executor=cloud_exec, rtt_fn=profile.rtt_at),
        ],
        n2m=LinearN2M(0.7, 1.0), seed=0)

    for i in range(n_req):
        n_len = int(rng.integers(4, 40))
        engine.submit(rng.integers(4, 256, (n_len,)).astype(np.int32),
                      now_s=float(i))
    s = engine.stats()
    print(f"  {n_req} requests: mean {s['mean_latency_s']*1e3:.1f}ms, "
          f"offloaded {s['offload_frac']*100:.0f}% to the pod tier")
    return {"prompts": prompts, "tokens": out, "stats": s, "routed": routed,
            "layout": layout}


if __name__ == "__main__":
    main()
