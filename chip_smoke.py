"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 is
the target).  It imports ``torch`` and the port (``src/repro_torch``)
only, builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, and then:

1. prints the card's name, the device count and ``nvidia-smi``'s name and
   power limit;
2. builds the kernels and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes: the attention kernels at Marian's 8 heads and
   zamba2's 32 (float32 within 2e-5, bfloat16 within 2e-2), ``rwkv6_wkv``
   at rwkv6-3b's 40 heads of 64 (within 2e-4) and ``ssd_scan`` at
   zamba2's 64 heads of P = N = 64 (within 3e-4), at the chunk lengths
   prefill meets, with and without an initial state, and under every
   value tile their hosts can pick; then the attention
   kernels' edge cases: a 2048-slot cache cut into many splits, GQA,
   length 0 in a batch, every query tile on ragged shapes (head dims 16,
   32, 64, 128, causal with S != T), a captured ``flash_decode`` replayed
   after ``lengths`` changed on the device, and bitwise repeatability;
4. builds the paper's Marian en-zh model at full width
   (``resolve("cnmt:en-zh", scale=1.0)``, random weights from a seed) and
   holds its encoder output and four decode-step logits against the same
   model with the plain kernels, within 1e-4;
5. drives the Marian main path: calibrates the card tier's latency plane
   through ``forced_len`` translations, fits the N->M regressor on the
   en-zh corpus, builds a ``CollaborativeEngine`` with the real card tier
   and a modelled cloud tier behind a replayed RTT trace, submits 16
   requests and one concurrent slot of 8, and checks that both attention
   kernels launched;
6. times each kernel (CUDA events over a CUDA graph) beside its bound
   (float32 FLOP at 3 x TF32's 165 TFLOP/s), its plain version and, where
   one PyTorch call computes the same function, that call
   (``rwkv6_wkv`` also at B=1 S=37, the chunk of 1 a prime prompt gives
   rwkv6-3b), and each scan kernel under every value tile its host
   chooses between; the tokens/s and peak memory of one batch-8
   translate; and Marian's decode step, eager and from a CUDA graph, with
   ``flash_decode``'s share of it;
7. builds rwkv6-3b at full width (``resolve("rwkv6-3b", size="full")``,
   random weights from a seed), holds its prefill and four decode-step
   logits against the same model on the plain kernels (within 1e-4), runs
   ``launch/serve.py``'s tiered path (a ``GenerationSession`` with
   ``max_len=64`` as the real edge tier of the engine, 8 requests in
   concurrent slots of 4, ``max_new=8``), checks that ``rwkv6_wkv``
   launched, and prints prefill and decode tokens/s and peak memory;
8. the same for zamba2-1.2b, checking that ``ssd_scan``,
   ``flash_attention`` and ``flash_decode`` launched;
9. builds the paper's two RNN models at full width (the BiLSTM de-en and
   the GRU fr-en, ``resolve("cnmt:<pair>", scale=1.0)``), holds each
   against a CPU copy of the same weights (encoder outputs and carries
   on a ragged batch of up to 128 tokens, four decode-step logits,
   within 1e-4, or ten times the effect of a 1e-7 perturbation of the
   embeddings where the recurrence amplifies rounding past that),
   calibrates each card plane on phase 5's grid and prints alpha_N,
   alpha_M and beta of all three models (the paper's Table I planes on
   this card), with translate rates and the decode step eager vs from a
   CUDA graph;
10. split placement for each of the three models: ``build_executor(
   model, kind="split")``, the legs bitwise equal to the fused translate
   on the card (8 ragged requests), states encoded on the CPU copy
   decoded on the card, then a three-tier ``CollaborativeEngine`` with
   ``allow_split=True`` (a modelled device tier; the card as the edge,
   carrying both legs; the card's decode leg behind the cp1 RTT trace as
   a 5x faster cloud, the trace rescaled per model so that its mean
   one-way delay sits inside the window where split(edge, cloud) is the
   cheapest plan for that model's calibrated planes) serving 24
   requests, checking that split plans ran on the real legs with the
   shipped states' measured payload, and that Marian's split launched
   both attention kernels.

It prints one JSON line of kernel numbers (each kernel's launches summed
over the main paths that run it) and, last, the line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a card it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

F32_TOL, BF16_TOL, MODEL_TOL = 2e-5, 2e-2, 1e-4
WKV_TOL, SSD_TOL = 2e-4, 3e-4    # tests/test_kernels.py's rwkv6 / ssd limits
# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth and tensor-core
# rates.  Float32 FLOP are bounded as float32-accurate tensor-core products,
# 3 x TF32 at 495 TFLOP/s = 165 TFLOP/s (the attention kernels run them so;
# the CUDA cores' 67 TFLOP/s would let a kernel read above its bound)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
F32_PEAK_NOTE = "float32 as 3xTF32 at 165 TFLOP/s"
H, DH, D = 8, 64, 512           # Marian en-zh: 8 heads of 64
MAX_DECODE = 256
WKV_H, WKV_P = 40, 64           # rwkv6-3b: 40 heads of 64
SSD_H, SSD_P, SSD_N = 64, 64, 64  # zamba2-1.2b: 64 heads, P = N = 64
ZA_H = 32                       # zamba2-1.2b shared attention: 32 heads of 64


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def randn(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def within(what: str, got, want, tol: float) -> None:
    """Raise unless every output of ``got`` (a tensor or a tuple) is finite
    and within ``tol`` of ``want``'s."""
    got = torch.cat([t.float().flatten() for t in _outputs(got)])
    err = max_err(got, torch.cat([t.float().flatten()
                                  for t in _outputs(want)]))
    log(f"  {what}: max_abs_err={err:.3e}")
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"{what}: error {err} > {tol}")


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call, CUDA events around ``iters`` eager calls: includes
    the host's enqueue cost whenever that is slower than the device."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, per_graph: int = 50, replays: int = 10) -> float:
    """Mean device ms per call: ``per_graph`` calls captured in one CUDA
    graph, CUDA events around ``replays`` replays, so the host's launch
    cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


# --------------------------------------------------------------- phase 3 --
def check_kernels(fa, da, gen):
    """Kernel vs plain version at the main path's shapes."""
    cases = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = "f32" if dtype == torch.float32 else "bf16"
        for b in (1, 8):
            # self-attention: the folded (B, T, D) decoder cache, lengths =
            # pos + 1 at the first step, mid-decode and the last step
            q = randn(gen, (b, D), dtype).view(b, H, DH)
            kc = randn(gen, (b, MAX_DECODE, D), dtype)
            vc = randn(gen, (b, MAX_DECODE, D), dtype)
            kv = kc.view(b, MAX_DECODE, H, DH), vc.view(b, MAX_DECODE, H, DH)
            for length in (1, 37, 256):
                lens = torch.full((b,), length, dtype=torch.int32,
                                  device="cuda")
                within(f"flash_decode {name} B={b} T=256 self len={length}",
                       da.flash_decode_cuda(q, *kv, lens),
                       da.flash_decode_plain(q, *kv, lens), tol)
                cases += 1
            # cross-attention: encoder K/V of a ragged source batch
            src = 40
            xk = randn(gen, (b, src, D), dtype).view(b, src, H, DH)
            xv = randn(gen, (b, src, D), dtype).view(b, src, H, DH)
            lens = torch.tensor([40, 3, 17, 1, 39, 22, 8, 40][:b],
                                dtype=torch.int32, device="cuda")
            within(f"flash_decode {name} B={b} S_src=40 cross ragged",
                   da.flash_decode_cuda(q, xk, xv, lens),
                   da.flash_decode_plain(q, xk, xv, lens), tol)
            cases += 1
        for s, causal in ((40, False), (128, False), (512, False), (64, True)):
            b = 2 if causal else 8
            q, k, v = (randn(gen, (b, s, D), dtype).view(b, s, H, DH)
                       for _ in range(3))
            lens = None if causal else torch.tensor(
                [s, s - 1, s // 2, 1, s // 3 + 1, s, 7, s - 5][:b],
                dtype=torch.int32, device="cuda")
            within(f"flash_attention {name} B={b} S=T={s} "
                   f"{'causal' if causal else 'ragged'}",
                   fa.flash_attention_cuda(q, k, v, lens, causal=causal),
                   fa.flash_attention_plain(q, k, v, lens, causal=causal),
                   tol)
            cases += 1
        # zamba2's shared attention: causal prefill at serving lengths and
        # decode against a max_len=64 cache
        for b, s in ((1, 37), (8, 64)):
            q, k, v = (randn(gen, (b, s, ZA_H * DH), dtype).view(
                b, s, ZA_H, DH) for _ in range(3))
            within(f"flash_attention {name} B={b} S=T={s} H={ZA_H} causal",
                   fa.flash_attention_cuda(q, k, v, causal=True),
                   fa.flash_attention_plain(q, k, v, causal=True), tol)
            lens = torch.tensor([s, 1, 40, 17, 64, 33, 2, 50][:b],
                                dtype=torch.int32, device="cuda")
            kc, vc = (randn(gen, (b, 64, ZA_H, DH), dtype) for _ in range(2))
            within(f"flash_decode {name} B={b} T=64 H={ZA_H}",
                   da.flash_decode_cuda(q[:, 0], kc, vc, lens),
                   da.flash_decode_plain(q[:, 0], kc, vc, lens), tol)
            cases += 2
    torch.cuda.synchronize()
    return cases + check_tile_cases(fa, da, gen)


def check_tile_cases(fa, da, gen):
    """The redesign's edge cases: long caches cut into many (mostly empty)
    splits, GQA, length 0 in a batch, every query tile on ragged shapes,
    and a captured decode replayed after ``lengths`` changed on the
    device (the split plan reads nothing from the device)."""
    cases = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = "f32" if dtype == torch.float32 else "bf16"
        for b, t, h, hkv, lens in ((1, 2048, 8, 8, (1,)),
                                   (1, 2048, 8, 8, (33,)),
                                   (1, 2048, 8, 8, (2047,)),
                                   (2, 256, 32, 8, (200, 17)),
                                   (3, 256, 8, 8, (0, 100, 256))):
            q = randn(gen, (b, h, DH), dtype)
            kc, vc = (randn(gen, (b, t, hkv, DH), dtype) for _ in range(2))
            lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
            within(f"flash_decode {name} B={b} T={t} H={h} Hkv={hkv} "
                   f"lens={lens} splits={da.decode_splits(b, hkv, t)[0]}",
                   da.flash_decode_cuda(q, kc, vc, lt),
                   da.flash_decode_plain(q, kc, vc, lt), tol)
            cases += 1
        for bq in fa.BLOCK_Q:
            for b, s, t, h, hkv, d, causal in ((2, 77, 77, 4, 4, 16, False),
                                               (2, 53, 91, 4, 2, 32, False),
                                               (1, 45, 45, 2, 2, 128, True),
                                               (1, 37, 70, 4, 4, 64, True),
                                               (2, 100, 29, 6, 2, 64, True)):
                q = randn(gen, (b, s, h, d), dtype)
                k, v = (randn(gen, (b, t, hkv, d), dtype) for _ in range(2))
                lens = torch.tensor([t, max(1, t // 3)][:b],
                                    dtype=torch.int32, device="cuda")
                within(f"flash_attention {name} block_q={bq} B={b} S={s} "
                       f"T={t} H={h} Hkv={hkv} D={d} causal={causal}",
                       fa.flash_attention_cuda(q, k, v, lens, causal=causal,
                                               block_q=bq),
                       fa.flash_attention_plain(q, k, v, lens,
                                                causal=causal), tol)
                cases += 1
    # graph replay: capture once, change lengths in place, replay
    q = randn(gen, (2, H, DH))
    kc, vc = (randn(gen, (2, 512, H, DH)) for _ in range(2))
    lens = torch.tensor([5, 300], dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.flash_decode_cuda(q, kc, vc, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.flash_decode_cuda(q, kc, vc, lens)
    for new in ((5, 300), (511, 1), (0, 64)):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        within(f"flash_decode graph replay, lengths set to {new} on the "
               f"device", out, da.flash_decode_plain(q, kc, vc, lens), F32_TOL)
        cases += 1
    # two calls on the same inputs give the same bits
    first = da.flash_decode_cuda(q, kc, vc, lens)
    if not torch.equal(first, da.flash_decode_cuda(q, kc, vc, lens)):
        raise AssertionError("flash_decode is not bitwise repeatable")
    torch.cuda.synchronize()
    return cases + 1


def wkv_inputs(gen, b, s, with_s0=False):
    """rwkv6-3b-shaped WKV operands; log w clamped as the model clamps."""
    r, k, v = (randn(gen, (b, s, WKV_H, WKV_P)) for _ in range(3))
    log_w = -torch.clamp(torch.exp(randn(gen, (b, s, WKV_H, WKV_P))), 1e-4,
                         2.5)
    u = 0.5 * randn(gen, (WKV_H, WKV_P))
    s0 = randn(gen, (b, WKV_H, WKV_P, WKV_P)) if with_s0 else None
    return (r, k, v, log_w, u, s0)


def ssd_inputs(gen, b, s, with_s0=False):
    """zamba2-1.2b-shaped SSD operands: one B/C group expanded over the
    64 heads (stride 0), dt after softplus, the model's a_log."""
    x = randn(gen, (b, s, SSD_H, SSD_P))
    dt = torch.nn.functional.softplus(randn(gen, (b, s, SSD_H)))
    a_log = torch.log(torch.linspace(1.0, 16.0, SSD_H, device="cuda"))
    bc = randn(gen, (b, s, 2 * SSD_N))
    b_in = bc[..., None, :SSD_N].expand(b, s, SSD_H, SSD_N)
    c_in = bc[..., None, SSD_N:].expand(b, s, SSD_H, SSD_N)
    s0 = randn(gen, (b, SSD_H, SSD_P, SSD_N)) if with_s0 else None
    return (x, dt, a_log, b_in, c_in, s0)


def check_scan_kernels(wkv, ssd, gen):
    """The two scan kernels vs their plain versions at the LM prefill
    shapes: every chunk length a prompt can give (1 for a prime length),
    then every value tile the hosts can pick (``wkv_plan``'s and
    ``ssd_plan``'s), forced through the wrappers' ``_launch``."""
    cases = 0
    for with_s0 in (False, True):
        for b, s, chunk in ((1, 37, 1), (2, 49, 7), (1, 64, 32), (8, 64, 32)):
            args = wkv_inputs(gen, b, s, with_s0)
            within(f"rwkv6_wkv B={b} S={s} H={WKV_H} P={WKV_P} L={chunk} "
                   f"s0={with_s0}", wkv.rwkv6_wkv_cuda(*args, chunk=chunk),
                   wkv.rwkv6_wkv_plain(*args, chunk=chunk), WKV_TOL)
            cases += 1
        for b, s, chunk in ((1, 37, 1), (1, 37, 37), (2, 128, 64),
                            (1, 256, 128)):
            args = ssd_inputs(gen, b, s, with_s0)
            within(f"ssd_scan B={b} S={s} H={SSD_H} P=N={SSD_P} L={chunk} "
                   f"s0={with_s0}", ssd.ssd_scan_cuda(*args, chunk=chunk),
                   ssd.ssd_scan_plain(*args, chunk=chunk), SSD_TOL)
            cases += 1
    for p_tile in wkv.P_TILES:
        for b, s, chunk in ((1, 37, 1), (2, 64, 32)):
            args = wkv_inputs(gen, b, s, True)
            within(f"rwkv6_wkv p_tile={p_tile} B={b} S={s} L={chunk}",
                   wkv._launch(*args, chunk, p_tile),
                   wkv.rwkv6_wkv_plain(*args, chunk=chunk), WKV_TOL)
            cases += 1
    for b, s, chunk in ((1, 37, 1), (2, 128, 64), (1, 256, 128)):
        for pt in ssd.ssd_tiles(SSD_P, SSD_N, chunk):
            args = ssd_inputs(gen, b, s, True)
            within(f"ssd_scan p_tile={pt} B={b} S={s} L={chunk}",
                   ssd._launch(*args, chunk, pt),
                   ssd.ssd_scan_plain(*args, chunk=chunk), SSD_TOL)
            cases += 1
    torch.cuda.synchronize()
    return cases


# --------------------------------------------------------------- phase 4 --
@contextlib.contextmanager
def plain_kernels(ops):
    """Route every kernel wrapper to its plain version on the card (the
    reference for the model checks); restores the wrappers after."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import ssd_scan as ssd
    plain = {"flash_attention": fa.flash_attention_plain,
             "flash_decode": da.flash_decode_plain,
             "rwkv6_wkv": wkv.rwkv6_wkv_plain,
             "ssd_scan": ssd.ssd_scan_plain}
    kernels = {name: getattr(ops, name) for name in plain}
    for name, fn in plain.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(ops, name, fn)


def model_outputs(model, src, mask):
    with torch.inference_mode():
        enc, m = model.encode(src, mask)
        state = model.init_cache(enc, m)
        logits = []
        for tok in (1, 17, 42, 99):       # fixed tokens: no argmax ties
            state, lg = model.decode_step(state, torch.full(
                (src.shape[0],), tok, dtype=torch.int32, device="cuda"))
            logits.append(lg)
        return enc, torch.stack(logits)


def check_model(model, ops):
    rng = np.random.default_rng(0)
    lens = [37, 12, 64, 5, 50, 64, 1, 23]
    src = np.zeros((8, 64), np.int32)
    mask = np.zeros((8, 64), np.float32)
    for i, L in enumerate(lens):
        src[i, :L] = rng.integers(4, model.cfg.vocab_src, L)
        mask[i, :L] = 1.0
    src_t = torch.as_tensor(src, device="cuda")
    mask_t = torch.as_tensor(mask, device="cuda")
    enc_k, logit_k = model_outputs(model, src_t, mask_t)
    with plain_kernels(ops):
        enc_p, logit_p = model_outputs(model, src_t, mask_t)
    for what, a, b in (("encoder", enc_k, enc_p), ("logits", logit_k, logit_p)):
        valid = mask_t.bool() if what == "encoder" else slice(None)
        err = max_err(a[valid], b[valid])
        log(f"  model {what}: max_abs_err={err:.3e} "
            f"(max |ref| {float(b[valid].abs().max()):.3f})")
        if not (err <= MODEL_TOL and torch.isfinite(a).all()):
            raise AssertionError(f"model {what} error {err} > {MODEL_TOL}")


# --------------------------------------------------------------- phase 5 --
def main_path(model, ops):
    from repro_torch.core.length_regressor import LinearN2M, prefilter_pairs
    from repro_torch.core.profiles import make_profile
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.nmt.transformer import make_executors
    from repro_torch.runtime.engine import CollaborativeEngine, Tier

    executor, batched_executor = make_executors(model)
    edge_prof, cloud_prof = calibrate(model)

    corpus = make_corpus("en-zh", 2200, seed=1, with_tokens=True)
    fit, eval_ = corpus.split(2000)
    n2m = LinearN2M().fit(*prefilter_pairs(fit.n, fit.m_real))
    log(f"  N->M fit: gamma={n2m.gamma:.4f} delta={n2m.delta:.4f} "
        f"r2={n2m.r2(fit.n, fit.m_real):.4f}")
    # the card is the local tier; the modelled cloud is 5x faster behind
    # the cp1 (~0.1 s) RTT trace, so short requests stay on the card
    profile = make_profile("cp1", seed=1)
    engine = CollaborativeEngine(
        tiers=[Tier(edge_prof, executor=executor, name="h100",
                    batch_size=8, batched_executor=batched_executor),
               Tier(cloud_prof, name="cloud",
                    rtt_fn=lambda now: float(profile.rtt_at(now)))],
        n2m=n2m, seed=0)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [engine.submit(eval_.src[i][:64], now_s=0.5 * i)
               for i in range(16)]
    results += engine.submit_batch([eval_.src[16 + i][:64] for i in range(8)],
                                   now_s=9.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    for r in results:
        log(f"  req {r.req_id:2d} n={r.n:3d} -> {r.tier_name:5s} "
            f"m_out={r.m_out:3d} latency={r.latency_s * 1e3:9.3f}ms "
            f"wait={r.wait_s * 1e3:8.3f}ms")
    stats = engine.stats()
    log(f"  stats: {json.dumps(stats, sort_keys=True)}")
    log(f"  main path wall {wall:.2f}s, kernel launches {launches}")
    if len(results) != 24 or any(r.shed for r in results):
        raise AssertionError("not every request was served")
    on_card = [r for r in results if r.device == 0]
    if not on_card:
        raise AssertionError("no request ran on the card tier")
    for r in results:
        if not (np.isfinite(r.latency_s) and r.latency_s > 0):
            raise AssertionError(f"bad latency {r}")
    for r in on_card:
        if not 0 <= r.m_out <= MAX_DECODE:
            raise AssertionError(f"bad output length {r}")
    for name in ("flash_attention", "flash_decode"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return launches, edge_prof, cloud_prof


# --------------------------------------------------------------- phase 6 --
def time_case(kernel, plain, library, nbytes, flops, *, per_graph=50,
              plain_per_graph=10) -> dict:
    """Device time of the kernel, its plain version and the library call
    (None where no single PyTorch call computes the function) on the same
    inputs, the kernel's eager per-call time, its largest difference from
    the plain version over every output, and its bound."""
    err = max_err(torch.cat([t.flatten() for t in _outputs(kernel())]),
                  torch.cat([t.flatten() for t in _outputs(plain())]))
    if not err < float("inf"):
        raise AssertionError(f"kernel and plain version differ by {err}")
    return dict(ms=device_ms(kernel, per_graph=per_graph),
                eager_ms=eager_ms(kernel, iters=4 * per_graph,
                                  warmup=min(per_graph, 20)),
                plain_ms=device_ms(plain, per_graph=plain_per_graph),
                library_ms=(None if library is None
                            else device_ms(library, per_graph=per_graph)),
                max_abs_err=err, **bound(nbytes, flops, torch.float32))


def decode_case(da, gen, b, length):
    """flash_decode on a batch-``b`` self-attention cache of 256 slots,
    ``length`` of them valid, as in the decoder half-way through a
    256-step translate.  The yardstick is SDPA with a key mask on the
    same numbers in its (B, H, T, dh) layout."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(gen, (b, D)).view(b, H, DH)
    kc = randn(gen, (b, MAX_DECODE, D)).view(b, MAX_DECODE, H, DH)
    vc = randn(gen, (b, MAX_DECODE, D)).view(b, MAX_DECODE, H, DH)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    qs = q[:, :, None, :]
    ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (kc, vc))
    keymask = (torch.arange(MAX_DECODE, device="cuda")[None, :]
               < lens[:, None])[:, None, None, :]
    row = time_case(lambda: da.flash_decode_cuda(q, kc, vc, lens),
                    lambda: da.flash_decode_plain(q, kc, vc, lens),
                    lambda: sdpa(qs, ks, vs, attn_mask=keymask),
                    4 * (2 * b * length * D + 2 * b * D + b),
                    4 * b * H * length * DH)
    row["library_err"] = max_err(da.flash_decode_cuda(q, kc, vc, lens),
                                 sdpa(qs, ks, vs, attn_mask=keymask)[:, :, 0])
    row["shape"] = f"B={b} H={H} dh={DH} T={MAX_DECODE} len={length} f32"
    row["batch"] = b
    return row


def attention_case(fa, gen, b, s):
    """flash_attention over one encoder layer of a batch-``b`` length
    bucket of ``s`` tokens (non-causal, all keys valid); the yardstick is
    SDPA on the same numbers in its (B, H, S, dh) layout."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (randn(gen, (b, s, D)).view(b, s, H, DH) for _ in range(3))
    lens = torch.full((b,), s, dtype=torch.int32, device="cuda")
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    row = time_case(
        lambda: fa.flash_attention_cuda(q, k, v, lens, causal=False),
        lambda: fa.flash_attention_plain(q, k, v, lens, causal=False),
        lambda: sdpa(qs, ks, vs),
        4 * (4 * b * s * D + b), 4 * b * H * s * s * DH)
    row["library_err"] = max_err(
        fa.flash_attention_cuda(q, k, v, lens, causal=False),
        sdpa(qs, ks, vs).permute(0, 2, 1, 3))
    row["shape"] = f"B={b} S=T={s} H={H} dh={DH} non-causal f32"
    return row


def causal_case(fa, gen, b, s):
    """flash_attention over one zamba2-1.2b shared-attention prefill call:
    causal, 32 heads of 64, all keys valid; the yardstick is SDPA with
    is_causal on the same numbers.  FLOP count the causal half."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (randn(gen, (b, s, ZA_H * DH)).view(b, s, ZA_H, DH)
               for _ in range(3))
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    big = b * s > 1024
    row = time_case(
        lambda: fa.flash_attention_cuda(q, k, v, causal=True),
        lambda: fa.flash_attention_plain(q, k, v, causal=True),
        lambda: sdpa(qs, ks, vs, is_causal=True),
        4 * 4 * b * s * ZA_H * DH, 2 * b * ZA_H * s * (s + 1) * DH,
        per_graph=5 if big else 50, plain_per_graph=1 if big else 10)
    row["library_err"] = max_err(
        fa.flash_attention_cuda(q, k, v, causal=True),
        sdpa(qs, ks, vs, is_causal=True).permute(0, 2, 1, 3))
    row["shape"] = f"B={b} S=T={s} H={ZA_H} dh={DH} causal f32"
    return row


def wkv_case(wkv, gen, b, s):
    """rwkv6_wkv over one rwkv6-3b prefill layer: batch ``b`` of ``s``
    tokens from the zero state, at the chunk prefill picks (the largest
    divisor of ``s`` up to 32: 1 for a prime ``s``).  Bound: r/k/v/log w
    and y once each, u and the final state; FLOP of the triangular chunk
    products and the state's two products."""
    args = wkv_inputs(gen, b, s)
    chunk = max(d for d in range(1, 33) if s % d == 0)
    p, h, nc = WKV_P, WKV_H, s // chunk
    nbytes = 4 * (5 * b * s * h * p + h * p + b * h * p * p)
    flops = b * h * nc * (2 * chunk * (chunk - 1) * p + 4 * chunk * p * p
                          + 3 * chunk * p + p * p)
    big = b * s > 1024
    row = time_case(lambda: wkv.rwkv6_wkv_cuda(*args, chunk=chunk),
                    lambda: wkv.rwkv6_wkv_plain(*args, chunk=chunk), None,
                    nbytes, flops, per_graph=5 if big else 50,
                    plain_per_graph=2 if big else 10)
    row["shape"] = f"B={b} S={s} H={h} P={p} L={chunk} f32"
    return row


def ssd_case(ssd, gen, b, s):
    """ssd_scan over one zamba2-1.2b prefill layer: batch ``b`` of ``s``
    tokens, one B/C group read for all 64 heads, at the chunk prefill
    picks.  Bound: x, dt, the one B/C group, y and the final state once
    each; FLOP of the triangular scores, their product with x and the
    state's two products."""
    args = ssd_inputs(gen, b, s)
    chunk = min(128, s)
    p, n, h, nc = SSD_P, SSD_N, SSD_H, s // chunk
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                  + b * h * p * n)
    flops = b * h * nc * (chunk * (chunk + 1) * (n + p + 2)
                          + 4 * chunk * n * p + chunk * (n + p) + n * p)
    big = b * s > 1024
    row = time_case(lambda: ssd.ssd_scan_cuda(*args, chunk=chunk),
                    lambda: ssd.ssd_scan_plain(*args, chunk=chunk), None,
                    nbytes, flops, per_graph=5 if big else 50,
                    plain_per_graph=2 if big else 10)
    row["shape"] = f"B={b} S={s} H={h} P=N={p} L={chunk} f32"
    return row


KERNELS = {   # name -> (source, the TPU kernel's pallas_call)
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:131"),
    "flash_decode": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:89"),
    "rwkv6_wkv": ("src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
                  "src/repro/kernels/rwkv6_wkv.py:99"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:99"),
}


def scan_cases(gen):
    """The scan kernels' timed cases: prefill at the serving shape, a long
    prefill and (rwkv6_wkv) a prime prompt length, chunk 1."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import ssd_scan as ssd
    return [("rwkv6_wkv", wkv_case(wkv, gen, 1, 64)),
            ("rwkv6_wkv", wkv_case(wkv, gen, 8, 2048)),
            ("rwkv6_wkv", wkv_case(wkv, gen, 1, 37)),
            ("ssd_scan", ssd_case(ssd, gen, 1, 64)),
            ("ssd_scan", ssd_case(ssd, gen, 8, 2048))]


def timings(gen):
    """Per-kernel numbers at the main paths' shapes (f32).  The first case
    of each kernel is its row in the JSON line; the rest are printed."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    cases = [("flash_decode", decode_case(da, gen, 8, 128)),
             ("flash_decode", decode_case(da, gen, 1, 128)),
             ("flash_attention", attention_case(fa, gen, 8, 64)),
             ("flash_attention", attention_case(fa, gen, 8, 512)),
             ("flash_attention", causal_case(fa, gen, 1, 64)),
             ("flash_attention", causal_case(fa, gen, 8, 2048))]
    cases += scan_cases(gen)
    for name, r in cases:
        lib = ("library — (no single PyTorch call computes it)"
               if r["library_ms"] is None else
               f"sdpa {r['library_ms']:.5f}ms (kernel vs sdpa "
               f"{r['library_err']:.2e})")
        by = r["bound_by"] + (f" ({F32_PEAK_NOTE})"
                              if r["bound_by"] == "operations" else "")
        log(f"  {name} {r['shape']}: device {r['ms']:.5f}ms, eager "
            f"{r['eager_ms']:.5f}ms, bound {r['bound_ms']:.5f}ms by {by}, "
            f"plain {r['plain_ms']:.5f}ms, {lib} "
            f"(kernel vs plain {r['max_abs_err']:.2e})")
    tile_sweep(gen)
    rows, seen = [], set()
    for name, r in cases:
        if name not in seen:
            seen.add(name)
            rows.append(dict(r, name=name, route="cuda",
                             source=KERNELS[name][0],
                             replaces=KERNELS[name][1]))
    decode_ms = {r["batch"]: r["ms"] for name, r in cases
                 if name == "flash_decode"}
    return rows, decode_ms


def tile_sweep(gen):
    """Device ms of every value tile of the two scan kernels at prefill's
    serving shape (B=1, S=64) and a long prefill (B=8, S=2048): what
    ``wkv_plan`` and ``ssd_plan`` choose between."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import ssd_scan as ssd
    for b, s in ((1, 64), (8, 2048)):
        per_graph = 5 if b * s > 1024 else 50
        args = wkv_inputs(gen, b, s)
        for pt in wkv.P_TILES:
            ms = device_ms(lambda pt=pt: wkv._launch(*args, 32, pt),
                           per_graph=per_graph)
            log(f"  rwkv6_wkv B={b} S={s} p_tile={pt} "
                f"({b * WKV_H * WKV_P // pt} blocks): device {ms:.5f}ms")
        args, chunk = ssd_inputs(gen, b, s), min(128, s)
        for pt in ssd.ssd_tiles(SSD_P, SSD_N, chunk):
            ms = device_ms(lambda pt=pt: ssd._launch(*args, chunk, pt),
                           per_graph=per_graph)
            log(f"  ssd_scan B={b} S={s} p_tile={pt} "
                f"({b * SSD_H * SSD_P // pt} blocks): device {ms:.5f}ms")


def bound(nbytes: int, flops: int, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def step_profile(model, b, decode_ms):
    """One decode step at batch ``b``: eager wall time per step (what the
    translate loop pays) vs device time of the same step replayed from a
    CUDA graph.  Their gap is the host's launch cost, the device idle.
    ``decode_ms`` is one ``flash_decode`` call's device time at this batch
    (T=256, len=128), for the share of the step its 12 calls take."""
    rng = np.random.default_rng(6)
    src = torch.as_tensor(rng.integers(4, model.cfg.vocab_src, (b, 32)),
                          device="cuda")
    with torch.inference_mode():
        enc, mask = model.encode(src)
        state = model.init_cache(enc, mask)
        tok = torch.full((b,), 7, dtype=torch.int32, device="cuda")

        def step():
            model.decode_step(state, tok)

        eager = eager_ms(step, iters=100, warmup=10)      # pos 0 -> 110
        device = device_ms(step, per_graph=20, replays=10)  # pos <= 133
    log(f"  decode step B={b} (pos ~110-133, 6 layers): eager "
        f"{eager:.4f}ms, device {device:.4f}ms, device busy "
        f"{100 * device / eager:.1f}% of the eager step; 12 flash_decode "
        f"calls x {decode_ms:.5f}ms = {100 * 12 * decode_ms / device:.1f}% "
        f"of the graph-replayed step")


def translate_rate(model):
    rng = np.random.default_rng(5)
    src = rng.integers(4, model.cfg.vocab_src, (8, 32)).astype(np.int32)
    translate = model.make_translate_batched()
    translate(src)                                      # warm-up
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lens, _ = translate(src)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"  B=8 N=32 translate: {int(lens.sum())} tokens in {wall:.3f}s = "
        f"{lens.sum() / wall:.1f} tokens/s, peak memory {peak:.1f} MiB")


# ----------------------------------------------------------- phases 7-8 --
def lm_logits(model, toks, steps=(5, 17, 42, 99)):
    """Prefill logits, then the logits of decode steps on fixed tokens (no
    argmax chain, so a near-tie cannot fork the two runs)."""
    with torch.inference_mode():
        logits, state = model.prefill(toks, max_len=toks.shape[1] + 8)
        out = [logits]
        for tok in steps:
            logits, state = model.decode_step(state, torch.full(
                (toks.shape[0], 1), tok, dtype=torch.int32,
                device=toks.device))
            out.append(logits)
        return torch.stack(out)


def perturbed(model, rel: float):
    """Scale the embeddings by (1 + rel * N(0, 1)) while active: the
    model's own float32 noise floor, for comparison with the kernels."""
    gen = torch.Generator(device=model.device).manual_seed(3)
    return model.embed.register_forward_hook(
        lambda mod, inp, out: out * (1 + rel * torch.randn(
            out.shape, generator=gen, device=out.device)))


def check_lm(model, ops):
    """The LM on the kernels vs the same LM on the plain versions, at a
    prime prompt length (chunk 1 for rwkv6) and a length the chunks
    divide, prefill plus four decode steps.

    Within 1e-4 at full width with the depth cut to the first two layers
    of each of the first four groups (a random-weight stack amplifies
    float32 rounding with depth: at full depth a perturbation of one part
    in 10^7 of the embeddings alone moves the logits by ~1e-4).  At full
    depth the kernels may move the logits no more than ten times what
    that perturbation does."""
    rng = np.random.default_rng(7)
    cfg = model.cfg
    cut = dataclasses.replace(cfg, layer_plan=tuple(
        dataclasses.replace(g, count=min(g.count, 2))
        for g in cfg.layer_plan[:4]))
    shallow = type(model)(cut, device=model.device, seed=1)
    for s in (37, 64):
        toks = torch.as_tensor(rng.integers(4, cfg.vocab_size, (2, s)),
                               dtype=torch.int32, device=model.device)
        for m, what in ((shallow, f"{cut.num_layers} layers"),
                        (model, f"all {cfg.num_layers} layers")):
            got = lm_logits(m, toks)
            with plain_kernels(ops):
                want = lm_logits(m, toks)
                hook = perturbed(m, 1e-7)
                floor = max_err(lm_logits(m, toks), want)
                hook.remove()
            err = max_err(got, want)
            log(f"  B=2 S={s} {what}: prefill + 4 decode-step logits, kernels "
                f"vs plain max_abs_err={err:.3e}; plain vs plain with the "
                f"embeddings perturbed by 1e-7 {floor:.3e} (max |ref| "
                f"{float(want.abs().max()):.3f})")
            limit = MODEL_TOL if m is shallow else 10 * floor
            if not (err <= limit and torch.isfinite(got).all()):
                raise AssertionError(f"LM logits error {err} > {limit}")
    del shallow


def lm_main_path(model, ops, needed):
    """launch/serve.py's tiered path: the LM session as the real edge tier
    of the engine, 8 requests in concurrent slots of 4, max_new=8."""
    from repro_torch.launch.serve import serve_tiered
    from repro_torch.runtime.serving import GenerationSession

    sess = GenerationSession(model, max_len=64)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine = serve_tiered(sess, model.cfg.vocab_size, requests=8, max_new=8,
                          seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    results = engine.results
    for r in results:
        log(f"  req {r.req_id} n={r.n:2d} -> {r.tier_name:5s} "
            f"m_out={r.m_out} latency={r.latency_s * 1e3:9.3f}ms "
            f"wait={r.wait_s * 1e3:8.3f}ms")
    log(f"  stats: {json.dumps(engine.stats(), sort_keys=True)}")
    log(f"  main path wall {wall:.2f}s, kernel launches {launches}")
    if len(results) != 8 or any(r.shed for r in results):
        raise AssertionError("not every request was served")
    edge = [r for r in results if r.tier_name == "edge"]
    if not edge:
        raise AssertionError("no request ran on the card's edge tier")
    for r in results:
        if not (np.isfinite(r.latency_s) and r.latency_s > 0):
            raise AssertionError(f"bad latency {r}")
    for r in edge:
        if not 0 <= r.m_out <= 8:
            raise AssertionError(f"bad output length {r}")
    for name in needed:
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return launches


def wall_ms(fn, reps=3):
    """Median host-clock ms of ``fn`` ending in a device sync (one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def lm_rates(model, ops, kernel_name):
    """Prefill tokens/s at the serving shape (B=1, S=64) and a long prefill
    (B=8, S=2048) with the scan kernel's share of it, decode tokens/s and
    the device's busy share of a decode step at B=1 and B=8, and the
    peak memory."""
    rng = np.random.default_rng(8)
    vocab = model.cfg.vocab_size
    layers = sum(g.count for g in model.cfg.layer_plan
                 if g.mixer in ("rwkv6", "mamba2"))
    with torch.inference_mode():
        for b, s in ((1, 64), (8, 2048)):
            toks = torch.as_tensor(rng.integers(4, vocab, (b, s)),
                                   dtype=torch.int32, device="cuda")
            reps = 3 if s < 1024 else 1
            ops.reset_launch_counts()
            ms = wall_ms(lambda: model.prefill(toks), reps=reps)
            calls = ops.launch_counts()[kernel_name] / (1 + reps)
            log(f"  prefill B={b} S={s}: {ms:.2f}ms = "
                f"{b * s / ms * 1e3:.0f} tokens/s ({calls:g} {kernel_name} "
                f"launches per prefill, one per {layers} layers)")
        for b in (1, 8):
            toks = torch.as_tensor(rng.integers(4, vocab, (b, 16)),
                                   dtype=torch.int32, device="cuda")
            torch.cuda.reset_peak_memory_stats()
            logits, state = model.prefill(toks, max_len=512)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            steps = 16
            step_ms = wall_ms(lambda: [model.decode_step(state, tok)
                                       for _ in range(steps)], reps=2) / steps
            peak = torch.cuda.max_memory_allocated() / 2**30
            graph_ms = device_ms(lambda: model.decode_step(state, tok),
                                 per_graph=10, replays=5)
            log(f"  decode B={b}: {step_ms:.3f}ms per eager step = "
                f"{b / step_ms * 1e3:.1f} tokens/s; the same step from a "
                f"CUDA graph {graph_ms:.3f}ms (device busy "
                f"{100 * graph_ms / step_ms:.1f}% of the eager step); peak "
                f"memory {peak:.2f} GiB")


def lm_phase(name, ops, needed):
    """Build ``name`` at full width on the card, check it against its
    plain kernels, drive the tiered serving path and time it."""
    from repro_torch.models.registry import resolve

    t0 = time.perf_counter()
    r = resolve(name, size="full", device="cuda", seed=0)
    model = r.model
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {r.name}: d_model {r.cfg.d_model}, {r.cfg.num_layers} layer "
        f"slots, vocab {r.cfg.vocab_size}; {n_params / 1e9:.3f}B parameters "
        f"({4 * n_params / 1e9:.2f} GB f32), built in "
        f"{time.perf_counter() - t0:.2f}s")
    check_lm(model, ops)
    launches = lm_main_path(model, ops, needed)
    lm_rates(model, ops, needed[0])
    del model, r
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- phases 9-10 --
RAGGED = [128, 37, 64, 5, 100, 128, 1, 23]


def ragged_batch(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    src = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros(src.shape, np.float32)
    for i, L in enumerate(lens):
        src[i, :L] = rng.integers(4, vocab, L)
        mask[i, :L] = 1.0
    return src, mask


def rnn_outputs(model, src, mask):
    """The encoder's states (outputs with zeros at the pads, carries, mask)
    and four decode-step logits on fixed tokens, flattened."""
    from repro_torch.nmt.common import _leaves
    state = model.make_encode_states()(src, mask).data
    with torch.inference_mode():
        enc = torch.cat([t.float().flatten() for t in _leaves(state)])
        logits = []
        for tok in (1, 17, 42, 99):
            state, lg = model.decode_step(state, torch.full(
                (src.shape[0],), tok, dtype=torch.int32,
                device=model.device))
            logits.append(lg)
        return enc.cpu(), torch.stack(logits).cpu()


def rnn_phase(pair):
    """Build the pair's RNN at full width on the card and hold it against
    a CPU copy of the same weights."""
    from repro_torch.models.registry import resolve

    t0 = time.perf_counter()
    r = resolve(f"cnmt:{pair}", scale=1.0, device="cuda", seed=0)
    model = r.model
    cpu = copy.deepcopy(model).to("cpu")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {r.name}: {type(model).__name__} {r.cfg} ({n_params / 1e6:.2f}M "
        f"parameters, built in {time.perf_counter() - t0:.2f}s)")
    src, mask = ragged_batch(r.cfg.vocab_src, RAGGED)
    card = rnn_outputs(model, src, mask)
    host = rnn_outputs(cpu, src, mask)
    noisy = copy.deepcopy(cpu)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for emb in (noisy.src_embed.weight, noisy.tgt_embed.weight):
            emb.mul_(1 + 1e-7 * torch.randn(emb.shape, generator=gen))
    floor = rnn_outputs(noisy, src, mask)
    for what, got, want, fl in zip(("encoder states", "decode logits"), card,
                                   host, floor):
        err, noise = max_err(got, want), max_err(fl, want)
        limit = MODEL_TOL if err <= MODEL_TOL else 10 * noise
        log(f"  {what} B=8 N<=128: card vs CPU max_abs_err={err:.3e}; CPU "
            f"vs CPU with the embeddings perturbed by 1e-7 {noise:.3e} (max "
            f"|ref| {float(want.abs().max()):.3f}); limit {limit:.1e}"
            + ("" if limit == MODEL_TOL else
               " = ten times the perturbation's effect (past 1e-4)"))
        if not (err <= limit and torch.isfinite(got).all()):
            raise AssertionError(f"{r.name} {what} error {err} > {limit}")
    translate_rate(model)
    for b in (1, 8):
        rnn_step_profile(model, b)
    return model, cpu, r.name


def rnn_step_profile(model, b):
    """One RNN decode step at batch ``b``: eager wall time per step vs the
    same step replayed from a CUDA graph (the host's launch cost)."""
    src, mask = ragged_batch(model.cfg.vocab_src, [32] * b, seed=6)
    state = model.make_encode_states()(src, mask).data
    tok = torch.full((b,), 7, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        eager = eager_ms(lambda: model.decode_step(state, tok), iters=100,
                         warmup=10)
        device = device_ms(lambda: model.decode_step(state, tok),
                           per_graph=20, replays=10)
    log(f"  decode step B={b}: eager {eager:.4f}ms, device {device:.4f}ms, "
        f"device busy {100 * device / eager:.1f}% of the eager step")


def calibrate(model):
    """The card tier's plane from forced-length translates (N in 8, 32,
    128 by M in 8, 64, 256), and the 5x faster modelled cloud beside it."""
    from repro_torch.core.calibration import (make_edge_cloud_pair,
                                              measure_seq2seq_grid)
    translate = model.make_translate_batched()

    def forced(tokens, m):
        lens, out = translate(np.asarray(tokens, np.int32)[None], None, m)
        return int(lens[0]), out[0]

    t0 = time.perf_counter()
    n, m, t = measure_seq2seq_grid(forced, (8, 32, 128),
                                   lambda nn: (8, 64, 256), reps=2,
                                   vocab=model.cfg.vocab_src)
    edge_prof, cloud_prof = make_edge_cloud_pair(n, m, t, speedup=5.0)
    log(f"  card plane from {len(t)} timed translates "
        f"({time.perf_counter() - t0:.1f}s): "
        f"aN={edge_prof.model.alpha_n * 1e3:.4f}ms "
        f"aM={edge_prof.model.alpha_m * 1e3:.4f}ms "
        f"b={edge_prof.model.beta * 1e3:.2f}ms")
    return edge_prof, cloud_prof


def fused_executor(model):
    """``executor(tokens) -> (m_out, tokens)``: the fused translate at B=1,
    the split decode leg's output contract."""
    translate = model.make_translate_batched()
    top = model.cfg.vocab_src - 1

    def executor(tokens):
        lens, out = translate(np.minimum(np.asarray(tokens, np.int32),
                                         top)[None])
        m = int(lens[0])
        return m, out[0, :max(m, 1)]

    return executor


def cloud_delay_scale(edge_prof, cloud_prof, n2m, ns, ship_s, edge_rtt_s,
                      mean_rtt_s):
    """Scale for the cloud's replayed RTT trace that puts the engine in the
    split regime for these planes.

    With the cloud's one-way delay r, ``plan_cost_fast`` makes split(edge,
    cloud) cheaper than whole(cloud) once r exceeds

        lo(n) = (aN_e - aN_c) n + (b_e - b_c)/2 + rtt_e/2 + ship(n)

    and cheaper than whole(edge) while r stays below

        hi(n) = (aM_e - aM_c) m_hat(n) + (b_e - b_c)/2 + rtt_e/2 - ship(n)

    (token serialization terms dropped: microseconds).  A model fast enough
    on the card has hi below cp1's 45 ms and never splits, so the trace is
    scaled to put its mean one-way delay at sqrt(lo * hi) over the stream's
    means: the same ratio of margin on either side.  Returns (scale, lo,
    hi), lo and hi in seconds."""
    e, c = edge_prof.model, cloud_prof.model
    half_beta = 0.5 * (e.beta - c.beta)
    lo, hi = [], []
    for n, ship in zip(ns, ship_s):
        m_hat = max(float(np.asarray(n2m.predict(float(n)))), 1.0)
        lo.append((e.alpha_n - c.alpha_n) * n + half_beta + edge_rtt_s / 2
                  + ship)
        hi.append((e.alpha_m - c.alpha_m) * m_hat + half_beta
                  + edge_rtt_s / 2 - ship)
    lo, hi = float(np.mean(lo)), float(np.mean(hi))
    if not 0.0 < lo < hi:
        raise AssertionError(f"no cloud delay makes split(edge, cloud) the "
                             f"cheapest plan: lo {lo} s >= hi {hi} s")
    return 2.0 * float(np.sqrt(lo * hi)) / mean_rtt_s, lo, hi


def split_phase(name, model, cpu, planes, ops):
    """The split legs on the card: bitwise against the fused translate,
    the wire from a CPU copy, then real split plans through the engine.
    Returns the kernel launches of the engine run."""
    from repro_torch.core.latency_model import (ActivationCostModel,
                                                DeviceProfile)
    from repro_torch.core.length_regressor import LinearN2M
    from repro_torch.core.profiles import make_profile
    from repro_torch.core.tx_estimator import LinkModel, TxEstimator
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.nmt.common import _leaves
    from repro_torch.runtime.engine import CollaborativeEngine, Tier
    from repro_torch.runtime.serving import build_executor

    vocab = model.cfg.vocab_src
    enc, dec = build_executor(model, kind="split", vocab_clip=vocab)
    fused = fused_executor(model)
    lens = [37, 12, 64, 5, 50, 64, 1, 23]
    src, mask = ragged_batch(vocab, lens, seed=2)
    want = model.make_translate_batched()(src, mask)
    got = model.make_decode_from_states()(
        model.make_encode_states()(src, mask))
    for w, g in zip(want, got):
        if not np.array_equal(w, g):
            raise AssertionError(f"{name}: split != fused on a batch of 8")
    for i, L in enumerate(lens):
        m, out = dec(enc(src[i, :L]))
        m_f, out_f = fused(src[i, :L])
        if m != m_f or not np.array_equal(out, out_f):
            raise AssertionError(f"{name}: split != fused, request {i}")
    log(f"  {name}: split legs == fused translate bitwise (a batch of 8 "
        f"ragged requests and each alone; m_out {want[0].tolist()})")
    host = cpu.make_encode_states()(src[:1, :lens[0]])
    card = enc(src[0, :lens[0]])
    err = max(max_err(h.to("cuda"), c) for h, c in zip(
        _leaves((host.data, host.src_lens)),
        _leaves((card.data, card.src_lens))))
    m_wire, _ = dec(host)
    log(f"  states encoded on the CPU copy vs on the card: max_abs_err="
        f"{err:.3e}, {host.payload_bytes()} bytes; decoded on the card: "
        f"m_out {m_wire} (card-encoded {dec(card)[0]})")
    if not (err <= MODEL_TOL
            and host.payload_bytes() == card.payload_bytes()):
        raise AssertionError(f"{name}: CPU-encoded states differ by {err}")

    shipped, received, decoded = [], [], []

    def encode_leg(tokens):
        states = enc(tokens)
        shipped.append(states.payload_bytes())
        return states

    def decode_leg(states):
        received.append(sum(t.numel() * t.element_size()
                            for t in _leaves((states.data,
                                              states.src_lens))))
        out = dec(states)
        decoded.append(out[0])
        return out

    edge_prof, cloud_prof = planes
    # the N->M law of this model as it decodes (random weights run most
    # rows to max_decode_len), fit on the 8 requests above
    n2m = LinearN2M().fit(np.asarray(lens, np.float64),
                          want[0].astype(np.float64))
    log(f"  N->M fit on the model's own outputs: gamma={n2m.gamma:.4f} "
        f"delta={n2m.delta:.4f}")
    eval_ = make_corpus(name.split(":")[1], 24, seed=1, with_tokens=True)
    reqs = [eval_.src[i][:64] for i in range(24)]
    now = [2.0 * i for i in range(24)]
    links = LinkModel(3)
    links.add_link(1, 2, TxEstimator(init_rtt_s=4e-3, bandwidth_bps=1e9))
    profile = make_profile("cp1", seed=1)
    width = getattr(model.cfg, "d_model", None) or model.cfg.hidden
    activation = ActivationCostModel(width, 4)
    ns = [len(t) for t in reqs]
    cp1_mean = float(np.mean([profile.rtt_at(t) for t in now]))
    scale, lo, hi = cloud_delay_scale(
        edge_prof, cloud_prof, n2m, ns,
        [links.tx_time(1, 2, 0.0, float(activation.payload_bytes(n)),
                       one_way=True) for n in ns], 5e-3, cp1_mean)
    log(f"  split window for the cloud's one-way delay: {lo * 1e3:.3f}-"
        f"{hi * 1e3:.3f}ms; cp1 (mean RTT {cp1_mean * 1e3:.3f}ms) scaled "
        f"by {scale:.4f}")
    engine = CollaborativeEngine(
        tiers=[Tier(DeviceProfile("dev", edge_prof.model.scaled(0.25), 0.05),
                    name="dev"),
               Tier(edge_prof, name="edge", executor=fused,
                    encode_executor=encode_leg, decode_executor=decode_leg,
                    rtt_fn=lambda now: 5e-3, bandwidth_bps=200e6),
               Tier(cloud_prof, name="cloud", decode_executor=decode_leg,
                    rtt_fn=lambda now: scale * float(profile.rtt_at(now)))],
        n2m=n2m, seed=0, links=links, activation=activation,
        inter_rtt_fns={(1, 2): lambda now: 4e-3}, allow_split=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = [engine.submit(t, now_s=at) for t, at in zip(reqs, now)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    stats = engine.stats()
    split = [r for r in results if r.plan is not None and r.plan.is_split]
    for r in results:
        plan = None if r.plan is None else (r.plan.encode_tier,
                                            r.plan.decode_tier)
        log(f"  req {r.req_id:2d} n={r.n:2d} plan={plan} -> "
            f"{r.tier_name:5s} m_out={r.m_out:3d} "
            f"latency={r.latency_s * 1e3:9.3f}ms")
    log(f"  stats: {json.dumps(stats, sort_keys=True)}")
    log(f"  split path wall {wall:.2f}s for 24 requests ({len(split)} split, "
        f"payloads {sorted(set(shipped))} bytes), kernel launches "
        f"{launches}")
    if any(r.shed for r in results) or stats["split"] == 0 or not split:
        raise AssertionError(f"{name}: no split plan ran, or a request "
                             "was shed")
    if not (len(shipped) == len(received) == len(decoded) == len(split)
            and shipped == received
            and [r.m_out for r in split] == decoded):
        raise AssertionError(f"{name}: split results were not served by "
                             "the real legs")
    for r in results:
        if not (np.isfinite(r.latency_s) and r.latency_s > 0):
            raise AssertionError(f"bad latency {r}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.registry import resolve

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log(f"== phase 1: device {kind} x{count}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _build.load_library()
    log(f"== phase 2: kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f}s ({_build.library_path().name})")

    gen = torch.Generator(device="cuda").manual_seed(0)
    log("== phase 3: kernels vs plain versions on the card")
    n_cases = check_kernels(fa, da, gen) + check_scan_kernels(wkv, ssd, gen)
    log(f"  {n_cases} cases within tolerance")

    log("== phase 4: Marian en-zh at full width, kernels vs plain versions")
    t0 = time.perf_counter()
    r = resolve("cnmt:en-zh", scale=1.0, device="cuda", seed=0)
    model = r.model
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {r.name}: {r.cfg} ({n_params / 1e6:.1f}M parameters, built in "
        f"{time.perf_counter() - t0:.2f}s)")
    check_model(model, ops)

    log("== phase 5: Marian main path through CollaborativeEngine")
    launches, *marian_planes = main_path(model, ops)
    paths = {"marian": launches}

    log(f"== phase 6: timings on {smi}")
    rows, decode_ms = timings(gen)
    translate_rate(model)
    for b in (1, 8):
        step_profile(model, b, decode_ms[b])
    del model, r
    gc.collect()
    torch.cuda.empty_cache()

    log("== phase 7: rwkv6-3b at full width through GenerationSession and "
        "CollaborativeEngine")
    paths["rwkv6-3b"] = lm_phase("rwkv6-3b", ops, ("rwkv6_wkv",))
    log("== phase 8: zamba2-1.2b at full width through GenerationSession and "
        "CollaborativeEngine")
    paths["zamba2-1.2b"] = lm_phase(
        "zamba2-1.2b", ops, ("ssd_scan", "flash_attention", "flash_decode"))

    log("== phase 9: the paper's BiLSTM de-en and GRU fr-en at full width")
    planes = {"cnmt:en-zh": marian_planes}
    rnns = {}
    for pair in ("de-en", "fr-en"):
        model, cpu, name = rnn_phase(pair)
        planes[name] = calibrate(model)
        rnns[name] = (model, cpu)
    log(f"  card planes (T = aN*N + aM*M + b) on {smi}:")
    for name, (edge_prof, _) in planes.items():
        pl = edge_prof.model
        log(f"    {name}: aN={pl.alpha_n * 1e3:.5f}ms aM="
            f"{pl.alpha_m * 1e3:.5f}ms b={pl.beta * 1e3:.4f}ms")

    log("== phase 10: split placement on the card, all three models")
    r = resolve("cnmt:en-zh", scale=1.0, device="cuda", seed=0)
    models = {"cnmt:en-zh": (r.model, copy.deepcopy(r.model).to("cpu"))}
    models.update(rnns)
    for name, (model, cpu) in models.items():
        paths[f"split {name}"] = split_phase(name, model, cpu, planes[name],
                                             ops)
    for name in ("flash_attention", "flash_decode"):
        if paths["split cnmt:en-zh"][name] == 0:
            raise AssertionError(f"Marian's split never launched {name}")
    del models, rnns, r
    gc.collect()
    torch.cuda.empty_cache()

    for row in rows:
        row["launches"] = sum(c[row["name"]] for c in paths.values())
    log("  main-path launches: " + json.dumps(paths, sort_keys=True))
    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
