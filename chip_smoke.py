"""Drive the PyTorch/CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 is
the target).  It imports ``torch`` and the port (``src/repro_torch``)
only, builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, and then:

1. prints the card's name, the device count and ``nvidia-smi``'s name and
   power limit;
2. builds the kernels and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, float32 within 2e-5 and bfloat16 within 2e-2;
4. builds the paper's Marian en-zh model at full width
   (``resolve("cnmt:en-zh", scale=1.0)``, random weights from a seed) and
   holds its encoder output and four decode-step logits against the same
   model with the plain attention, within 1e-4;
5. drives the main path: calibrates the card tier's latency plane through
   ``forced_len`` translations, fits the N->M regressor on the en-zh
   corpus, builds a ``CollaborativeEngine`` with the real card tier and a
   modelled cloud tier behind a replayed RTT trace, submits 16 requests
   and one concurrent slot of 8, and checks that both kernels launched;
6. times each kernel (CUDA events) beside its bound, its plain version
   and ``scaled_dot_product_attention`` as a yardstick, and the tokens/s
   and peak memory of one batch-8 translate.

It prints one JSON line of kernel numbers and, last, the line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a card it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
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
# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth, float32 on the CUDA
# cores, bf16 on the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
H, DH, D = 8, 64, 512           # Marian en-zh: 8 heads of 64
MAX_DECODE = 256


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
                err = max_err(da.flash_decode_cuda(q, *kv, lens),
                              da.flash_decode_plain(q, *kv, lens))
                log(f"  flash_decode {name} B={b} T=256 self len={length}: "
                    f"max_abs_err={err:.3e}")
                if not err <= tol:
                    raise AssertionError(f"flash_decode error {err} > {tol}")
                cases += 1
            # cross-attention: encoder K/V of a ragged source batch
            src = 40
            xk = randn(gen, (b, src, D), dtype).view(b, src, H, DH)
            xv = randn(gen, (b, src, D), dtype).view(b, src, H, DH)
            lens = torch.tensor([40, 3, 17, 1, 39, 22, 8, 40][:b],
                                dtype=torch.int32, device="cuda")
            err = max_err(da.flash_decode_cuda(q, xk, xv, lens),
                          da.flash_decode_plain(q, xk, xv, lens))
            log(f"  flash_decode {name} B={b} S_src=40 cross ragged: "
                f"max_abs_err={err:.3e}")
            if not err <= tol:
                raise AssertionError(f"flash_decode error {err} > {tol}")
            cases += 1
        for s, causal in ((40, False), (128, False), (512, False), (64, True)):
            b = 2 if causal else 8
            q, k, v = (randn(gen, (b, s, D), dtype).view(b, s, H, DH)
                       for _ in range(3))
            lens = None if causal else torch.tensor(
                [s, s - 1, s // 2, 1, s // 3 + 1, s, 7, s - 5][:b],
                dtype=torch.int32, device="cuda")
            err = max_err(fa.flash_attention_cuda(q, k, v, lens,
                                                  causal=causal),
                          fa.flash_attention_plain(q, k, v, lens,
                                                   causal=causal))
            log(f"  flash_attention {name} B={b} S=T={s} "
                f"{'causal' if causal else 'ragged'}: max_abs_err={err:.3e}")
            if not err <= tol:
                raise AssertionError(f"flash_attention error {err} > {tol}")
            cases += 1
    torch.cuda.synchronize()
    return cases


# --------------------------------------------------------------- phase 4 --
@contextlib.contextmanager
def plain_attention(ops, fa, da):
    """Route the model's attention through the plain versions on the card
    (the reference for the model check); restores the wrappers after."""
    kernel_fa, kernel_fd = ops.flash_attention, ops.flash_decode
    ops.flash_attention = (lambda q, k, v, lengths=None, *, causal=True,
                           scale=None: fa.flash_attention_plain(
                               q, k, v, lengths, causal=causal, scale=scale))
    ops.flash_decode = (lambda q, k, v, lengths, *, scale=None:
                        da.flash_decode_plain(q, k, v, lengths, scale=scale))
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = kernel_fa, kernel_fd


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


def check_model(model, ops, fa, da):
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
    with plain_attention(ops, fa, da):
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
    from repro_torch.core.calibration import (make_edge_cloud_pair,
                                              measure_seq2seq_grid)
    from repro_torch.core.length_regressor import LinearN2M, prefilter_pairs
    from repro_torch.core.profiles import make_profile
    from repro_torch.data.synthetic import make_corpus
    from repro_torch.nmt.transformer import make_executors
    from repro_torch.runtime.engine import CollaborativeEngine, Tier

    executor, batched_executor = make_executors(model)
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
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} never launched on the main path")
    return launches


# --------------------------------------------------------------- phase 6 --
def time_case(kernel, plain, library, nbytes, flops) -> dict:
    """Device time of the kernel, its plain version and the library call
    on the same inputs, the kernel's eager per-call time, and its bound."""
    return dict(ms=device_ms(kernel), eager_ms=eager_ms(kernel),
                plain_ms=device_ms(plain, per_graph=10),
                library_ms=device_ms(library),
                max_abs_err=max_err(kernel(), plain()),
                **bound(nbytes, flops, torch.float32))


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


def timings(fa, da, launches, gen):
    """Per-kernel numbers at the main path's shapes (f32).  The first case
    of each kernel is its row in the JSON line; the rest are printed."""
    cases = [("flash_decode", decode_case(da, gen, 8, 128)),
             ("flash_decode", decode_case(da, gen, 1, 128)),
             ("flash_attention", attention_case(fa, gen, 8, 64)),
             ("flash_attention", attention_case(fa, gen, 8, 512))]
    for name, r in cases:
        log(f"  {name} {r['shape']}: device {r['ms']:.5f}ms, eager "
            f"{r['eager_ms']:.5f}ms, bound {r['bound_ms']:.5f}ms by "
            f"{r['bound_by']}, plain {r['plain_ms']:.5f}ms, sdpa "
            f"{r['library_ms']:.5f}ms (kernel vs plain {r['max_abs_err']:.2e},"
            f" vs sdpa {r['library_err']:.2e})")
    meta = {
        "flash_decode": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:89"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:131")}
    rows, seen = [], set()
    for name, r in cases:
        if name in seen:
            continue
        seen.add(name)
        rows.append(dict(r, name=name, route="cuda", source=meta[name][0],
                         replaces=meta[name][1], launches=launches[name]))
    return rows


def bound(nbytes: int, flops: int, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def step_profile(model, b):
    """One decode step at batch ``b``: eager wall time per step (what the
    translate loop pays) vs device time of the same step replayed from a
    CUDA graph.  Their gap is the host's launch cost, the device idle."""
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
        f"{100 * device / eager:.1f}% of the eager step")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
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
    log(f"  {check_kernels(fa, da, gen)} cases within tolerance")

    log("== phase 4: Marian en-zh at full width, kernels vs plain attention")
    t0 = time.perf_counter()
    r = resolve("cnmt:en-zh", scale=1.0, device="cuda", seed=0)
    model = r.model
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {r.name}: {r.cfg} ({n_params / 1e6:.1f}M parameters, built in "
        f"{time.perf_counter() - t0:.2f}s)")
    check_model(model, ops, fa, da)

    log("== phase 5: main path through CollaborativeEngine")
    launches = main_path(model, ops)

    log(f"== phase 6: timings on {smi}")
    rows = timings(fa, da, launches, gen)
    translate_rate(model)
    for b in (1, 8):
        step_profile(model, b)

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
