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
   zamba2's 64 heads of P = N = 64 (within 3e-4), the scans against the
   float64 run of their plain versions (the float32 run's own gap to it
   printed beside each case, not gated), at the chunk lengths
   prefill meets (a prime length above 128 too, and B=8 S=2048), with and
   without an initial state (``rwkv6_wkv`` also at head size 128;
   ``ssd_scan`` on the plan's kernel and every one it can be forced to,
   and under every value tile its mma.sync kernel's host can pick); a
   captured call of each scan replays 100 times bitwise equal;
   then the attention
   kernels at the D=128 models' shapes (qwen3-8b's 32 query heads over 8
   KV heads of 128, qwen3-moe-30b-a3b's 32 over 4, moonshot-v1-16b-a3b's
   16 over 16; float32 and bfloat16: a causal B=8 S=64 prefill, a B=8
   T=256 decode over ragged lengths and over lengths past the cache, the
   idle slots of a slot table; and in bfloat16 at phase 18's own shapes:
   the causal prefill at B=2 S=37 and at the admission waves' padded
   buckets, the decode over a 45-slot cache and a 128-slot table); then the
   attention kernels' edge cases: a 2048-slot cache cut into many splits, GQA,
   length 0 in a batch, every query tile on ragged shapes (head dims 16,
   32, 64, 128, causal with S != T), a captured ``flash_decode`` replayed
   after ``lengths`` changed on the device, and bitwise repeatability;
   then phase 15's shapes: whisper's encoder (B=4, S=T=1500 frames, 20
   heads of 64, non-causal), its cross-attention in prefill (16 tokens
   against 1500 frames, ragged lengths) and decode, and the sliding
   ``window`` on both kernels (windows of 1, 64 and wider than T under
   every query tile, a window past the prefix, qwen3-8b-swa's windowed
   prefill at S = 4200 and linear-window decode at 4200 slots, a decode
   whose splits lie wholly before the window start);
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
   rwkv6-3b; the attention kernels also at qwen3-8b's phase-3 shapes and
   at phase 15's: whisper's encoder, cross prefill and cross decode,
   qwen3-8b-swa's windowed prefill, linear-window and ring decode; and in
   bfloat16 at phase 18's: the three D=128 models' prefill and decode and
   whisper's encoder, bounded at 2-byte operands and 989 TFLOP/s),
   and ``ssd_scan`` on every path it has at every timed shape (the plan's
   choice beside them); the tokens/s and peak memory of one batch-8
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
   ``flash_attention`` and ``flash_decode`` launched; then a
   ``ContinuousGenerationSession`` (4 slots, ``max_len=64``) serves 8
   prompts of three lengths through ``CollaborativeEngine.
   serve_continuous``, block-to-completion and continuous, in
   exact-width admission waves, each row held against solo generation
   (tokens equal up to the first whose top-2 logit margin is under 1e-4);
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
   both attention kernels;
11. trains the paper's three NMT models at full width through
   ``launch/train_nmt.py``'s loop on their pairs' synthetic corpora at
   B=32 and max_len 48: Marian en-zh 200 AdamW steps, the BiLSTM de-en
   and the GRU fr-en 50 each.  Each checks a finite loss whose last-10
   mean is below its first-10 mean, the first step's loss against a CPU
   copy of the same weights and batch (within 1e-4 relative), that no
   kernel launched while training, and a checkpoint in the reference's
   format read back bitwise; it prints ms per step, target tokens/s and
   peak memory.  The trained Marian's kernel-path ``forward_teacher``
   (no grad) is held against its training path (within 1e-4), the same
   call under autograd must raise (the kernels are forward-only), and a
   greedy decode of 32 corpus sources prints the mean output length, the
   N->M correlation and the share that reaches ``max_decode_len``
   (reported, not gated);
12. the LM train step (loss, gradients, clipping, AdamW) at full width
   for zamba2-1.2b and rwkv6-3b, 5 steps each on one B=1 S=64 batch,
   each model freed before the next: a finite loss that falls, no kernel
   launched while training, and ``train_logits``' last position against
   ``prefill``'s kernel-path logits (phases 7-8's rule); it prints ms
   per step and peak memory.
13. (run after phase 10, before phases 11-12, so that its weights are
   freed before rwkv6-3b trains) builds qwen3-8b at full width
   (``resolve("qwen3-8b", size="full")``, random weights from a seed),
   prints its parameter count, holds its prefill and four decode-step
   logits against the plain kernels (phases 7-8's rule), runs the tiered
   path, then serves 32 ragged prompts (5-100 tokens, ``max_new=32``) on
   a Poisson schedule through ``serve_continuous`` with a
   ``ContinuousGenerationSession(max_slots=8, max_len=256)``, once
   block-to-completion and once continuous, after a warm-up pass.  It
   checks that the continuous run admitted more waves than ``ceil(32/8)``
   and filled all 8 slots, that both attention kernels launched, and
   that every row equals solo generation (the rule above); it prints
   p50/p95 of both modes, steps, waves, the eager step at 8 live slots
   beside the weight-read bound, the device busy share of a step
   (profiler), decode tokens/s, an admission wave's prefill time and
   the phase's peak memory.
15. (run after phase 14, before phases 11-12) whisper-large-v3 at full
   width and depth (``resolve("whisper-large-v3", size="full")``, 32 + 32
   layers, random weights from a seed): first a copy cut to 2 + 2 layers
   at full width holds its prefill + four decode-step logits on the
   kernels against the plain versions, and four decode steps against the
   teacher-forced ``train_logits``, on 1500 frames with a ragged prefix
   mask (each within ten times the effect of a 1e-7 perturbation of the
   embeddings and the frames); then ``GenerationSession(max_len=448).
   generate(frames=)`` on B=4 of 1500 frames (numpy, seeded) for prompts
   of 4 and of 16 tokens, 32 new tokens each, checking both attention
   kernels launched; it prints the encoder and prefill times, an eager
   decode step beside its bound (decoder and head weights plus the cross
   caches), launches per step, the device busy share and peak memory.
   Then the long_500k variants: qwen3-8b-swa at full width cut to 4 of
   36 layers prefills 4090 tokens into a 4096-slot state (a ring) and
   decodes 10 tokens past position 4096, held against a linear cache of
   4200 slots under the window on the same weights, and prefills 4200
   tokens (past the window) on the kernels against the plain versions;
   it prints the ring's bytes against a linear cache's at 524288
   positions; zamba2-1.2b-swa at full depth prefills 4200 tokens, kernels
   against plain (the rule above).
16. (run after phase 15, before phases 11-12) ``flash_decode(
   return_stats=True)`` against its plain twin at qwen3-8b's decode
   shapes (output, softmax max m and normaliser l within 2e-5, l
   relative; ragged, length 0, past the cache, one split and four, from
   a CUDA graph; the output bitwise as without stats), and 2 and 4 cache
   slices merged by ``merge_decode_stats`` against the whole cache; then
   qwen3-8b at full width through ``make_sharded_session`` on a 1x1 NCCL
   mesh (``tp``, so every attention layer decodes through
   ``attn_decode_seq_sharded``: the stats kernel and two all_reduces),
   a ragged B=8 ``generate_with_lengths`` and 12 prompts through a
   continuous slot table of 8, 16 new tokens each, held against the
   unsharded sessions on the same weights (tokens equal up to the first
   behind a top-2 margin under 1e-4), checking that both attention
   kernels launched; it prints the rank's parameter bytes and the eager
   B=8 decode step, sharded beside unsharded, in turns.  Phase 6 also
   times the stats call at qwen3-8b's step.
17. (run after phase 16, before phases 11-12) sharded training: qwen3-8b
   at full width cut to 4 of its 36 layers (2.016 B parameters, random
   weights from seed 0) takes 3 AdamW steps through ``make_train_step``
   on a ``ShardedLM`` over a 1x1 NCCL mesh (``tp``) at B=4 S=256 from
   ``launch/train.py``'s token stream, then the unsharded model on the
   same weights and batches; each step's loss and grad norm and every
   parameter after step 3 are held equal (bitwise, else within 1e-6
   relative; it prints which held).  The dry run's per-rank argument
   bytes of this step at float32 (``launch/dryrun.argument_bytes``) are
   held against the card's ``memory_allocated`` and the state's own
   tensors within 2%, naming the term that is off.  A ragged B=8
   ``generate_with_lengths`` of 16 tokens from the trained sharded model
   is held against the unsharded one behind the margin, and must launch
   both attention kernels.  It prints the eager train step, sharded
   beside unsharded, in turns, and the peak memory.
18. (run after phase 17, before phases 11-12) bfloat16 serving at full
   depth: qwen3-8b cut to 4 of 36 layers at full width, drawn from seed 0
   in bf16 and in float32 (each bf16 weight must be its float32 draw
   cast), its bf16 prefill + four decode-step logits on the kernels held
   against the float32 twin within 2.0x the gap of the bf16 plain route
   to the same twin; then qwen3-8b (36 layers), qwen3-moe-30b-a3b (48)
   and moonshot-v1-16b-a3b (48) each built whole in bf16 on the card
   (``resolve(..., param_dtype=torch.bfloat16)``, seed 0), one at a
   time: prefill + four decode-step logits, a ragged B=8
   ``generate_with_lengths`` of 16 tokens and ragged admission waves on
   8 slots with every kernel call held against its plain version on the
   same inputs (a bf16 output within 2e-2 of it, a float32 one within
   phase 3's limit, each over the scale max(1, max |plain|)), then 12
   prompts through ``serve_continuous`` on 8 slots (both modes), each
   launching both attention kernels; it prints the parameters' bytes,
   the eager slot-table step at 8 live slots with its ATen operators,
   its device time beside the weight-read bound (for a MoE model also
   beside the read of only the experts its routing picked), and the peak
   memory; then zamba2-1.2b, rwkv6-3b and whisper-large-v3 (1500 frames)
   whole in bf16: prefill + four decode-step logits and an 8-token
   generate with every kernel call checked the same way, the logits and
   state bf16, and each of the family's kernels launched.

19. (run after phase 18, before phases 11-12) bfloat16 sharded and
   trained: phase 3 also holds bf16 ``flash_decode(return_stats=True)``
   against its plain twin at phase 16's shapes (the output within 2e-2
   of its scale, m and l within 2e-5, a one-slice merge the kernel's
   output bitwise) and phase 6 times it; qwen3-8b (36 layers) and
   qwen3-moe-30b-a3b (48) whole in bf16 through ``make_sharded_session``
   on a 1x1 NCCL mesh (``tp``: every attention layer decodes through the
   bf16 stats kernel and the float32 merge), a ragged B=8 generate and
   12 prompts on a slot table of 8 against the unsharded bf16 sessions
   (bitwise, else behind the margin), both attention kernels launched,
   the eager step sharded beside unsharded; qwen3-8b cut to 4 of 36
   layers in bf16 (bf16 moments), 3 steps at B=4 S=256: the 1x1-mesh
   steps and the unsharded ones bitwise, ``LM(remat=True)`` and
   ``remat=False`` bitwise with each one's peak memory, the loss falling
   and its gap to the float32 twin's, and the dry run's per-rank bytes
   against ``memory_allocated`` within 1% with bf16 and with float32
   moments; then 3 bf16 steps at B=1 S=64 at full depth: rwkv6-3b and
   zamba2-1.2b (float32 moments) and qwen3-8b (``remat=True``, bf16
   moments) at the deepest cut the dry run's bytes and the 4-layer
   run's peak say fits (all 36 layers where they do), each with ms a
   step, the device busy share, the peak memory and a falling loss.
20. (run after phase 19, before phases 11-12) the examples' launchers,
   ``repro_torch.launch.<name>.main()`` in process with
   ``REPRO_SMOKE=1``: ``quickstart`` and ``fault_tolerant_serving`` as
   they are, ``partitioned_serving``, ``collaborative_serving`` and
   ``multitier_serving`` with the BiLSTM de-en at ``--scale 1.0``, and
   ``big_model_serving --size full`` (qwen3-8b as the cloud tier and
   rwkv6-3b as the edge, both whole in float32), every kernel call held
   against its plain version (``checked_kernels``; the scans against
   the float64 run).  It checks each result (every request of the
   smoke streams served or accounted for, finite latencies, full token
   rows) and that ``big_model_serving`` launched ``flash_attention``,
   ``flash_decode`` and ``rwkv6_wkv``; it prints each launcher's wall
   time, launches and engine stats, and the phase's peak memory.

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
import tempfile
import time
import types

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
QW_H, QW_HKV, QW_D = 32, 8, 128  # qwen3-8b: 32 query heads over 8 KV heads
# the D=128 attention shapes of the GQA models: qwen3-8b's group of 4,
# qwen3-moe-30b-a3b's group of 8 and moonshot-v1-16b-a3b's MHA
GQA_SHAPES = (("qwen3-8b", QW_H, QW_HKV), ("qwen3-moe-30b-a3b", 32, 4),
              ("moonshot-v1-16b-a3b", 16, 16))
QW_T = 256                      # phase 13's slot-table capacity (max_len)
QW_LENS = (37, 256, 100, 5, 180, 64, 1, 129)   # a table step's pos + 1
QW_RATE_HZ = 40.0               # phase 13's Poisson arrivals: twice what 8
                                # slots serve at ~25 ms a step
MARGIN = 1e-4                   # top-2 logit margin behind a compared token
WH_H, WH_T = 20, 1500           # whisper-large-v3: 20 MHA heads of 64 over
                                # 1500 frames (1500 mod 64 = 28 keys of tail)
WH_LENS = (1500, 1213, 700, 1)  # ragged frame lengths of a batch of 4
WH_B, WH_MAX_LEN, WH_NEW = 4, 448, 32   # phase 15's generation
SWA_W = 4096                    # the long_500k variants' sliding window
BF16_T = 128                    # phase 18's slot-table and session capacity
BF16_LENS = (53, 9, 128, 80, 1, 66, 29, 46)   # a B=8 step's pos + 1 there
SWA_CUT = 4                     # qwen3-8b-swa's layers (of 36) in phase 15


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's header ("== ...") with the seconds since
    the script started."""
    if msg.startswith("== "):
        msg = f"{msg} [{time.perf_counter() - _T0:.0f} s]"
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
def within_paths(what: str, kernel, want, tol: float, mod=None,
                 paths=None) -> None:
    """``kernel(path)`` within ``tol`` of ``want`` on the plan's own path
    and on every path it can be forced to: ``paths`` where given (the
    scans'), else those the attention kernel module ``mod`` has at this
    head dim: ``flash_attention``'s wgmma and mma.sync kernels,
    ``flash_decode``'s tensor-core and CUDA-core paths."""
    if paths is None:
        d = _outputs(want)[0].shape[-1]
        if hasattr(mod, "attention_plan"):
            paths = ["mma"] + (["wgmma"] if d in mod.WGMMA_HEAD_DIMS else [])
        else:
            paths = ["cores"] + (["mma"] if d in mod.MMA_HEAD_DIMS else [])
    for path in (None, *paths):
        within(f"{what} [{path or 'plan'}]", kernel(path), want, tol)


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
                within_paths(
                    f"flash_decode {name} B={b} T=256 self len={length}",
                    lambda p: da.flash_decode_cuda(q, *kv, lens, path=p),
                    da.flash_decode_plain(q, *kv, lens), tol, da)
                cases += 1
            # cross-attention: encoder K/V of a ragged source batch
            src = 40
            xk = randn(gen, (b, src, D), dtype).view(b, src, H, DH)
            xv = randn(gen, (b, src, D), dtype).view(b, src, H, DH)
            lens = torch.tensor([40, 3, 17, 1, 39, 22, 8, 40][:b],
                                dtype=torch.int32, device="cuda")
            within_paths(
                f"flash_decode {name} B={b} S_src=40 cross ragged",
                lambda p: da.flash_decode_cuda(q, xk, xv, lens, path=p),
                da.flash_decode_plain(q, xk, xv, lens), tol, da)
            cases += 1
        for s, causal in ((40, False), (128, False), (512, False), (64, True)):
            b = 2 if causal else 8
            q, k, v = (randn(gen, (b, s, D), dtype).view(b, s, H, DH)
                       for _ in range(3))
            lens = None if causal else torch.tensor(
                [s, s - 1, s // 2, 1, s // 3 + 1, s, 7, s - 5][:b],
                dtype=torch.int32, device="cuda")
            within_paths(
                f"flash_attention {name} B={b} S=T={s} "
                f"{'causal' if causal else 'ragged'}",
                lambda p: fa.flash_attention_cuda(q, k, v, lens,
                                                  causal=causal, path=p),
                fa.flash_attention_plain(q, k, v, lens, causal=causal),
                tol, fa)
            cases += 1
        # zamba2's shared attention: causal prefill at serving lengths and
        # decode against a max_len=64 cache
        for b, s in ((1, 37), (8, 64)):
            q, k, v = (randn(gen, (b, s, ZA_H * DH), dtype).view(
                b, s, ZA_H, DH) for _ in range(3))
            within_paths(
                f"flash_attention {name} B={b} S=T={s} H={ZA_H} causal",
                lambda p: fa.flash_attention_cuda(q, k, v, causal=True,
                                                  path=p),
                fa.flash_attention_plain(q, k, v, causal=True), tol, fa)
            lens = torch.tensor([s, 1, 40, 17, 64, 33, 2, 50][:b],
                                dtype=torch.int32, device="cuda")
            kc, vc = (randn(gen, (b, 64, ZA_H, DH), dtype) for _ in range(2))
            within_paths(
                f"flash_decode {name} B={b} T=64 H={ZA_H}",
                lambda p: da.flash_decode_cuda(q[:, 0], kc, vc, lens, path=p),
                da.flash_decode_plain(q[:, 0], kc, vc, lens), tol, da)
            cases += 2
    torch.cuda.synchronize()
    return (cases + check_gqa_cases(fa, da, gen)
            + check_tile_cases(fa, da, gen) + check_window_cases(fa, da, gen))


def check_gqa_cases(fa, da, gen):
    """The D=128 models' attention (``GQA_SHAPES``: qwen3-8b,
    qwen3-moe-30b-a3b's group of 8, moonshot-v1-16b-a3b's MHA) in float32
    and in bfloat16 (phase 18's dtype): an admission wave's causal
    prefill, a slot-table step's decode over ragged lengths, and the
    decode of idle slots whose lengths run past the cache (they attend to
    every slot, as the reference's mask ``idx <= pos`` does there)."""
    cases = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = "f32" if dtype == torch.float32 else "bf16"
        for model, h, hkv in GQA_SHAPES:
            q = randn(gen, (8, 64, h, QW_D), dtype)
            k, v = (randn(gen, (8, 64, hkv, QW_D), dtype) for _ in range(2))
            within_paths(
                f"{model} flash_attention {name} B=8 S=T=64 H={h} "
                f"Hkv={hkv} D={QW_D} causal",
                lambda p: fa.flash_attention_cuda(q, k, v, causal=True,
                                                  path=p),
                fa.flash_attention_plain(q, k, v, causal=True), tol, fa)
            q = randn(gen, (8, h, QW_D), dtype)
            kc, vc = (randn(gen, (8, QW_T, hkv, QW_D), dtype)
                      for _ in range(2))
            for what, lens in (("ragged", QW_LENS),
                               ("past the cache",
                                (QW_T + 1, 300, QW_T, 1000, 511, 2**20, 258,
                                 1))):
                lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
                within_paths(
                    f"{model} flash_decode {name} B=8 T={QW_T} H={h} "
                    f"Hkv={hkv} D={QW_D} {what} lens={lens}",
                    lambda p: da.flash_decode_cuda(q, kc, vc, lt, path=p),
                    da.flash_decode_plain(q, kc, vc, lt), tol, da)
            cases += 3
    for model, h, hkv in GQA_SHAPES:      # phase 18's own bf16 shapes
        # check_bf16_model's B=2 S=37 prefill, the admission waves' padded
        # (batch, width) buckets at max_len 128, and the decodes over
        # lm_logits' 45-slot cache and the sessions' 128-slot tables
        for b, s in ((2, 37), (1, 8), (2, 16), (4, 32), (8, 64)):
            q = randn(gen, (b, s, h, QW_D), torch.bfloat16)
            k, v = (randn(gen, (b, s, hkv, QW_D), torch.bfloat16)
                    for _ in range(2))
            within_paths(
                f"{model} flash_attention bf16 B={b} S=T={s} H={h} "
                f"Hkv={hkv} D={QW_D} causal",
                lambda p: fa.flash_attention_cuda(q, k, v, causal=True,
                                                  path=p),
                fa.flash_attention_plain(q, k, v, causal=True), BF16_TOL, fa)
            cases += 1
        for t, lens in ((45, (38, 41)), (BF16_T, BF16_LENS)):
            q = randn(gen, (len(lens), h, QW_D), torch.bfloat16)
            kc, vc = (randn(gen, (len(lens), t, hkv, QW_D), torch.bfloat16)
                      for _ in range(2))
            lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
            within_paths(
                f"{model} flash_decode bf16 B={len(lens)} T={t} H={h} "
                f"Hkv={hkv} D={QW_D} lens={lens}",
                lambda p: da.flash_decode_cuda(q, kc, vc, lt, path=p),
                da.flash_decode_plain(q, kc, vc, lt), BF16_TOL, da)
            cases += 1
    return cases


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
            within_paths(
                f"flash_decode {name} B={b} T={t} H={h} Hkv={hkv} "
                f"lens={lens} splits={da.decode_splits(b, hkv, t)[0]}",
                lambda p: da.flash_decode_cuda(q, kc, vc, lt, path=p),
                da.flash_decode_plain(q, kc, vc, lt), tol, da)
            cases += 1
        # every query tile of the mma.sync kernel, then the wgmma kernel,
        # on ragged shapes whose rows and keys straddle the tiles' edges
        for bq in (*fa.BLOCK_Q, "wgmma"):
            for b, s, t, h, hkv, d, causal in ((2, 77, 77, 4, 4, 16, False),
                                               (2, 53, 91, 4, 2, 32, False),
                                               (1, 45, 45, 2, 2, 128, True),
                                               (1, 37, 70, 4, 4, 64, True),
                                               (2, 100, 29, 6, 2, 64, True),
                                               (1, 130, 130, 16, 2, 128,
                                                True),
                                               (2, 129, 200, 8, 8, 64,
                                                False)):
                if bq == "wgmma" and d not in fa.WGMMA_HEAD_DIMS:
                    continue
                q = randn(gen, (b, s, h, d), dtype)
                k, v = (randn(gen, (b, t, hkv, d), dtype) for _ in range(2))
                lens = torch.tensor([t, max(1, t // 3)][:b],
                                    dtype=torch.int32, device="cuda")
                force = (dict(path="wgmma") if bq == "wgmma"
                         else dict(block_q=bq))
                within(f"flash_attention {name} {bq=} B={b} S={s} "
                       f"T={t} H={h} Hkv={hkv} D={d} causal={causal}",
                       fa.flash_attention_cuda(q, k, v, lens, causal=causal,
                                               **force),
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
    return cases + 1 + check_decode_graph(da, gen)


def check_decode_graph(da, gen):
    """The one-launch decode under a CUDA graph on both paths: captured at
    qwen3-moe-30b-a3b's group of 8 in bf16, replayed 100 times with new
    lengths written on the device each time, every output held against
    the plain version, bitwise repeatable, and the split counters back at
    zero after the last replay (the last block of each head group resets
    its own)."""
    cases = 0
    q = randn(gen, (8, 32, QW_D), torch.bfloat16)
    kc, vc = (randn(gen, (8, QW_T, 4, QW_D), torch.bfloat16)
              for _ in range(2))
    lens = torch.tensor(QW_LENS, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(11)
    for path in ("mma", "cores"):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            da.flash_decode_cuda(q, kc, vc, lens, path=path)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = da.flash_decode_cuda(q, kc, vc, lens, path=path)
        worst = 0.0
        for i in range(100):
            new = rng.integers(-1, QW_T + 40, size=8)
            lens.copy_(torch.as_tensor(new, dtype=torch.int32))
            graph.replay()
            got = out.clone()
            graph.replay()
            want = da.flash_decode_plain(q, kc, vc, lens)
            worst = max(worst, max_err(got, want))
            if not (torch.equal(got, out) and worst <= BF16_TOL
                    and torch.isfinite(got.float()).all()):
                raise AssertionError(f"flash_decode {path} graph replay {i} "
                                     f"at lengths {new}: error {worst}")
        torch.cuda.synchronize()
        busy = int((da.counter_buffer("cuda") != 0).sum())
        log(f"  flash_decode {path} bf16 B=8 H=32 Hkv=4: 100 graph replays "
            f"over new device lengths, max_abs_err={worst:.3e}, bitwise "
            f"repeatable, {busy} split counters left nonzero")
        if busy:
            raise AssertionError("split counters not reset")
        cases += 1
    return cases


def check_window_cases(fa, da, gen):
    """Phase 15's shapes: whisper's encoder (non-causal, T = 1500 keys, not
    a multiple of the key tile), its cross-attention in prefill (16 tokens
    against 1500 frames, ragged lengths) and decode; then the sliding
    window on both kernels: windows of 1, 64 and wider than T, a row whose
    window lies past its prefix, the windowed prefill past 4096 and the
    linear-window decode at 4200 slots (qwen3-8b-swa's shapes), and a
    decode whose splits lie wholly before the window start."""
    cases = 0
    lens = torch.tensor(WH_LENS, dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = "f32" if dtype == torch.float32 else "bf16"
        q, k, v = (randn(gen, (4, WH_T, WH_H, DH), dtype) for _ in range(3))
        within_paths(
            f"whisper encoder flash_attention {name} B=4 S=T={WH_T} "
            f"H={WH_H} non-causal",
            lambda p: fa.flash_attention_cuda(q, k, v, causal=False, path=p),
            fa.flash_attention_plain(q, k, v, causal=False), tol, fa)
        qx = randn(gen, (4, 16, WH_H, DH), dtype)
        within_paths(
            f"whisper cross prefill flash_attention {name} B=4 S=16 "
            f"T={WH_T} lens={WH_LENS}",
            lambda p: fa.flash_attention_cuda(qx, k, v, lens, causal=False,
                                              path=p),
            fa.flash_attention_plain(qx, k, v, lens, causal=False), tol, fa)
        q1 = randn(gen, (4, WH_H, DH), dtype)
        within_paths(
            f"whisper cross decode flash_decode {name} B=4 T={WH_T} "
            f"lens={WH_LENS}",
            lambda p: da.flash_decode_cuda(q1, k, v, lens, path=p),
            da.flash_decode_plain(q1, k, v, lens), tol, da)
        cases += 3
        # the generate path's shapes: every frame valid, the prompts' causal
        # prefill, and self decode against the max_len = 448 cache
        full = torch.full((4,), WH_T, dtype=torch.int32, device="cuda")
        within_paths(
            f"whisper cross decode flash_decode {name} B=4 T={WH_T} "
            f"lens={WH_T}",
            lambda p: da.flash_decode_cuda(q1, k, v, full, path=p),
            da.flash_decode_plain(q1, k, v, full), tol, da)
        for s in (4, 16):
            within_paths(
                f"whisper cross prefill flash_attention {name} B=4 S={s} "
                f"T={WH_T} lens={WH_T}",
                lambda p: fa.flash_attention_cuda(qx[:, :s], k, v, full,
                                                  causal=False, path=p),
                fa.flash_attention_plain(qx[:, :s], k, v, full,
                                         causal=False), tol, fa)
            within_paths(
                f"whisper self prefill flash_attention {name} B=4 "
                f"S=T={s} H={WH_H} causal",
                lambda p: fa.flash_attention_cuda(
                    qx[:, :s], k[:, :s], v[:, :s], causal=True, path=p),
                fa.flash_attention_plain(qx[:, :s], k[:, :s], v[:, :s],
                                         causal=True), tol, fa)
        kc, vc = k[:, :WH_MAX_LEN], v[:, :WH_MAX_LEN]
        for length in (5, 47):
            lt = torch.full((4,), length, dtype=torch.int32, device="cuda")
            within_paths(
                f"whisper self decode flash_decode {name} B=4 "
                f"T={WH_MAX_LEN} lens={length}",
                lambda p: da.flash_decode_cuda(q1, kc, vc, lt, path=p),
                da.flash_decode_plain(q1, kc, vc, lt), tol, da)
        cases += 7
    for window in (1, 64, 5000):
        for b, s, h, hkv, d, lt in ((2, 300, 8, 8, 64, None),
                                    (1, 200, 32, 8, 128, None),
                                    (2, 130, 4, 4, 64, (130, 90))):
            q = randn(gen, (b, s, h, d))
            k, v = (randn(gen, (b, s, hkv, d)) for _ in range(2))
            lengths = None if lt is None else torch.tensor(
                lt, dtype=torch.int32, device="cuda")
            for bq in fa.BLOCK_Q:
                within(f"flash_attention f32 window={window} block_q={bq} "
                       f"B={b} S=T={s} H={h} Hkv={hkv} D={d} lens={lt}",
                       fa.flash_attention_cuda(q, k, v, lengths, causal=True,
                                               window=window, block_q=bq),
                       fa.flash_attention_plain(q, k, v, lengths,
                                                causal=True, window=window),
                       F32_TOL)
                cases += 1
        q = randn(gen, (3, H, DH))
        kc, vc = (randn(gen, (3, 512, H, DH)) for _ in range(2))
        lt = torch.tensor((300, 512, 600), dtype=torch.int32, device="cuda")
        within_paths(
            f"flash_decode f32 window={window} B=3 T=512 "
            f"lens=(300, 512, 600)",
            lambda p: da.flash_decode_cuda(q, kc, vc, lt, window=window,
                                           path=p),
            da.flash_decode_plain(q, kc, vc, lt, window=window), F32_TOL, da)
        cases += 1
    # qwen3-8b-swa: the windowed prefill past the window, the linear-window
    # decode at 4200 slots, the full ring
    q = randn(gen, (1, 4200, QW_H, QW_D))
    k, v = (randn(gen, (1, 4200, QW_HKV, QW_D)) for _ in range(2))
    within_paths(
        f"qwen3-8b-swa flash_attention f32 B=1 S=T=4200 H={QW_H} "
        f"Hkv={QW_HKV} D={QW_D} window={SWA_W}",
        lambda p: fa.flash_attention_cuda(q, k, v, causal=True, window=SWA_W,
                                          path=p),
        fa.flash_attention_plain(q, k, v, causal=True, window=SWA_W),
        F32_TOL, fa)
    within_paths(
        f"qwen3-8b-swa flash_attention f32 B=1 S=T=4090 H={QW_H} "
        f"Hkv={QW_HKV} D={QW_D} window={SWA_W}",
        lambda p: fa.flash_attention_cuda(
            q[:, :4090], k[:, :4090], v[:, :4090], causal=True,
            window=SWA_W, path=p),
        fa.flash_attention_plain(q[:, :4090], k[:, :4090], v[:, :4090],
                                 causal=True, window=SWA_W), F32_TOL, fa)
    q = randn(gen, (2, QW_H, QW_D))
    kc, vc = (randn(gen, (2, 4200, QW_HKV, QW_D)) for _ in range(2))
    for lt in ((4150, 4200), (4097, 5000), (4096, 1)):
        lt_t = torch.tensor(lt, dtype=torch.int32, device="cuda")
        within_paths(
            f"qwen3-8b-swa flash_decode f32 B=2 T=4200 lens={lt} "
            f"window={SWA_W}",
            lambda p: da.flash_decode_cuda(q, kc, vc, lt_t, window=SWA_W,
                                           path=p),
            da.flash_decode_plain(q, kc, vc, lt_t, window=SWA_W), F32_TOL, da)
    # phase 15's decode at B=1: the linear cache of 4200 slots under the
    # window, and the ring of 4096 slots (lengths min(pos + 1, 4096))
    for t, length, window in ((4200, 4100, SWA_W), (SWA_W, 4091, None),
                              (SWA_W, SWA_W, None)):
        lt_t = torch.tensor((length,), dtype=torch.int32, device="cuda")
        within_paths(
            f"qwen3-8b-swa flash_decode f32 B=1 T={t} len={length} "
            f"window={window}",
            lambda p: da.flash_decode_cuda(q[:1], kc[:1, :t], vc[:1, :t],
                                           lt_t, window=window, path=p),
            da.flash_decode_plain(q[:1], kc[:1, :t], vc[:1, :t], lt_t,
                                  window=window), F32_TOL, da)
    cases += 8
    # splits wholly before the window start: (m, l) = (-inf, 0), no NaN
    q = randn(gen, (1, H, DH))
    kc, vc = (randn(gen, (1, 2048, H, DH)) for _ in range(2))
    lt = torch.tensor((2047,), dtype=torch.int32, device="cuda")
    n_split, chunk = da.decode_splits(1, H, 2048)
    within_paths(
        f"flash_decode f32 B=1 T=2048 len=2047 window=64: "
        f"{(2047 - 64) // chunk} of {n_split} splits before the window "
        f"start",
        lambda p: da.flash_decode_cuda(q, kc, vc, lt, window=64, path=p),
        da.flash_decode_plain(q, kc, vc, lt, window=64), F32_TOL, da)
    torch.cuda.synchronize()
    return cases + 1


def wkv_inputs(gen, b, s, with_s0=False, h=WKV_H, p=WKV_P):
    """rwkv6-3b-shaped WKV operands (``h`` heads of ``p``); log w clamped
    as the model clamps."""
    r, k, v = (randn(gen, (b, s, h, p)) for _ in range(3))
    log_w = -torch.clamp(torch.exp(randn(gen, (b, s, h, p))), 1e-4, 2.5)
    u = 0.5 * randn(gen, (h, p))
    s0 = randn(gen, (b, h, p, p)) if with_s0 else None
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


def twin_gap(got, exact) -> float:
    """Max abs difference of each output of ``got`` from ``exact``'s, the
    float64 one cast to ``got``'s dtype first."""
    return max(max_err(a, b.to(a.dtype))
               for a, b in zip(_outputs(got), _outputs(exact)))


def float64_twin(what, plain, args, chunk):
    """The yardstick of a scan check: ``plain`` (a scan's plain twin) run
    in float64 on ``args``, cast back to float32.  Logs the float32
    twin's own gap to it beside the check, for the record, not as a
    gate: at rwkv6-3b's |y| ~ 90 the float32 twin at chunk 32 is up to
    2.3e-4 off, past ``WKV_TOL``."""
    exact = tuple(t.float() for t in plain(*args, chunk=chunk,
                                           dtype=torch.float64))
    log(f"  {what}: float32 twin's gap to the float64 twin "
        f"{twin_gap(plain(*args, chunk=chunk), exact):.3e}")
    return exact


def check_scan_kernels(wkv, ssd, gen):
    """The two scan kernels vs the float64 runs of their plain versions
    (:func:`float64_twin`) at the LM prefill shapes: every chunk length a
    prompt can give (1 for a prime length; both kernels run blocks of
    their own whatever the chunk, and ``ssd_scan``'s also above 128), the
    long prefill B=8 S=2048 and ``rwkv6_wkv`` at head size 128;
    ``ssd_scan`` on the plan's kernel and every kernel it can be forced to
    (``_launch(..., path=)``), then every value tile its mma.sync kernel's
    host can pick (``ssd_plan``'s); then a captured call of each replayed
    100 times, bitwise equal every time."""
    cases = 0
    for with_s0 in (False, True):
        for b, s, chunk in ((1, 37, 1), (2, 49, 7), (1, 64, 32), (8, 64, 32),
                            *([(8, 2048, 32)] if with_s0 else [])):
            args = wkv_inputs(gen, b, s, with_s0)
            what = (f"rwkv6_wkv B={b} S={s} H={WKV_H} P={WKV_P} L={chunk} "
                    f"s0={with_s0}")
            within(what, wkv.rwkv6_wkv_cuda(*args, chunk=chunk),
                   float64_twin(what, wkv.rwkv6_wkv_plain, args, chunk),
                   WKV_TOL)
            cases += 1
        for b, s, chunk in ((1, 37, 1), (1, 37, 37), (2, 128, 64),
                            (1, 256, 128), (1, 257, 1),
                            *([(8, 2048, 128)] if with_s0 else [])):
            args = ssd_inputs(gen, b, s, with_s0)
            what = (f"ssd_scan B={b} S={s} H={SSD_H} P=N={SSD_P} L={chunk} "
                    f"s0={with_s0}")
            within_paths(what, lambda p: ssd._launch(*args, chunk, path=p),
                         float64_twin(what, ssd.ssd_scan_plain, args, chunk),
                         SSD_TOL, paths=ssd.ssd_paths(SSD_P, SSD_N, chunk))
            cases += 1
    for b, s, chunk in ((2, 53, 1), (1, 96, 32)):
        args = wkv_inputs(gen, b, s, True, 4, 128)
        what = f"rwkv6_wkv B={b} S={s} H=4 P=128 L={chunk} s0=True"
        within(what, wkv.rwkv6_wkv_cuda(*args, chunk=chunk),
               float64_twin(what, wkv.rwkv6_wkv_plain, args, chunk), WKV_TOL)
        cases += 1
    for b, s, chunk in ((1, 37, 1), (2, 128, 64), (1, 256, 128)):
        for pt in ssd.ssd_tiles(SSD_P, SSD_N, chunk):
            args = ssd_inputs(gen, b, s, True)
            what = f"ssd_scan mma.sync p_tile={pt} B={b} S={s} L={chunk}"
            within(what, ssd._launch(*args, chunk, pt),
                   float64_twin(what, ssd.ssd_scan_plain, args, chunk),
                   SSD_TOL)
            cases += 1
    wargs, sargs = wkv_inputs(gen, 2, 64, True), ssd_inputs(gen, 2, 128, True)
    for name, call in (
            ("rwkv6_wkv", lambda: wkv.rwkv6_wkv_cuda(*wargs, chunk=32)),
            ("ssd_scan", lambda: ssd.ssd_scan_cuda(*sargs, chunk=64))):
        replays_equal(name, call)
        cases += 1
    torch.cuda.synchronize()
    return cases


def replays_equal(name: str, call, replays: int = 100) -> None:
    """Capture one ``call`` in a CUDA graph, replay it ``replays`` times
    and raise unless every replay's outputs equal the first's bitwise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _outputs(call())
    graph.replay()
    first = [t.clone() for t in out]
    for _ in range(replays - 1):
        graph.replay()
        if not all(torch.equal(a, b) for a, b in zip(out, first)):
            raise AssertionError(f"{name}: a graph replay differs")
    torch.cuda.synchronize()
    log(f"  {name}: {replays} graph replays bitwise equal")


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


# each kernel's limit on one call's error against its plain version, over
# the scale max(1, max |plain|): 2e-2 for a bf16 output, phase 3's limit
# for a float32 one (the scan kernels run in float32 inside a bf16 model)
CALL_TOL = {"flash_attention": F32_TOL, "flash_decode": F32_TOL,
            "rwkv6_wkv": WKV_TOL, "ssd_scan": SSD_TOL}


SCANS = ("rwkv6_wkv", "ssd_scan")


@contextlib.contextmanager
def checked_kernels(worst):
    """While active, each kernel wrapper runs and counts its launch as on
    the main path, and each CUDA launch is followed by the kernel's plain
    version on the same inputs (a scan's run in float64: its float32 run
    is logged beside, in ``worst``, not gated): every output must be
    finite and within ``CALL_TOL`` (``BF16_TOL`` for a bf16 output) x
    max(1, max |plain|) of the plain one (the max over values under 1e29:
    an empty row's m is the -1e30 sentinel, which the kernel must then
    return too).  ``worst`` gathers per kernel the calls checked, the call
    nearest its limit and, for a scan, the float32 twin's largest gap to
    the float64 one.  Raises at the first call out of it."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import ssd_scan as ssd
    mods = {"flash_attention": fa, "flash_decode": da, "rwkv6_wkv": wkv,
            "ssd_scan": ssd}
    cuda = {name: getattr(m, f"{name}_cuda") for name, m in mods.items()}

    def checked(name):
        plain = getattr(mods[name], f"{name}_plain")

        def call(*args, **kw):
            out = cuda[name](*args, **kw)
            w = worst.setdefault(name, {"calls": 0, "share": -1.0})
            if name in SCANS:
                want = plain(*args, **kw, dtype=torch.float64)
                w["twin_gap"] = max(w.get("twin_gap", 0.0),
                                    twin_gap(plain(*args, **kw), want))
            else:
                want = plain(*args, **kw)
            w["calls"] += 1
            for a, b in zip(_outputs(out), _outputs(want)):
                live = b.float().abs()
                live = live[live < 1e29]
                scale = max(1.0, float(live.max()) if live.numel() else 1.0)
                tol = (BF16_TOL if a.dtype == torch.bfloat16
                       else CALL_TOL[name]) * scale
                err = max_err(a, b)
                what = (f"{' x '.join(str(tuple(t.shape)) for t in args[:2])}"
                        f" {_dname(a.dtype)}")
                if not (err <= tol and torch.isfinite(a).all()):
                    raise AssertionError(f"{name} at {what}: {err} against "
                                         f"its plain version > {tol}")
                if err / tol > w["share"]:
                    w.update(share=err / tol, err=err, tol=tol, shape=what)
            return out
        return call

    for name, m in mods.items():
        setattr(m, f"{name}_cuda", checked(name))
    try:
        yield
    finally:
        for name, m in mods.items():
            setattr(m, f"{name}_cuda", cuda[name])


def checked_line(worst) -> str:
    return "; ".join(
        f"{name} {w['calls']} calls, nearest its limit {w['err']:.3e} of "
        f"{w['tol']:.3e} at {w['shape']}"
        + (f" (against float64; the float32 twin's own gap up to "
           f"{w['twin_gap']:.3e})" if "twin_gap" in w else "")
        for name, w in sorted(worst.items()))


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
              plain_per_graph=10, dtype=torch.float32, sweep=None) -> dict:
    """Device time of the kernel, its plain version and the library call
    (None where no single PyTorch call computes the function) on the same
    inputs, the kernel's eager per-call time, its largest difference from
    the plain version over every output, and its bound (``flops`` at the
    peak rate of the operands' ``dtype``).  ``sweep`` = (call, paths,
    plan): also the device time of ``call(path)`` for each of the
    kernel's paths at this shape, ``plan`` the one its plan picks."""
    err = max_err(torch.cat([t.flatten() for t in _outputs(kernel())]),
                  torch.cat([t.flatten() for t in _outputs(plain())]))
    if not err < float("inf"):
        raise AssertionError(f"kernel and plain version differ by {err}")
    row = dict(ms=device_ms(kernel, per_graph=per_graph),
               eager_ms=eager_ms(kernel, iters=4 * per_graph,
                                 warmup=min(per_graph, 20)),
               plain_ms=device_ms(plain, per_graph=plain_per_graph),
               library_ms=(None if library is None
                           else device_ms(library, per_graph=per_graph)),
               max_abs_err=err, **bound(nbytes, flops, dtype))
    if sweep is not None:
        call, paths, plan = sweep
        row["paths"] = {p: device_ms(lambda p=p: call(p), per_graph=per_graph)
                        for p in paths}
        row["plan"] = plan
    return row


def fa_sweep(fa, call, b, s, h, hkv, d, dtype):
    """``time_case``'s sweep of both flash_attention kernels."""
    paths = ["mma"] + (["wgmma"] if d in fa.WGMMA_HEAD_DIMS else [])
    return call, paths, fa.attention_plan(b, s, h, hkv, d, dtype)[0]


def da_sweep(da, call, h, hkv, d, dtype=torch.float32):
    """``time_case``'s sweep of both flash_decode paths."""
    paths = ["cores"] + (["mma"] if d in da.MMA_HEAD_DIMS else [])
    return call, paths, da.decode_path(h // hkv, d, dtype)


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
    call = lambda p=None: da.flash_decode_cuda(q, kc, vc, lens, path=p)
    row = time_case(call, lambda: da.flash_decode_plain(q, kc, vc, lens),
                    lambda: sdpa(qs, ks, vs, attn_mask=keymask),
                    4 * (2 * b * length * D + 2 * b * D + b),
                    4 * b * H * length * DH,
                    sweep=da_sweep(da, call, H, H, DH))
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
    call = lambda p=None: fa.flash_attention_cuda(q, k, v, lens,
                                                  causal=False, path=p)
    row = time_case(
        call, lambda: fa.flash_attention_plain(q, k, v, lens, causal=False),
        lambda: sdpa(qs, ks, vs),
        4 * (4 * b * s * D + b), 4 * b * H * s * s * DH,
        sweep=fa_sweep(fa, call, b, s, H, H, DH, torch.float32))
    row["library_err"] = max_err(
        fa.flash_attention_cuda(q, k, v, lens, causal=False),
        sdpa(qs, ks, vs).permute(0, 2, 1, 3))
    row["shape"] = f"B={b} S=T={s} H={H} dh={DH} non-causal f32"
    return row


def causal_case(fa, gen, b, s, h=ZA_H, hkv=ZA_H, d=DH, model="zamba2-1.2b",
                dtype=torch.float32):
    """flash_attention over one causal prefill call with all keys valid:
    zamba2-1.2b's shared attention (32 heads of 64) or, with ``h``,
    ``hkv``, ``d`` given, qwen3-8b's (32 query heads over 8 KV heads of
    128), in ``dtype``.  The yardstick is SDPA with is_causal (and
    enable_gqa) on the same numbers.  FLOP count the causal half; bytes
    and the peak rate are the dtype's."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(gen, (b, s, h, d), dtype)
    k, v = (randn(gen, (b, s, hkv, d), dtype) for _ in range(2))
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    big = b * s > 1024
    call = lambda p=None: fa.flash_attention_cuda(q, k, v, causal=True,
                                                  path=p)
    row = time_case(
        call, lambda: fa.flash_attention_plain(q, k, v, causal=True),
        lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=h != hkv),
        q.element_size() * 2 * b * s * (h + hkv) * d,
        2 * b * h * s * (s + 1) * d,
        per_graph=5 if big else 50, plain_per_graph=1 if big else 10,
        dtype=dtype, sweep=fa_sweep(fa, call, b, s, h, hkv, d, dtype))
    row["library_err"] = max_err(
        fa.flash_attention_cuda(q, k, v, causal=True),
        sdpa(qs, ks, vs, is_causal=True,
             enable_gqa=h != hkv).permute(0, 2, 1, 3))
    row["shape"] = (f"{model} B={b} S=T={s} H={h} Hkv={hkv} dh={d} causal "
                    f"{_dname(dtype)}")
    return row


def _dname(dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def gqa_decode_case(da, gen, b, h=QW_H, hkv=QW_HKV, model="qwen3-8b",
                    dtype=torch.float32):
    """flash_decode over one layer of a slot-table step: a cache of
    ``QW_T`` slots, ragged lengths, ``h`` query heads over ``hkv`` KV
    heads of 128 (qwen3-8b's 32 over 8 by default), in ``dtype``.  Bytes
    count the valid slots only (the dtype's size; lengths int32); the
    yardstick is SDPA with a key mask and enable_gqa."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(gen, (b, h, QW_D), dtype)
    kc, vc = (randn(gen, (b, QW_T, hkv, QW_D), dtype) for _ in range(2))
    lens = torch.tensor(QW_LENS[:b], dtype=torch.int32, device="cuda")
    valid = sum(QW_LENS[:b])
    qs = q[:, :, None, :]
    ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (kc, vc))
    keymask = (torch.arange(QW_T, device="cuda")[None, :]
               < lens[:, None])[:, None, None, :]
    call = lambda p=None: da.flash_decode_cuda(q, kc, vc, lens, path=p)
    row = time_case(
        call, lambda: da.flash_decode_plain(q, kc, vc, lens),
        lambda: sdpa(qs, ks, vs, attn_mask=keymask, enable_gqa=h != hkv),
        q.element_size() * (2 * valid * hkv * QW_D + 2 * b * h * QW_D)
        + 4 * b, 4 * valid * h * QW_D, dtype=dtype,
        sweep=da_sweep(da, call, h, hkv, QW_D, dtype))
    row["library_err"] = max_err(
        da.flash_decode_cuda(q, kc, vc, lens),
        sdpa(qs, ks, vs, attn_mask=keymask, enable_gqa=h != hkv)[:, :, 0])
    row["shape"] = (f"{model} B={b} H={h} Hkv={hkv} dh={QW_D} "
                    f"T={QW_T} lens={QW_LENS[:b]} {_dname(dtype)}")
    return row


def gqa_decode_stats_case(da, gen, b=8, h=QW_H, hkv=QW_HKV,
                          model="qwen3-8b", dtype=torch.float32):
    """``flash_decode(return_stats=True)`` at a slot-table step (qwen3-8b's
    32 over 8 heads by default), the sequence-sharded decode's call
    (phases 16 and 19): the output in ``dtype`` and each row's (m, l) in
    float32; no single PyTorch call returns the softmax state."""
    q = randn(gen, (b, h, QW_D), dtype)
    kc, vc = (randn(gen, (b, QW_T, hkv, QW_D), dtype) for _ in range(2))
    lens = torch.tensor(QW_LENS[:b], dtype=torch.int32, device="cuda")
    valid = sum(QW_LENS[:b])
    call = lambda p=None: da.flash_decode_cuda(q, kc, vc, lens,
                                               return_stats=True, path=p)
    row = time_case(
        call,
        lambda: da.flash_decode_plain(q, kc, vc, lens, return_stats=True),
        None, q.element_size() * (2 * valid * hkv * QW_D + 2 * b * h * QW_D)
        + 4 * (b + 2 * b * h), 4 * valid * h * QW_D, dtype=dtype,
        sweep=da_sweep(da, call, h, hkv, QW_D, dtype))
    row["shape"] = (f"{model} return_stats B={b} H={h} Hkv={hkv} "
                    f"dh={QW_D} T={QW_T} lens={QW_LENS[:b]} {_dname(dtype)}")
    return row


def whisper_encoder_case(fa, gen, b=WH_B, dtype=torch.float32):
    """flash_attention over one whisper-large-v3 encoder layer: B=4 of
    1500 frames, 20 heads of 64, non-causal, no lengths (the reference's
    encoder attends to every frame), in ``dtype``.  The yardstick is
    SDPA."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (randn(gen, (b, WH_T, WH_H, DH), dtype) for _ in range(3))
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    call = lambda p=None: fa.flash_attention_cuda(q, k, v, causal=False,
                                                  path=p)
    row = time_case(
        call, lambda: fa.flash_attention_plain(q, k, v, causal=False),
        lambda: sdpa(qs, ks, vs),
        q.element_size() * 4 * b * WH_T * WH_H * DH,
        4 * b * WH_H * WH_T * WH_T * DH,
        per_graph=5, plain_per_graph=1, dtype=dtype,
        sweep=fa_sweep(fa, call, b, WH_T, WH_H, WH_H, DH, dtype))
    row["library_err"] = max_err(
        fa.flash_attention_cuda(q, k, v, causal=False),
        sdpa(qs, ks, vs).permute(0, 2, 1, 3))
    row["shape"] = (f"whisper encoder B={b} S=T={WH_T} H={WH_H} dh={DH} "
                    f"non-causal {_dname(dtype)}")
    return row


def whisper_cross_case(fa, da, gen, decode: bool):
    """whisper-large-v3's cross-attention of one decoder layer, B=4 over
    1500 frames of ragged lengths ``WH_LENS``: prefill (16 tokens,
    ``flash_attention``, non-causal) or decode (``flash_decode``).  Bytes
    and FLOP count the valid frames only; the yardstick is SDPA with a
    key mask."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, s = WH_B, 1 if decode else 16
    k, v = (randn(gen, (b, WH_T, WH_H, DH)) for _ in range(2))
    q = randn(gen, (b, s, WH_H, DH))
    lens = torch.tensor(WH_LENS, dtype=torch.int32, device="cuda")
    valid = sum(WH_LENS)
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    keymask = (torch.arange(WH_T, device="cuda")[None, :]
               < lens[:, None])[:, None, None, :]
    if decode:
        q = q[:, 0]
        kernel = lambda p=None: da.flash_decode_cuda(q, k, v, lens, path=p)
        plain = lambda: da.flash_decode_plain(q, k, v, lens)
        ref = lambda: sdpa(qs, ks, vs, attn_mask=keymask)[:, :, 0]
        sweep = da_sweep(da, kernel, WH_H, WH_H, DH)
    else:
        kernel = lambda p=None: fa.flash_attention_cuda(q, k, v, lens,
                                                        causal=False, path=p)
        plain = lambda: fa.flash_attention_plain(q, k, v, lens, causal=False)
        ref = lambda: sdpa(qs, ks, vs, attn_mask=keymask).permute(0, 2, 1, 3)
        sweep = fa_sweep(fa, kernel, b, s, WH_H, WH_H, DH, torch.float32)
    row = time_case(kernel, plain,
                    lambda: sdpa(qs, ks, vs, attn_mask=keymask),
                    4 * (2 * valid * WH_H * DH + 2 * b * s * WH_H * DH + b),
                    4 * s * valid * WH_H * DH, sweep=sweep)
    row["library_err"] = max_err(kernel(), ref())
    row["shape"] = (f"whisper cross {'decode' if decode else 'prefill'} "
                    f"B={b} S={s} T={WH_T} H={WH_H} dh={DH} "
                    f"lens={WH_LENS} f32")
    return row


def window_prefill_case(fa, gen, s=4200, dtype=torch.float32):
    """flash_attention over one qwen3-8b-swa prefill layer past the window:
    B=1, S=T=4200, 32 query heads over 8 KV heads of 128, causal, window
    4096, in ``dtype``.  FLOP count the (query, key) pairs inside the
    window; the yardstick is SDPA with the same boolean mask and
    enable_gqa."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(gen, (1, s, QW_H, QW_D), dtype)
    k, v = (randn(gen, (1, s, QW_HKV, QW_D), dtype) for _ in range(2))
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
    pos = torch.arange(s, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - SWA_W)
    pairs = sum(min(i + 1, SWA_W) for i in range(s))
    kernel = lambda p=None: fa.flash_attention_cuda(q, k, v, causal=True,
                                                    window=SWA_W, path=p)
    row = time_case(
        kernel,
        lambda: fa.flash_attention_plain(q, k, v, causal=True, window=SWA_W),
        lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True),
        q.element_size() * 2 * s * (QW_H + QW_HKV) * QW_D,
        4 * pairs * QW_H * QW_D, per_graph=5, plain_per_graph=1,
        dtype=dtype,
        sweep=fa_sweep(fa, kernel, 1, s, QW_H, QW_HKV, QW_D, dtype))
    row["library_err"] = max_err(kernel(), sdpa(
        qs, ks, vs, attn_mask=mask, enable_gqa=True).permute(0, 2, 1, 3))
    row["shape"] = (f"qwen3-8b-swa B=1 S=T={s} H={QW_H} Hkv={QW_HKV} "
                    f"dh={QW_D} causal window={SWA_W} {_dname(dtype)}")
    return row


def window_decode_case(da, gen, t, length, window):
    """flash_decode over one qwen3-8b-swa decode layer at B=1: the linear
    cache of ``t`` slots under the window (``window`` set) or the full
    ring of 4096 slots (``window`` None, ``length`` = 4096).  Bytes count
    the valid slots only; the yardstick is SDPA with a key mask."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = randn(gen, (1, QW_H, QW_D))
    kc, vc = (randn(gen, (1, t, QW_HKV, QW_D)) for _ in range(2))
    lens = torch.tensor([length], dtype=torch.int32, device="cuda")
    slot = torch.arange(t, device="cuda")[None, :]
    keep = slot < min(length, t)
    if window:
        keep = keep & (slot >= length - window)
    valid = int(keep.sum())
    qs = q[:, :, None, :]
    ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (kc, vc))
    keymask = keep[:, None, None, :]
    kernel = lambda p=None: da.flash_decode_cuda(q, kc, vc, lens,
                                                 window=window, path=p)
    row = time_case(
        kernel, lambda: da.flash_decode_plain(q, kc, vc, lens, window=window),
        lambda: sdpa(qs, ks, vs, attn_mask=keymask, enable_gqa=True),
        4 * (2 * valid * QW_HKV * QW_D + 2 * QW_H * QW_D + 1),
        4 * valid * QW_H * QW_D, sweep=da_sweep(da, kernel, QW_H, QW_HKV,
                                                QW_D))
    row["library_err"] = max_err(kernel(), sdpa(
        qs, ks, vs, attn_mask=keymask, enable_gqa=True)[:, :, 0])
    kind = (f"linear T={t} len={length} window={window}" if window
            else f"ring T={t} len={length}")
    row["shape"] = (f"qwen3-8b-swa B=1 H={QW_H} Hkv={QW_HKV} dh={QW_D} "
                    f"{kind} f32")
    return row


def wkv_case(wkv, gen, b, s, h=WKV_H, p=WKV_P):
    """rwkv6_wkv over one rwkv6-3b prefill layer (``h`` heads of ``p``):
    batch ``b`` of ``s`` tokens from the zero state, at the chunk prefill
    picks (the largest divisor of ``s`` up to 32: 1 for a prime ``s``).
    Bound: r/k/v/log w and y once each, u and the final state; FLOP of
    the kernel's own work (``wkv_flops``)."""
    args = wkv_inputs(gen, b, s, False, h, p)
    chunk = max(d for d in range(1, 33) if s % d == 0)
    nbytes = 4 * (5 * b * s * h * p + h * p + b * h * p * p)
    big = b * s > 1024
    row = time_case(lambda: wkv.rwkv6_wkv_cuda(*args, chunk=chunk),
                    lambda: wkv.rwkv6_wkv_plain(*args, chunk=chunk), None,
                    nbytes, wkv_flops(wkv, b, h, s, p),
                    per_graph=5 if big else 50,
                    plain_per_graph=2 if big else 10)
    row["shape"] = f"B={b} S={s} H={h} P={p} L={chunk} f32"
    return row


def ssd_case(ssd, gen, b, s):
    """ssd_scan over one zamba2-1.2b prefill layer: batch ``b`` of ``s``
    tokens, one B/C group read for all 64 heads, at the chunk prefill
    picks.  Bound: x, dt, the one B/C group, y and the final state once
    each; FLOP at the blocking of the kernel the plan picks
    (``ssd_flops``)."""
    args = ssd_inputs(gen, b, s)
    chunk = max(d for d in range(1, 129) if s % d == 0)
    p, n, h = SSD_P, SSD_N, SSD_H
    path = ssd.ssd_path(p, n, chunk)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                  + b * h * p * n)
    flops = ssd_flops(b, h, s, p, n,
                      ssd.WGMMA_STEPS if path == "wgmma" else chunk)
    big = b * s > 1024
    row = time_case(lambda: ssd.ssd_scan_cuda(*args, chunk=chunk),
                    lambda: ssd.ssd_scan_plain(*args, chunk=chunk), None,
                    nbytes, flops, per_graph=5 if big else 50,
                    plain_per_graph=2 if big else 10,
                    sweep=(lambda path: ssd._launch(*args, chunk, path=path),
                           ssd.ssd_paths(p, n, chunk), path))
    row["shape"] = f"B={b} S={s} H={h} P=N={p} L={chunk} f32"
    return row


def wkv_flops(wkv, b, h, s, p):
    """FLOP of rwkv6_wkv as its kernel runs it, step by step in groups of
    ``CORES_STEPS`` (the last one ragged): per (sequence, head) and step,
    y's product with the state and the state's rank-one update (4 P^2),
    the transform, bonus and its term in y (5 P); per group the state's
    decay (P^2)."""
    groups = -(-s // wkv.CORES_STEPS)
    return b * h * (s * (4 * p * p + 5 * p) + groups * p * p)


def ssd_flops(b, h, s, p, n, steps):
    """FLOP of ssd_scan run in blocks of ``steps`` (the last one ragged):
    per (sequence, head) and block of l steps, the triangular scores
    C B^T and their product with x (l (l + 1) (N + P + 2), with the
    decay weights), the state's two products (4 l N P), the per-step
    scalings (l (N + P)) and the state's decay (N P)."""
    blocks = [steps] * (s // steps) + ([s % steps] if s % steps else [])
    return b * h * sum(l * (l + 1) * (n + p + 2) + 4 * l * n * p
                       + l * (n + p) + n * p for l in blocks)


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
    """The scan kernels' timed cases, each with every path it has: prefill
    at the serving shape, a long prefill and a prime prompt length (chunk
    1: rwkv6-3b at 37 steps, zamba2-1.2b at 257); ``rwkv6_wkv`` also at
    rwkv6-3b's width in heads of 128 (no configuration's head size)."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.kernels import ssd_scan as ssd
    return [("rwkv6_wkv", wkv_case(wkv, gen, 1, 64)),
            ("rwkv6_wkv", wkv_case(wkv, gen, 8, 2048)),
            ("rwkv6_wkv", wkv_case(wkv, gen, 1, 37)),
            ("rwkv6_wkv", wkv_case(wkv, gen, 8, 2048, 20, 128)),
            ("ssd_scan", ssd_case(ssd, gen, 1, 64)),
            ("ssd_scan", ssd_case(ssd, gen, 8, 2048)),
            ("ssd_scan", ssd_case(ssd, gen, 1, 257))]


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
             ("flash_attention", causal_case(fa, gen, 8, 2048)),
             *[("flash_attention", causal_case(fa, gen, 8, 64, h, hkv, QW_D,
                                               model))
               for model, h, hkv in GQA_SHAPES],
             *[("flash_decode", gqa_decode_case(da, gen, 8, h, hkv, model))
               for model, h, hkv in GQA_SHAPES],
             ("flash_decode", gqa_decode_stats_case(da, gen)),
             ("flash_attention", whisper_encoder_case(fa, gen)),
             ("flash_attention", whisper_cross_case(fa, da, gen, False)),
             ("flash_decode", whisper_cross_case(fa, da, gen, True)),
             ("flash_attention", window_prefill_case(fa, gen)),
             ("flash_decode", window_decode_case(da, gen, 4200, 4150, SWA_W)),
             ("flash_decode", window_decode_case(da, gen, SWA_W, SWA_W,
                                                 None)),
             # phase 18's bf16 shapes
             *[("flash_attention", causal_case(fa, gen, 8, 64, h, hkv, QW_D,
                                               model, torch.bfloat16))
               for model, h, hkv in GQA_SHAPES],
             *[("flash_decode", gqa_decode_case(da, gen, 8, h, hkv, model,
                                                torch.bfloat16))
               for model, h, hkv in GQA_SHAPES],
             ("flash_attention", whisper_encoder_case(
                 fa, gen, dtype=torch.bfloat16)),
             # the long prefills in bf16 too (the wgmma kernel's rows)
             ("flash_attention", causal_case(fa, gen, 8, 2048,
                                             dtype=torch.bfloat16)),
             ("flash_attention", window_prefill_case(
                 fa, gen, dtype=torch.bfloat16)),
             # phase 19's bf16 sequence-sharded decode
             *[("flash_decode", gqa_decode_stats_case(
                 da, gen, 8, h, hkv, model, torch.bfloat16))
               for model, h, hkv in GQA_SHAPES[:2]]]
    cases += scan_cases(gen)
    for name, r in cases:
        lib = ("library — (no single PyTorch call computes it)"
               if r["library_ms"] is None else
               f"sdpa {r['library_ms']:.5f}ms (kernel vs sdpa "
               f"{r['library_err']:.2e})")
        by = r["bound_by"] + (
            (f" ({F32_PEAK_NOTE})" if r["shape"].endswith("f32")
             else " (bf16 at 989 TFLOP/s)")
            if r["bound_by"] == "operations" else "")
        sweep = ("" if "paths" not in r else "; paths " + ", ".join(
            f"{p} {ms:.5f}ms" for p, ms in r["paths"].items())
            + f" (plan: {r['plan']})")
        log(f"  {name} {r['shape']}: device {r['ms']:.5f}ms, eager "
            f"{r['eager_ms']:.5f}ms, bound {r['bound_ms']:.5f}ms by {by}, "
            f"plain {r['plain_ms']:.5f}ms, {lib} "
            f"(kernel vs plain {r['max_abs_err']:.2e}){sweep}")
    rows, seen = [], set()
    for name, r in cases:
        if name not in seen:
            seen.add(name)
            rows.append(dict(r, name=name, route="cuda",
                             source=KERNELS[name][0],
                             replaces=KERNELS[name][1]))
    decode_ms = {r["batch"]: r["ms"] for name, r in cases
                 if name == "flash_decode" and "batch" in r}
    return rows, decode_ms


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


def build_lm(name):
    """``name`` at full width on the card, random weights from seed 0."""
    from repro_torch.models.registry import resolve

    t0 = time.perf_counter()
    r = resolve(name, size="full", device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in r.model.parameters())
    log(f"  {r.name}: d_model {r.cfg.d_model}, {r.cfg.num_layers} layer "
        f"slots, vocab {r.cfg.vocab_size}; {n_params / 1e9:.3f}B parameters "
        f"({4 * n_params / 1e9:.2f} GB f32), built in "
        f"{time.perf_counter() - t0:.2f}s")
    return r.model, n_params


def lm_phase(name, ops, needed, continuous=None):
    """Build ``name`` at full width on the card, check it against its
    plain kernels, drive the tiered serving path and time it; then
    ``continuous(model)``, if given, whose launches join the paths."""
    model, _ = build_lm(name)
    check_lm(model, ops)
    paths = {name: lm_main_path(model, ops, needed)}
    lm_rates(model, ops, needed[0])
    if continuous is not None:
        paths[f"{name} continuous"] = continuous(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


class Recorder:
    """A continuous session as the engine drives it, keeping each finished
    row's ``(m_out, tokens)`` (the engine's results carry ``m_out``
    only)."""

    def __init__(self, sess):
        self.sess, self.rows = sess, {}

    def __getattr__(self, name):
        return getattr(self.sess, name)

    def step(self):
        stream, finished = self.sess.step()
        for rid, m, toks in finished:
            self.rows[rid] = (m, toks)
        return stream, finished


def serve_both_modes(sess, ops, prompts, max_new, rate_hz, needed):
    """``CollaborativeEngine.serve_continuous`` over one Poisson schedule,
    block-to-completion (``refill=False``) then continuous, with the
    session as the card's one tier, after a warm-up pass.  Checks that
    every request was served with a finite latency and that the
    ``needed`` kernels launched.  Returns ({refill: (stats, steps, waves,
    peak live, rows)}, launches)."""
    from repro_torch.core.latency_model import (DeviceProfile,
                                                LinearLatencyModel)
    from repro_torch.core.length_regressor import LinearN2M
    from repro_torch.runtime.engine import CollaborativeEngine, Tier

    sess.serve(prompts[:sess.max_slots], max_new=min(max_new, 4))
    arrivals = np.cumsum(np.random.default_rng(11).exponential(
        1 / rate_hz, len(prompts)))
    card = DeviceProfile("card", LinearLatencyModel(0.0, 0.0, 0.01), 0.0)
    runs = {}
    ops.reset_launch_counts()
    for refill in (False, True):
        sess.reset()
        rec = Recorder(sess)
        engine = CollaborativeEngine(
            n2m=LinearN2M(1.0, 0.0),
            tiers=[Tier(card, name="card", servers=1, queue_capacity=256,
                        batch_size=sess.max_slots, continuous_session=rec)],
            seed=0)
        t0 = time.perf_counter()
        results = engine.serve_continuous(prompts, arrival_s=arrivals,
                                          max_new=max_new, refill=refill)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.stats()
        if len(results) != len(prompts) or any(r.shed for r in results) \
                or len(rec.rows) != len(prompts):
            raise AssertionError(f"refill={refill}: not every request was "
                                 "served")
        for r in results:
            if not (np.isfinite(r.latency_s) and r.latency_s > 0
                    and r.m_out == rec.rows[r.req_id][0]):
                raise AssertionError(f"bad result {r}")
        mode = "continuous (refill=True)" if refill else \
            "block-to-completion"
        log(f"  {mode}: p50={s['p50_latency_s'] * 1e3:.1f}ms "
            f"p95={s['p95_latency_s'] * 1e3:.1f}ms mean="
            f"{s['mean_latency_s'] * 1e3:.1f}ms steps={sess.n_steps} "
            f"prefill waves={sess.n_prefills} peak live={sess.peak_live} "
            f"wall {wall:.2f}s ({len(prompts)} requests, arrivals over "
            f"{arrivals[-1]:.2f}s)")
        runs[refill] = (s, sess.n_steps, sess.n_prefills, sess.peak_live,
                        rec.rows)
    launches = ops.launch_counts()
    log(f"  kernel launches over both runs: {launches}")
    for name in needed:
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched in serve_continuous")
    return runs, launches


def check_against_solo(model, prompts, runs, max_new, max_len):
    """Each row of each run against the same model's solo
    ``generate_with_lengths``: tokens equal up to the first whose top-2
    logit margin (``greedy_margins``) is under 1e-4, and ``m`` equal when
    there is none; a mismatch above that margin fails."""
    from repro_torch.runtime.serving import GenerationSession, greedy_margins

    sess = GenerationSession(model, max_len=max_len)
    compared = ties = 0
    low = float("inf")
    for i, p in enumerate(prompts):
        lens, out = sess.generate_with_lengths(p[None], max_new=max_new)
        m, ref = int(lens[0]), out[0]
        margins = greedy_margins(model, p, ref[:min(m + 1, max_new)])
        tie = np.flatnonzero(margins < MARGIN)
        k = int(tie[0]) if len(tie) else len(margins)
        low, ties, compared = min(low, float(margins.min())), \
            ties + bool(len(tie)), compared + k
        for refill, (*_, rows) in runs.items():
            m2, toks = rows[i]
            if not np.array_equal(toks[:k], ref[:k]) or (
                    not len(tie) and (m2 != m or len(toks) != k)):
                raise AssertionError(
                    f"request {i} (refill={refill}): ({m2}, {toks.tolist()})"
                    f" != solo ({m}, {ref.tolist()}); margins "
                    f"{np.round(margins, 6).tolist()}")
    log(f"  every row == solo generate_with_lengths in both modes: "
        f"{compared} tokens compared per mode, {ties} of {len(prompts)} "
        f"rows stop at a top-2 margin under {MARGIN:g}; smallest margin "
        f"{low:.3e}")


def zamba2_continuous(model, ops):
    """Phase 8's slot table: 8 prompts of three lengths, so the recurrent
    plan admits exact-width waves through ``ssd_scan``."""
    from repro_torch.runtime.serving import ContinuousGenerationSession

    rng = np.random.default_rng(12)
    prompts = [rng.integers(4, model.cfg.vocab_size, n).astype(np.int32)
               for n in (3, 17, 40, 3, 17, 40, 17, 3)]
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=64)
    runs, launches = serve_both_modes(
        sess, ops, prompts, 8, 50.0,
        ("ssd_scan", "flash_attention", "flash_decode"))
    check_against_solo(model, prompts, runs, 8, 64)
    return launches


def profiled_busy_ms(fn):
    """Device kernel time and kernel count of one ``fn()`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "cuda" in str(e.device_type).lower()]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in events) / 1e3
    return busy, sum(e.count for e in events)


def qwen3_phase(ops):
    """qwen3-8b at full width: kernels vs plain, the tiered path, then
    continuous in-flight batching through the engine, held against solo
    generation, and the slot table's step and wave times."""
    from repro_torch.runtime.serving import ContinuousGenerationSession

    torch.cuda.reset_peak_memory_stats()
    model, n_params = build_lm("qwen3-8b")
    log(f"  allocated after the build "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check_lm(model, ops)
    check_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    paths = {"qwen3-8b": lm_main_path(model, ops, ("flash_attention",
                                                   "flash_decode"))}

    rng = np.random.default_rng(13)
    prompts = [rng.integers(4, model.cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 101, 32)]
    sess = ContinuousGenerationSession(model, max_slots=8, max_len=QW_T)
    runs, paths["qwen3-8b continuous"] = serve_both_modes(
        sess, ops, prompts, 32, QW_RATE_HZ, ("flash_attention",
                                             "flash_decode"))
    waves = -(-len(prompts) // sess.max_slots)
    if not (runs[True][2] > waves and runs[True][3] == sess.max_slots):
        raise AssertionError(
            f"refill=True ran {runs[True][2]} prefill waves (need more than "
            f"{waves}) at peak {runs[True][3]} live (need {sess.max_slots})")
    check_against_solo(model, prompts, runs, 32, QW_T)

    # a full table: 8 live slots mid-decode, one step each call
    sess.reset()
    sess.admit([p[:16] for p in prompts[:8]], max_new=QW_T - 32)
    for _ in range(3):
        sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        sess.step()
    step_ms = (time.perf_counter() - t0) / 20 * 1e3
    busy, kernels = profiled_busy_ms(lambda: [sess.step() for _ in range(5)])
    n_ops = aten_ops(sess.step)
    with torch.inference_mode():
        tok = sess._tok[:, None].clone()
        graph_ms = device_ms(lambda: model.decode_step(sess._state, tok),
                             per_graph=10, replays=3)
    weights_ms = 4 * n_params / HBM_BYTES_S * 1e3
    block = torch.as_tensor(np.stack([p[:5].repeat(13)[:64]
                                      for p in prompts[:8]]),
                            device=model.device)
    with torch.inference_mode():
        wave_ms = wall_ms(lambda: model.prefill(block, max_len=QW_T))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  slot-table step at 8 live slots: {step_ms:.2f}ms eager = "
        f"{8 / step_ms * 1e3:.1f} decode tokens/s; bound {weights_ms:.2f}ms "
        f"(the {4 * n_params / 1e9:.2f} GB of float32 weights at 3.35 TB/s); "
        f"{n_ops} ATen operators; profiled: {kernels / 5:.0f} device kernels "
        f"and "
        f"{busy / 5:.2f}ms device time per step = device busy "
        f"{100 * busy / 5 / step_ms:.1f}% of the step; the model's decode "
        f"step from a CUDA graph {graph_ms:.2f}ms")
    log(f"  admission wave prefill B=8 S=64 (max_len {QW_T}): {wave_ms:.2f}ms"
        f" = {8 * 64 / wave_ms * 1e3:.0f} tokens/s, "
        f"{2 * n_params * 8 * 64 / wave_ms / 1e9:.1f} TFLOP/s of weight "
        f"GEMMs; peak memory while serving {peak:.2f} GiB (while checking "
        f"against the plain kernels, with a 2-layer copy: "
        f"{check_peak:.2f} GiB)")
    del model, sess
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------- phase 14 --
# phase 14's depth cuts: every width is the configuration's own; the depth
# is what fits one 80 GB card in float32 (phase 18 serves them whole in bf16)
MOE_CUTS = {
    # 24 of 48 MoE layers: 15.6 B parameters, 62 GB
    "qwen3-moe-30b-a3b": dict(counts=(24,)),
    # the dense first layer and 3 of 47 MoE layers: 2.5 B parameters
    "moonshot-v1-16b-a3b": dict(counts=(1, 3)),
    # the 3 dense MLA layers and 1 of 58 MoE layers, no MTP block (training
    # only; a second 11.5 B MoE layer): 15.1 B parameters, 60 GB
    "deepseek-v3-671b": dict(counts=(3, 1), mtp_depth=0),
}


def empty_cache() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def cut_config(name, counts, **fields):
    """``name``'s configuration at its full width, its groups cut to
    ``counts`` layers (and ``fields`` replaced)."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    plan = tuple(dataclasses.replace(g, count=n)
                 for g, n in zip(cfg.layer_plan, counts))
    return dataclasses.replace(cfg, layer_plan=plan, **fields).validate()


def build_cut(cfg, seed=0):
    """The LM of ``cfg`` on the card, random weights drawn there from
    ``seed`` (a CPU copy of a 60 GB cut could not be made)."""
    from repro_torch.models.model import LM

    t0 = time.perf_counter()
    model = LM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name} cut to {[g.count for g in cfg.layer_plan]} layers of "
        f"{[g.mixer + '/' + g.ffn for g in cfg.layer_plan]}: d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}; {n / 1e9:.3f}B parameters "
        f"({4 * n / 1e9:.2f} GB f32), built in "
        f"{time.perf_counter() - t0:.2f}s")
    return model, n


@contextlib.contextmanager
def drop_free(model):
    """The model with ``capacity_factor = E / top_k`` while active (the
    reference's smoke rule: capacity >= group size, nothing dropped, so a
    row's output does not depend on the other rows of its batch); the
    weights are the model's own."""
    cfg = model.cfg
    mo = cfg.moe
    model.cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    try:
        yield model
    finally:
        model.cfg = cfg


def floor_and_err(fn, model, want):
    """(the effect of a 1e-7 perturbation of the embeddings on ``fn()``,
    ``fn()``'s difference from ``want``): the float32 noise floor of this
    random-weight stack beside an error."""
    got = fn()
    hook = perturbed(model, 1e-7)
    floor = max_err(fn(), got)
    hook.remove()
    return floor, max_err(got, want)


def check_moe_model(model, ops, what):
    """On ``model`` (a shallow copy of an MoE / MLA model): the kernel path
    against the plain versions (prefill + four decode-step logits at two
    prompt lengths), then, with the model made drop-free, decode against
    the teacher-forced forward and the slot table (both modes) against
    solo generation.  Each logit limit is ten times the
    1e-7-perturbation floor; tokens follow ``check_against_solo``."""
    from repro_torch.runtime.serving import ContinuousGenerationSession

    rng = np.random.default_rng(21)
    vocab = model.cfg.vocab_size
    for s in (37, 64):
        toks = torch.as_tensor(rng.integers(4, vocab, (2, s)),
                               dtype=torch.int32, device="cuda")
        ops.reset_launch_counts()
        got = lm_logits(model, toks)
        launches = ops.launch_counts()
        with plain_kernels(ops):
            floor, err = floor_and_err(lambda: lm_logits(model, toks), model,
                                       got)
        log(f"  {what} B=2 S={s}: prefill + 4 decode-step logits, kernels "
            f"(launches {launches}) vs plain max_abs_err={err:.3e}; the "
            f"1e-7 perturbation {floor:.3e}")
        if not (err <= 10 * floor and torch.isfinite(got).all()):
            raise AssertionError(f"{what}: kernels vs plain {err} > "
                                 f"10 x {floor}")
    with drop_free(model):
        toks = torch.as_tensor(rng.integers(4, vocab, (2, 32)),
                               dtype=torch.int32, device="cuda")

        def decoded():
            with torch.inference_mode():
                _, state = model.prefill(toks[:, :28], max_len=32)
                return torch.stack([model.decode_step(
                    state, toks[:, t:t + 1])[0] for t in range(28, 32)])

        with torch.no_grad():
            full = model.train_logits(toks)["logits"][:, 28:].transpose(0, 1)
        floor, err = floor_and_err(decoded, model, full)
        log(f"  {what} drop-free: 4 decode steps vs the teacher-forced "
            f"forward max_abs_err={err:.3e}; the 1e-7 perturbation "
            f"{floor:.3e}")
        if not err <= 10 * floor:
            raise AssertionError(f"{what}: decode vs teacher-forced {err} > "
                                 f"10 x {floor}")
        prompts = [rng.integers(4, vocab, int(n)).astype(np.int32)
                   for n in rng.integers(3, 30, 12)]
        sess = ContinuousGenerationSession(model, max_slots=8, max_len=64)
        runs = {refill: (dict(enumerate(sess.serve(prompts, max_new=8,
                                                   refill=refill))),)
                for refill in (False, True)}
        check_against_solo(model, prompts, runs, 8, 64)


def dropped_shares(model, toks):
    """The share of routed assignments that capacity drops in one prefill
    of ``toks`` (one group per row) and in the decode step after it (the
    whole batch one group), over every MoE layer."""
    from repro_torch.models.layers import moe as moe_lib

    shares = {True: [], False: []}
    real = moe_lib.moe_ffn

    def counting(p, cfg, x):
        shares[x.shape[1] == 1].append(moe_lib.dropped_share(p, cfg, x))
        return real(p, cfg, x)

    moe_lib.moe_ffn = counting
    try:
        with torch.inference_mode():
            logits, state = model.prefill(toks, max_len=toks.shape[1] + 1)
            model.decode_step(state, torch.argmax(logits, -1).to(
                torch.int32)[:, None])
    finally:
        moe_lib.moe_ffn = real
    return float(np.mean(shares[False])), float(np.mean(shares[True]))


def slot_table_numbers(model, n_params, prompts, what):
    """An eager slot-table step at 8 live slots, the device's busy share of
    it (profiler), a B=8 S=64 admission wave, beside the step's bound: ALL
    weights read once at 3.35 TB/s.  The MoE dispatch multiplies the whole
    (E, C, D) buffer, so every expert's weights are read at every step,
    even at capacity 1."""
    from repro_torch.runtime.serving import ContinuousGenerationSession

    sess = ContinuousGenerationSession(model, max_slots=8, max_len=QW_T)
    sess.admit([p[:16] for p in prompts[:8]], max_new=QW_T - 32)
    for _ in range(3):
        sess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        sess.step()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    busy, kernels = profiled_busy_ms(lambda: [sess.step() for _ in range(3)])
    bound_ms = 4 * n_params / HBM_BYTES_S * 1e3
    block = torch.as_tensor(np.stack([np.resize(p, 64) for p in prompts[:8]]),
                            device="cuda")
    with torch.inference_mode():
        wave_ms = wall_ms(lambda: model.prefill(block, max_len=QW_T))
    log(f"  {what} slot-table step at 8 live slots: {step_ms:.2f}ms eager = "
        f"{8 / step_ms * 1e3:.1f} decode tokens/s; bound {bound_ms:.2f}ms "
        f"(all {4 * n_params / 1e9:.2f} GB of float32 weights at 3.35 TB/s: "
        f"the dispatch multiplies the whole (E, C, D) buffer, so every "
        f"expert's weights are read each step, even at capacity 1; not the "
        f"active experts' share); profiled: {kernels / 3:.0f} device kernels "
        f"and {busy / 3:.2f}ms device time per step = device busy "
        f"{100 * busy / 3 / step_ms:.1f}% of the step")
    log(f"  {what} admission wave prefill B=8 S=64 (max_len {QW_T}): "
        f"{wave_ms:.2f}ms = {8 * 64 / wave_ms * 1e3:.0f} tokens/s")


def checked_copy(name, counts, ops):
    """Build a shallow copy of ``name`` (full width, ``counts`` layers,
    seed 1), run :func:`check_moe_model` on it and free it."""
    shallow, _ = build_cut(cut_config(name, counts), seed=1)
    check_moe_model(shallow, ops, f"{name} ({shallow.cfg.num_layers} "
                    "layers)")
    del shallow
    empty_cache()


def qwen3_moe_phase(ops, rng):
    """qwen3-moe-30b-a3b: GQA with a group of 8, 128 experts top-8."""
    from repro_torch.runtime.serving import ContinuousGenerationSession

    name, attn = "qwen3-moe-30b-a3b", ("flash_attention", "flash_decode")
    checked_copy(name, (2,), ops)
    torch.cuda.reset_peak_memory_stats()
    model, n_params = build_cut(cut_config(name, **MOE_CUTS[name]))
    paths = {name: lm_main_path(model, ops, attn)}
    toks = torch.as_tensor(rng.integers(4, model.cfg.vocab_size, (8, 64)),
                           dtype=torch.int32, device="cuda")
    pre, dec = dropped_shares(model, toks)
    log(f"  {name} at capacity_factor 1.25: {100 * pre:.2f}% of routed "
        f"assignments dropped in a B=8 S=64 prefill (8 groups of 64 tokens, "
        f"capacity 5) and {100 * dec:.2f}% in the B=8 decode step after it "
        f"(one group of 8, capacity 1)")
    prompts = [rng.integers(4, model.cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(5, 61, 16)]
    sess = ContinuousGenerationSession(model, max_slots=8, max_len=128)
    runs, paths[f"{name} continuous"] = serve_both_modes(
        sess, ops, prompts, 16, 20.0, attn)
    waves = -(-len(prompts) // sess.max_slots)
    if not (runs[True][2] > waves and runs[True][3] == sess.max_slots):
        raise AssertionError(
            f"refill=True ran {runs[True][2]} prefill waves (need more than "
            f"{waves}) at peak {runs[True][3]} live (need {sess.max_slots})")
    log("  (rows are not held against solo generation at capacity factor "
        "1.25: the decode group couples the rows; the drop-free copy above "
        "is)")
    del sess, runs
    slot_table_numbers(model, n_params, prompts, name)
    log(f"  {name}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model
    empty_cache()
    return paths


def deepseek_v3_phase(ops, rng):
    """deepseek-v3-671b: MLA, 256 experts top-8 and a shared expert;
    neither MLA nor the MoE runs a kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import costs
    from repro_torch.runtime.serving import GenerationSession

    name = "deepseek-v3-671b"
    torch.cuda.reset_peak_memory_stats()
    model, n_params = build_cut(cut_config(name, **MOE_CUTS[name]))
    check_moe_model(model, ops, f"{name} ({model.cfg.num_layers} layers)")
    sess = GenerationSession(model, max_len=64)
    prompts = rng.integers(4, model.cfg.vocab_size, (4, 24)).astype(np.int32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lens, out = sess.generate_with_lengths(prompts, max_new=16)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    if not (out.shape == (4, 16) and (lens >= 0).all()
            and (out < model.cfg.vocab_size).all()):
        raise AssertionError(f"{name}: bad generation {lens} {out.shape}")
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits, state = model.prefill(toks, max_len=64)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        step_ms = wall_ms(lambda: model.decode_step(state, tok))
        prefill_ms = wall_ms(lambda: model.prefill(toks, max_len=64))
    full = get_config(name)
    gqa = dataclasses.replace(full, mla=None, layer_plan=tuple(
        dataclasses.replace(g, mixer="attn") for g in full.layer_plan))
    log(f"  {name} GenerationSession: 4 prompts of 24 tokens, 16 new tokens "
        f"each in {wall:.2f}s (kernel launches {launches}); prefill B=4 "
        f"S=24 {prefill_ms:.2f}ms; a decode step at B=4 {step_ms:.2f}ms "
        f"(bound {4 * n_params / HBM_BYTES_S * 1e3:.2f}ms: all weights "
        f"once); MLA cache {costs.kv_bytes_per_token(model.cfg, 4):.0f} B per "
        f"token at this depth, {costs.kv_bytes_per_token(full, 4) / 1e3:.1f} "
        f"kB at all 61 layers vs "
        f"{costs.kv_bytes_per_token(gqa, 4) / 1e6:.2f} MB for a GQA cache of "
        f"the same 128 heads of 128 (float32, costs.kv_bytes_per_token); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    toks = torch.as_tensor(rng.integers(4, model.cfg.vocab_size, (8, 64)),
                           dtype=torch.int32, device="cuda")
    pre, dec = dropped_shares(model, toks)
    log(f"  {name} at capacity_factor 1.25: {100 * pre:.2f}% of routed "
        f"assignments dropped in a B=8 S=64 prefill and {100 * dec:.2f}% in "
        f"the B=8 decode step after it")
    del model, sess, state, logits
    empty_cache()


def moe_phase(ops):
    """qwen3-moe-30b-a3b, moonshot-v1-16b-a3b and deepseek-v3-671b at full
    width, cut in depth (``MOE_CUTS``), each freed before the next; the
    checks run on shallow copies built first (deepseek-v3's on its cut,
    whose one MoE layer alone is 46 GB)."""
    empty_cache()
    rng = np.random.default_rng(14)
    paths = qwen3_moe_phase(ops, rng)
    name = "moonshot-v1-16b-a3b"
    checked_copy(name, (1, 1), ops)
    model, _ = build_cut(cut_config(name, **MOE_CUTS[name]))
    paths[name] = lm_main_path(model, ops, ("flash_attention",
                                            "flash_decode"))
    del model
    empty_cache()
    deepseek_v3_phase(ops, rng)
    return paths


def mtp_training(ops, steps=8):
    """deepseek-v3-671b's train step at smoke size on the card: MLA, MoE
    (the load-balance term) and the MTP loss; ``mtp_ce`` and ``aux``
    finite, the loss falls, no kernel launched."""
    from repro_torch.models.registry import resolve
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    r = resolve("deepseek-v3-671b", size="smoke", device="cuda", seed=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, r.cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    state = init_train_state(r.model)
    step = make_train_step(r.model)
    ops.reset_launch_counts()
    mets = []
    for _ in range(steps):
        state, m = step(state, batch)
        mets.append({k: float(m[k]) for k in ("loss", "ce", "aux", "mtp_ce")})
    launches = ops.launch_counts()
    log(f"  deepseek-v3-671b (smoke: {r.cfg.num_layers} layers, d_model "
        f"{r.cfg.d_model}, MTP depth {r.cfg.mtp_depth}), {steps} train steps "
        f"at B=2 S=32, first and last: " + "; ".join(
            f"loss {m['loss']:.4f} ce {m['ce']:.4f} aux {m['aux']:.4f} "
            f"mtp_ce {m['mtp_ce']:.4f}" for m in (mets[0], mets[-1]))
        + f"; kernel launches {launches}")
    if not all(np.isfinite(list(m.values())).all() for m in mets):
        raise AssertionError(f"deepseek-v3-671b: non-finite metrics {mets}")
    if not mets[-1]["loss"] < mets[0]["loss"]:
        raise AssertionError("deepseek-v3-671b: the loss did not fall")
    if any(launches.values()):
        raise AssertionError("deepseek-v3-671b: a kernel launched while "
                             "training")
    del r, state, step
    empty_cache()


# --------------------------------------------------------------- phase 15 --
def noisy(x, rel: float, seed: int = 5):
    """``x`` scaled by (1 + rel * N(0, 1)): a perturbation of float32 inputs
    that are not embeddings (whisper's frames)."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return x * (1 + rel * torch.randn(x.shape, generator=gen,
                                      device=x.device))


def whisper_logits(model, toks, frames, mask):
    """Prefill logits (the encoder included) into phase 15's ``max_len =
    448`` state, then the logits of four decode steps on fixed tokens."""
    with torch.inference_mode():
        logits, state = model.prefill(toks, frames=frames, frame_mask=mask,
                                      max_len=WH_MAX_LEN)
        out = [logits]
        for tok in (5, 17, 42, 99):
            logits, state = model.decode_step(state, torch.full(
                (toks.shape[0], 1), tok, dtype=torch.int32,
                device=toks.device))
            out.append(logits)
        return torch.stack(out)


def whisper_floor(fn, model, frames, want):
    """The effect on ``fn(frames)`` of a 1e-7 perturbation of both float32
    inputs, the token embeddings and the frames: the copy's noise floor."""
    hook = perturbed(model, 1e-7)
    try:
        return max_err(fn(noisy(frames, 1e-7)), want)
    finally:
        hook.remove()


def check_whisper_copy(ops):
    """whisper-large-v3 at full width cut to 2 encoder + 2 decoder layers
    (seed 1), at the generate path's B=4 and ``max_len = 448``: prefill +
    four decode-step logits on the kernels against the plain versions,
    then four decode steps against the teacher-forced forward
    (``train_logits``, plain ops), both on 1500 frames, two rows whole
    and two under a prefix mask; each within ten times the effect of a
    1e-7 perturbation of the embeddings and the frames."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-large-v3")
    cut = dataclasses.replace(
        cfg, layer_plan=(dataclasses.replace(cfg.layer_plan[0], count=2),),
        encoder=dataclasses.replace(cfg.encoder, num_layers=2))
    model, _ = build_cut(cut, seed=1)
    rng = np.random.default_rng(31)
    frames = torch.as_tensor(rng.standard_normal((WH_B, WH_T, cfg.d_model)),
                             dtype=torch.float32, device="cuda")
    mask = torch.ones((WH_B, WH_T), device="cuda")
    mask[1, 1100:] = 0.0
    mask[3, 700:] = 0.0
    toks = torch.as_tensor(rng.integers(4, cfg.vocab_size, (WH_B, 16)),
                           dtype=torch.int32, device="cuda")
    what = "whisper-large-v3 (2+2 layers)"
    got = whisper_logits(model, toks[:, :12], frames, mask)
    with plain_kernels(ops):
        want = whisper_logits(model, toks[:, :12], frames, mask)
        floor = whisper_floor(
            lambda fr: whisper_logits(model, toks[:, :12], fr, mask), model,
            frames, want)
    err = max_err(got, want)
    log(f"  {what} B={WH_B} S=12 T={WH_T} max_len={WH_MAX_LEN}: prefill + "
        f"4 decode-step logits, "
        f"kernels vs plain max_abs_err={err:.3e}; the 1e-7 perturbation "
        f"{floor:.3e} (max |ref| over the real vocabulary "
        f"{float(want[..., :cfg.vocab_size].abs().max()):.3f})")
    if not (err <= 10 * floor and torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernels vs plain {err} > 10 x {floor}")

    def decoded(fr):
        with torch.inference_mode():
            _, state = model.prefill(toks[:, :12], frames=fr,
                                     frame_mask=mask, max_len=WH_MAX_LEN)
            return torch.stack([model.decode_step(
                state, toks[:, t:t + 1])[0] for t in range(12, 16)])

    with torch.no_grad():
        full = model.train_logits(toks, frames=frames, frame_mask=mask)[
            "logits"][:, 12:].transpose(0, 1)
    got = decoded(frames)
    err, floor = max_err(got, full), whisper_floor(decoded, model, frames,
                                                   got)
    log(f"  {what}: 4 decode steps vs the teacher-forced forward "
        f"max_abs_err={err:.3e}; the 1e-7 perturbation {floor:.3e}")
    if not err <= 10 * floor:
        raise AssertionError(f"{what}: decode vs teacher-forced {err} > "
                             f"10 x {floor}")
    del model
    empty_cache()


def whisper_phase(ops):
    """whisper-large-v3 at full width and depth (32 + 32 layers): checks on
    a 2+2-layer copy, then ``GenerationSession(max_len=448).generate(
    frames=)`` on B=4 of 1500 frames (numpy, seed 15) for prompts of 4 and
    of 16 tokens, 32 new tokens each; encoder, prefill and decode-step
    times beside their bounds, launches per step, peak memory."""
    from repro_torch.runtime.serving import GenerationSession

    check_whisper_copy(ops)
    torch.cuda.reset_peak_memory_stats()
    model, n_params = build_lm("whisper-large-v3")
    cfg = model.cfg
    n_enc = sum(p.numel() for p in model.encoder.parameters())
    n_dec = n_params - n_enc - model.embed.w.numel()  # decode reads a row
    log(f"  encoder {n_enc / 1e9:.3f}B parameters, decoder layers + head "
        f"{n_dec / 1e9:.3f}B")
    frames = torch.as_tensor(np.random.default_rng(15).standard_normal(
        (WH_B, WH_T, cfg.d_model)), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(16)
    prompts = {s: rng.integers(4, cfg.vocab_size, (WH_B, s)).astype(np.int32)
               for s in (4, 16)}
    sess = GenerationSession(model, max_len=WH_MAX_LEN)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for s, toks in prompts.items():
        lens, out = sess.generate_with_lengths(toks, max_new=WH_NEW,
                                               frames=frames)
        if not (out.shape == (WH_B, WH_NEW) and ((lens >= 0)
                                                 & (lens <= WH_NEW)).all()
                and (out < cfg.vocab_size).all() and (out >= 0).all()):
            raise AssertionError(f"whisper: bad generation {lens} "
                                 f"{out.shape}")
        log(f"  generate B={WH_B} prompt {s} tokens, 1500 frames, max_new="
            f"{WH_NEW}: lengths {lens.tolist()}, row 0 {out[0, :8].tolist()}"
            "...")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"  main path wall {wall:.2f}s, kernel launches {launches}")
    for name in ("flash_attention", "flash_decode"):
        if launches[name] == 0:
            raise AssertionError(f"whisper never launched {name}")
    toks = torch.as_tensor(prompts[16], device="cuda")
    with torch.inference_mode():
        enc_ms = wall_ms(lambda: model.encode(frames))
        pre_ms = wall_ms(lambda: model.prefill(toks, frames=frames,
                                               max_len=WH_MAX_LEN))
        logits, state = model.prefill(toks, frames=frames,
                                      max_len=WH_MAX_LEN)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        ops.reset_launch_counts()
        model.decode_step(state, tok)
        per_step = ops.launch_counts()
        for _ in range(3):
            model.decode_step(state, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            model.decode_step(state, tok)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 20 * 1e3
        busy, kernels = profiled_busy_ms(
            lambda: [model.decode_step(state, tok) for _ in range(5)])
    cross = 2 * WH_B * cfg.num_layers * WH_T * cfg.num_kv_heads \
        * cfg.head_dim * 4
    bound_ms = (4 * n_dec + cross) / HBM_BYTES_S * 1e3
    enc_flop = 2 * n_enc * WH_B * WH_T + cfg.encoder.num_layers * 4 * WH_B \
        * WH_H * WH_T * WH_T * DH
    log(f"  encoder B={WH_B} T={WH_T}: {enc_ms:.2f}ms = "
        f"{enc_flop / enc_ms / 1e9:.1f} TFLOP/s of its {enc_flop / 1e12:.2f} "
        f"TFLOP (weights GEMMs + attention); prefill of {toks.shape[1]} "
        f"tokens with the encoder {pre_ms:.2f}ms")
    log(f"  eager decode step B={WH_B} (pos ~{toks.shape[1] + 24}): "
        f"{step_ms:.2f}ms against a bound of {bound_ms:.2f}ms (decoder and "
        f"head weights {4 * n_dec / 1e9:.2f} GB + cross caches "
        f"{cross / 1e9:.2f} GB at 3.35 TB/s); launches per step {per_step}; "
        f"profiled: {kernels / 5:.0f} device kernels and {busy / 5:.2f}ms "
        f"device time per step = device busy {100 * busy / 5 / step_ms:.1f}%"
        f" of the step; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, sess, state
    empty_cache()
    return {"whisper-large-v3": launches}


def float64_attention(q, k, v, window):
    """Causal attention in float64 under an optional window."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).double()
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k.double()) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    w = torch.softmax(scores.masked_fill(~keep, -1e300), -1)
    return torch.einsum("bgrst,btgd->bsgrd", w, v.double()).reshape(
        b, s, h, d)


def attention_vs_float64(model, toks):
    """Each layer's own windowed prefill attention (``toks`` of 4200, the
    window 4096) on the kernel and on the plain version, each against a
    float64 reference: a kernel whose float32 sums lose more than the
    plain version's, growing with the keys (F4), shows here.  Returns the
    worst layer's (kernel, plain) errors."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import attention as att
    from repro_torch.models.layers.basic import rmsnorm

    cfg = model.cfg
    worst = (0.0, 0.0)
    with torch.inference_mode():
        x = model.embed(toks)
        pos = torch.arange(toks.shape[1], device="cuda")[None]
        for p in model.groups[0]:
            q, k, v = att._qkv(p.mixer, cfg, rmsnorm(p.ln1.g, x, cfg.norm_eps),
                               pos)
            ref = float64_attention(q, k, v, SWA_W)
            errs = tuple(float((f(q, k, v, causal=True, window=SWA_W).double()
                                - ref).abs().max())
                         for f in (fa.flash_attention_cuda,
                                   fa.flash_attention_plain))
            worst = max(worst, errs)
            del ref
            x, _, _ = model._block_full(p, cfg.layer_plan[0], x, kernels=True,
                                        window=SWA_W)
    return worst


def swa_phase(ops):
    """The long_500k variants at full width: qwen3-8b-swa cut to
    ``SWA_CUT`` of 36 layers, a 4090-token prefill into a 4096-slot state
    (a ring) stepped 10 tokens past position 4096, held against a linear
    cache of 4200 slots under the window and against the same ring on the
    plain kernels, a windowed 4200-token prefill on the kernels against
    the plain versions, and each layer's attention against float64;
    then zamba2-1.2b-swa at full depth, one windowed 4200-token prefill,
    kernels against plain.  Each within ten times the effect of a 1e-7
    perturbation of the embeddings."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import resolve

    paths = {}
    full = get_config("qwen3-8b", shape="long_500k")
    cfg = dataclasses.replace(full, layer_plan=(dataclasses.replace(
        full.layer_plan[0], count=SWA_CUT),))
    model, _ = build_cut(cfg)
    rng = np.random.default_rng(17)
    toks = torch.as_tensor(rng.integers(4, cfg.vocab_size, (1, 4200)),
                           dtype=torch.int32, device="cuda")
    s0 = 4090

    def decoded(max_len):
        with torch.inference_mode():
            logits, state = model.prefill(toks[:, :s0], max_len=max_len)
            out = [logits]
            for t in range(s0, s0 + 10):             # past position 4096
                out.append(model.decode_step(state, toks[:, t:t + 1])[0])
            return torch.stack(out), state

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ring, state = decoded(SWA_W)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["qwen3-8b-swa"] = ops.launch_counts()
    slots = state["caches"][0]["k"].shape[2]
    if slots != SWA_W or int(state["pos"][0]) != s0 + 10:
        raise AssertionError(f"not a ring: {slots} slots, pos "
                             f"{int(state['pos'][0])}")
    linear, lstate = decoded(4200)
    if lstate["caches"][0]["k"].shape[2] != 4200:
        raise AssertionError("the linear state is not 4200 slots")
    floor, err = floor_and_err(lambda: decoded(SWA_W)[0], model, linear)
    with plain_kernels(ops):
        plain_err = max_err(ring, decoded(SWA_W)[0])
    log(f"  qwen3-8b-swa ({SWA_CUT} layers) ring of {SWA_W} slots, prefill "
        f"{s0} + 10 decode steps to position {s0 + 10} (wall {wall:.2f}s, "
        f"launches {paths['qwen3-8b-swa']}): vs a linear cache of 4200 "
        f"slots under the window max_abs_err={err:.3e}, vs the same ring "
        f"on the plain kernels {plain_err:.3e}; the 1e-7 perturbation "
        f"{floor:.3e}")
    if not (err <= 10 * floor and plain_err <= 10 * floor
            and torch.isfinite(ring).all()):
        raise AssertionError(f"ring vs linear {err}, vs plain {plain_err}: "
                             f"> 10 x {floor}")
    with torch.inference_mode():
        tok = toks[:, -1:].clone()
        for _ in range(3):
            model.decode_step(state, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            model.decode_step(state, tok)
        torch.cuda.synchronize()
        ring_ms = (time.perf_counter() - t0) / 20 * 1e3
    del state, lstate
    prefill = lambda: model.prefill(toks, max_len=4200)[0]
    with torch.inference_mode():
        got = prefill()
        pre_ms = wall_ms(prefill)
    with plain_kernels(ops):
        floor, err = floor_and_err(prefill, model, got)
    log(f"  qwen3-8b-swa windowed prefill S=4200 > {SWA_W}: {pre_ms:.2f}ms; "
        f"kernels vs plain max_abs_err={err:.3e}, the 1e-7 perturbation "
        f"{floor:.3e}; a ring decode step (B=1, {SWA_CUT} layers) "
        f"{ring_ms:.2f}ms eager")
    if not (err <= 10 * floor and torch.isfinite(got).all()):
        raise AssertionError(f"windowed prefill {err} > 10 x {floor}")
    kern64, plain64 = attention_vs_float64(model, toks)
    log(f"  qwen3-8b-swa attention of each of {SWA_CUT} layers at S=4200, "
        f"window {SWA_W}, against float64 (the worst layer): kernel "
        f"{kern64:.3e}, plain {plain64:.3e}")
    if not kern64 <= 4 * plain64:
        raise AssertionError(f"flash_attention {kern64} from float64, "
                             f"> 4 x the plain version's {plain64}")
    per_slot = 2 * full.num_layers * full.num_kv_heads * full.head_dim * 4
    from repro_torch.models.model import LM
    meta = LM(full, device="meta").init_decode_state(1, 524288)
    ring_bytes = sum(t.numel() * 4 for c in meta["caches"]
                     for t in c.values())
    log(f"  qwen3-8b-swa at 524288 positions (36 layers, B=1, float32): the "
        f"ring holds {ring_bytes / 1e9:.3f} GB ({SWA_W} slots); a linear "
        f"cache would hold {per_slot * 524288 / 1e9:.1f} GB")
    del model
    empty_cache()

    model = resolve("zamba2-1.2b", size="full", shape="long_500k",
                    device="cuda", seed=0).model
    toks = torch.as_tensor(rng.integers(4, model.cfg.vocab_size, (1, 4200)),
                           dtype=torch.int32, device="cuda")
    prefill = lambda: model.prefill(toks, max_len=4200)[0]
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = prefill()
    paths["zamba2-1.2b-swa"] = ops.launch_counts()
    with torch.inference_mode():
        pre_ms = wall_ms(prefill)
    with plain_kernels(ops):
        floor, err = floor_and_err(prefill, model, got)
    log(f"  zamba2-1.2b-swa windowed prefill B=1 S=4200 (window "
        f"{model.cfg.sliding_window}, all 38 layer slots): {pre_ms:.2f}ms, "
        f"launches {paths['zamba2-1.2b-swa']}; kernels vs plain "
        f"max_abs_err={err:.3e}, the 1e-7 perturbation {floor:.3e}")
    if not (err <= 10 * floor and torch.isfinite(got).all()):
        raise AssertionError(f"zamba2-1.2b-swa prefill {err} > 10 x {floor}")
    for name, needed in (("qwen3-8b-swa", ("flash_attention",
                                           "flash_decode")),
                         ("zamba2-1.2b-swa", ("flash_attention",
                                              "ssd_scan"))):
        for k in needed:
            if paths[name][k] == 0:
                raise AssertionError(f"{name} never launched {k}")
    del model
    empty_cache()
    return paths


# --------------------------------------------------------------- phase 16 --
SH_NEW, SH_SLOTS = 16, 8        # phase 16's generation and slot table


def check_stats_cases(da, gen):
    """``flash_decode(return_stats=True)`` against its plain twin at
    qwen3-8b's decode shapes (B=8, 32 over 8 heads of 128, 256 slots: 4
    splits, the combine pass's stats; 32 slots: one split, the main
    kernel's): ragged lengths, length 0, lengths past the cache, a
    captured call replayed after the lengths changed; the output bitwise
    as without stats; then n = 2 and 4 slices of the cache merged
    (``merge_decode_stats``) against the whole cache's ``flash_decode``.
    Float32 within 2e-5 (l relative: it sums up to 256 terms)."""
    b = 8
    q = randn(gen, (b, QW_H, QW_D))
    kc, vc = (randn(gen, (b, QW_T, QW_HKV, QW_D)) for _ in range(2))

    def held(what, got, lengths, t=QW_T):
        want = da.flash_decode_plain(q, kc[:, :t], vc[:, :t], lengths,
                                     return_stats=True)
        errs = (max_err(got[0], want[0]), max_err(got[1], want[1]),
                float(((got[2] - want[2]).abs() / want[2]).max()))
        log(f"  {what}: out {errs[0]:.3e}, m {errs[1]:.3e}, l (relative) "
            f"{errs[2]:.3e}")
        if not (max(errs) <= F32_TOL and all(torch.isfinite(x).all()
                                             for x in got)):
            raise AssertionError(f"{what}: {errs} > {F32_TOL}")

    cases = [QW_LENS, (0,) + QW_LENS[1:], (256, 300, 1, 0, 129, 5, 2, 255)]
    for lens in cases:
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = da.flash_decode_cuda(q, kc, vc, lengths, return_stats=True)
        if not torch.equal(got[0], da.flash_decode_cuda(q, kc, vc, lengths)):
            raise AssertionError("return_stats changed the output")
        held(f"stats T={QW_T} lens={lens}", got, lengths)
    short = torch.tensor((0, 32, 7, 40, 1, 31, 16, 2), dtype=torch.int32,
                         device="cuda")
    if da.decode_splits(b, QW_HKV, 32)[0] != 1:
        raise AssertionError("the T=32 case should take one split")
    held(f"stats T=32 (one split) lens={short.tolist()}",
         da.flash_decode_cuda(q, kc[:, :32].contiguous(),
                              vc[:, :32].contiguous(), short,
                              return_stats=True), short, 32)
    lengths = torch.tensor(QW_LENS, dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.flash_decode_cuda(q, kc, vc, lengths, return_stats=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = da.flash_decode_cuda(q, kc, vc, lengths, return_stats=True)
    for lens in cases[1:]:
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        held(f"stats from a CUDA graph, lens={lens}", got, lengths)
    lengths.copy_(torch.tensor(cases[1], dtype=torch.int32))
    whole = da.flash_decode_cuda(q, kc, vc, lengths)
    for n in (2, 4):
        s = QW_T // n
        parts = [da.flash_decode_cuda(
            q, kc[:, i * s:(i + 1) * s], vc[:, i * s:(i + 1) * s],
            (lengths - i * s).clamp(min=0), return_stats=True)
            for i in range(n)]
        within(f"{n} slices merged vs the whole cache",
               da.merge_decode_stats(*zip(*parts)), whole, F32_TOL)
    return len(cases) + 1 + (len(cases) - 1) + 2


def check_bf16_stats_cases(da, gen):
    """bf16 ``flash_decode(return_stats=True)`` against its plain twin at
    each of ``GQA_SHAPES`` (B=8, heads of 128, 256 slots: ragged, a length
    0, lengths past the cache): the bf16 output within
    2e-2 x max(1, max |plain|), m within 2e-5 and l within 2e-5 relative
    (both float32); the output bitwise as without stats; and
    ``merge_decode_stats`` of the one slice (a 1x1 mesh's merge) the
    kernel's own output, bitwise."""
    b = 8
    cases = [QW_LENS, (0,) + QW_LENS[1:], (256, 300, 1, 0, 129, 5, 2, 255)]
    for model, h, hkv in GQA_SHAPES:
        q = randn(gen, (b, h, QW_D), torch.bfloat16)
        kc, vc = (randn(gen, (b, QW_T, hkv, QW_D), torch.bfloat16)
                  for _ in range(2))
        for lens in cases:
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = da.flash_decode_cuda(q, kc, vc, lengths, return_stats=True)
            want = da.flash_decode_plain(q, kc, vc, lengths,
                                         return_stats=True)
            tol = BF16_TOL * max(1.0, float(want[0].float().abs().max()))
            errs = (max_err(got[0], want[0]), max_err(got[1], want[1]),
                    float(((got[2] - want[2]).abs() / want[2]).max()))
            what = f"{model} H={h} Hkv={hkv} T={QW_T} lens={lens}"
            log(f"  bf16 stats {what}: out {errs[0]:.3e} (limit {tol:.3e}), "
                f"m {errs[1]:.3e}, l (relative) {errs[2]:.3e}")
            if not (got[0].dtype == torch.bfloat16 and errs[0] <= tol
                    and max(errs[1:]) <= F32_TOL
                    and all(torch.isfinite(x).all() for x in got)):
                raise AssertionError(f"bf16 stats {what}: {errs}")
            if not torch.equal(got[0],
                               da.flash_decode_cuda(q, kc, vc, lengths)):
                raise AssertionError(f"{what}: return_stats changed the "
                                     f"bf16 output")
            if not torch.equal(da.merge_decode_stats([got[0]], [got[1]],
                                                     [got[2]]), got[0]):
                raise AssertionError(f"{what}: a one-slice merge moved the "
                                     f"bf16 output")
    return len(cases) * len(GQA_SHAPES)


def first_low_margin(model, prompt, tokens, margin=MARGIN) -> int:
    """The index of the first of ``tokens`` (a greedy continuation of
    ``prompt``) behind a top-2 logit margin under ``margin``, else len."""
    from repro_torch.runtime.serving import greedy_margins

    low = np.flatnonzero(greedy_margins(model, prompt, tokens) < margin)
    return int(low[0]) if low.size else len(tokens)


def held_rows(what, model, prompts, want, got, margin=MARGIN):
    """Each row of ``got`` ((m, tokens) pairs) equals ``want``'s, or
    differs only at or after a token behind a top-2 margin under
    ``margin`` (margins computed only for rows that differ)."""
    differ = 0
    for i, (p, (m_w, t_w), (m_g, t_g)) in enumerate(zip(prompts, want,
                                                        got)):
        t_w, t_g = np.asarray(t_w), np.asarray(t_g)
        if m_w == m_g and np.array_equal(t_w, t_g):
            continue
        differ += 1
        n = min(len(t_w), len(t_g))
        first = int(np.flatnonzero(t_w[:n] != t_g[:n])[0]) if (
            t_w[:n] != t_g[:n]).any() else n
        if first < first_low_margin(model, p, t_w[:first + 1], margin):
            raise AssertionError(f"{what}: row {i} differs at token {first} "
                                 f"above the margin: {t_g.tolist()} != "
                                 f"{t_w.tolist()}")
    log(f"  {what}: {len(prompts) - differ} of {len(prompts)} rows "
        f"equal, {differ} differ behind a top-2 margin under {margin:g}")


def step_ms(lm, toks, steps=10):
    """Eager ms of one B=8 decode step of ``lm`` (an LM or a ShardedLM),
    after a prefill of ``toks``."""
    with torch.inference_mode():
        logits, state = lm.prefill(toks, max_len=QW_T)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        for _ in range(2):
            lm.decode_step(state, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            lm.decode_step(state, tok)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def sharded_phase(ops):
    """qwen3-8b at full width through ``make_sharded_session`` on a 1x1
    NCCL mesh (``tp``: the caches' slots over the size-1 ``model`` axis, so
    every attention layer decodes through ``attn_decode_seq_sharded``: the
    stats kernel and two all_reduces), ``GenerationSession`` and a
    continuous slot table, held against the unsharded sessions on the
    same weights behind the margin; per-rank parameter bytes and the eager
    decode step, sharded beside unsharded, in turns."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.serving import (ContinuousGenerationSession,
                                             GenerationSession)
    from repro_torch.runtime.sharded import make_sharded_session

    model, n_params = build_lm("qwen3-8b")
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(16)
    toks = rng.integers(4, vocab, (8, 64)).astype(np.int32)
    lens = np.concatenate([[64], rng.integers(5, 65, 7)]).astype(np.int32)
    prompts = [rng.integers(4, vocab, int(n)).astype(np.int32)
               for n in rng.integers(5, 61, 12)]
    rows = [t[:n] for t, n in zip(toks, lens)]
    ref = GenerationSession(model, max_len=QW_T).generate_with_lengths(
        toks, max_new=SH_NEW, lengths=lens)
    cont_ref = ContinuousGenerationSession(
        model, max_slots=SH_SLOTS, max_len=QW_T).serve(prompts,
                                                       max_new=SH_NEW)
    block = torch.as_tensor(toks, device="cuda")
    plain_ms = [step_ms(model, block)]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
        try:
            sess = make_sharded_session(
                model, make_host_mesh((1, 1), ("data", "model"), "cuda"),
                max_len=QW_T, batch_size=SH_SLOTS, layout="tp")
            lm = sess.model
            log(f"  {sess.layout} layout on a 1x1 NCCL mesh: "
                f"{lm.local_bytes()} parameter bytes on the rank "
                f"({4 * n_params} for the whole model)")
            ops.reset_launch_counts()
            got = sess.generate_with_lengths(toks, max_new=SH_NEW,
                                             lengths=lens)
            cont = ContinuousGenerationSession(
                lm, max_slots=SH_SLOTS, max_len=QW_T).serve(prompts,
                                                            max_new=SH_NEW)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            log(f"  kernel launches, sharded generate + slot table: "
                f"{launches}")
            for name in ("flash_attention", "flash_decode"):
                if launches[name] == 0:
                    raise AssertionError(f"the sharded path never launched "
                                         f"{name}")
            sharded_ms = [step_ms(lm, block), step_ms(lm, block)]
            plain_ms.append(step_ms(model, block))
        finally:
            dist.destroy_process_group()
    held_rows("sharded GenerationSession vs unsharded", model, rows,
              list(zip(*ref)), list(zip(*got)))
    held_rows("sharded slot table vs unsharded", model, prompts, cont_ref,
              cont)
    log(f"  eager B=8 decode step at 64-73 positions: unsharded "
        f"{plain_ms[0]:.2f} / {plain_ms[1]:.2f} ms, sharded 1x1 "
        f"{sharded_ms[0]:.2f} / {sharded_ms[1]:.2f} ms (in turns)")
    del model, sess, lm
    gc.collect()
    torch.cuda.empty_cache()
    return {"qwen3-8b sharded": launches}


# --------------------------------------------------------------- phase 17 --
ST_CUT, ST_B, ST_S, ST_STEPS = 4, 4, 256, 3   # phase 17: qwen3-8b's layers
                                              # (of 36), batch, steps
ST_REL = 1e-6                   # sharded vs unsharded where not bitwise


def train_steps(step, state, batches):
    """``step`` over ``batches``: (state, losses, grad norms, ms each)."""
    losses, norms, times = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        times.append((time.perf_counter() - t0) * 1e3)
    return state, losses, norms, times


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (0 where both are 0)."""
    a, b = a.detach(), b.detach()
    scale = float(b.abs().max())
    return max_err(a, b) / scale if scale else max_err(a, b)


def dryrun_bytes_check(lm, pol, state, base_bytes, *, tol=0.02,
                       moments=torch.float32, b=ST_B, s=ST_S):
    """The dry-run's per-rank argument bytes of this train step at the
    model's dtype with ``moments`` moments (``launch/dryrun.
    argument_bytes`` on the meta device) against what the card holds
    after the steps: ``memory_allocated`` less what was allocated before
    the model, and the state's own tensors term by term.  Raises naming
    the term that is off by more than ``tol``."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM

    meta = LM(lm.cfg, device="meta", param_dtype=lm.param_dtype)
    inputs = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
              for k in ("tokens", "targets")}
    want = dryrun.argument_bytes(meta, "train", inputs, pol,
                                 moments_dtype=moments)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base_bytes
    held = {"parameters": sum(p.nbytes for p in state.params.values()),
            "moments": sum(t.nbytes for t in (*state.opt.mu.values(),
                                              *state.opt.nu.values())),
            "step": state.opt.step.nbytes}
    log(f"  dry-run per-rank argument bytes ({_dname(lm.param_dtype)} "
        f"model, {_dname(moments)} moments) {want}; on the card after the "
        f"steps: memory_allocated {allocated} B (less the {base_bytes} B "
        f"held before the model; {100 * (allocated / want['total'] - 1):+.3f}"
        f"% of the total), the state's tensors {held}")
    off = [f"{k}: {held[k]} vs {want[k]}" for k in held
           if abs(held[k] - want[k]) > tol * want[k]]
    if abs(allocated - want["total"]) > tol * want["total"]:
        off.append(f"memory_allocated {allocated} vs the total "
                   f"{want['total']} (unaccounted "
                   f"{allocated - sum(held.values())} B)")
    if off:
        raise AssertionError(f"dry-run bytes off by more than {tol:.0%}: "
                             + "; ".join(off))
    return want, allocated


def sharded_training_phase(ops):
    """qwen3-8b at full width cut to 4 of 36 layers: 3 AdamW steps through
    ``make_train_step`` on a ``ShardedLM`` over a 1x1 NCCL mesh (``tp``)
    at B=4 S=256 from ``launch/train.py``'s token stream, then the same
    steps unsharded on the same weights and batches; losses, grad norms
    and every parameter held equal (bitwise, else within 1e-6 relative);
    the dry-run's per-rank bytes against the card's; a ragged B=8
    generate of 16 tokens from the trained sharded model against the
    unsharded one behind the margin, through both attention kernels; the
    eager step, sharded beside unsharded, in turns."""
    import datetime

    import torch.distributed as dist
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.serving import GenerationSession
    from repro_torch.runtime.sharded import shard_lm
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = cut_config("qwen3-8b", (ST_CUT,))
    model, n_params = build_cut(cfg)
    init = {n: t.to("cpu", copy=True) for n, t in model.state_dict().items()}
    rng = np.random.default_rng(0)
    stream = rng.integers(1, cfg.vocab_size, ST_STEPS * ST_B * (ST_S + 1)
                          * 2).astype(np.int32)
    batches = list(lm_batches(stream, batch_size=ST_B,
                              seq_len=ST_S))[:ST_STEPS]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
        try:
            lm, pol = shard_lm(model, make_host_mesh((1, 1), ("data",
                                                              "model"),
                                                     "cuda"),
                               batch_size=ST_B, layout="tp")
            st_a = init_train_state(lm)
            step_a = make_train_step(lm)
            ops.reset_launch_counts()
            st_a, loss_a, norm_a, ms_a = train_steps(step_a, st_a, batches)
            if any(ops.launch_counts().values()):
                raise AssertionError("a kernel launched while training")
            want, allocated = dryrun_bytes_check(lm, pol, st_a, base)

            other = build_cut(cfg)[0]
            other.load_state_dict(init)
            del init
            st_b = init_train_state(other)
            step_b = make_train_step(other)
            st_b, loss_b, norm_b, ms_b = train_steps(step_b, st_b, batches)
            log(f"  {ST_STEPS} steps at B={ST_B} S={ST_S}, sharded 1x1 "
                f"(tp) / unsharded: losses {loss_a} / {loss_b}; grad norms "
                f"{norm_a} / {norm_b}; ms {[round(t, 1) for t in ms_a]} / "
                f"{[round(t, 1) for t in ms_b]}")
            if not (np.all(np.isfinite(loss_a)) and loss_a[-1] < loss_a[0]):
                raise AssertionError(f"the sharded loss did not fall: "
                                     f"{loss_a}")
            worst = {"loss": max(abs(a - b) / abs(b)
                                 for a, b in zip(loss_a, loss_b)),
                     "grad_norm": max(abs(a - b) / abs(b)
                                      for a, b in zip(norm_a, norm_b)),
                     "parameters": max(rel_err(st_a.params[n],
                                               st_b.params[n])
                                       for n in st_b.params)}
            bitwise = (loss_a == loss_b and norm_a == norm_b and all(
                torch.equal(st_a.params[n], st_b.params[n])
                for n in st_b.params))
            log(f"  sharded vs unsharded after {ST_STEPS} steps: "
                + ("bitwise equal" if bitwise else
                   f"not bitwise; worst relative errors {worst}"))
            if not bitwise and max(worst.values()) > ST_REL:
                raise AssertionError(f"sharded training vs unsharded: "
                                     f"{worst} > {ST_REL}")
            turns = []
            for step, st in ((step_a, st_a), (step_b, st_b)) * 2:
                turns.append(train_steps(step, st, batches[:1])[3][0])
            log(f"  eager train step, in turns sharded / unsharded: "
                f"{turns[0]:.1f} / {turns[1]:.1f}, {turns[2]:.1f} / "
                f"{turns[3]:.1f} ms; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del st_a, st_b, step_a, step_b
            empty_cache()

            toks = rng.integers(4, cfg.vocab_size, (8, 64)).astype(np.int32)
            lens = np.concatenate([[64], rng.integers(5, 65, 7)]).astype(
                np.int32)
            ref = GenerationSession(other, max_len=QW_T)\
                .generate_with_lengths(toks, max_new=SH_NEW, lengths=lens)
            ops.reset_launch_counts()
            got = GenerationSession(lm, max_len=QW_T).generate_with_lengths(
                toks, max_new=SH_NEW, lengths=lens)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        finally:
            dist.destroy_process_group()
    log(f"  kernel launches, the trained sharded model's generate: "
        f"{launches}")
    for name in ("flash_attention", "flash_decode"):
        if launches[name] == 0:
            raise AssertionError(f"serving the trained sharded model never "
                                 f"launched {name}")
    held_rows("trained sharded GenerationSession vs unsharded", other,
              [t[:n] for t, n in zip(toks, lens)], list(zip(*ref)),
              list(zip(*got)))
    del model, other, lm
    empty_cache()
    return {"qwen3-8b sharded trained": launches}


# --------------------------------------------------------------- phase 18 --
BF16 = torch.bfloat16
# the models phase 18 serves in bfloat16 at full depth on one card
BF16_MODELS = ("qwen3-8b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
BF16_TWIN_LAYERS = 4      # qwen3-8b's layers (of 36) against its f32 twin
BF16_TWIN_CEILING = 2.0   # the kernels' bf16 gap over the plain route's


def bf16_twin_check(ops):
    """qwen3-8b at full width cut to ``BF16_TWIN_LAYERS`` layers, drawn
    from seed 0 in bf16 and in float32: the bf16 weights must be the
    float32 ones cast (bitwise), and the bf16 logits on the kernels must
    lie within ``BF16_TWIN_CEILING`` x the gap between the bf16 plain
    route and the float32 twin (the CPU tests hold that plain route
    within 0.8-1.1x of the reference's own bf16-vs-f32 gap)."""
    from repro_torch.models.model import LM

    cfg = cut_config("qwen3-8b", (BF16_TWIN_LAYERS,))
    half = LM(cfg, device="cuda", seed=0, param_dtype=BF16)
    full = LM(cfg, device="cuda", seed=0)
    for (name, p), q in zip(half.named_parameters(), full.parameters()):
        if not torch.equal(p, q.to(p.dtype)):
            raise AssertionError(f"{name}: the bf16 draw is not the float32 "
                                 "draw cast")
    toks = torch.as_tensor(np.random.default_rng(32).integers(
        4, cfg.vocab_size, (2, 37)), dtype=torch.int32, device="cuda")
    twin = lm_logits(full, toks)
    kern = lm_logits(half, toks)
    with plain_kernels(ops):
        plain = lm_logits(half, toks)
    err, gap = max_err(kern, twin), max_err(plain, twin)
    log(f"  qwen3-8b, {BF16_TWIN_LAYERS} of 36 layers (seed 0): every bf16 "
        f"weight == its float32 draw cast; prefill + 4 decode-step logits, "
        f"bf16 on the kernels vs the float32 twin {err:.4e}, bf16 on the "
        f"plain route vs the twin {gap:.4e} ({err / gap:.2f}x, ceiling "
        f"{BF16_TWIN_CEILING}x; max |twin| {float(twin.abs().max()):.3f})")
    if not (kern.dtype == BF16 and torch.isfinite(kern).all()
            and err <= BF16_TWIN_CEILING * gap):
        raise AssertionError(f"bf16 vs the float32 twin {err} > "
                             f"{BF16_TWIN_CEILING} x {gap}")
    del half, full
    empty_cache()


def check_bf16_model(model, ops, what):
    """A full-depth bf16 LM on the kernels, prefill + four decode-step
    logits at B=2 S=37 (bf16 and finite), each kernel call held against
    its plain version on the same inputs (``checked_kernels``).  The
    logits of the whole run are no test of the kernels: over 36-48
    random layers a one-step bf16 change of the embeddings moves them by
    about their own size."""
    toks = torch.as_tensor(np.random.default_rng(31).integers(
        4, model.cfg.vocab_size, (2, 37)), dtype=torch.int32, device="cuda")
    worst = {}
    ops.reset_launch_counts()
    with checked_kernels(worst):
        got = lm_logits(model, toks)
    launches = ops.launch_counts()
    log(f"  {what} B=2 S=37: prefill + 4 decode-step logits ({got.dtype}), "
        f"launches {launches}; each kernel call vs its plain version: "
        f"{checked_line(worst)}")
    if not (got.dtype == BF16 and torch.isfinite(got).all()):
        raise AssertionError(f"{what}: logits not finite bf16")
    for k in ("flash_attention", "flash_decode"):
        if launches[k] == 0:
            raise AssertionError(f"{what}: {k} never launched")


def aten_ops(fn) -> int:
    """The ATen operators that ``fn()`` dispatches: each one a host-side
    call, whether it launches a kernel or not."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def routed_bytes(model, fn) -> int:
    """The weight bytes ``fn()`` needs read: every parameter but the
    routed experts' (the embedding table whole), plus, per MoE layer, the
    distinct experts its router picks in the call; the port's dispatch
    reads every expert instead."""
    from repro_torch.models.layers import moe

    picked = []
    route = moe.route

    def spy(p, mo, tokens):
        out = route(p, mo, tokens)
        picked.append((p, int(torch.unique(out[1]).numel())))
        return out

    moe.route = spy
    try:
        fn()
    finally:
        moe.route = route
    layers = [m for m in model.modules() if isinstance(m, moe.MoE)]
    own = {id(m): sum(t.w.nbytes for t in (m.experts_gate, m.experts_up,
                                            m.experts_down)) for m in layers}
    if len(picked) != len(layers):
        raise AssertionError(f"{len(picked)} routings for {len(layers)} "
                             "MoE layers in one step")
    return (sum(p.nbytes for p in model.parameters()) - sum(own.values())
            + sum(own[id(m)] * n // m.experts_gate.w.shape[0]
                  for m, n in picked))


def bf16_model_phase(name, ops, rng):
    """``name`` at full width and depth in bf16 on the card (``resolve(
    ..., param_dtype=torch.bfloat16)``, seed 0): ``check_bf16_model``, a
    ragged B=8 ``generate_with_lengths`` and ragged admission waves on 8
    slots with each kernel call checked, 12 prompts through
    ``serve_continuous`` on 8 slots (both modes), then the eager
    slot-table step at 8 live slots (its ATen operators, its device time
    beside the weight-read bound and, for a MoE model, beside the read of
    the experts its routing picked), and the peak memory."""
    from repro_torch.models.registry import resolve
    from repro_torch.runtime.serving import (ContinuousGenerationSession,
                                             GenerationSession)

    attn = ("flash_attention", "flash_decode")
    empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = resolve(name, size="full", device="cuda", seed=0, param_dtype=BF16)
    model = r.model
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.nbytes for p in model.parameters())
    log(f"  {name}: all {r.cfg.num_layers} layers, d_model {r.cfg.d_model}; "
        f"{n_params / 1e9:.3f}B parameters in {n_bytes / 1e9:.2f} GB (bf16 "
        f"matrices, float32 norms and router), built in "
        f"{time.perf_counter() - t0:.2f}s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    check_bf16_model(model, ops, name)
    paths = {}

    vocab = model.cfg.vocab_size
    lens = np.array([37, 8, 21, 64, 5, 50, 13, 30], np.int32)
    toks = rng.integers(4, vocab, (8, int(lens.max()))).astype(np.int32)
    sess = GenerationSession(model, max_len=BF16_T)
    worst = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with checked_kernels(worst):
        m_out, out = sess.generate_with_lengths(toks, max_new=16,
                                                lengths=lens)
    wall = time.perf_counter() - t0
    paths[f"{name} bf16"] = ops.launch_counts()
    log(f"  ragged B=8 generate_with_lengths (lengths {lens.tolist()}, 16 "
        f"new): {wall:.2f}s with each kernel call checked, output lengths "
        f"{m_out.tolist()}, launches {paths[f'{name} bf16']}; each call vs "
        f"its plain version: {checked_line(worst)}")
    if out.shape != (8, 16) or ((out < 0) | (out >= vocab)).any():
        raise AssertionError(f"{name} bf16: bad generation {out}")
    prompts = [rng.integers(4, vocab, int(n)).astype(np.int32)
               for n in rng.integers(5, 61, 12)]
    csess = ContinuousGenerationSession(model, max_slots=8, max_len=BF16_T)
    worst = {}
    ops.reset_launch_counts()
    with checked_kernels(worst):
        csess.admit(prompts[:5], max_new=8)
        for _ in range(2):
            csess.step()
        csess.admit(prompts[5:8], max_new=8)
        for _ in range(2):
            csess.step()
    paths[f"{name} bf16 admission waves"] = ops.launch_counts()
    log(f"  ragged admission waves of 5 then 3 prompts (lengths "
        f"{[len(p) for p in prompts[:8]]}), 2 steps after each, launches "
        f"{paths[f'{name} bf16 admission waves']}; each call vs its plain "
        f"version: {checked_line(worst)}")
    _, paths[f"{name} bf16 continuous"] = serve_both_modes(
        csess, ops, prompts, 8, 20.0, attn)
    for what, launches in paths.items():
        for k in attn:
            if launches[k] == 0:
                raise AssertionError(f"{what}: {k} never launched")

    csess.reset()
    csess.admit([p[:16] for p in prompts[:8]], max_new=BF16_T - 32)
    for _ in range(3):
        csess.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        csess.step()
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    busy, kernels = profiled_busy_ms(lambda: [csess.step() for _ in range(3)])
    n_ops = aten_ops(csess.step)
    bound_ms = n_bytes / HBM_BYTES_S * 1e3
    routed = ""
    if r.cfg.moe:
        need = routed_bytes(model, csess.step)
        routed = (f"; the weights this step's routing needs (every expert "
                  f"it picks once, the rest whole) {need / 1e9:.2f} GB = "
                  f"{need / HBM_BYTES_S * 1e3:.2f}ms")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {name} bf16 slot-table step at 8 live slots: {step_ms:.2f}ms "
        f"eager = {8 / step_ms * 1e3:.1f} decode tokens/s; {n_ops} ATen "
        f"operators; {busy / 3:.2f}ms device time ({kernels / 3:.0f} device "
        f"kernels, device busy {100 * busy / 3 / step_ms:.1f}% of the "
        f"step); weight-read bound {bound_ms:.2f}ms ({n_bytes / 1e9:.2f} GB "
        f"at 3.35 TB/s{', the dispatch reading every expert' if r.cfg.moe else ''})"
        f"{routed}; peak memory {peak:.2f} GiB")
    del model, sess, csess, r
    empty_cache()
    return paths


def bf16_small_phase(name, ops, needed):
    """``name`` (zamba2-1.2b, rwkv6-3b or whisper-large-v3) at full width
    and depth in bf16 on the card, seed 0: prefill + four decode-step
    logits at B=2 (whisper with 1500 frames of each ragged length) and a
    ``GenerationSession`` generate of 8 tokens, each kernel call held
    against its plain version (``checked_kernels``), the logits and every
    floating state leaf bf16 and finite, each of ``needed`` launched."""
    from repro_torch.models.registry import resolve
    from repro_torch.runtime.serving import GenerationSession

    empty_cache()
    r = resolve(name, size="full", device="cuda", seed=0, param_dtype=BF16)
    model, cfg = r.model, r.model.cfg
    toks = torch.as_tensor(np.random.default_rng(34).integers(
        4, cfg.vocab_size, (2, 37)), dtype=torch.int32, device="cuda")
    frames = mask = None
    if cfg.is_encoder_decoder:
        frames = torch.as_tensor(np.random.default_rng(15).standard_normal(
            (2, WH_T, cfg.d_model)), dtype=torch.float32, device="cuda")
        mask = (torch.arange(WH_T, device="cuda")[None, :] < torch.tensor(
            WH_LENS[1:3], device="cuda")[:, None]).float()
    worst = {}
    ops.reset_launch_counts()
    with checked_kernels(worst), torch.inference_mode():
        got = (whisper_logits(model, toks, frames, mask) if frames is not None
               else lm_logits(model, toks))
        _, state = model.prefill(toks, frames=frames, frame_mask=mask,
                                 max_len=BF16_T)
        sess = GenerationSession(model, max_len=BF16_T)
        _, out = sess.generate_with_lengths(
            toks.cpu().numpy(), max_new=8,
            frames=None if frames is None else frames)
    launches = ops.launch_counts()
    leaves = [t for c in state["caches"] for t in c.values()
              if t.is_floating_point()]
    log(f"  {name}: {sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
        f"parameters in bf16, prefill + 4 decode-step logits "
        f"({got.dtype}, max |logit| over the real vocabulary "
        f"{float(got[..., :cfg.vocab_size].float().abs().max()):.3f}) "
        f"and an 8-token generate, launches {launches}; each kernel call vs "
        f"its plain version: {checked_line(worst)}")
    if not (got.dtype == BF16 and torch.isfinite(got).all()
            and all(t.dtype == BF16 for t in leaves)
            and out.shape == (2, 8)):
        raise AssertionError(f"{name}: bf16 logits, state or tokens off")
    for k in needed:
        if launches[k] == 0:
            raise AssertionError(f"{name} bf16: {k} never launched")
    del model, r, state, sess
    empty_cache()
    return {f"{name} bf16": launches}


def bf16_phase(ops):
    """Phase 18: the float32-twin check, each of ``BF16_MODELS`` served in
    bf16 at full depth, then the recurrent and encoder-decoder families'
    short bf16 pass."""
    bf16_twin_check(ops)
    rng = np.random.default_rng(33)
    paths = {}
    for name in BF16_MODELS:
        paths.update(bf16_model_phase(name, ops, rng))
    for name, needed in (("zamba2-1.2b", ("ssd_scan", "flash_attention",
                                          "flash_decode")),
                         ("rwkv6-3b", ("rwkv6_wkv",)),
                         ("whisper-large-v3", ("flash_attention",
                                               "flash_decode"))):
        paths.update(bf16_small_phase(name, ops, needed))
    return paths


# --------------------------------------------------------------- phase 19 --
# bf16 training: qwen3-8b's cut (of 36 layers), batch, sequence, steps
BT_CUT, BT_B, BT_S, BT_STEPS = 4, 4, 256, 3
BT_TOL = 0.01           # the dry run's per-rank bytes vs the card's
BF16_MARGIN = 0.125     # a bf16 top-2 logit margin: 8 steps at 2-4
BF16_TRAIN = ("rwkv6-3b", "zamba2-1.2b")   # full depth, float32 moments


@contextlib.contextmanager
def nccl_1x1():
    """A one-rank NCCL process group and its 1x1 ("data", "model") mesh,
    destroyed on exit."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=60))
        try:
            yield make_host_mesh((1, 1), ("data", "model"), "cuda")
        finally:
            dist.destroy_process_group()


def bf16_sharded_serving(name, ops, mesh, rng):
    """``name`` whole in bf16 (seed 0) through ``make_sharded_session`` on
    the 1x1 NCCL mesh (``tp``: every attention layer decodes through
    ``attn_decode_seq_sharded``, the bf16 stats kernel and its float32
    merge): a ragged B=8 ``generate_with_lengths`` of 16 tokens and 12
    prompts through a slot table of 8, each kernel call held against its
    plain version (``checked_kernels``: the stats call's output, m and
    l), the tokens against the unsharded bf16 sessions on the same
    weights (bitwise, else behind the margin); both attention kernels
    launched; the eager B=8 decode step, sharded beside unsharded, in
    turns."""
    from repro_torch.models.registry import resolve
    from repro_torch.runtime.serving import (ContinuousGenerationSession,
                                             GenerationSession)
    from repro_torch.runtime.sharded import make_sharded_session

    empty_cache()
    r = resolve(name, size="full", device="cuda", seed=0, param_dtype=BF16)
    model = r.model
    n_bytes = sum(p.nbytes for p in model.parameters())
    vocab = model.cfg.vocab_size
    toks = rng.integers(4, vocab, (8, 64)).astype(np.int32)
    lens = np.concatenate([[64], rng.integers(5, 65, 7)]).astype(np.int32)
    prompts = [rng.integers(4, vocab, int(n)).astype(np.int32)
               for n in rng.integers(5, 61, 12)]
    rows = [t[:n] for t, n in zip(toks, lens)]
    ref = GenerationSession(model, max_len=QW_T).generate_with_lengths(
        toks, max_new=SH_NEW, lengths=lens)
    cont_ref = ContinuousGenerationSession(
        model, max_slots=SH_SLOTS, max_len=QW_T).serve(prompts,
                                                       max_new=SH_NEW)
    block = torch.as_tensor(toks, device="cuda")
    plain_ms = [step_ms(model, block)]
    sess = make_sharded_session(model, mesh, max_len=QW_T,
                                batch_size=SH_SLOTS, layout="tp")
    lm = sess.model
    worst = {}
    ops.reset_launch_counts()
    with checked_kernels(worst):
        got = sess.generate_with_lengths(toks, max_new=SH_NEW, lengths=lens)
        cont = ContinuousGenerationSession(
            lm, max_slots=SH_SLOTS, max_len=QW_T).serve(prompts,
                                                        max_new=SH_NEW)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    sharded_ms = [step_ms(lm, block), step_ms(lm, block)]
    plain_ms.append(step_ms(model, block))
    same = (all(np.array_equal(a, b) for a, b in zip(ref, got))
            and all(m1 == m2 and np.array_equal(a, b)
                    for (m1, a), (m2, b) in zip(cont_ref, cont)))
    log(f"  {name} bf16 whole ({n_bytes / 1e9:.2f} GB), {sess.layout} on "
        f"the 1x1 NCCL mesh ({lm.local_bytes()} parameter bytes on the "
        f"rank); launches, sharded generate + slot table: {launches}; "
        f"tokens vs the unsharded bf16 sessions: "
        f"{'bitwise equal' if same else 'not all equal'}; each kernel call "
        f"vs its plain version: {checked_line(worst)}")
    for k in ("flash_attention", "flash_decode"):
        if launches[k] == 0:
            raise AssertionError(f"{name} bf16 sharded: {k} never launched")
    if not same:       # bf16's margin (tests/test_torch_bf16.py)
        held_rows(f"{name} bf16 sharded GenerationSession vs unsharded",
                  model, rows, list(zip(*ref)), list(zip(*got)),
                  BF16_MARGIN)
        held_rows(f"{name} bf16 sharded slot table vs unsharded", model,
                  prompts, cont_ref, cont, BF16_MARGIN)
    log(f"  {name} bf16 eager B=8 decode step at 64-73 positions: unsharded "
        f"{plain_ms[0]:.2f} / {plain_ms[1]:.2f} ms, sharded 1x1 "
        f"{sharded_ms[0]:.2f} / {sharded_ms[1]:.2f} ms (in turns)")
    del model, r, sess, lm
    empty_cache()
    return {f"{name} bf16 sharded": launches}


def bf16_train_run(cfg, batches, *, mesh=None, remat=False,
                   moments=BF16, dtype=BF16):
    """``make_train_step`` over ``batches`` on ``cfg``'s LM from seed 0
    (a ``ShardedLM`` under ``tp`` on ``mesh`` if given): its losses,
    grad norms, ms each, state, model, policy, peak bytes over what was
    allocated before the model, and that base."""
    from repro_torch.models.model import LM
    from repro_torch.runtime.sharded import shard_lm
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device="cuda", seed=0, param_dtype=dtype, remat=remat)
    pol = None
    if mesh is not None:
        model, pol = shard_lm(model, mesh, batch_size=batches[0][
            "tokens"].shape[0], layout="tp")
    state = init_train_state(model, moments_dtype=moments)
    state, losses, norms, times = train_steps(make_train_step(model), state,
                                              batches)
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        losses=losses, norms=norms, times=times, state=state, model=model,
        pol=pol, peak=torch.cuda.max_memory_allocated() - base, base=base)


def bf16_cut_training(ops):
    """qwen3-8b at full width cut to ``BT_CUT`` layers in bf16 (seed 0;
    the bf16 draw is the float32 one cast), ``BT_STEPS`` steps at
    B=``BT_B`` S=``BT_S`` from ``launch/train.py``'s token stream: the
    1x1-mesh step and the unsharded one bitwise, ``LM(remat=True)`` and
    ``remat=False`` bitwise (the peak memory of each), the loss falling
    and its gap to the float32 twin's; the dry run's per-rank bytes
    against ``memory_allocated`` within 1% with bf16 and with float32
    moments.  Returns the remat run's peak over its state's bytes (the
    temporaries a step adds)."""
    from repro_torch.data.pipeline import lm_batches

    cfg = cut_config("qwen3-8b", (BT_CUT,))
    stream = np.random.default_rng(0).integers(
        1, cfg.vocab_size, BT_STEPS * BT_B * (BT_S + 1) * 2).astype(np.int32)
    batches = list(lm_batches(stream, batch_size=BT_B,
                              seq_len=BT_S))[:BT_STEPS]
    ops.reset_launch_counts()
    with nccl_1x1() as mesh:
        for moments, steps in ((BF16, batches), (torch.float32, batches[:1])):
            run = bf16_train_run(cfg, steps, mesh=mesh, moments=moments)
            dryrun_bytes_check(run.model, run.pol, run.state, run.base,
                               tol=BT_TOL, moments=moments, b=BT_B, s=BT_S)
            if moments == BF16:
                sharded = (run.losses, run.norms, state_cpu(run.state))
            del run
    plain = bf16_train_run(cfg, batches)
    remat = bf16_train_run(cfg, batches, remat=True)
    if any(ops.launch_counts().values()):
        raise AssertionError("a kernel launched while training")
    want = state_cpu(plain.state, copy=False)
    got = state_cpu(remat.state, copy=False)
    sharded_same = (sharded[0] == plain.losses and sharded[1] == plain.norms
                    and all(torch.equal(sharded[2][k][n], t.cpu())
                            for k, d in want.items() for n, t in d.items()))
    remat_same = (remat.losses == plain.losses and remat.norms == plain.norms
                  and all(torch.equal(got[k][n], t)
                          for k, d in want.items() for n, t in d.items()))
    grads_peak = [backward_peak(r.model, batches[0]) for r in (plain, remat)]
    state_bytes = sum(t.nbytes for d in got.values() for t in d.values())
    del want, got
    log(f"  qwen3-8b, {BT_CUT} of 36 layers, bf16 with bf16 moments, "
        f"{BT_STEPS} steps at B={BT_B} S={BT_S}: losses {plain.losses}, "
        f"grad norms {plain.norms}; ms {[round(t, 1) for t in plain.times]} "
        f"(remat {[round(t, 1) for t in remat.times]}); the 1x1-mesh steps "
        f"vs unsharded: {'bitwise equal' if sharded_same else 'NOT equal'};"
        f" remat=True vs remat=False: "
        f"{'bitwise equal' if remat_same else 'NOT equal'}; peak memory "
        f"over the base {plain.peak / 2**30:.2f} GiB without remat, "
        f"{remat.peak / 2**30:.2f} GiB with (state {state_bytes / 2**30:.2f} "
        f"GiB); the loss and its gradients alone (no AdamW) peak "
        f"{grads_peak[0] / 2**30:.2f} GiB over the state without remat, "
        f"{grads_peak[1] / 2**30:.2f} GiB with")
    if not (sharded_same and remat_same):
        raise AssertionError(f"bf16 training: sharded {sharded_same}, "
                             f"remat {remat_same}")
    if not (np.all(np.isfinite(plain.losses))
            and plain.losses[-1] < plain.losses[0]):
        raise AssertionError(f"the bf16 loss did not fall: {plain.losses}")
    # the step's bytes past its state and gradients: AdamW's float32
    # temporaries of the largest leaves and the activations
    grad_bytes = sum(p.nbytes for p in remat.state.params.values())
    overhead = remat.peak - state_bytes - grad_bytes
    losses = plain.losses
    del plain, remat
    twin = bf16_train_run(cfg, batches, moments=torch.float32,
                          dtype=torch.float32)
    log(f"  the float32 twin (the same draw, float32 moments): losses "
        f"{twin.losses}, grad norms {twin.norms}; bf16 - float32 loss per "
        f"step {[a - b for a, b in zip(losses, twin.losses)]}")
    del twin
    empty_cache()
    return overhead


def state_cpu(state, copy=True):
    """A train state's parameters and moments by kind (host copies, or
    the tensors themselves)."""
    move = (lambda t: t.cpu()) if copy else (lambda t: t)
    return {k: {n: move(t) for n, t in d.items()} for k, d in (
        ("params", state.params), ("mu", state.opt.mu),
        ("nu", state.opt.nu))}


def backward_peak(model, batch) -> int:
    """Peak bytes of one loss and its gradients (no optimizer) over what
    was allocated before."""
    from repro_torch.training.losses import lm_loss

    tensors = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = [p for _, p in model.named_parameters()]
    with torch.enable_grad():
        grads = torch.autograd.grad(lm_loss(model, tensors)[0], params,
                                    allow_unused=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del grads
    return peak


def bf16_depth_training(cfg, what, ops, *, moments, remat, steps=3):
    """``cfg``'s LM in bf16 (seed 0, ``remat``) trained ``steps`` times on
    one B=1 S=64 batch from ``launch/train.py``'s token stream with
    ``moments`` moments: finite losses that fall, no kernel launched;
    prints ms a step, the device busy share of one more step
    (profiler), and the peak memory."""
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.training.train_loop import make_train_step

    stream = np.random.default_rng(0).integers(
        1, cfg.vocab_size, 4 * 65).astype(np.int32)
    batch = next(lm_batches(stream, batch_size=1, seq_len=64))
    ops.reset_launch_counts()
    run = bf16_train_run(cfg, [batch] * steps, remat=remat, moments=moments)
    losses, times, state, model = run.losses, run.times, run.state, run.model
    peak = run.peak
    del run
    step = make_train_step(model)
    busy, kernels = profiled_busy_ms(lambda: step(state, batch))
    wall = float(np.median(times[1:]))
    n = sum(p.numel() for p in model.parameters())
    log(f"  {what}: {n / 1e9:.3f}B parameters in bf16, {_dname(moments)} "
        f"moments, remat={remat}, {steps} steps at B=1 S=64: losses "
        f"{[round(x, 4) for x in losses]}; ms a step "
        f"{[round(t, 1) for t in times]}; one more step's device time "
        f"(profiler) {busy:.1f} ms in {kernels} kernels, busy "
        f"{100 * busy / wall:.1f}% of the median step after the first; "
        f"peak memory {peak / 2**30:.2f} GiB (card total "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
        f"GiB)")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: the bf16 loss did not fall: {losses}")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{what}: a kernel launched while training")
    del state, model, step
    empty_cache()
    return peak


def qwen3_depth_plan(overhead):
    """The deepest qwen3-8b cut (all 36 layers if it fits) whose bf16
    train state with bf16 moments (the dry run's per-rank bytes at B=1
    S=64 on a 1x1 mesh), its gradients (the parameters' bytes again,
    all alive while AdamW runs) and ``overhead`` (the 4-layer remat
    run's peak past its state and gradients: the embedding's and head's
    AdamW float32 temporaries, which every cut shares, and activations
    at B=4 S=256) fit on the card with 2 GiB to spare.  Returns (layers,
    the bytes expected)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    from repro_torch.sharding.policy import MeshShape, make_policy

    limit = torch.cuda.get_device_properties(0).total_memory - 2 * 2**30
    pol = make_policy(MeshShape(("data", "model"), (1, 1)), batch_size=1,
                      layout="tp")
    inputs = {k: torch.empty((1, 64), dtype=torch.int32, device="meta")
              for k in ("tokens", "targets")}
    for layers in range(36, 0, -1):
        meta = LM(cut_config("qwen3-8b", (layers,)), device="meta",
                  param_dtype=BF16)
        args = dryrun.argument_bytes(meta, "train", inputs, pol,
                                     moments_dtype=BF16)
        want = args["total"] + args["parameters"] + overhead
        if want <= limit:
            return layers, want
    raise AssertionError("not even one qwen3-8b layer fits")


def bf16_training_phase(ops):
    """Phase 19's training: the 4-layer qwen3-8b checks, then bf16 steps at
    full depth: rwkv6-3b and zamba2-1.2b (float32 moments), qwen3-8b
    with ``remat=True`` and bf16 moments at the depth the dry run and
    the 4-layer peak say fits."""
    from repro_torch.configs import get_config

    overhead = bf16_cut_training(ops)
    for name in BF16_TRAIN:
        bf16_depth_training(get_config(name), name, ops,
                            moments=torch.float32, remat=False)
    layers, want = qwen3_depth_plan(overhead)
    log(f"  qwen3-8b: the dry run's bf16 state (bf16 moments), its "
        f"gradients and the 4-layer peak's {overhead / 2**30:.2f} GiB of "
        f"temporaries: {want / 2**30:.2f} GiB at {layers} of 36 layers")
    peak = bf16_depth_training(cut_config("qwen3-8b", (layers,)),
                               f"qwen3-8b ({layers} of 36 layers)", ops,
                               moments=BF16, remat=True)
    log(f"  qwen3-8b ({layers} layers): peak {peak / 2**30:.2f} GiB against "
        f"the {want / 2**30:.2f} GiB expected")


def phase19(ops):
    """bf16 serving on the 1x1 NCCL mesh (qwen3-8b and qwen3-moe-30b-a3b
    whole), then bf16 training."""
    rng = np.random.default_rng(19)
    paths = {}
    with nccl_1x1() as mesh:
        for name in ("qwen3-8b", "qwen3-moe-30b-a3b"):
            paths.update(bf16_sharded_serving(name, ops, mesh, rng))
    bf16_training_phase(ops)
    return paths


# --------------------------------------------------------------- phase 20 --
# the examples' launchers (``repro_torch.launch.<name>``) and the arguments
# phase 20 gives them: the BiLSTM at the paper's width, the LMs at full size
LAUNCHERS = (("quickstart", []), ("fault_tolerant_serving", []),
             ("partitioned_serving", ["--scale", "1.0"]),
             ("collaborative_serving", ["--scale", "1.0"]),
             ("multitier_serving", ["--scale", "1.0"]),
             ("big_model_serving", ["--size", "full"]))
LM_KERNELS = ("flash_attention", "flash_decode", "rwkv6_wkv")


def engine_stats(res) -> dict:
    """The engine stats in a launcher's result, by the key they sit
    under, cut to the figures the examples print."""
    keys = ("requests", "mean_latency_s", "p95_latency_s", "offload_frac",
            "tier_frac", "split", "shed", "slo_attainment", "availability",
            "failovers")
    found = {}
    for name, s in res.items():
        if name == "stats":
            name = "engine"
        if isinstance(s, dict) and "requests" in s:
            found[name] = {k: s[k] for k in keys if k in s}
    return found


# where each launcher's result keeps the stats of its last stream, and
# the requests that stream sends under REPRO_SMOKE=1
SMOKE_STREAMS = {"fault_tolerant_serving": ("failover", 120),
                 "partitioned_serving": ("split-capable", 60),
                 "collaborative_serving": ("stats", 30),
                 "multitier_serving": ("slo_stats", 100),
                 "big_model_serving": ("stats", 6)}


def check_launcher(name, res) -> None:
    """Raise unless the launcher's result is what its example promises:
    quickstart's five finite decisions; else every request of the smoke
    stream accounted for at a finite mean latency, and big_model_serving's
    full token rows."""
    if name == "quickstart":
        ok = len(res["decisions"]) == 5 and all(
            np.isfinite([d.t_edge_pred, d.t_cloud_pred, d.m_hat]).all()
            for d in res["decisions"])
    else:
        key, n = SMOKE_STREAMS[name]
        ok = (res[key]["requests"] == n
              and np.isfinite(res[key]["mean_latency_s"]))
        if name == "big_model_serving":
            ok = ok and res["tokens"].shape == (4, 8) and all(
                len(out) == max(m, 1) for _, _, m, out in res["routed"])
    if not ok:
        raise AssertionError(f"{name}: result off: {engine_stats(res)}")


def launchers_phase(ops):
    """Phase 20: each launcher's ``main()`` in process, ``REPRO_SMOKE=1``,
    every kernel call held against its plain version (the scans against
    their float64 runs); launches per launcher; big_model_serving must
    launch ``LM_KERNELS``."""
    import importlib

    paths, worst = {}, {}
    empty_cache()
    torch.cuda.reset_peak_memory_stats()
    smoke = os.environ.get("REPRO_SMOKE")
    os.environ["REPRO_SMOKE"] = "1"
    try:
        for name, argv in LAUNCHERS:
            mod = importlib.import_module(f"repro_torch.launch.{name}")
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with checked_kernels(worst):
                res = mod.main(argv)
            wall = time.perf_counter() - t0
            launches = paths[f"launch {name}"] = ops.launch_counts()
            check_launcher(name, res)
            log(f"  {name} {' '.join(argv)}: {wall:.2f} s wall, launches "
                f"{launches}, stats {json.dumps(engine_stats(res))}")
            del res
            empty_cache()
    finally:
        if smoke is None:
            del os.environ["REPRO_SMOKE"]
        else:
            os.environ["REPRO_SMOKE"] = smoke
    for k in LM_KERNELS:
        if paths["launch big_model_serving"][k] == 0:
            raise AssertionError(f"big_model_serving never launched {k}")
    log(f"  each kernel call vs its plain version: {checked_line(worst)}")
    log(f"  phase 20 peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return paths


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
    means: the same ratio of margin on either side.  The plane's beta is
    an intercept fitted to wall times of up to a second, so its noise can
    take lo to 0 or below: split then beats whole(cloud) at any delay, and
    the window starts at the edge's own one-way delay instead (a cloud
    nearer than the edge is no deployment).  Returns (scale, lo, hi), lo
    the window's start and hi its end, in seconds."""
    e, c = edge_prof.model, cloud_prof.model
    half_beta = 0.5 * (e.beta - c.beta)
    lo, hi = [], []
    for n, ship in zip(ns, ship_s):
        m_hat = max(float(np.asarray(n2m.predict(float(n)))), 1.0)
        lo.append((e.alpha_n - c.alpha_n) * n + half_beta + edge_rtt_s / 2
                  + ship)
        hi.append((e.alpha_m - c.alpha_m) * m_hat + half_beta
                  + edge_rtt_s / 2 - ship)
    lo = max(float(np.mean(lo)), edge_rtt_s / 2)
    hi = float(np.mean(hi))
    if not lo < hi:
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


# --------------------------------------------------------- phases 11-12 --
def nmt_training(family, pair, ops, steps, smi):
    """``launch/train_nmt.py``'s loop for ``family`` at the paper's width on
    the pair's corpus, B=32 and max_len 48.  Checks: finite loss that
    falls (last-10 mean below first-10), the first step's loss equal to a
    CPU copy's on the same weights and batch within 1e-4 relative, no
    kernel launched while training, a checkpoint that reads back
    bitwise.  Returns (model, losses)."""
    from repro_torch.launch import train_nmt as tn
    from repro_torch.training.checkpoint import (load_checkpoint,
                                                 save_checkpoint,
                                                 state_from_jax, state_to_jax)

    model = tn.build_model(family, full_width=True, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    src, tgt = tn.corpus_tokens(pair, model.cfg)
    first = next(tn.batches(src, tgt, batch=32))
    cpu = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        cpu_loss = float(cpu.loss({k: torch.as_tensor(v)
                                   for k, v in first.items()}))
    del cpu
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, losses, step_s, tokens = tn.train(model, src, tgt, steps=steps,
                                             batch=32, log_every=50)
    train_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = 1e3 * float(np.mean(step_s[1:]))
    rate = sum(tokens[1:]) / sum(step_s[1:])
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    rel = abs(losses[0] - cpu_loss) / cpu_loss
    log(f"  {family} {pair} ({n_params / 1e6:.2f}M parameters), {steps} "
        f"AdamW steps at B=32 max_len 48: {ms:.2f}ms per step after the "
        f"first ({1e3 * step_s[0]:.1f}ms), {rate:.0f} target tokens/s, "
        f"peak memory {peak:.2f} GiB on {smi}")
    log(f"  loss first-10 mean {head:.4f} -> last-10 mean {tail:.4f}; step "
        f"0 loss {losses[0]:.6f} on the card vs {cpu_loss:.6f} on a CPU "
        f"copy (rel {rel:.2e}); kernel launches while training "
        f"{train_launches}")
    if not (np.all(np.isfinite(losses)) and tail < head):
        raise AssertionError(f"{family}: the loss did not fall ({head} -> "
                             f"{tail})")
    if rel > 1e-4:
        raise AssertionError(f"{family}: step 0 loss {losses[0]} vs CPU "
                             f"{cpu_loss}")
    if any(train_launches.values()):
        raise AssertionError(f"{family}: a kernel launched while training")
    trees = state_to_jax(model, state.params, state.opt)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        save_checkpoint(path, {"params": trees[0], "opt": trees[1]},
                        step=steps)
        back = load_checkpoint(path, {"params": trees[0], "opt": trees[1]})
    sd, opt = state_from_jax(model, back["params"], back["opt"])
    same = all(torch.equal(sd[n], p.detach())
               for n, p in state.params.items())
    same &= all(torch.equal(opt.mu[n], state.opt.mu[n]) and
                torch.equal(opt.nu[n], state.opt.nu[n]) for n in sd)
    same &= int(opt.step) == int(state.opt.step) == steps
    log(f"  checkpoint ({len(sd)} parameters and both moments, "
        f"{sum(t.numel() for t in sd.values()) * 12 / 2**20:.1f} MiB) "
        f"written and read back: bitwise equal {same}")
    if not same:
        raise AssertionError(f"{family}: checkpoint did not read back")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in first.items()}
    step_breakdown(family, lambda: model.loss(batch), state.params,
                   state.opt, tn.leaf_ndims(model))
    return model, losses


def step_breakdown(what, loss_fn, params, opt, leaf_ndim):
    """Where a train step's time goes: loss + backward, then clip + AdamW,
    each ended by a device sync (3 reps, median), and one step under
    ``torch.profiler`` for the device's kernel time and launch count.
    AdamW runs at lr 0, so the weights do not move."""
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                clip_by_global_norm)

    def halves():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(), list(params.values()))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads, _ = clip_by_global_norm(dict(zip(params, grads)), 1.0)
        adamw_update(params, grads, opt, lr=0.0, cfg=AdamWConfig(),
                     leaf_ndim=leaf_ndim)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    fb, up = np.median([halves() for _ in range(3)], axis=0) * 1e3
    busy, kernels = profiled_busy_ms(halves)
    log(f"  {what} step: loss + backward {fb:.2f}ms, clip + AdamW "
        f"{up:.2f}ms ({len(params)} parameter tensors); one profiled step: "
        f"{kernels} device kernels, {busy:.2f}ms of device time = "
        f"{100 * busy / (fb + up):.1f}% of the step")


def marian_after_training(model, ops):
    """The trained Marian: kernel-path ``forward_teacher`` (no grad) vs the
    training path on a corpus batch, the kernel guard under autograd, and
    a greedy decode of 32 corpus sources (M, the N->M correlation, the
    share that reaches max_decode_len; reported, not gated).  Returns the
    kernel launches of the two kernel paths."""
    from repro_torch.data.tokenizer import EOS_ID, PAD_ID
    from repro_torch.launch import train_nmt as tn

    src, tgt = tn.corpus_tokens("en-zh", model.cfg)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(tn.batches(src, tgt, batch=32)).items()}
    args = (batch["src"], batch["src_mask"], batch["tgt_in"])
    launches = {}
    with torch.no_grad():
        ops.reset_launch_counts()
        kern = model.forward_teacher(*args, kernels=True)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        train = model.forward_teacher(*args)
    log(f"  trained Marian, forward_teacher B=32 M={args[2].shape[1]}: "
        f"kernel path launches {launches}")
    within("kernel path vs training path logits", kern, train, MODEL_TOL)
    if launches["flash_attention"] == 0:
        raise AssertionError("the kernel path launched no flash_attention")
    try:
        with torch.enable_grad():
            model.forward_teacher(*args, kernels=True)
    except RuntimeError as e:
        log(f"  kernel path under autograd refused: {str(e)[:72]}...")
    else:
        raise AssertionError("flash_attention ran under autograd")

    # the sources as training saw them: cut to max_len - 1, then EOS
    rows = [np.concatenate([s[:tn.MAX_LEN - 1], [EOS_ID]]) for s in src[:32]]
    n = np.array([len(r) for r in rows])
    block = np.full((32, n.max()), PAD_ID, np.int32)
    for i, r in enumerate(rows):
        block[i, :len(r)] = r
    mask = (block != PAD_ID).astype(np.float32)
    translate = model.make_translate_batched()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m, _ = translate(block, mask)
    wall = time.perf_counter() - t0
    decode = ops.launch_counts()
    top = model.cfg.max_decode_len
    corr = (float(np.corrcoef(n, m)[0, 1]) if np.std(m) > 0
            else float("nan"))
    log(f"  greedy decode of 32 en-zh sources (N {n.min()}-{n.max()}, mean "
        f"{n.mean():.2f}) in {wall:.2f}s: mean M {m.mean():.2f}, N->M "
        f"correlation {corr:.4f}, {np.mean(m >= top) * 100:.1f}% reach "
        f"max_decode_len {top}; launches {decode}")
    return {k: launches[k] + decode[k] for k in launches}


def lm_training(name, ops, steps=5):
    """The LM train step (loss, grads, clip, AdamW) at full width, B=1
    S=64, ``steps`` times on one batch.  Checks: finite loss that falls,
    and ``train_logits``' last position against ``prefill``'s kernel-path
    logits (within 1e-4, or ten times the effect of a 1e-7 perturbation of
    the embeddings, phases 7-8's rule).  Returns the prefill's launches."""
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models.registry import resolve
    from repro_torch.training.losses import lm_loss
    from repro_torch.training.train_loop import (init_train_state,
                                                 leaf_ndims, make_train_step)

    r = resolve(name, size="full", device="cuda", seed=0)
    model = r.model
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    stream = rng.integers(1, r.cfg.vocab_size, 4 * 65).astype(np.int32)
    batch = next(lm_batches(stream, batch_size=1, seq_len=64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model)
    step = make_train_step(model)
    losses, times = [], []
    ops.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    train_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {name} ({n_params / 1e9:.3f}B parameters, all {r.cfg.num_layers}"
        f" layer slots), {steps} train steps at B=1 S=64: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + "; ms per step " + ", ".join(f"{1e3 * t:.1f}" for t in times)
        + f"; peak memory {peak:.2f} GiB (float32 parameters, gradients "
        f"and two moments: {16 * n_params / 2**30:.2f} GiB); kernel "
        f"launches while training {train_launches}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    if any(train_launches.values()):
        raise AssertionError(f"{name}: a kernel launched while training")
    tensors = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    step_breakdown(name, lambda: lm_loss(model, tensors)[0], state.params,
                   state.opt, leaf_ndims(model))
    toks = tensors["tokens"]
    with torch.no_grad():
        want = model.train_logits(toks)["logits"][:, -1]
        hook = perturbed(model, 1e-7)
        floor = max_err(model.train_logits(toks)["logits"][:, -1], want)
        hook.remove()
        ops.reset_launch_counts()
        got, _ = model.prefill(toks)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    err = max_err(got, want)
    limit = MODEL_TOL if err <= MODEL_TOL else 10 * floor
    log(f"  trained {name}: prefill (kernels, launches {launches}) vs "
        f"train_logits' last position max_abs_err={err:.3e}; train_logits "
        f"with the embeddings perturbed by 1e-7 {floor:.3e} (max |ref| "
        f"{float(want.abs().max()):.3f}); limit {limit:.1e}")
    if not (err <= limit and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: prefill vs train_logits {err} > "
                             f"{limit}")
    del model, r, state, step
    gc.collect()
    torch.cuda.empty_cache()
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
    n_cases = (check_kernels(fa, da, gen) + check_scan_kernels(wkv, ssd, gen)
               + check_bf16_stats_cases(da, gen))
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
    paths.update(lm_phase("rwkv6-3b", ops, ("rwkv6_wkv",)))
    log("== phase 8: zamba2-1.2b at full width through GenerationSession, "
        "CollaborativeEngine and a ContinuousGenerationSession")
    paths.update(lm_phase(
        "zamba2-1.2b", ops, ("ssd_scan", "flash_attention", "flash_decode"),
        continuous=lambda model: zamba2_continuous(model, ops)))

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

    log("== phase 13: qwen3-8b at full width through GenerationSession, "
        "CollaborativeEngine and continuous in-flight batching "
        "(run before phases 11-12, whose rwkv6-3b training would not fit "
        "beside its weights)")
    paths.update(qwen3_phase(ops))

    log("== phase 14: qwen3-moe-30b-a3b, moonshot-v1-16b-a3b and "
        "deepseek-v3-671b at full width, cut in depth, through "
        "GenerationSession, CollaborativeEngine and continuous batching")
    paths.update(moe_phase(ops))

    log("== phase 15: whisper-large-v3 at full width and depth through "
        "GenerationSession(frames=); the long_500k variants (qwen3-8b-swa's "
        "ring past position 4096, zamba2-1.2b-swa's windowed prefill)")
    paths.update(whisper_phase(ops))
    paths.update(swa_phase(ops))

    log("== phase 16: flash_decode's softmax state against its plain twin; "
        "qwen3-8b at full width through make_sharded_session on a 1x1 NCCL "
        "mesh (sequence-sharded decode)")
    log(f"  {check_stats_cases(da, gen)} stats cases within tolerance")
    paths.update(sharded_phase(ops))

    log("== phase 17: qwen3-8b at full width, 4 of 36 layers: sharded "
        "training on a 1x1 NCCL mesh vs unsharded, the dry-run's bytes, "
        "serving the trained sharded model")
    paths.update(sharded_training_phase(ops))

    log("== phase 18: qwen3-8b, qwen3-moe-30b-a3b and moonshot-v1-16b-a3b "
        "in bfloat16 at full depth on one card; zamba2-1.2b, rwkv6-3b and "
        "whisper-large-v3 in bfloat16")
    paths.update(bf16_phase(ops))

    log("== phase 19: bfloat16 on the 1x1 NCCL mesh: qwen3-8b and "
        "qwen3-moe-30b-a3b served whole; bf16 training (the 1x1 mesh and "
        "remat bitwise, the dry run's bytes within 1%, rwkv6-3b, zamba2-1.2b "
        "and qwen3-8b at depth)")
    paths.update(phase19(ops))

    log("== phase 20: the examples' six launchers (repro_torch.launch), "
        "REPRO_SMOKE=1: the BiLSTM at --scale 1.0, qwen3-8b and rwkv6-3b at "
        "--size full, every kernel call checked")
    paths.update(launchers_phase(ops))

    log("== phase 11: training the paper's three NMT models at full width")
    model, _ = nmt_training("marian", "en-zh", ops, 200, smi)
    paths["train marian"] = marian_after_training(model, ops)
    del model
    for family, pair in (("bilstm", "de-en"), ("gru", "fr-en")):
        nmt_training(family, pair, ops, 50, smi)
    gc.collect()
    torch.cuda.empty_cache()

    log("== phase 12: the LM train step at full width")
    for name in ("zamba2-1.2b", "rwkv6-3b"):
        paths[f"train {name}"] = lm_training(name, ops)
    mtp_training(ops)

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
