"""Device time of the float32 ``flash_attention`` kernel at the main
paths' shapes, for the package under a given source root, and its error
against a float64 reference at S = 4200.

    python3 scripts/flash_attention_before_after.py OLD/src
    python3 scripts/flash_attention_before_after.py src

Run on a machine with a CUDA card; each run builds the kernels of its
own tree.  To compare two versions, unpack the older commit with ``git
archive`` into a directory ``.gitignore`` lists and run both in one
session on one card, in turns (old, new, new, old): times from
different sessions or cards do not compare.  The shapes are Marian's
encoder (B=8, S=64 and 512), zamba2-1.2b's long prefill, qwen3-8b's
admission wave (D=128), whisper-large-v3's encoder and qwen3-8b-swa's
4200-token prefill.
"""

import os
import sys

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402

# the timer and the float64 reference are chip_smoke.py's; the package
# imported above (from ``sys.argv[1]``) stays the one measured
sys.path.insert(1, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as c  # noqa: E402


def main():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    out = []
    for b, s, h, hkv, d, causal in ((8, 64, 8, 8, 64, False),
                                    (8, 512, 8, 8, 64, False),
                                    (8, 2048, 32, 32, 64, True),
                                    (8, 64, 32, 8, 128, True),
                                    (4, 1500, 20, 20, 64, False),
                                    (1, 4200, 32, 8, 128, True)):
        q, k, v = rn(b, s, h, d), rn(b, s, hkv, d), rn(b, s, hkv, d)
        ms = c.device_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                         causal=causal),
                         per_graph=5 if b * s > 1024 else 50)
        out.append(f"B={b} S={s} H={h}/{hkv} D={d} causal={causal}: "
                   f"{ms:.5f}")
    # accuracy at 4200 keys with peaky scores (q, k scaled by 3)
    q, k, v = 3 * rn(1, 4200, 32, 128), 3 * rn(1, 4200, 8, 128), \
        rn(1, 4200, 8, 128)
    ref = c.float64_attention(q, k, v, None)
    err = lambda t: float((t.double() - ref).abs().max())
    out.append(f"S=4200 scaled q,k: kernel vs float64 "
               f"{err(fa.flash_attention_cuda(q, k, v, causal=True)):.3e}, "
               f"plain vs float64 "
               f"{err(fa.flash_attention_plain(q, k, v, causal=True)):.3e}")
    print(sys.argv[1], " | ".join(out), flush=True)


if __name__ == "__main__":
    main()
