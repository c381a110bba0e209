"""Device time of the float32 ``flash_decode`` kernel at the main paths'
shapes, for the package under a given source root.

    python3 scripts/flash_decode_before_after.py OLD/src
    python3 scripts/flash_decode_before_after.py src

Run on a machine with a CUDA card; each run builds the kernels of its
own tree.  To compare two versions, unpack the older commit with ``git
archive`` into a directory ``.gitignore`` lists and run both in one
session on one card, in turns (old, new, new, old): times from
different sessions or cards do not compare.  The shapes are Marian's
decode step (B=8 and B=1, 256 slots, 128 valid, 8 heads of 64),
qwen3-8b's and qwen3-moe-30b-a3b's slot-table step (B=8, 256 slots,
ragged; 32 query heads over 8 and 4 KV heads of 128), whisper's cross
decode (B=4, 1500 frames, 20 heads of 64) and qwen3-8b-swa's ring (B=1,
4096 slots); where the tree's kernel returns the softmax state, the
qwen3-8b call with ``return_stats=True`` too.
"""

import inspect
import os
import sys

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

from repro_torch.kernels import decode_attention as da  # noqa: E402

# the timer is chip_smoke.py's; the package imported above (from
# ``sys.argv[1]``) stays the one measured
sys.path.insert(1, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke as c  # noqa: E402


def main():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    stats = "return_stats" in inspect.signature(
        da.flash_decode_cuda).parameters
    out = []
    for b, t, h, hkv, d, lens in (
            (8, 256, 8, 8, 64, (128,) * 8),
            (1, 256, 8, 8, 64, (128,)),
            (8, 256, 32, 8, 128, c.QW_LENS),
            (8, 256, 32, 4, 128, c.QW_LENS),
            (4, 1500, 20, 20, 64, c.WH_LENS),
            (1, 4096, 32, 8, 128, (4096,))):
        q, kc, vc = rn(b, h, d), rn(b, t, hkv, d), rn(b, t, hkv, d)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ms = c.device_ms(lambda: da.flash_decode_cuda(q, kc, vc, lengths))
        out.append(f"B={b} T={t} H={h}/{hkv} D={d}: {ms:.5f}")
        if stats and (h, hkv, d) == (32, 8, 128) and t == 256:
            ms = c.device_ms(lambda: da.flash_decode_cuda(
                q, kc, vc, lengths, return_stats=True))
            out.append(f"  return_stats: {ms:.5f}")
    print(sys.argv[1], " | ".join(out), flush=True)


if __name__ == "__main__":
    main()
