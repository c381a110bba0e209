"""The two attention kernels' designs, rehearsed on the CPU.

The CUDA kernels cannot run here, so these tests hold the arithmetic
their designs rest on against the plain versions:

* ``flash_decode``'s split plan (``decode_splits``) and its split-and-
  combine: partial (m, l, acc) states over the planned slot ranges,
  merged by ``combine_splits_plain`` (the plain twin of the kernel's
  combine pass), give ``flash_decode_plain`` within 1e-6, with a sliding
  window too (splits wholly before the window start are empty);
* ``flash_attention``'s float32 products as 3 x TF32: each operand split
  into hi (rounded to TF32, nearest with ties away from zero, as
  ``cvt.rna.tf32.f32``) and lo = x - hi (truncated to TF32, as the
  tensor core reads it), lo.hi + hi.lo + hi.hi accumulated in float32.
  That holds the 2e-5 float32 tolerance of ``tests/test_kernels.py`` at
  Marian's and zamba2's shapes, where one TF32 product does not.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from _torch_threads import cap_threads

cap_threads()

F32_TOL = 2e-5


# ------------------------------------------------------------ split plan --
@pytest.mark.parametrize("b", [1, 2, 8, 64])
@pytest.mark.parametrize("hkv", [1, 8, 32])
@pytest.mark.parametrize("s", [1, 7, 40, 64, 256, 300, 2048, 4096])
def test_decode_splits_cover_every_slot_once(b, hkv, s):
    n_split, chunk = da.decode_splits(b, hkv, s)
    assert n_split >= 1
    if n_split > 1:
        assert chunk >= da.MIN_SPLIT_SLOTS
        # about SPLIT_WAVES blocks per SM, no more
        assert n_split * b * hkv <= da.SPLIT_WAVES * fa.SMS
    covered = np.zeros(s, np.int64)
    for i in range(n_split):
        lo, hi = i * chunk, min((i + 1) * chunk, s)
        assert lo < hi                      # no split lies past the cache
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # a plain function of (B * Hkv, S): the lengths never enter it
    assert da.decode_splits(hkv, b, s) == (n_split, chunk)


def _partials(q, k_cache, v_cache, lengths, scale, window=0):
    """Per-split (m, l, acc) over the planned slot ranges, in plain torch,
    as the split kernel forms them: slots [w_lo, min(len, S)) with w_lo =
    len - window under a window, every slot masked when that range is
    empty.  An empty split (past the prefix or wholly before the window
    start) carries m = -inf, l = 0 and an accumulator of NaN (unwritten
    scratch)."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    n_split, chunk = da.decode_splits(b, hkv, s)
    m = torch.full((b, h, n_split), float("-inf"))
    l = torch.zeros((b, h, n_split))
    acc = torch.full((b, h, n_split, d), float("nan"))
    for bi in range(b):
        length = int(lengths[bi])
        w_lo = max(0, length - window) if window else 0
        masked = length <= 0 or w_lo >= min(length, s)
        n_slots = s if masked else min(length, s)
        for i in range(n_split):
            lo = max(i * chunk, 0 if masked else w_lo)
            hi = min((i + 1) * chunk, n_slots)
            if lo >= hi:
                continue
            kk = k_cache[bi, lo:hi].float().repeat_interleave(rep, dim=1)
            vv = v_cache[bi, lo:hi].float().repeat_interleave(rep, dim=1)
            sc = torch.einsum("hd,thd->ht", q[bi].float(), kk) * scale
            if masked:
                sc = torch.full_like(sc, da.NEG_INF)
            mx = sc.amax(-1)
            p = torch.exp(sc - mx[:, None])
            m[bi, :, i], l[bi, :, i] = mx, p.sum(-1)
            acc[bi, :, i] = torch.einsum("ht,thd->hd", p, vv)
    return m, l, acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,lens", [
    (1, 256, 8, 8, 64, (128,)),              # Marian B=1 mid-decode
    (1, 2048, 8, 8, 64, (1,)),               # 31 empty splits
    (1, 2048, 8, 8, 64, (33,)),
    (1, 2048, 8, 8, 64, (2047,)),
    (2, 256, 32, 8, 64, (200, 17)),          # GQA rep = 4
    (3, 256, 8, 8, 32, (0, 100, 256)),       # length 0 beside split rows
    (2, 96, 32, 2, 16, (96, 5)),             # rep = 16
])
def test_split_and_combine_gives_the_plain_version(dtype, b, t, h, hkv, d,
                                                   lens):
    rng = np.random.default_rng(0)
    q, kc, vc = (torch.as_tensor(rng.standard_normal(shape, np.float32))
                 .to(dtype) for shape in ((b, h, d), (b, t, hkv, d),
                                          (b, t, hkv, d)))
    lengths = torch.tensor(lens, dtype=torch.int32)
    scale = d ** -0.5
    got = da.combine_splits_plain(*_partials(q, kc, vc, lengths, scale))
    # the plain version on the same (bf16-valued) numbers, in float32
    want = da.flash_decode_plain(q.float(), kc.float(), vc.float(), lengths)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if dtype == torch.bfloat16:   # and the kernel's final cast
        torch.testing.assert_close(
            got.to(dtype).float(),
            da.flash_decode_plain(q, kc, vc, lengths).float(),
            rtol=2 ** -8, atol=2 ** -8)


@pytest.mark.parametrize("b,t,h,hkv,d,lens,window", [
    (1, 2048, 8, 8, 64, (2047,), 64),        # 31 splits before the start
    (2, 256, 32, 8, 64, (200, 17), 1),       # one slot each
    (3, 256, 8, 8, 32, (0, 100, 256), 300),  # a window wider than the cache
    (2, 512, 8, 8, 64, (600, 513), 16),      # past the cache: no valid slot
                                             # in row 0, 15 in row 1
    (1, 4200, 8, 8, 64, (4150,), 4096),      # qwen3-8b-swa's linear check
])
def test_split_and_combine_with_a_window_gives_the_plain_version(
        b, t, h, hkv, d, lens, window):
    rng = np.random.default_rng(2)
    q, kc, vc = (torch.as_tensor(rng.standard_normal(shape, np.float32))
                 for shape in ((b, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    lengths = torch.tensor(lens, dtype=torch.int32)
    m, l, acc = _partials(q, kc, vc, lengths, d ** -0.5, window)
    n_split, chunk = da.decode_splits(b, hkv, t)
    # some split lies wholly before the window start: it carries nothing
    if window < max(lens) - chunk:
        assert bool((l == 0).any())
    got = da.combine_splits_plain(m, l, acc)
    want = da.flash_decode_plain(q, kc, vc, lengths, window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- 3 x TF32 --
def tf32_rna(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """How the TF32 tensor core reads a float32: low 13 bits ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a, b, passes):
    """a @ b as the kernel forms it: 3 passes lo.hi + hi.lo + hi.hi, or
    one TF32 pass hi.hi, accumulated in float32."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_trunc(a - ah), tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def attention_tf32(q, k, v, *, causal, passes):
    """flash_attention_plain's function (all keys valid, rep = 1) with its
    two products taken as TF32 products; (B,S,H,D) in and out."""
    d, s, t = q.shape[-1], q.shape[1], k.shape[1]
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    scores = tf32_matmul(qh, kh.transpose(-1, -2), passes) * d ** -0.5
    if causal:
        mask = torch.arange(t)[None, :] <= torch.arange(s)[:, None]
        scores = scores.masked_fill(~mask, fa.NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return tf32_matmul(w, vh, passes).permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,s,h,causal,heads_per_pass", [
    (2, 512, 8, False, 8),      # Marian encoder bucket, B cut from 8
    (1, 2048, 32, True, 2),     # zamba2-1.2b shared attention, B cut from 8
])
def test_3xtf32_holds_the_float32_tolerance_where_1xtf32_does_not(
        b, s, h, causal, heads_per_pass):
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.standard_normal((b, s, h, 64), np.float32))
               for _ in range(3))
    err = {1: 0.0, 3: 0.0}
    for h0 in range(0, h, heads_per_pass):    # head slices bound the memory
        sl = slice(h0, h0 + heads_per_pass)
        want = fa.flash_attention_plain(q[:, :, sl], k[:, :, sl],
                                        v[:, :, sl], causal=causal)
        for passes in err:
            got = attention_tf32(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                 causal=causal, passes=passes)
            err[passes] = max(err[passes], float((got - want).abs().max()))
    assert err[3] <= F32_TOL, err
    assert err[1] > F32_TOL, err
