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
  Marian's and zamba2's shapes, where one TF32 product does not;
* the plans that choose between the kernels' paths (``attention_plan``,
  ``decode_path`` / ``head_tile``): every flattened query row and every
  query head is covered exactly once, and the split counters a call
  needs fit its region;
* ``flash_decode``'s in-kernel combine (the last block folds the splits
  in split order) equals ``combine_splits_plain``; its tensor-core path
  as 3 x TF32 holds 2e-5 over qwen3-8b-swa's 4150-slot cache where one
  TF32 product does not; the wgmma kernel's bf16 P.V as P_hi.V + P_lo.V
  at 128-key tiles holds the 2e-2 bf16 tolerance.
"""

import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from _torch_threads import cap_threads

cap_threads()

F32_TOL = 2e-5
BF16_TOL = 2e-2


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


# ------------------------------------------------------------ path plans --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (1, 20, 8, 8, 64), (8, 64, 8, 8, 64), (8, 512, 8, 8, 64),
    (1, 37, 32, 32, 64), (8, 2048, 32, 32, 64), (8, 64, 32, 8, 128),
    (8, 64, 32, 4, 128), (8, 64, 16, 16, 128), (4, 1500, 20, 20, 64),
    (4, 16, 20, 20, 64), (1, 4200, 32, 8, 128), (2, 77, 6, 2, 32),
    (1, 45, 2, 2, 16), (2, 100, 12, 4, 64),
])
def test_attention_plan_covers_every_query_row_once(dtype, b, s, h, hkv, d):
    path, tile = fa.attention_plan(b, s, h, hkv, d, dtype)
    assert (path, tile) == fa.attention_plan(b, s, h, hkv, d, dtype)
    rows = s * (h // hkv)
    if path == "wgmma":
        assert d in fa.WGMMA_HEAD_DIMS and tile == fa.wgmma_rows(d, dtype)
        assert 4 * rows >= 3 * -(-rows // tile) * tile     # 3/4 filled
        assert -(-rows // tile) * b * hkv >= fa.WGMMA_MIN_BLOCKS
    else:
        assert path == "mma" and tile in fa.BLOCK_Q
    covered = np.zeros(rows, np.int64)
    for blk in range(-(-rows // tile)):      # grid.x; every (b, kv head) alike
        covered[blk * tile:min((blk + 1) * tile, rows)] += 1
    assert (covered == 1).all()
    # each flattened row f is (position f // rep, head g * rep + f % rep)
    rep = h // hkv
    pairs = {(f // rep, f % rep) for f in range(rows)}
    assert len(pairs) == rows == s * rep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 5, 8, 12, 16, 17, 32])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_decode_head_tiles_cover_every_head_once(dtype, rep, d):
    path = da.decode_path(rep, d, dtype)
    assert path == ("mma" if d in da.MMA_HEAD_DIMS
                    and (dtype == torch.bfloat16 or rep >= da.MMA_MIN_REP_F32)
                    else "cores")
    for p in ("mma", "cores") if d in da.MMA_HEAD_DIMS else ("cores",):
        tile, groups = da.head_tile(rep, p), da.head_groups(rep, p)
        covered = np.zeros(rep, np.int64)
        for grp in range(groups):             # the kernel's h0, nh
            h0 = grp * tile
            nh = min(tile, rep - h0)
            assert nh >= 1
            covered[h0:h0 + nh] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("b", [1, 8, 33, 132, 256])
@pytest.mark.parametrize("hkv", [1, 8, 20, 32])
def test_split_counters_fit_every_grid_the_plan_makes(b, hkv):
    for s, rep in itertools.product((16, 256, 4200, 1 << 16),
                                    (1, 4, 8, 16, 64)):
        n_split, _ = da.decode_splits(b, hkv, s)
        if n_split == 1:
            continue                          # no counter is read
        for path in ("mma", "cores"):
            assert b * hkv * da.head_groups(rep, path) <= da.REGION_COUNTERS


# ------------------------------------------------- the in-kernel combine --
def combine_in_kernel_order(m, l, acc):
    """The last block's combine of one head, as the kernel runs it on a
    warp: the largest live m, then per 32 splits the weights' normaliser
    summed by a shuffle butterfly (lane 0's order) and each split's
    accumulator folded in split order with one rounding (fmaf)."""
    m, l, acc = (np.asarray(x, np.float32) for x in (m, l, acc))
    n = len(m)
    live = l > 0
    mx = np.float32(m[live].max()) if live.any() else np.float32(-np.inf)
    total = np.float32(0)
    a = np.zeros(acc.shape[-1], np.float32)
    for i0 in range(0, n, 32):
        w = np.zeros(32, np.float32)
        lw = np.zeros(32, np.float32)
        for lane in range(min(32, n - i0)):
            i = i0 + lane
            if live[i]:
                w[lane] = np.exp(m[i] - mx, dtype=np.float32)
                lw[lane] = l[i] * w[lane]
        for o in (16, 8, 4, 2, 1):            # __shfl_xor_sync butterfly
            lw = (lw + lw[np.arange(32) ^ o]).astype(np.float32)
        total = np.float32(total + lw[0])
        for j in range(min(32, n - i0)):
            if w[j] > 0:
                a = (acc[i0 + j].astype(np.float64) * np.float64(w[j])
                     + a).astype(np.float32)
    return a / np.float32(max(total, np.float32(1e-30)))


@pytest.mark.parametrize("b,t,h,hkv,d,lens,window", [
    (1, 2048, 8, 8, 64, (2047,), 0),         # 31 splits
    (1, 2048, 8, 8, 64, (33,), 0),           # every split but two empty
    (2, 256, 32, 8, 128, (200, 17), 0),
    (3, 256, 8, 8, 32, (0, 100, 256), 0),    # length 0: masked, all live
    (1, 4200, 8, 8, 64, (4150,), 4096),      # splits before the window
])
def test_in_kernel_combine_in_split_order_equals_the_plain_combine(
        b, t, h, hkv, d, lens, window):
    rng = np.random.default_rng(3)
    q, kc, vc = (torch.as_tensor(rng.standard_normal(shape, np.float32))
                 for shape in ((b, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    lengths = torch.tensor(lens, dtype=torch.int32)
    m, l, acc = _partials(q, kc, vc, lengths, d ** -0.5, window)
    want = da.combine_splits_plain(m, l, acc)
    got = torch.stack([torch.stack([
        torch.as_tensor(combine_in_kernel_order(m[bi, hi], l[bi, hi],
                                                acc[bi, hi].nan_to_num()))
        for hi in range(h)]) for bi in range(b)])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        got, da.flash_decode_plain(q, kc, vc, lengths, window=window),
        rtol=1e-6, atol=1e-6)


# --------------------------------------- 3 x TF32 decode, bf16 P hi + lo --
def decode_tf32(q, kc, vc, lengths, window, passes):
    """flash_decode's tensor-core path over the planned splits: q.K^T and
    P.V as TF32 products (``passes`` 3 or 1), each split's (m, l, acc),
    then the split-order combine.  GQA: the group's heads are the rows."""
    b, h, d = q.shape
    t, hkv = kc.shape[1], kc.shape[2]
    rep = h // hkv
    n_split, chunk = da.decode_splits(b, hkv, t)
    out = torch.empty(b, h, d)
    for bi in range(b):
        length = int(lengths[bi])
        lo0 = max(0, length - window) if window else 0
        for g in range(hkv):
            qg = q[bi, g * rep:(g + 1) * rep]
            ms, ls, accs = [], [], []
            for i in range(n_split):
                lo, hi = max(i * chunk, lo0), min((i + 1) * chunk, length, t)
                if lo >= hi:
                    ms.append(float("-inf"))
                    ls.append(0.0)
                    accs.append(torch.zeros(rep, d))
                    continue
                sc = tf32_matmul(qg, kc[bi, lo:hi, g].T, passes) * d ** -0.5
                mx = sc.amax(-1, keepdim=True)
                p = torch.exp(sc - mx)
                ms.append(mx[:, 0])
                ls.append(p.sum(-1))
                accs.append(tf32_matmul(p, vc[bi, lo:hi, g], passes))
            m = torch.stack([torch.as_tensor(x).expand(rep) for x in ms], -1)
            l = torch.stack([torch.as_tensor(x).expand(rep) for x in ls], -1)
            out[bi, g * rep:(g + 1) * rep] = da.combine_splits_plain(
                m, l, torch.stack(accs, 1))
    return out


def test_3xtf32_decode_holds_the_float32_tolerance_where_1xtf32_does_not():
    # qwen3-8b-swa's linear-window decode: 4150 slots, window 4096
    rng = np.random.default_rng(4)
    q, kc, vc = (torch.as_tensor(rng.standard_normal(shape, np.float32))
                 for shape in ((1, 32, 128), (1, 4200, 8, 128),
                               (1, 4200, 8, 128)))
    lengths = torch.tensor([4150], dtype=torch.int32)
    want = da.flash_decode_plain(q, kc, vc, lengths, window=4096)
    err = {p: float((decode_tf32(q, kc, vc, lengths, 4096, p)
                     - want).abs().max()) for p in (1, 3)}
    assert err[3] <= F32_TOL, err
    assert err[1] > F32_TOL, err


def bf16(x):
    return x.to(torch.bfloat16).float()


def attention_bf16_tiles(q, k, v, *, causal, tile=128, lo_half=True):
    """The wgmma kernel's bf16 path (rep = 1, all keys valid): per tile of
    ``tile`` keys, scores exact in float32 from bf16 operands, the online
    softmax in base 2, P split into bf16 hi + lo (or hi alone) against
    bf16 V, O rescaled and summed in float32; (B,S,H,D) float32 out."""
    b, s, h, d = q.shape
    t = k.shape[1]
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    c = d ** -0.5 * 1.4426950408889634
    m = torch.full((b, h, s, 1), fa.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, d)
    for t0 in range(0, t, tile):
        sc = (qh @ kh[:, :, t0:t0 + tile].transpose(-1, -2)) * c
        if causal:
            keep = (torch.arange(t0, min(t0 + tile, t))[None, :]
                    <= torch.arange(s)[:, None])
            sc = sc.masked_fill(~keep, fa.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        ph = bf16(p)
        pv = ph @ vh[:, :, t0:t0 + tile]
        if lo_half:
            pv = pv + bf16(p - ph) @ vh[:, :, t0:t0 + tile]
        o = alpha * o + pv
        m = m_new
    return (o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,s,h,d,causal", [
    (1, 1500, 2, 64, False),     # whisper's encoder, 2 of its 20 heads
    (2, 300, 4, 128, True),      # a D=128 causal prefill
])
def test_bf16_p_hi_plus_lo_at_128_key_tiles_holds_the_bf16_tolerance(
        b, s, h, d, causal):
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal((b, s, h, d), np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    exact = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal)
    hilo = attention_bf16_tiles(q, k, v, causal=causal)
    hi = attention_bf16_tiles(q, k, v, causal=causal, lo_half=False)
    err = float((hilo.to(torch.bfloat16).float() - want.float()).abs().max())
    assert err <= BF16_TOL, err
    # before the output's own rounding: the lo half keeps P to ~16 bits
    e_hilo = float((hilo - exact).abs().max())
    e_hi = float((hi - exact).abs().max())
    assert e_hilo < e_hi / 8, (e_hilo, e_hi)
