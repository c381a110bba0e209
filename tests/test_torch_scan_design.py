"""The two scan kernels' designs, rehearsed on the CPU.

The CUDA kernels cannot run here, so these tests hold the arithmetic
their designs rest on against the plain versions:

* the block plans (``ssd_plan`` / ``ssd_tiles`` and ``wkv_plan``) give
  every (head, value column) of every sequence to exactly one block, and
  give a block per two SMs (``MIN_BLOCKS``) wherever the shape has that
  many, with more than one block per (sequence, head) at the serving
  shape;
* the value-tiled decomposition: each block (one head, a tile of value
  columns) runs its chunks in order with its own state tile, on 16-row tiles whose rows past L are zero, and computes
  the chunk's shared part (the scores, the prefix sums) for itself.
  Emulated in float32 it reproduces ``ssd_scan_plain`` /
  ``rwkv6_wkv_plain`` within 1e-6 of the output's scale, at the chunk
  lengths prefill meets (1 for a prime prompt length), with and without
  an initial state, under every value tile;
* the kernels' products as 3 x TF32: each operand split into hi (rounded
  to TF32, nearest with ties away from zero, as ``cvt.rna.tf32.f32``) and
  lo = x - hi (truncated to TF32, as the tensor core reads it), lo.hi +
  hi.lo + hi.hi accumulated in float32.  That holds the kernels'
  tolerances (2e-4 for rwkv6, 3e-4 for ssd, those of
  ``tests/test_kernels.py``) at rwkv6-3b's and zamba2-1.2b's shapes,
  where one TF32 product does not.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6_wkv as wkv
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.layers.mamba2 import pick_chunk
from _torch_threads import cap_threads

cap_threads()

WKV_TOL, SSD_TOL = 2e-4, 3e-4
# (heads, head size, state size, model chunk): full width and smoke
SSD_MODELS = {"zamba2-1.2b": (64, 64, 64, 128),
              "zamba2-1.2b-smoke": (16, 32, 16, 8)}
WKV_MODELS = {"rwkv6-3b": (40, 64), "rwkv6-3b-smoke": (8, 32)}


# ------------------------------------------------------------ block plans --
def _block(i, h, p, pt):
    """(sequence, head, value columns) of block i (the plans' docstrings)."""
    j = i % (p // pt)
    return i // (h * (p // pt)), i // (p // pt) % h, slice(pt * j, pt * (j + 1))


@pytest.mark.parametrize("model", sorted(SSD_MODELS))
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("s", [37, 64, 2048])
def test_ssd_plans_cover_every_head_and_column_once(model, b, s):
    h, p, n, model_chunk = SSD_MODELS[model]
    chunk = pick_chunk(s, model_chunk)
    chosen = ssd.ssd_plan(b, h, p, n, chunk)
    tiles = ssd.ssd_tiles(p, n, chunk)
    assert chosen in tiles
    for pt in tiles:
        covered = np.zeros((b, h, p), np.int64)
        for i in range(b * h * (p // pt)):
            seq, head, cols = _block(i, h, p, pt)
            covered[seq, head, cols] += 1
        assert (covered == 1).all(), pt
    if b * h * (p // 16) >= ssd.MIN_BLOCKS:   # the shape has the blocks
        assert b * h * (p // chosen) >= ssd.MIN_BLOCKS
    assert ssd._smem_bytes(chosen, n, chunk) <= ssd._SMEM_LIMIT


@pytest.mark.parametrize("model", sorted(WKV_MODELS))
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("s", [37, 64, 2048])
def test_wkv_plans_cover_every_head_and_column_once(model, b, s):
    h, p = WKV_MODELS[model]
    chosen = wkv.wkv_plan(b, h, p)
    tiles = [pt for pt in wkv.P_TILES if p % pt == 0]
    assert chosen in tiles
    for pt in tiles:
        covered = np.zeros((b, h, p), np.int64)
        for i in range(b * h * (p // pt)):
            seq, head, cols = _block(i, h, p, pt)
            covered[seq, head, cols] += 1
        assert (covered == 1).all(), pt
    if b * h * (p // 16) >= wkv.MIN_BLOCKS:
        assert b * h * (p // chosen) >= wkv.MIN_BLOCKS


def test_serving_shape_splits_every_head_over_blocks():
    """At B=1, S=64 both kernels cut each head's value columns over more
    than one block: zamba2-1.2b (64 heads) and rwkv6-3b (40 heads)."""
    assert ssd.ssd_plan(1, 64, 64, 64, 64) < 64
    assert wkv.wkv_plan(1, 40, 64) < 64


# ------------------------------------------------- the blocks, emulated --
def tf32_rna(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def tf32_trunc(x):
    """How the TF32 tensor core reads a float32: low 13 bits ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def product(passes):
    """a @ b as the kernels form it: exactly in float32 (None), or three
    TF32 passes lo.hi + hi.lo + hi.hi, or one TF32 pass hi.hi."""
    def mm(a, b):
        if passes is None:
            return a @ b
        ah, bh = tf32_rna(a), tf32_rna(b)
        if passes == 1:
            return ah @ bh
        return tf32_trunc(a - ah) @ bh + ah @ tf32_trunc(b - bh) + ah @ bh
    return mm


def _rows16(t, chunk):
    """A chunk's (L, ...) tile as the kernels stage it: 16-row tiles, the
    rows past L zero."""
    rows = -(-chunk // 16) * 16
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def ssd_blocks(x, dt, a_log, b_in, c_in, s0, chunk, p_tile, passes=None):
    """ssd_scan as the kernel's blocks compute it: per block (one head, a
    tile of value columns), per chunk, the scores C B^T, the float64
    prefix sums, decay and mask over 16-row tiles, then y and the block's
    state tile.  Unwritten outputs stay NaN."""
    mm = product(passes)
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    y = torch.full((bsz, s, h, p), float("nan"))
    s_out = torch.full((bsz, h, p, n), float("nan"))
    a = -torch.exp(a_log.float())
    t = torch.arange(-(-chunk // 16) * 16)
    live = t < chunk
    causal = (t[None, :] <= t[:, None]) & live[:, None]
    for i in range(bsz * h * (p // p_tile)):
        seq, hh, cols = _block(i, h, p, p_tile)
        state = (s0[seq, hh, cols].T.clone() if s0 is not None
                 else torch.zeros((n, p_tile)))
        for c0 in range(0, s, chunk):
            c_t, b_t = (_rows16(z[seq, c0:c0 + chunk, hh], chunk)
                        for z in (c_in, b_in))
            x_t = _rows16(x[seq, c0:c0 + chunk, hh, cols], chunk)
            d = _rows16(dt[seq, c0:c0 + chunk, hh], chunk)
            cum = torch.cumsum((d[:chunk] * a[hh]).double(), 0)
            total = cum[-1]
            cum = torch.cat([cum, total.repeat(len(t) - chunk)])
            seg = (cum[:, None] - cum[None, :]).float()
            decay = torch.exp(torch.where(causal, seg, 0.0))
            scores = torch.where(causal, mm(c_t, b_t.T) * decay * d[None, :],
                                 0.0)
            e_cum = torch.where(live, torch.exp(cum.float()), 0.0)
            w = torch.where(live, torch.exp((total - cum).float()), 0.0)
            y_t = mm(c_t, state) * e_cum[:, None] + mm(scores, x_t)
            state = (state * torch.exp(total.float())
                     + mm((b_t * (w * d)[:, None]).T, x_t))
            y[seq, c0:c0 + chunk, hh, cols] = y_t[:chunk]
        s_out[seq, hh, cols] = state.T
    return y, s_out


def wkv_blocks(r, k, v, log_w, u, s0, chunk, p_tile, passes=None):
    """rwkv6_wkv as the kernel's blocks compute it: per block (one head, a
    tile of value columns), per chunk, the prefix sums, r', k', the state
    weights and A = r' k'^T over all P channels, masked to j < t < L on
    16-row tiles, then y (with the bonus) and the block's state tile."""
    mm = product(passes)
    bsz, s, h, p = r.shape
    y = torch.full((bsz, s, h, p), float("nan"))
    s_out = torch.full((bsz, h, p, p), float("nan"))
    t = torch.arange(-(-chunk // 16) * 16)
    lower = (t[None, :] < t[:, None]) & (t[:, None] < chunk)
    for i in range(bsz * h * (p // p_tile)):
        seq, hh, cols = _block(i, h, p, p_tile)
        state = (s0[seq, hh][:, cols].clone() if s0 is not None
                 else torch.zeros((p, p_tile)))
        for c0 in range(0, s, chunk):
            r_t, k_t, lw = (_rows16(z[seq, c0:c0 + chunk, hh], chunk)
                            for z in (r, k, log_w))
            v_t = _rows16(v[seq, c0:c0 + chunk, hh, cols], chunk)
            cum = torch.cumsum(lw, 0)
            r_dec = r_t * torch.exp(cum - lw)
            k_inc = k_t * torch.exp(-cum)
            k_w = k_t * torch.exp(cum[chunk - 1] - cum)
            a_t = torch.where(lower, mm(r_dec, k_inc.T), 0.0)
            bonus = (r_t * u[hh] * k_t).sum(-1)
            y_t = mm(a_t, v_t) + mm(r_dec, state) + bonus[:, None] * v_t
            state = (state * torch.exp(cum[chunk - 1])[:, None]
                     + mm(k_w.T, v_t))
            y[seq, c0:c0 + chunk, hh, cols] = y_t[:chunk]
        s_out[seq, hh][:, cols] = state
    return y, s_out


def _ssd_inputs(seed, b, s, h, p, n, with_s0, shared_bc=True):
    """zamba2-shaped operands as chip_smoke.py draws them: dt after
    softplus, the model's a_log, one B/C group expanded over the heads."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.as_tensor(rng.standard_normal(shape)
                                       .astype(np.float32))
    x, dt = f(b, s, h, p), torch.nn.functional.softplus(f(b, s, h))
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    if shared_bc:
        bc = f(b, s, 2 * n)
        b_in = bc[..., None, :n].expand(b, s, h, n)
        c_in = bc[..., None, n:].expand(b, s, h, n)
    else:
        b_in, c_in = f(b, s, h, n), f(b, s, h, n)
    return x, dt, a_log, b_in, c_in, f(b, h, p, n) if with_s0 else None


def _wkv_inputs(seed, b, s, h, p, with_s0):
    """rwkv6-shaped operands; log w clamped as the model clamps it."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.as_tensor(rng.standard_normal(shape)
                                       .astype(np.float32))
    r, k, v = f(b, s, h, p), f(b, s, h, p), f(b, s, h, p)
    log_w = -torch.clamp(torch.exp(f(b, s, h, p)), 1e-4, 2.5)
    return r, k, v, log_w, 0.5 * f(h, p), f(b, h, p, p) if with_s0 else None


def _assert_within_scale(got, want, tol):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()          # every output written
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=tol, atol=tol * scale)


_SSD_CASES = [(s, chunk, pt) for s, chunk in ((37, 1), (74, 37), (128, 64),
                                              (256, 128))
              for pt in ssd.ssd_tiles(64, 64, chunk)]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk,p_tile", _SSD_CASES)
def test_ssd_value_tiled_blocks_give_the_plain_version(with_s0, s, chunk,
                                                       p_tile):
    args = _ssd_inputs(1, 1, s, 8, 64, 64, with_s0)
    _assert_within_scale(ssd_blocks(*args, chunk, p_tile),
                         ssd.ssd_scan_plain(*args, chunk=chunk), 1e-6)


@pytest.mark.parametrize("b,s,h,p,n,chunk,shared_bc", [
    (1, 64, 64, 64, 64, 64, True),     # zamba2-1.2b at the serving shape
    (2, 16, 16, 32, 16, 8, True),      # zamba2-1.2b smoke
    (2, 74, 3, 32, 8, 37, False),      # per-head B/C
])
def test_ssd_default_plan_gives_the_plain_version(b, s, h, p, n, chunk,
                                                  shared_bc):
    args = _ssd_inputs(2, b, s, h, p, n, True, shared_bc)
    _assert_within_scale(ssd_blocks(*args, chunk,
                                    ssd.ssd_plan(b, h, p, n, chunk)),
                         ssd.ssd_scan_plain(*args, chunk=chunk), 1e-6)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", [(37, 1), (49, 7), (64, 32)])
@pytest.mark.parametrize("p_tile", wkv.P_TILES)
def test_wkv_value_tiled_blocks_give_the_plain_version(with_s0, s, chunk,
                                                       p_tile):
    args = _wkv_inputs(3, 1, s, 3, 64, with_s0)
    _assert_within_scale(wkv_blocks(*args, chunk, p_tile),
                         wkv.rwkv6_wkv_plain(*args, chunk=chunk), 1e-6)


@pytest.mark.parametrize("b,s,h,p,chunk", [
    (1, 64, 40, 64, 32),               # rwkv6-3b at the serving shape
    (2, 16, 8, 32, 8),                 # rwkv6-3b smoke
])
def test_wkv_default_plan_gives_the_plain_version(b, s, h, p, chunk):
    args = _wkv_inputs(4, b, s, h, p, True)
    _assert_within_scale(wkv_blocks(*args, chunk, wkv.wkv_plan(b, h, p)),
                         wkv.rwkv6_wkv_plain(*args, chunk=chunk), 1e-6)


# -------------------------------------------------------------- 3 x TF32 --
def test_3xtf32_holds_the_wkv_tolerance_where_1xtf32_does_not():
    """rwkv6-3b: B=1, S=128, 40 heads of 64, chunk 32."""
    args = _wkv_inputs(5, 1, 128, 40, 64, False)
    want = wkv.rwkv6_wkv_plain(*args, chunk=32)
    pt = wkv.wkv_plan(1, 40, 64)
    errs = {passes: max(float((g - w).abs().max()) for g, w in zip(
        wkv_blocks(*args, 32, pt, passes=passes), want)) for passes in (3, 1)}
    assert errs[3] <= WKV_TOL / 4, errs
    assert errs[1] > 10 * WKV_TOL, errs


def test_3xtf32_holds_the_ssd_tolerance_where_1xtf32_does_not():
    """zamba2-1.2b: B=1, S=256, 64 heads, P = N = 64, chunk 128."""
    args = _ssd_inputs(6, 1, 256, 64, 64, 64, False)
    want = ssd.ssd_scan_plain(*args, chunk=128)
    pt = ssd.ssd_plan(1, 64, 64, 64, 128)
    errs = {passes: max(float((g - w).abs().max()) for g, w in zip(
        ssd_blocks(*args, 128, pt, passes=passes), want))
        for passes in (3, 1)}
    assert errs[3] <= SSD_TOL / 4, errs
    assert errs[1] > 10 * SSD_TOL, errs
