"""The two scan kernels' designs, rehearsed on the CPU.

The CUDA kernels cannot run here, so these tests hold the arithmetic
their designs rest on against the plain versions:

* the mma.sync ``ssd_scan`` kernel's block plan (``ssd_plan`` /
  ``ssd_tiles``) gives every (head, value column) of every sequence to
  exactly one block, and gives a block per two SMs (``MIN_BLOCKS``)
  wherever the shape has that many, with more than one block per
  (sequence, head) at the serving shape (as the ``rwkv6_wkv`` kernel's
  ``cores_tile`` does);
* that kernel's value-tiled decomposition: each block (one head, a tile
  of value columns) runs its chunks in order with its own state tile, on
  16-row tiles whose rows past L are zero, and computes the chunk's
  shared part (the scores, the prefix sums) for itself.  Emulated in
  float32 it reproduces ``ssd_scan_plain`` within 1e-6 of the output's
  scale, at the chunk lengths prefill meets (1 for a prime prompt
  length), with and without an initial state, under every value tile;
* the products as 3 x TF32: each operand split into hi (rounded to TF32,
  nearest with ties away from zero, as ``cvt.rna.tf32.f32``) and lo = x -
  hi (truncated to TF32, as the tensor core reads it), lo.hi + hi.lo +
  hi.hi accumulated in float32.  That holds ssd's tolerance (3e-4, that
  of ``tests/test_kernels.py``) at zamba2-1.2b's shape, where one TF32
  product does not;
* the Hopper kernels, emulated: the wgmma ``ssd_scan`` kernel (blocks of
  64 steps whatever the caller's chunk, each tile split into TF32 hi/lo
  once, 3 x TF32 products, exp2 of float64 differences) and the CUDA-core
  ``rwkv6_wkv`` kernel (groups of 16 steps, the recurrence in float32
  with one exponential a step, every head size it takes), each within the
  card's tolerance (3e-4 / 2e-4) of the plain version at the caller's
  chunk, with and without an initial state; ``ssd_path`` follows the
  shape alone.
"""

import math

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


def test_serving_shape_splits_every_head_over_blocks():
    """At B=1, S=64 both kernels cut each head's value columns over more
    than one block: zamba2-1.2b (64 heads) on the mma.sync kernel's plan
    and rwkv6-3b (40 heads) on the CUDA-core kernel's fixed tile."""
    assert ssd.ssd_plan(1, 64, 64, 64, 64) < 64
    assert wkv.cores_tile(64) < 64


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


# -------------------------------------------------------------- 3 x TF32 --
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


# ------------------------------------------- the Hopper kernels, emulated --
def _abs_err(got, want):
    for g in got:
        assert torch.isfinite(g).all()          # every output written
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def ssd_ws_blocks(x, dt, a_log, b_in, c_in, s0):
    """ssd_scan as the wgmma kernel computes it, whatever the caller's
    chunk: per (b, h), blocks of ``WGMMA_STEPS`` steps (the last one
    ragged, its rows past S zero), every product 3 x TF32 with each tile
    split once (x^T, B and the state in shared memory, C, the weighted
    scores and (B w)^T in registers), the float64 prefix sums kept as cum
    log2(e) and every exponential an exp2 of one float64 difference
    rounded to float32, y summed on e^{cum_t} C S, the state seeded with
    e^{cum_L} S.  Unwritten outputs stay NaN."""
    mm = product(3)
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    kl = ssd.WGMMA_STEPS
    y = torch.full((bsz, s, h, p), float("nan"))
    s_out = torch.full((bsz, h, p, n), float("nan"))
    a = -torch.exp(a_log.float())
    t = torch.arange(kl)
    for seq in range(bsz):
        for hh in range(h):
            state = (s0[seq, hh].clone() if s0 is not None
                     else torch.zeros((p, n)))                 # [p][n]
            for t0 in range(0, s, kl):
                live = min(kl, s - t0)
                pad = lambda z: torch.cat(
                    [z, z.new_zeros((kl - live,) + z.shape[1:])])
                xt, bt, ct = (pad(z[seq, t0:t0 + live, hh])
                              for z in (x, b_in, c_in))
                d = pad(dt[seq, t0:t0 + live, hh])
                cum = torch.cumsum((d * a[hh]).double(), 0) * math.log2(math.e)
                wgt = torch.exp2((cum[-1] - cum).float()) * d
                causal = (t[None, :] <= t[:, None]) & (t[:, None] < live)
                seg = torch.where(causal, cum[:, None] - cum[None, :], 0.0)
                w = torch.where(causal, mm(ct, bt.T) * torch.exp2(seg.float())
                                * d[None, :], 0.0)
                y_t = mm(ct, state.T) * torch.exp2(cum.float())[:, None]
                y_t = y_t + mm(w, xt)
                state = (state * torch.exp2(cum[-1].float())
                         + mm(xt.T, bt * wgt[:, None]))
                y[seq, t0:t0 + live, hh] = y_t[:live]
            s_out[seq, hh] = state
    return y, s_out


def wkv_cores_blocks(r, k, v, log_w, u, s0):
    """rwkv6_wkv as the CUDA-core kernel computes it, whatever the
    caller's chunk: per block (one head, ``cores_tile`` value columns),
    groups of ``CORES_STEPS`` steps (the last one ragged, its rows past S
    zero), the transform (r' = r / e^{-cum_{t-1}}, k' = k e^{-cum_t}, one
    exponential a step, e^{cum_L}, the bonus r . u k) and then the steps
    in float32: y_t = r'_t . S^ + bonus_t v_t, S^ += k'_t v_t^T, and S =
    diag(e^{cum_L}) S^ after the group.  Unwritten outputs stay NaN."""
    bsz, s, h, p = r.shape
    kl, qt = wkv.CORES_STEPS, wkv.cores_tile(p)
    y = torch.full((bsz, s, h, p), float("nan"))
    s_out = torch.full((bsz, h, p, p), float("nan"))
    for i in range(bsz * h * (p // qt)):
        seq, hh, cols = _block(i, h, p, qt)
        sh = (s0[seq, hh][:, cols].clone() if s0 is not None
              else torch.zeros((p, qt)))
        for t0 in range(0, s, kl):
            live = min(kl, s - t0)
            rt, kt, lw = (z[seq, t0:t0 + live, hh] for z in (r, k, log_w))
            vt = v[seq, t0:t0 + live, hh, cols]
            run, e_prev = torch.zeros(p), torch.ones(p)
            rp, kp = torch.empty_like(rt), torch.empty_like(kt)
            for j in range(live):
                run = run + lw[j]
                e_neg = torch.exp(-run)
                rp[j], kp[j] = rt[j] / e_prev, kt[j] * e_neg
                e_prev = e_neg
            bonus = (rt * u[hh] * kt).sum(-1)
            for j in range(live):
                y[seq, t0 + j, hh, cols] = rp[j] @ sh + bonus[j] * vt[j]
                sh = sh + kp[j][:, None] * vt[j][None, :]
            sh = sh * torch.exp(run)[:, None]
        s_out[seq, hh][:, cols] = sh
    return y, s_out


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", [(37, 1), (74, 37), (128, 64),
                                     (256, 128), (131, 1), (64, 64),
                                     (192, 64), (100, 50), (130, 65),
                                     (300, 100)])
def test_ssd_wgmma_blocks_give_the_plain_version(with_s0, s, chunk):
    """Blocks of 64 steps held to the plain version at the caller's chunk:
    a prime prompt (chunk 1, one ragged block; 131: two whole blocks and a
    3-step one), chunks that are no multiple of 64 (37, 50, 65, 100),
    zamba2's 64 and 128, one whole block and three."""
    args = _ssd_inputs(7, 1, s, 2, 64, 64, with_s0)
    err = _abs_err(ssd_ws_blocks(*args), ssd.ssd_scan_plain(*args,
                                                           chunk=chunk))
    assert err <= SSD_TOL, err


@pytest.mark.parametrize("with_s0", [False, True])
def test_ssd_wgmma_blocks_per_head_b_c(with_s0):
    """B/C given per head (no shared group) go through the same blocks."""
    args = _ssd_inputs(8, 2, 100, 3, 64, 64, with_s0, shared_bc=False)
    err = _abs_err(ssd_ws_blocks(*args), ssd.ssd_scan_plain(*args, chunk=50))
    assert err <= SSD_TOL, err


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", [(37, 1), (49, 7), (64, 32), (53, 1),
                                     (17, 1), (96, 32)])
@pytest.mark.parametrize("p", wkv.HEAD_SIZES)
def test_wkv_cores_blocks_give_the_plain_version(with_s0, s, chunk, p):
    """Groups of 16 steps held to the plain version at the caller's chunk
    (1 for a prime prompt, 7, rwkv6's 32), every head size the kernel
    takes, the last group ragged (37, 49, 53, 17) or whole (64, 96)."""
    args = _wkv_inputs(9, 1, s, 2, p, with_s0)
    err = _abs_err(wkv_cores_blocks(*args),
                   wkv.rwkv6_wkv_plain(*args, chunk=chunk))
    assert err <= WKV_TOL, err


def _wkv_exact(r, k, v, log_w, u, s0):
    """The WKV6 recurrence step by step in float64: y_t = r_t . (S +
    diag(u) k_t v_t^T), S <- diag(w_t) S + k_t v_t^T."""
    r, k, v, log_w, u = (z.double() for z in (r, k, v, log_w, u))
    bsz, s, h, p = r.shape
    state = (torch.zeros((bsz, h, p, p), dtype=torch.float64)
             if s0 is None else s0.double())
    ys = []
    for t in range(s):
        kv = torch.einsum("bhp,bhq->bhpq", k[:, t], v[:, t])
        ys.append(torch.einsum("bhp,bhpq->bhq", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = state * torch.exp(log_w[:, t])[..., None] + kv
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("b,s,h,p,chunk", [
    (1, 128, 40, 64, 32),              # rwkv6-3b, four chunks of 32
    (1, 64, 40, 64, 32),               # rwkv6-3b at the serving shape
    (1, 37, 40, 64, 1),                # rwkv6-3b, a prime prompt
    (2, 16, 8, 32, 8),                 # rwkv6-3b smoke
    (2, 37, 8, 32, 1),                 # rwkv6-3b smoke, a prime prompt
])
def test_wkv_cores_blocks_at_the_model_shapes(with_s0, b, s, h, p, chunk):
    """The CUDA-core kernel's blocks at rwkv6-3b's and its smoke
    configuration's heads, every sequence of the batch, held to the exact
    recurrence (float64) at the card's tolerance.  Exact, not the plain
    version: at 40 heads |y| reaches ~90, where the float32 plain version
    at chunk 32 is itself up to 2.3e-4 from the exact recurrence (seed 10,
    S=64; the emulated kernel 3e-5).  ``chunk`` is the one prefill picks;
    the kernel's groups do not depend on it."""
    args = _wkv_inputs(10, b, s, h, p, with_s0)
    err = _abs_err(wkv_cores_blocks(*args), _wkv_exact(*args))
    assert err <= WKV_TOL, (err, chunk)


@pytest.mark.parametrize("b,s", [(1, 37), (1, 64), (8, 64), (2, 2048)])
@pytest.mark.parametrize("model", sorted(SSD_MODELS))
def test_ssd_path_is_a_function_of_the_shape(b, s, model):
    """ssd_path names a kernel that takes the shape: the wgmma kernel at
    zamba2-1.2b's P = N = 64, the mma.sync kernel at its smoke widths."""
    h, p, n, model_chunk = SSD_MODELS[model]
    chunk = pick_chunk(s, model_chunk)
    path = ssd.ssd_path(p, n, chunk)
    assert path in ssd.ssd_paths(p, n, chunk)
    assert path == ("wgmma" if (p, n) in ssd.WGMMA_SHAPES else "mma")
