"""RWKV6 chunked WKV: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/rwkv6_wkv.py`` (the Pallas TPU kernel
``rwkv6_wkv``).  The kernel itself is ``csrc/rwkv6_wkv.cu`` (value-tiled
blocks, 3 x TF32 tensor-core products, pipelined chunk loads); its
header says what bounds it on the H100 and what it leaves for later.
:func:`wkv_plan` is its host-side block plan.

Semantics, shared by the kernel and :func:`rwkv6_wkv_plain`:

* r/k/v/log_w (B,S,H,P) float32, log_w <= 0; u (H,P); s0 (B,H,P,P) or
  None (zero state) -> (y (B,S,H,P) float32, s_final (B,H,P,P) float32);
* the sequence is cut into S / chunk chunks (``S % chunk == 0``, as the
  reference asserts); within a chunk the per-channel decay factorizes
  through r e^{cum_{t-1}} and k e^{-cum}, which stays finite only for a
  chunk of at most 32 steps under the caller's ``|log w| <= 2.5`` clamp
  (the kernel refuses longer chunks).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import SMS

DEFAULT_CHUNK = 32
MAX_CHUNK = 32        # e^{2.5 * 32} < float32 max: the chunk bound of the clamp
HEAD_SIZES = (16, 32, 64, 128)   # head sizes the kernel takes
P_TILES = (64, 32, 16)           # value columns per block it is built for
# a plan needs this many blocks to count as filling the card: one per two
# SMs (at B=1, S=64, fewer wider blocks beat 132 narrow ones, PERF.md)
MIN_BLOCKS = SMS // 2


@functools.lru_cache(maxsize=256)
def wkv_plan(b: int, h: int, p: int) -> int:
    """Value columns per block (``p_tile``) of the kernel's grid of
    ``b * h * p / p_tile`` blocks: block i owns value columns
    ``[p_tile * j, p_tile * (j + 1))`` of head ``i // (p / p_tile) % h``
    of sequence ``i // (h * p / p_tile)``, with ``j = i % (p / p_tile)``.
    The widest tile (the least recomputed prefix sums and scores) that
    still gives :data:`MIN_BLOCKS` blocks, else the narrowest (the most
    blocks).  A plain function of the shape."""
    tiles = [pt for pt in P_TILES if p % pt == 0]
    for pt in tiles:
        if b * h * (p // pt) >= MIN_BLOCKS:
            return pt
    return tiles[-1]


def _check_shapes(r, k, v, log_w, u, s0, chunk):
    b, s, h, p = r.shape
    for name, x in (("k", k), ("v", v), ("log_w", log_w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != r {tuple(r.shape)}")
    if u.shape != (h, p):
        raise ValueError(f"u must be ({h}, {p}), got {tuple(u.shape)}")
    if s0 is not None and s0.shape != (b, h, p, p):
        raise ValueError(f"s0 must be ({b}, {h}, {p}, {p}), "
                         f"got {tuple(s0.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")


def rwkv6_wkv_plain(r, k, v, log_w, u, s0=None, *,
                    chunk: int = DEFAULT_CHUNK):
    """Plain PyTorch version of the kernel: the same chunked algorithm
    (the reference's ``_wkv_kernel``) in torch ops, batched over (B, H)."""
    _check_shapes(r, k, v, log_w, u, s0, chunk)
    b, s, h, p = r.shape
    state = (torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    uf = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    ys = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, lw = (x[:, c0:c0 + chunk].float()
                          for x in (r, k, v, log_w))            # (B,L,H,P)
        cum = torch.cumsum(lw, dim=1)
        r_dec = rc * torch.exp(cum - lw)
        k_inc = kc * torch.exp(-cum)
        a = torch.einsum("blhp,bmhp->bhlm", r_dec, k_inc)
        a = torch.where(tri, a, torch.zeros((), device=r.device))
        bonus = torch.einsum("blhp,hp,blhp->blh", rc, uf, kc)
        y = (torch.einsum("bhlm,bmhp->blhp", a, vc) + bonus[..., None] * vc
             + torch.einsum("blhp,bhpq->blhq", r_dec, state))
        wj = torch.exp(cum[:, -1:] - cum)
        inc = torch.einsum("blhp,blhq->bhpq", kc * wj, vc)
        state = state * torch.exp(cum[:, -1])[..., None] + inc
        ys.append(y)
    return torch.cat(ys, dim=1).to(r.dtype), state


def rwkv6_wkv_cuda(r, k, v, log_w, u, s0=None, *,
                   chunk: int = DEFAULT_CHUNK):
    """Launch ``csrc/rwkv6_wkv.cu`` on PyTorch's current stream.

    Takes float32 CUDA tensors only and raises on anything the kernel
    does not take; (B,S,H,P) inputs are read through their strides, with
    rows 16-byte aligned.  :func:`wkv_plan` picks the value columns per
    block from the shape.  Builds the kernel library at first use.
    """
    return _launch(r, k, v, log_w, u, s0, chunk, None)


def _launch(r, k, v, log_w, u, s0, chunk, p_tile):
    """:func:`rwkv6_wkv_cuda` with its value tile forced to ``p_tile`` (one
    of :data:`P_TILES` dividing P; None: :func:`wkv_plan`'s), so every
    tile can be checked on the card."""
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv_cuda needs CUDA tensors, got {r.device}")
    _check_shapes(r, k, v, log_w, u, s0, chunk)
    b, s, h, p = r.shape
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}: e^(2.5 L) "
                         "overflows float32 past 32 steps")
    if p not in HEAD_SIZES:
        raise ValueError(f"head size {p} not in {HEAD_SIZES}")
    named = {"r": r, "k": k, "v": v, "log_w": log_w, "u": u}
    if s0 is not None:
        named["s0"] = s0
    for name, x in named.items():
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, expected {r.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {x.dtype}, expected float32")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
    for name in ("r", "k", "v", "log_w"):
        x = named[name]   # the kernel stages rows with 16-byte copies
        if x.data_ptr() % 16 or any(st % 4 for st in x.stride()[:3]):
            raise ValueError(f"{name} rows are not 16-byte aligned")
    if p_tile is None:
        p_tile = wkv_plan(b, h, p)
    elif p_tile not in P_TILES or p % p_tile:
        raise ValueError(f"p_tile {p_tile} not in {P_TILES} or does not "
                         f"divide {p}")
    u = u.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, p, p), dtype=torch.float32, device=r.device)
    lib = _build.load_library()
    rc = lib.repro_rwkv6_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_out.data_ptr(), b, s, h, p, chunk, p_tile,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *log_w.stride()[:3], *y.stride()[:3],
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, "rwkv6_wkv")
    return y, s_out
