"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/ssd_scan.py`` (the Pallas TPU kernel
``ssd_scan``).  The kernels themselves are in ``csrc/ssd_scan.cu``: a
warp-specialised ``wgmma`` kernel fed by TMA (zamba2's P = N = 64; blocks
of 64 steps, the last one ragged, whatever the caller's chunk) and the
``mma.sync`` kernel it grew from (value-tiled blocks at the caller's
chunk), both 3 x TF32; its header says what bounds them on the H100 and
what they leave for later.  :func:`ssd_path` picks the kernel and
:func:`ssd_plan` the ``mma.sync`` kernel's value tile, both on the host
from the shape alone.

Semantics, shared by the kernel and :func:`ssd_scan_plain`:

* x (B,S,H,P), dt (B,S,H) post-softplus, a_log (H,) with
  A = -exp(a_log), b_in/c_in (B,S,H,N), s0 (B,H,P,N) or None (zero
  state) -> (y (B,S,H,P) float32, s_final (B,H,P,N) float32);
* the sequence is cut into S / chunk chunks (``S % chunk == 0``, as the
  reference asserts).  The scan is linear with a scalar decay, so any
  blocking of the steps composes exactly: the wgmma kernel runs blocks
  of its own (:data:`WGMMA_STEPS`) and is held to the plain version at
  the caller's chunk.  The state is (P,N) at this API, as in the
  reference's.
* B/C may arrive expanded over the heads (a head stride of 0, one
  group): the kernel reads them in place.
* the prefix sums of the log decay are taken in float64 (the reference
  takes them in float32): at a chunk of 128 with A down to -16 they reach
  about -1400, where a float32 ulp of cum_t - cum_j is already the whole
  3e-4 tolerance of the scores.  Everything else is float32.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import SMS

DEFAULT_CHUNK = 64
# a plan needs this many blocks to count as filling the card: one per two
# SMs (at B=1, S=64, fewer wider blocks beat 132 narrow ones, PERF.md)
MIN_BLOCKS = SMS // 2
_SMEM_LIMIT = 232448     # bytes of shared memory one H100 block may use
P_TILES = (64, 32, 16)   # value columns per block the kernel is built for
WGMMA_SHAPES = ((64, 64),)   # the (P, N) the wgmma kernel is built for
WGMMA_STEPS = 64             # its steps per block: one warpgroup's rows


def _smem_bytes(pt: int, n: int, chunk: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the .cu)."""
    lr = -(-chunk // 16) * 16
    stage = lr * (pt + 4) + 2 * lr * (n + 4) + lr
    return 8 * lr + 4 * (2 * stage + n * (pt + 8) + 2 * lr + 1)


@functools.lru_cache(maxsize=256)
def ssd_tiles(p: int, n: int, chunk: int) -> tuple:
    """Every value tile (``p_tile``) the kernel takes for this shape,
    widest first: the tile divides P and its shared memory fits."""
    return tuple(pt for pt in P_TILES if p % pt == 0
                 and _smem_bytes(pt, n, chunk) <= _SMEM_LIMIT)


@functools.lru_cache(maxsize=256)
def ssd_plan(b: int, h: int, p: int, n: int, chunk: int) -> int:
    """Value columns per block (``p_tile``) of the kernel's grid of
    ``b * h * p / p_tile`` blocks: block i owns value columns
    ``[p_tile * j, p_tile * (j + 1))`` of head ``i // (p / p_tile) % h``
    of sequence ``i // (h * p / p_tile)``, with ``j = i % (p / p_tile)``.
    Among :func:`ssd_tiles`, the widest (the least recomputed scores and
    prefix sums) that still gives :data:`MIN_BLOCKS` blocks, else the
    narrowest (the most blocks).  A plain function of the shape."""
    tiles = ssd_tiles(p, n, chunk)
    if not tiles:
        raise ValueError(f"P={p} N={n} chunk={chunk}: no value tile fits "
                         f"(P must be a multiple of 16, N of 8, and the "
                         f"tiles {_SMEM_LIMIT} bytes of shared memory)")
    for pt in tiles:
        if b * h * (p // pt) >= MIN_BLOCKS:
            return pt
    return tiles[-1]


def ssd_paths(p: int, n: int, chunk: int) -> tuple:
    """Every kernel that takes this shape: ``"wgmma"`` at the (P, N) of
    :data:`WGMMA_SHAPES`, ``"mma"`` where a value tile fits."""
    return tuple(path for path, ok in (
        ("wgmma", (p, n) in WGMMA_SHAPES),
        ("mma", bool(ssd_tiles(p, n, chunk)))) if ok)


def ssd_path(p: int, n: int, chunk: int) -> str:
    """The kernel for a call, a plain function of the shape: the wgmma
    kernel wherever it has the (P, N) (chip_smoke.py phase 6 times both
    kernels at every scan shape; it won at each, from B=1 S=37 to B=8
    S=2048), else the mma.sync kernel."""
    paths = ssd_paths(p, n, chunk)
    if not paths:
        raise ValueError(f"P={p} N={n} chunk={chunk}: no kernel takes it "
                         f"(P must be a multiple of 16, N of 8, and the "
                         f"tiles {_SMEM_LIMIT} bytes of shared memory)")
    return paths[0]


def _check_shapes(x, dt, a_log, b_in, c_in, s0, chunk):
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if dt.shape != (bsz, s, h):
        raise ValueError(f"dt must be ({bsz}, {s}, {h}), got {tuple(dt.shape)}")
    if a_log.shape != (h,):
        raise ValueError(f"a_log must be ({h},), got {tuple(a_log.shape)}")
    for name, t in (("b_in", b_in), ("c_in", c_in)):
        if t.shape != (bsz, s, h, n):
            raise ValueError(f"{name} must be ({bsz}, {s}, {h}, {n}), "
                             f"got {tuple(t.shape)}")
    if s0 is not None and s0.shape != (bsz, h, p, n):
        raise ValueError(f"s0 must be ({bsz}, {h}, {p}, {n}), "
                         f"got {tuple(s0.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")


def ssd_scan_plain(x, dt, a_log, b_in, c_in, s0=None, *,
                   chunk: int = DEFAULT_CHUNK, dtype=torch.float32):
    """Plain PyTorch version of the kernel: the same chunked algorithm
    (the reference's ``_ssd_kernel``) in torch ops, batched over (B, H).

    ``dtype`` is the type the algorithm runs in (the prefix sums are
    float64 either way): float32 as the kernel's reference; float64 gives
    the exact recurrence to hold both to.  ``y`` comes back in ``x``'s
    dtype, the state in ``dtype``."""
    _check_shapes(x, dt, a_log, b_in, c_in, s0, chunk)
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    a = -torch.exp(a_log.to(dtype))
    log_decay = (dt.to(dtype) * a).double()                    # (B,S,H)
    state = (torch.zeros((bsz, h, p, n), dtype=dtype,
                         device=x.device) if s0 is None else s0.to(dtype))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        xc, bc, cc = (t[:, sl].to(dtype) for t in (x, b_in, c_in))
        dtc, ld = dt[:, sl].to(dtype), log_decay[:, sl]         # (B,L,H)
        cum = torch.cumsum(ld, dim=1)                           # float64
        cb = torch.einsum("blhn,bmhn->bhlm", cc, bc)
        seg = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        seg = torch.where(tri, seg.to(dtype), torch.full((), float("-inf"),
                                                         device=x.device))
        scores = cb * torch.exp(seg) * dtc.permute(0, 2, 1)[:, :, None, :]
        y = (torch.einsum("bhlm,bmhp->blhp", scores, xc)
             + torch.einsum("blhn,bhpn,blh->blhp", cc, state,
                            torch.exp(cum.to(dtype))))
        wj = torch.exp((cum[:, -1:] - cum).to(dtype)) * dtc
        hc = torch.einsum("blh,blhn,blhp->bhpn", wj, bc, xc)
        state = state * torch.exp(cum[:, -1].to(dtype))[:, :, None, None] + hc
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), state


def ssd_scan_cuda(x, dt, a_log, b_in, c_in, s0=None, *,
                  chunk: int = DEFAULT_CHUNK):
    """Launch ``csrc/ssd_scan.cu`` on PyTorch's current stream.

    Takes float32 CUDA tensors only and raises on anything the kernels
    do not take; (B,S,H,·) inputs are read through their strides, with
    x, b_in and c_in rows 16-byte aligned.  :func:`ssd_path` picks the
    kernel and :func:`ssd_plan` the mma.sync kernel's value tile from the
    shape.  Builds the kernel library at first use.
    """
    return _launch(x, dt, a_log, b_in, c_in, s0, chunk)


def _launch(x, dt, a_log, b_in, c_in, s0, chunk, p_tile=None, path=None):
    """:func:`ssd_scan_cuda` with its kernel forced to ``path`` (one of
    :func:`ssd_paths`; None: :func:`ssd_path`'s) and the mma.sync
    kernel's value tile to ``p_tile`` (one of :func:`ssd_tiles`; None:
    :func:`ssd_plan`'s), so every path and tile can be checked on the
    card."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {x.device}")
    _check_shapes(x, dt, a_log, b_in, c_in, s0, chunk)
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    if p % 16 or n % 8:
        raise ValueError(f"P={p} must be a multiple of 16 and N={n} of 8")
    named = {"x": x, "dt": dt, "a_log": a_log, "b_in": b_in, "c_in": c_in}
    if s0 is not None:
        named["s0"] = s0
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected float32")
    for name in ("x", "b_in", "c_in"):
        t = named[name]
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
        # the kernel stages rows with 16-byte copies
        if t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:3]):
            raise ValueError(f"{name} rows are not 16-byte aligned")
    if path is None:
        path = "mma" if p_tile is not None else ssd_path(p, n, chunk)
    if path not in ssd_paths(p, n, chunk) or (path == "wgmma"
                                              and p_tile is not None):
        raise ValueError(f"path {path!r} does not take P={p} N={n} "
                         f"chunk={chunk} (p_tile={p_tile})")
    if path == "mma":
        if p_tile is None:
            p_tile = ssd_plan(bsz, h, p, n, chunk)
        elif p_tile not in ssd_tiles(p, n, chunk):
            raise ValueError(f"p_tile {p_tile} does not fit P={p} N={n} "
                             f"chunk={chunk}")
    a_log = a_log.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    s_out = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    ptrs = (x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), None if s0 is None else s0.data_ptr(),
            y.data_ptr(), s_out.data_ptr())
    strides = (*x.stride()[:3], *dt.stride(), *b_in.stride()[:3],
               *c_in.stride()[:3], *y.stride()[:3])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if path == "wgmma":
        rc = lib.repro_ssd_scan_ws(*ptrs, bsz, s, h, p, n, *strides, stream)
    else:
        rc = lib.repro_ssd_scan(*ptrs, bsz, s, h, p, n, chunk, p_tile,
                                *strides, stream)
    _build.check(rc, "ssd_scan")
    return y, s_out
