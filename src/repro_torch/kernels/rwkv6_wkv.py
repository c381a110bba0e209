"""RWKV6 chunked WKV: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/rwkv6_wkv.py`` (the Pallas TPU kernel
``rwkv6_wkv``).  The kernel itself is ``csrc/rwkv6_wkv.cu``: the
recurrence step by step on the CUDA cores in float32, fed by a ring of
TMA loads; its header says what bounds it on the H100, what was tried
and lost, and what it leaves for later.

Semantics, shared by the kernel and :func:`rwkv6_wkv_plain`:

* r/k/v/log_w (B,S,H,P) float32, log_w <= 0; u (H,P); s0 (B,H,P,P) or
  None (zero state) -> (y (B,S,H,P) float32, s_final (B,H,P,P) float32);
* the sequence is cut into S / chunk chunks (``S % chunk == 0``, as the
  reference asserts); within a chunk the per-channel decay factorizes
  through r e^{cum_{t-1}} and k e^{-cum}, which stays finite only for a
  chunk of at most 32 steps under the caller's ``|log w| <= 2.5`` clamp
  (the wrapper refuses longer chunks).  The recurrence composes exactly
  over any blocking of the steps, so the kernel runs groups of its own
  (:data:`CORES_STEPS`, the last one ragged, whatever the caller's chunk)
  and is held to the plain version at the caller's chunk.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

DEFAULT_CHUNK = 32
MAX_CHUNK = 32        # e^{2.5 * 32} < float32 max: the chunk bound of the clamp
HEAD_SIZES = (16, 32, 64, 128)   # head sizes the kernel takes
CORES_STEPS = 16                  # its steps per group (one ring slot)


def cores_tile(p: int) -> int:
    """Value columns per block of the kernel (``cores::qt`` in the .cu):
    block i of its ``b * h * p / cores_tile(p)`` owns columns ``[t * j,
    t * (j + 1))`` of head ``i // (p / t) % h`` of sequence ``i // (h * p
    / t)``, with ``t = cores_tile(p)`` and ``j = i % (p / t)``, and runs
    every step of that sequence in groups of :data:`CORES_STEPS`."""
    return min(32, p)


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
                    chunk: int = DEFAULT_CHUNK, dtype=torch.float32):
    """Plain PyTorch version of the kernel: the same chunked algorithm
    (the reference's ``_wkv_kernel``) in torch ops, batched over (B, H).

    ``dtype`` is the type the algorithm runs in: float32 as the kernel's
    reference; float64 gives the exact recurrence to hold both to.  ``y``
    comes back in ``r``'s dtype, the state in ``dtype``."""
    _check_shapes(r, k, v, log_w, u, s0, chunk)
    b, s, h, p = r.shape
    state = (torch.zeros((b, h, p, p), dtype=dtype, device=r.device)
             if s0 is None else s0.to(dtype))
    uf = u.to(dtype)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    ys = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, lw = (x[:, c0:c0 + chunk].to(dtype)
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
    rows 16-byte aligned.  Builds the kernel library at first use.
    """
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
        x = named[name]   # the kernel loads rows through TMA tensor maps
        if x.data_ptr() % 16 or any(st % 4 for st in x.stride()[:3]):
            raise ValueError(f"{name} rows are not 16-byte aligned")
    u = u.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, p, p), dtype=torch.float32, device=r.device)
    lib = _build.load_library()
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
            s_out.data_ptr())
    strides = (*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *log_w.stride()[:3], *y.stride()[:3])
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.repro_rwkv6_wkv(*ptrs, b, s, h, p, *strides, stream)
    _build.check(rc, "rwkv6_wkv")
    return y, s_out
