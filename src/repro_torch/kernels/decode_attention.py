"""Flash decode: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/decode_attention.py`` (the Pallas TPU kernel
``flash_decode``).  The kernel itself is ``csrc/decode_attention.cu``:
one launch a call, split-KV (the cache is cut into :func:`decode_splits`
ranges, one block each), the splits' partial softmax states combined in
split order by the last block of each head group, which it learns from a
counter (:func:`split_counters`); a kv head's query heads run as the
rows of tensor-core tiles or on the CUDA cores, as :func:`decode_path`
chooses.  Its header says what bounds it on the H100 and what it leaves
for later.  :func:`combine_splits_plain` is the plain twin of its
combine.

Semantics, shared by the kernel and :func:`flash_decode_plain`: one query
token per sequence, q (B,H,D), against caches (B,S,Hkv,D) over the valid
prefix ``slot < lengths[b]``; softmax in float32; the output is
``acc / max(l, 1e-30)`` in q's dtype (float32 or bfloat16).  Masked
scores are -1e30, so a row with no valid slot (length <= 0) averages
over every slot, as the TPU kernel does; callers clamp lengths to >= 1.
``window`` (None or 0 means none) also masks the slots below ``lengths -
window``: with ``lengths = pos + 1`` the reference LM's linear-cache
window ``idx > pos - window``, which the TPU kernel does not take (the
reference computes windowed decode in jnp; the port's LM runs it here).

The split counters (:func:`split_counters`) are one zeroed buffer per
device, allocated at the first call there, which must not be inside a
CUDA graph capture: the step graphs' warm-up on their capture stream
(``repro_torch.runtime.graphs``) makes that call.  A captured call keeps
the address of its capture stream's counter region, and a graph replays
with that region on whatever stream it is launched: replays and eager
calls of one process run one after another on one stream, and only that
single-threaded, one-stream use is supported.

The caches may be strided views: the Marian decoder passes its folded
(B,T,H*D) buffers as ``view(B,T,H,D)``, and the kernel reads them through
their strides, with no per-step transpose or copy.

``return_stats=True`` also returns each (b, h) row's softmax state in
float32: the score maximum ``m`` and the normaliser ``l = sum exp(s -
m)`` over the slots the softmax ran over (a row with no valid slot: m =
-1e30 and l its slot count).  Outputs over disjoint slices of one cache
merge into the whole cache's output with :func:`merge_decode_stats`,
which is what the sequence-sharded decode computes with collectives
(``models/layers/attention.attn_decode_seq_sharded``; the reference's
``pmax`` / ``psum`` merge).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    _DTYPES,
    HEAD_DIMS,
    SMS,
    _check_operands,
    _lengths_i32,
    _window,
)

NEG_INF = -1e30
MIN_SPLIT_SLOTS = 32   # a split reads at least this many slots
SPLIT_WAVES = 2        # aim: this many blocks per SM over B * Hkv * splits
MMA_HEAD_DIMS = (64, 128)   # head dims of the tensor-core path
MMA_HEADS = 16         # tensor-core path: query heads a block (one mma tile)
CORE_HEADS = 8         # CUDA-core path: at most this many heads a block
# the plan's threshold: grouped heads per kv head from which the tensor
# cores take a float32 call (a group of 3 or more fills enough of a
# 16-row tile; below, the CUDA cores were faster in chip_smoke.py phase
# 6's sweep of both paths); bf16 calls take them at every group, where
# the sweep found them faster
MMA_MIN_REP_F32 = 3
# split counters: one int32 per (b, kv head, head group) of a call with
# more than one split, in a region of one per-device buffer per stream
COUNTER_REGIONS = 64
REGION_COUNTERS = 4096


@functools.lru_cache(maxsize=256)
def decode_splits(b: int, hkv: int, s: int) -> tuple:
    """Split plan ``(n_split, chunk)`` of a cache of capacity ``s`` slots:
    split i covers slots ``[i * chunk, min((i + 1) * chunk, s))``.

    Depends on ``b * hkv`` and ``s`` only, never on the lengths, which live
    on the device (reading them would sync the host every step and break
    CUDA-graph capture).  About ``SPLIT_WAVES`` blocks per SM, with chunks
    of at least ``MIN_SPLIT_SLOTS`` slots in whole groups of 16.
    """
    want = max(1, SPLIT_WAVES * SMS // (b * hkv))
    n = min(want, max(1, s // MIN_SPLIT_SLOTS))
    chunk = -(-s // n)
    chunk = -(-chunk // 16) * 16
    return -(-s // chunk), chunk


def decode_path(rep: int, d: int, dtype) -> str:
    """``"mma"`` (the group's query heads as the rows of tensor-core
    tiles) or ``"cores"`` (dot products reduced by shuffles on the CUDA
    cores): a pure function of the group size ``rep = H / Hkv``, the head
    dim and the dtype."""
    if d not in MMA_HEAD_DIMS:
        return "cores"
    if dtype == torch.bfloat16 or rep >= MMA_MIN_REP_F32:
        return "mma"
    return "cores"


def head_tile(rep: int, path: str) -> int:
    """Query heads a block serves on ``path`` (the kernel's dispatch):
    one mma tile of 16 rows, or on the CUDA cores 1, 2, 4 or 8."""
    if path == "mma":
        return MMA_HEADS
    return rep if rep <= 2 else (4 if rep <= 4 else CORE_HEADS)


def head_groups(rep: int, path: str) -> int:
    """Blocks a kv head's ``rep`` query heads take on ``path``."""
    return -(-rep // head_tile(rep, path))


_COUNTERS: dict = {}   # device index -> the zeroed int32 buffer
_REGIONS: dict = {}    # (device index, stream handle) -> region index


def _index(device) -> int:
    device = torch.device(device)
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def split_counters(device, stream) -> torch.Tensor:
    """This stream's :data:`REGION_COUNTERS` split counters on ``device``.

    The kernel's last block of each head group resets its counter, so the
    counters are zero between calls; calls in flight on two streams at
    once use two regions.  The buffer is allocated (zeroed) once per
    device, at the first call there, which must not be inside a CUDA
    graph capture; a stream's region is handed out at its first call, and
    nothing is allocated after that, so capture is safe.  A graph replays
    with the region of the stream it was captured on."""
    dev = _index(device)
    buf = _COUNTERS.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode allocates its split counters at its first call "
                "on a device; make that call outside CUDA graph capture")
        buf = torch.zeros(COUNTER_REGIONS * REGION_COUNTERS,
                          dtype=torch.int32, device=torch.device("cuda", dev))
        torch.cuda.synchronize(dev)   # zero before any stream reads it
        _COUNTERS[dev] = buf
    key = (dev, stream.cuda_stream)
    region = _REGIONS.get(key)
    if region is None:
        region = sum(1 for d, _ in _REGIONS if d == dev)
        if region >= COUNTER_REGIONS:
            raise RuntimeError(f"flash_decode ran on more than "
                               f"{COUNTER_REGIONS} streams of one device")
        _REGIONS[key] = region
    return buf[region * REGION_COUNTERS:(region + 1) * REGION_COUNTERS]


def counter_buffer(device) -> torch.Tensor | None:
    """The device's whole split-counter buffer (every stream's region),
    or None before its first call with splits; zero between calls."""
    return _COUNTERS.get(_index(device))


def combine_splits_plain(m, l, acc):
    """Plain twin of the kernel's combine pass: the splits' partial softmax
    states ``m``, ``l`` (..., n_split) and ``acc`` (..., n_split, D), all
    float32, merged into the output (..., D).  An empty split (``l == 0``)
    carries no weight; a split of masked slots only carries m = -1e30 and
    its slot count, so a length <= 0 still averages over every slot."""
    live = l > 0
    mx = torch.where(live, m, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
    total = (l * w).sum(-1)
    acc = torch.where(live[..., None], acc, torch.zeros_like(acc))
    return (acc * w[..., None]).sum(-2) / total.clamp_min(1e-30)[..., None]


def merge_decode_stats(outs, ms, ls):
    """The output over a whole cache from ``flash_decode(return_stats=
    True)`` over disjoint slices of it: ``outs`` (B,H,D), ``ms`` and
    ``ls`` (B,H) float32, one each per slice.  ``m_g = max m``, ``w =
    exp(m - m_g)``, ``l_g = sum l w``, ``o = sum o l w / max(l_g,
    1e-30)`` in float32, in outs' dtype.  A slice whose rows have no
    valid slot (m = -1e30) weighs 0 beside a live slice."""
    m = torch.stack(list(ms))
    lw = torch.stack(list(ls)) * torch.exp(m - m.amax(0))
    acc = (torch.stack(list(outs)).float() * lw[..., None]).sum(0)
    return (acc / lw.sum(0).clamp_min(1e-30)[..., None]).to(outs[0].dtype)


def flash_decode_plain(q, k_cache, v_cache, lengths, *, scale=None,
                       window: int | None = None,
                       return_stats: bool = False):
    """Plain PyTorch version of the kernel (materialized scores); with
    ``return_stats`` also (m, l) (B,H) float32."""
    window = _window(window, True)
    b, h, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, rep, d).float()
    scores = torch.einsum("bgrd,btgd->bgrt", qg, k_cache.float()) * scale
    lens = lengths.to(q.device)[:, None]
    slot = torch.arange(t, device=q.device)[None, :]
    valid = slot < lens
    if window:
        valid = valid & (slot >= lens - window)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrt,btgd->bgrd", w, v_cache.float())
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_stats:
        return out
    m = scores.amax(-1)
    l = torch.exp(scores - m[..., None]).sum(-1)
    return out, m.reshape(b, h), l.reshape(b, h)


def flash_decode_cuda(q, k_cache, v_cache, lengths, *, scale=None,
                      window: int | None = None,
                      return_stats: bool = False, path: str | None = None):
    """Launch ``csrc/decode_attention.cu`` on PyTorch's current stream;
    with ``return_stats`` also (m, l) (B,H) float32.

    Takes CUDA tensors only and raises on anything the kernel does not
    take; builds the kernel library at first use.  ``path`` ("mma" or
    "cores") forces a path; by default :func:`decode_path` chooses.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_cuda needs CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    _check_operands({"q": q, "k_cache": k_cache, "v_cache": v_cache},
                    q.dtype, q.device)
    b, h, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match "
                         f"q {tuple(q.shape)}")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled; have {HEAD_DIMS}")
    window = _window(window, True)
    lens = _lengths_i32(lengths, b, q.device)
    scale = scale if scale is not None else d ** -0.5
    if path is None:
        path = decode_path(h // hkv, d, q.dtype)
    elif path not in ("mma", "cores") or (path == "mma"
                                          and d not in MMA_HEAD_DIMS):
        raise ValueError(f"no {path!r} path at head dim {d}")
    n_split, chunk = decode_splits(b, hkv, s)
    counters = None
    if n_split > 1:
        need = b * hkv * head_groups(h // hkv, path)
        if need > REGION_COUNTERS:
            raise ValueError(f"{need} split counters needed, a region has "
                             f"{REGION_COUNTERS}")
        counters = split_counters(
            q.device, torch.cuda.current_stream(q.device)).data_ptr()
    # one allocation: the output first, then (with splits) the partial
    # accumulators (B*H*n_split*D) and (m, l) pairs, then (with stats) m
    # and l, all float32
    n_out = b * h * d * q.element_size() // 4
    n_part = b * h * n_split * d if n_split > 1 else 0
    n_ml = 2 * b * h * n_split if n_split > 1 else 0
    n_st = 2 * b * h if return_stats else 0
    buf = torch.empty(n_out + n_part + n_ml + n_st, dtype=torch.float32,
                      device=q.device)
    out = buf[:n_out].view(q.dtype).view(b, h, d)
    base = buf.data_ptr()
    parts = ((base + 4 * n_out, base + 4 * (n_out + n_part)) if n_split > 1
             else (None, None))
    stats = buf[n_out + n_part + n_ml:].view(2, b, h) if return_stats \
        else None
    stat_ptrs = ((stats[0].data_ptr(), stats[1].data_ptr()) if return_stats
                 else (None, None))
    lib = _build.load_library()
    rc = lib.repro_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lens.data_ptr(), out.data_ptr(), *parts, *stat_ptrs, counters, b, s,
        h, hkv, d, n_split, chunk, int(path == "mma"), *q.stride()[:2],
        *k_cache.stride()[:3], *v_cache.stride()[:3], *out.stride()[:2],
        ctypes.c_float(scale), window, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_decode")
    return (out, stats[0], stats[1]) if return_stats else out
