"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``flash_attention``).  The kernels themselves are in
``csrc/flash_attention.cu``: a warp-specialised ``wgmma`` kernel fed by
TMA (head dims 64 and 128) and the ``mma.sync`` kernel it grew from,
which keeps the shapes :func:`attention_plan` gives it (every head dim;
float32 as 3 x TF32 in both); the header says what bounds them on the
H100 and what they leave for later.

Semantics, shared by the kernel and :func:`flash_attention_plain`:

* q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D) in q's dtype (float32 or
  bfloat16); softmax in float32; GQA groups of ``rep = H / Hkv``.
* ``lengths`` (B,) marks each sequence's valid KEY prefix
  (``k_pos < lengths[b]``); None means all T keys are valid.
* ``causal`` adds ``k_pos <= q_pos`` at offset 0, as the TPU kernel does
  (``repro_torch.kernels.ref.attention_ref`` instead aligns queries to the
  last S keys; the two agree when S == T, the only causal case Marian
  has).
* ``window`` (causal only; None or 0 means none) adds ``k_pos > q_pos -
  window``: the sliding window of the reference LM's ``blocked_sdpa``,
  which the TPU kernel does not take (the reference computes windowed
  attention in jnp; the port's LM runs it here).
* Masked scores are -1e30, so a row with no valid key averages over all
  T keys, as the TPU kernel does.  Callers clamp lengths to >= 1.
* Ragged S and T need no padding: the kernel masks its tails, so the JAX
  wrapper's pad-to-block copies have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)     # head dims the kernel is compiled for
BLOCK_Q = (16, 32, 64)            # query rows per block of the mma.sync kernel
SMS = 132                         # streaming multiprocessors of an H100
WGMMA_HEAD_DIMS = (64, 128)       # head dims of the wgmma kernel
# the plan's threshold: the wgmma kernel takes a shape whose query rows
# fill at least 3/4 of its blocks of wgmma_rows rows per kv head and give
# at least WGMMA_MIN_BLOCKS blocks (chip_smoke.py phase 6's sweep of both
# kernels at every timed shape sets it)
WGMMA_MIN_BLOCKS = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pick_block_q(rows: int, bh: int) -> int:
    """Query rows per block for ``rows = S * rep`` flattened query rows in
    each of ``bh = B * Hkv`` kv heads: the largest tile that still gives
    one block per SM, else 16 (the most blocks the shape has)."""
    for bq in (64, 32):
        if -(-rows // bq) * bh >= SMS:
            return bq
    return 16


def wgmma_rows(d: int, dtype) -> int:
    """Query rows per block of the wgmma kernel: 64 per consumer
    warpgroup; three warpgroups in bf16, two in float32 but one at D =
    128 (its TF32 hi/lo tiles fill the shared memory)."""
    if dtype == torch.bfloat16:
        return 192
    return 64 if d == 128 else 128


def attention_plan(b: int, s: int, h: int, hkv: int, d: int,
                   dtype) -> tuple:
    """The kernel and tile for a call: ``("wgmma", rows)`` or ``("mma",
    block_q)``.  A pure function of the shape and dtype: the wgmma kernel
    where it has the head dim, a kv head's flattened (position, grouped
    head) rows fill at least 3/4 of its blocks of ``wgmma_rows``, and the
    blocks number at least ``WGMMA_MIN_BLOCKS``; else the mma.sync kernel
    at :func:`pick_block_q`'s tile."""
    rows = s * (h // hkv)
    per = wgmma_rows(d, dtype)
    blocks = -(-rows // per)
    if (d in WGMMA_HEAD_DIMS and 4 * rows >= 3 * blocks * per
            and blocks * b * hkv >= WGMMA_MIN_BLOCKS):
        return "wgmma", per
    return "mma", pick_block_q(rows, b * hkv)


def _window(window, causal: bool) -> int:
    """The kernels' window argument: 0 for none; a window needs causal."""
    if not window:
        return 0
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if not causal:
        raise ValueError("a sliding window bounds causal attention only")
    return int(window)


def flash_attention_plain(q, k, v, lengths=None, *, causal: bool = True,
                          scale: float | None = None,
                          window: int | None = None):
    """Plain PyTorch version of the kernel (materialized scores)."""
    window = _window(window, causal)
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, s, hkv, rep, d).float()
    scores = torch.einsum("bsgrd,btgd->bgrst", qg, k.float()) * scale
    k_pos = torch.arange(t, device=q.device)
    if lengths is None:
        valid = torch.ones((b, t), dtype=torch.bool, device=q.device)
    else:
        valid = k_pos[None, :] < lengths.to(q.device)[:, None]      # (B,T)
    mask = valid[:, None, None, None, :]                             # (B,1,1,1,T)
    if causal:
        q_pos = torch.arange(s, device=q.device)
        mask = mask & (k_pos[None, :] <= q_pos[:, None])            # (B,1,1,S,T)
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _check_operands(tensors, dtype, device):
    for name, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension")
        # the kernels read rows with 16-byte loads
        per16 = 16 // x.element_size()
        if x.data_ptr() % 16 or any(st % per16 for st in x.stride()[:-1]):
            raise ValueError(f"{name} rows are not 16-byte aligned")


def _lengths_i32(lengths, b, device):
    if lengths is None:
        return None
    if lengths.shape != (b,):
        raise ValueError(f"lengths must have shape ({b},), "
                         f"got {tuple(lengths.shape)}")
    if lengths.device != device:
        raise ValueError(f"lengths is on {lengths.device}, expected {device}")
    return lengths.to(torch.int32).contiguous()


def flash_attention_cuda(q, k, v, lengths=None, *, causal: bool = True,
                         scale: float | None = None,
                         block_q: int | None = None,
                         window: int | None = None,
                         path: str | None = None):
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream.

    Takes CUDA tensors only and raises on anything the kernel does not
    take; builds the kernel library at first use.  By default
    :func:`attention_plan` chooses the kernel and its tile from the
    shape.  ``path="wgmma"`` forces the wgmma kernel (head dims 64 and
    128), ``path="mma"`` the mma.sync kernel; ``block_q`` (one of
    :data:`BLOCK_Q`) forces the mma.sync kernel at that query tile.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, "
                         f"got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    _check_operands({"q": q, "k": k, "v": v}, q.dtype, q.device)
    b, s, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    t, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled; have {HEAD_DIMS}")
    if block_q is not None and (block_q not in BLOCK_Q or path == "wgmma"):
        raise ValueError(f"block_q {block_q} is not one of the mma.sync "
                         f"kernel's {BLOCK_Q}")
    if path is None and block_q is None:
        path, block_q = attention_plan(b, s, h, hkv, d, q.dtype)
    elif path in (None, "mma"):
        path = "mma"
        block_q = block_q or pick_block_q(s * (h // hkv), b * hkv)
    elif path != "wgmma":
        raise ValueError(f"path must be 'wgmma' or 'mma', got {path!r}")
    if path == "wgmma":
        if d not in WGMMA_HEAD_DIMS:
            raise ValueError(f"the wgmma kernel has head dims "
                             f"{WGMMA_HEAD_DIMS}, not {d}")
        block_q = 0           # the C entry's code for the wgmma kernel
    window = _window(window, causal)
    lens = _lengths_i32(lengths, b, q.device)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(),
        b, s, t, h, hkv, d, block_q,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        ctypes.c_float(scale), int(causal), window, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    return out
