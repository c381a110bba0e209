"""The port's scan kernels on CPU tensors (their plain versions) against
the JAX Pallas kernels in interpret mode and against the step-by-step
reference recurrences, mirroring ``tests/test_kernels.py``'s rwkv6 and
ssd cases.

Tolerances are those of ``tests/test_kernels.py``: 2e-4 for ``rwkv6_wkv``
and 3e-4 for ``ssd_scan`` (chunked vs step-by-step float32 sums).  Inputs
are drawn with numpy from a seed and handed to both sides.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here it is checked that a non-CPU tensor never takes
the plain path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_wkv as twkv
from repro_torch.kernels import ssd_scan as tssd
from _torch_threads import cap_threads

cap_threads()

WKV_TOL = 2e-4
SSD_TOL = 3e-4


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _wkv_inputs(seed, b, s, h, p, with_s0):
    rng = np.random.default_rng(seed)
    r, k, v = (_randn(rng, (b, s, h, p)) for _ in range(3))
    log_w = -np.clip(np.exp(_randn(rng, (b, s, h, p))), 1e-4, 2.5)
    u = _randn(rng, (h, p)) * 0.5
    s0 = _randn(rng, (b, h, p, p)) if with_s0 else None
    return r, k, v, log_w.astype(np.float32), u, s0


def _ssd_inputs(seed, b, s, h, p, n, with_s0):
    rng = np.random.default_rng(seed)
    x = _randn(rng, (b, s, h, p))
    dt = np.log1p(np.exp(_randn(rng, (b, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    b_in, c_in = _randn(rng, (b, s, h, n)), _randn(rng, (b, s, h, n))
    s0 = _randn(rng, (b, h, p, n)) if with_s0 else None
    return x, dt, a_log, b_in, c_in, s0


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


# ------------------------------------------------------------------ rwkv6 --
@pytest.mark.parametrize("b,s,h,p,chunk,with_s0", [
    (1, 32, 2, 16, 32, False),     # single chunk
    (2, 64, 2, 32, 32, False),     # two chunks (state carry)
    (1, 128, 4, 64, 32, False),    # production head dim
    (2, 96, 1, 16, 32, False),     # three chunks
    (1, 37, 2, 16, 1, False),      # a prime length: chunk of 1
    (1, 32, 2, 16, 32, True),      # non-zero initial state
    (2, 21, 2, 16, 7, True),       # odd chunk, initial state
])
def test_rwkv6_wkv_plain_matches_pallas_and_recurrence(b, s, h, p, chunk,
                                                        with_s0):
    args = _wkv_inputs(b * 100 + s, b, s, h, p, with_s0)
    y, s_t = tops.rwkv6_wkv(*_torch(args), chunk=chunk)
    assert y.shape == (b, s, h, p) and s_t.shape == (b, h, p, p)
    assert y.dtype == s_t.dtype == torch.float32
    jy, js = jops.rwkv6_wkv(*_jax(args), chunk=chunk, interpret=True)
    _close(y, jy, WKV_TOL)
    _close(s_t, js, WKV_TOL)
    ry, rs = jref.rwkv6_ref(*_jax(args))
    _close(y, ry, WKV_TOL)
    _close(s_t, rs, WKV_TOL)


def test_rwkv6_step_reference_matches_jax_reference():
    args = _wkv_inputs(3, 2, 20, 2, 16, True)
    for got, want in zip(tref.rwkv6_ref(*_torch(args)),
                         jref.rwkv6_ref(*_jax(args))):
        _close(got, want, 1e-5)


# -------------------------------------------------------------------- ssd --
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_s0", [
    (1, 64, 2, 16, 8, 64, False),     # one chunk
    (2, 128, 2, 32, 16, 64, False),   # two chunks
    (1, 256, 4, 64, 64, 64, False),   # production dims
    (1, 192, 1, 16, 8, 64, False),    # three chunks
    (1, 37, 2, 16, 8, 1, False),      # a prime length: chunk of 1
    (1, 64, 2, 16, 8, 64, True),      # non-zero initial state
    (2, 24, 2, 16, 8, 8, True),       # smoke chunk, initial state
])
def test_ssd_scan_plain_matches_pallas_and_recurrence(b, s, h, p, n, chunk,
                                                      with_s0):
    args = _ssd_inputs(b * 100 + s, b, s, h, p, n, with_s0)
    y, s_t = tops.ssd_scan(*_torch(args), chunk=chunk)
    assert y.shape == (b, s, h, p) and s_t.shape == (b, h, p, n)
    jy, js = jops.ssd_scan(*_jax(args), chunk=chunk, interpret=True)
    _close(y, jy, SSD_TOL)
    _close(s_t, js, SSD_TOL)
    ry, rs = jref.ssd_ref(*_jax(args))
    _close(y, ry, SSD_TOL)
    _close(s_t, rs, SSD_TOL)


def test_ssd_plain_reads_bc_expanded_over_heads():
    """One B/C group expanded over the heads (stride 0, the model's view)
    gives what the repeated copy gives."""
    x, dt, a_log, b_in, c_in, _ = _ssd_inputs(5, 2, 16, 4, 16, 8, False)
    bt, ct = torch.from_numpy(b_in[:, :, :1]), torch.from_numpy(c_in[:, :, :1])
    xt, dtt, at = _torch((x, dt, a_log))
    got = tops.ssd_scan(xt, dtt, at, bt.expand(2, 16, 4, 8),
                        ct.expand(2, 16, 4, 8), chunk=8)
    want = tops.ssd_scan(xt, dtt, at, bt.repeat(1, 1, 4, 1),
                         ct.repeat(1, 1, 4, 1), chunk=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_step_reference_matches_jax_reference():
    args = _ssd_inputs(4, 2, 20, 2, 16, 8, True)
    for got, want in zip(tref.ssd_ref(*_torch(args)),
                         jref.ssd_ref(*_jax(args))):
        _close(got, want, 1e-5)


# ------------------------------------------------------------- contracts --
def test_scan_wrappers_refuse_a_chunk_that_does_not_divide():
    r, k, v, lw, u, _ = _torch(_wkv_inputs(6, 1, 12, 2, 16, False))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.rwkv6_wkv(r, k, v, lw, u, chunk=5)
    x, dt, al, bi, ci, _ = _torch(_ssd_inputs(7, 1, 12, 2, 16, 8, False))
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.ssd_scan(x, dt, al, bi, ci, chunk=5)


def test_scan_wrappers_send_non_cpu_tensors_to_the_kernels():
    """A tensor off the CPU goes to the kernel's wrapper, which launches
    on CUDA or raises: never the plain version, never a fallback."""
    r = torch.zeros((1, 8, 2, 16), device="meta")
    u = torch.zeros((2, 16), device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.rwkv6_wkv(r, r, r, r, u, chunk=8)
    dt = torch.zeros((1, 8, 2), device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.ssd_scan(r, dt, torch.zeros(2, device="meta"), r, r, chunk=8)
    assert tops.launch_counts()["rwkv6_wkv"] == 0
    assert tops.launch_counts()["ssd_scan"] == 0


def test_ssd_kernel_shared_memory_fits_the_serving_chunks():
    """zamba2's chunk of 128 at P = N = 64 fits the 227 KB a block may use;
    far larger tiles are refused before any launch."""
    assert tssd._smem_bytes(64, 64, 128) <= tssd._SMEM_LIMIT
    assert tssd._smem_bytes(128, 128, 256) > tssd._SMEM_LIMIT
    assert twkv.MAX_CHUNK * 2.5 < np.log(np.finfo(np.float32).max)
