"""The scan kernels' plain twins run in float64: the yardstick the card's
scan checks hold the kernels to.

``rwkv6_wkv_plain`` and ``ssd_scan_plain`` take ``dtype=``, the type
their chunked algorithm runs in.  At float64 each agrees with its exact
recurrence, written here step by step in numpy float64, within 1e-10 of
the output's scale: at rwkv6-3b's 40 heads of 64, where |y| reaches
about 90 and the float32 twin at chunk 32 is itself up to 2.3e-4 from
the exact recurrence, and at zamba2-1.2b's 64 heads of P = N = 64.  The
default call is bitwise the ``dtype=torch.float32`` one.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6_wkv as wkv
from repro_torch.kernels import ssd_scan as ssd
from _torch_threads import cap_threads

cap_threads()

EXACT_TOL = 1e-10       # float64 twin vs numpy recurrence, of max |y|


def _draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32).astype(np.float64)


def wkv_inputs(seed, b, s, h, p, with_s0):
    """rwkv6-shaped operands (float64 holding float32 draws); log w
    clamped as the model clamps it."""
    rng = np.random.default_rng(seed)
    r, k, v = _draw(rng, b, s, h, p), _draw(rng, b, s, h, p), \
        _draw(rng, b, s, h, p)
    log_w = -np.clip(np.exp(_draw(rng, b, s, h, p)), 1e-4, 2.5)
    return r, k, v, log_w, 0.5 * _draw(rng, h, p), \
        _draw(rng, b, h, p, p) if with_s0 else None


def ssd_inputs(seed, b, s, h, p, n, with_s0):
    """zamba2-shaped operands: dt after softplus, the model's a_log, one
    B/C group expanded over the heads."""
    rng = np.random.default_rng(seed)
    x, dt = _draw(rng, b, s, h, p), np.logaddexp(0.0, _draw(rng, b, s, h))
    a_log = np.log(np.linspace(1.0, 16.0, h))
    bc = _draw(rng, b, s, 2 * n)
    b_in = np.broadcast_to(bc[..., None, :n], (b, s, h, n))
    c_in = np.broadcast_to(bc[..., None, n:], (b, s, h, n))
    return x, dt, a_log, b_in, c_in, _draw(rng, b, h, p, n) if with_s0 \
        else None


def wkv_exact(r, k, v, log_w, u, s0):
    """y_t = r_t . (S + diag(u) k_t v_t^T), S <- diag(w_t) S + k_t v_t^T."""
    b, s, h, p = r.shape
    state = np.zeros((b, h, p, p)) if s0 is None else s0.copy()
    ys = []
    for t in range(s):
        kv = np.einsum("bhp,bhq->bhpq", k[:, t], v[:, t])
        ys.append(np.einsum("bhp,bhpq->bhq", r[:, t],
                            state + u[None, :, :, None] * kv))
        state = state * np.exp(log_w[:, t])[..., None] + kv
    return np.stack(ys, 1), state


def ssd_exact(x, dt, a_log, b_in, c_in, s0):
    """H_t = e^{dt_t A} H_{t-1} + dt_t x_t (x) B_t, y_t = H_t . C_t."""
    b, s, h, p = x.shape
    n = b_in.shape[-1]
    a = -np.exp(a_log)
    state = np.zeros((b, h, p, n)) if s0 is None else s0.copy()
    ys = []
    for t in range(s):
        state = (state * np.exp(dt[:, t] * a)[..., None, None]
                 + np.einsum("bh,bhp,bhn->bhpn", dt[:, t], x[:, t],
                             b_in[:, t]))
        ys.append(np.einsum("bhpn,bhn->bhp", state, c_in[:, t]))
    return np.stack(ys, 1), state


def _torch(args, dtype=torch.float64):
    return [None if a is None else torch.as_tensor(np.ascontiguousarray(a),
                                                   dtype=dtype)
            for a in args]


def _rel_err(got, want):
    scale = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g.numpy() - w).max())
               for g, w in zip(got, want)) / scale


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 32), (37, 1)])
def test_wkv_float64_twin_is_the_exact_recurrence(s, chunk, with_s0):
    """rwkv6-3b's 40 heads of 64 (seed 10: |y| reaches ~90 at S=64)."""
    args = wkv_inputs(10, 1, s, 40, 64, with_s0)
    want = wkv_exact(*args)
    got = wkv.rwkv6_wkv_plain(*_torch(args), chunk=chunk,
                              dtype=torch.float64)
    assert all(g.dtype == torch.float64 for g in got)
    assert _rel_err(got, want) <= EXACT_TOL
    if s == 64:
        assert float(np.abs(want[0]).max()) > 60.0   # |y| ~ 90 in this draw


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", [(128, 64), (37, 1)])
def test_ssd_float64_twin_is_the_exact_recurrence(s, chunk, with_s0):
    """zamba2-1.2b's 64 heads of P = N = 64."""
    args = ssd_inputs(3, 1, s, 64, 64, 64, with_s0)
    got = ssd.ssd_scan_plain(*_torch(args), chunk=chunk,
                             dtype=torch.float64)
    assert all(g.dtype == torch.float64 for g in got)
    assert _rel_err(got, ssd_exact(*args)) <= EXACT_TOL


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("twin", ["wkv", "ssd"])
def test_default_twin_is_the_float32_run_bitwise(twin, in_dtype):
    """The default call is the dtype=torch.float32 one, bitwise, for the
    float32 and bf16 inputs the models pass; a float64 run of float32
    inputs returns y in float32 and the state in float64, and is closer
    to the exact recurrence than the float32 run."""
    if twin == "wkv":
        args, fn, chunk = wkv_inputs(10, 1, 64, 40, 64, True), \
            wkv.rwkv6_wkv_plain, 32
        exact = wkv_exact(*args)
    else:
        args, fn, chunk = ssd_inputs(3, 1, 128, 64, 64, 64, True), \
            ssd.ssd_scan_plain, 64
        exact = ssd_exact(*args)
    inputs = _torch(args, in_dtype)
    default = fn(*inputs, chunk=chunk)
    f32 = fn(*inputs, chunk=chunk, dtype=torch.float32)
    for a, b in zip(default, f32):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if in_dtype != torch.float32:
        return
    f64 = fn(*inputs, chunk=chunk, dtype=torch.float64)
    assert f64[0].dtype == torch.float32 and f64[1].dtype == torch.float64
    err64 = _rel_err([t.double() for t in f64], exact)
    assert err64 < _rel_err([t.double() for t in f32], exact)
