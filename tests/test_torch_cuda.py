"""The CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips without a card
(the check is made in a fixture, never at import).  On the machine with
the card, run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file, unlike the other ``test_torch_*`` files, does not import JAX:
it compares the port with itself (kernel vs plain version), and the
card's machine carries no JAX.

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16 for the attention
kernels, 2e-4 for ``rwkv6_wkv`` and 3e-4 for ``ssd_scan``, those of
``tests/test_kernels.py``; 1e-4 for whole-model outputs, whose float32
reductions run in another order through every layer.
"""

import copy

import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_wkv as wkv
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.nmt import MarianTransformer, TransformerConfig
from _torch_threads import cap_threads

cap_threads()

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip")
    return torch.device("cuda")


def _randn(seed, shape, dev, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,lens", [
    (8, 40, 40, 8, 8, 64, False, (40, 1, 17, 33, 40, 2, 39, 40)),
    (2, 512, 512, 8, 8, 64, False, (512, 301)),
    (2, 64, 64, 8, 8, 64, True, None),
    (1, 100, 100, 8, 2, 128, True, (77,)),      # GQA, ragged, causal
    (3, 7, 130, 4, 4, 32, False, (130, 5, 64)),  # cross-attention shape
    (1, 33, 33, 2, 1, 16, False, (0,)),         # fully masked row
])
def test_flash_attention_kernel_matches_plain(dev, dtype, b, s, t, h, hkv, d,
                                              causal, lens):
    q = _randn(1, (b, s, h, d), dev, dtype)
    k = _randn(2, (b, t, hkv, d), dev, dtype)
    v = _randn(3, (b, t, hkv, d), dev, dtype)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                     device=dev)
    got = fa.flash_attention_cuda(q, k, v, lengths, causal=causal)
    want = fa.flash_attention_plain(q, k, v, lengths, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,lens", [
    (1, 256, 8, 8, 64, (37,)),
    (8, 256, 8, 8, 64, (1, 37, 256, 100, 64, 65, 200, 255)),
    (3, 100, 8, 2, 128, (100, 1, 50)),
    (2, 70, 4, 4, 32, (0, 70)),
])
def test_flash_decode_kernel_matches_plain_on_folded_cache(dev, dtype, b, t,
                                                            h, hkv, d, lens):
    q = _randn(4, (b, h * d), dev, dtype).view(b, h, d)
    kc = _randn(5, (b, t, hkv * d), dev, dtype).view(b, t, hkv, d)
    vc = _randn(6, (b, t, hkv * d), dev, dtype).view(b, t, hkv, d)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = da.flash_decode_cuda(q, kc, vc, lengths)
    want = da.flash_decode_plain(q, kc, vc, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,lens", [
    (1, 2048, 8, 8, 64, (1,)),       # many splits, all but one empty
    (1, 2048, 8, 8, 64, (33,)),
    (1, 2048, 8, 8, 64, (2047,)),
    (2, 256, 32, 8, 64, (200, 17)),  # GQA rep = 4
    (1, 300, 12, 4, 32, (299,)),     # rep = 3 in a block of 4 heads
    (2, 96, 32, 2, 16, (96, 5)),     # rep = 16: two head groups per kv head
    (3, 256, 8, 8, 64, (0, 100, 256)),   # length 0 beside split rows
])
def test_flash_decode_split_kv_matches_plain(dev, dtype, b, t, h, hkv, d,
                                             lens):
    q = _randn(20, (b, h, d), dev, dtype)
    kc = _randn(21, (b, t, hkv, d), dev, dtype)
    vc = _randn(22, (b, t, hkv, d), dev, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = da.flash_decode_cuda(q, kc, vc, lengths)
    want = da.flash_decode_plain(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


def test_flash_decode_is_bitwise_repeatable(dev):
    q = _randn(23, (4, 8, 64), dev, torch.float32)
    kc = _randn(24, (4, 1024, 8, 64), dev, torch.float32)
    vc = _randn(25, (4, 1024, 8, 64), dev, torch.float32)
    lengths = torch.tensor([1024, 3, 700, 0], dtype=torch.int32, device=dev)
    assert da.decode_splits(4, 8, 1024)[0] > 1
    first = da.flash_decode_cuda(q, kc, vc, lengths)
    again = da.flash_decode_cuda(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_flash_decode_graph_replay_reads_lengths_on_the_device(dev):
    b, t, h, d = 2, 512, 8, 64
    q = _randn(26, (b, h, d), dev, torch.float32)
    kc = _randn(27, (b, t, h, d), dev, torch.float32)
    vc = _randn(28, (b, t, h, d), dev, torch.float32)
    lengths = torch.tensor([5, 300], dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.flash_decode_cuda(q, kc, vc, lengths)      # build and warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.flash_decode_cuda(q, kc, vc, lengths)
    for lens in ((5, 300), (511, 1), (0, 64)):
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, da.flash_decode_plain(q, kc, vc,
                                                              lengths),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_q", [16, 32, 64])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,lens", [
    (2, 77, 77, 4, 4, 16, False, (77, 30)),
    (2, 53, 91, 4, 2, 32, False, (91, 1)),
    (1, 45, 45, 2, 2, 128, True, None),
    (2, 61, 61, 8, 8, 64, True, (61, 20)),
    (1, 37, 70, 4, 4, 64, True, None),           # causal, S != T
    (2, 100, 29, 6, 2, 64, True, (29, 10)),      # causal, S > T, rep = 3
])
def test_flash_attention_every_query_tile_on_ragged_shapes(
        dev, dtype, block_q, b, s, t, h, hkv, d, causal, lens):
    q = _randn(29, (b, s, h, d), dev, dtype)
    k = _randn(30, (b, t, hkv, d), dev, dtype)
    v = _randn(31, (b, t, hkv, d), dev, dtype)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                     device=dev)
    got = fa.flash_attention_cuda(q, k, v, lengths, causal=causal,
                                  block_q=block_q)
    want = fa.flash_attention_plain(q, k, v, lengths, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


def test_wrappers_count_launches_and_reject_bad_operands(dev):
    ops.reset_launch_counts()
    q = _randn(7, (1, 16, 2, 64), dev, torch.float32)
    ops.flash_attention(q, q, q, causal=True)
    ops.flash_decode(q[:, 0], q, q, torch.tensor([16], dtype=torch.int32,
                                                 device=dev))
    assert ops.launch_counts() == {"flash_attention": 1, "flash_decode": 1,
                                   "rwkv6_wkv": 0, "ssd_scan": 0}
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.double(), q, causal=True)
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :8], q[..., :8], q[..., :8])   # head dim 8
    with pytest.raises(ValueError):
        ops.flash_decode(q[:, 0], q, q, torch.tensor([16], dtype=torch.int32))


def test_marian_on_the_card_matches_the_cpu(dev):
    cfg = TransformerConfig(vocab_src=500, vocab_tgt=500, d_model=128,
                            heads=2, d_ff=256, enc_layers=2, dec_layers=2,
                            max_decode_len=20, max_src_len=64)
    gpu = MarianTransformer(cfg, device=dev, seed=1)
    cpu = MarianTransformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(0)
    src = rng.integers(4, 500, (3, 11)).astype(np.int32)
    mask = np.ones(src.shape, np.float32)
    mask[1, 6:] = 0.0
    mask[2, 2:] = 0.0
    with torch.inference_mode():
        outs = []
        for model, d in ((gpu, dev), (cpu, torch.device("cpu"))):
            enc, m = model.encode(torch.as_tensor(src, device=d),
                                  torch.as_tensor(mask, device=d))
            state = model.init_cache(enc, m)
            logits = []
            for tok in (1, 17, 42, 99):
                state, lg = model.decode_step(
                    state, torch.full((3,), tok, dtype=torch.int32, device=d))
                logits.append(lg)
            outs.append((enc.cpu(), torch.stack(logits).cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# rwkv6-3b's 40 heads of 64 and zamba2-1.2b's 64 heads of P = N = 64, at
# the chunk lengths prefill meets: a prime prompt (L = 1), an odd divisor,
# and the largest chunk
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("b,s,h,p,chunk", [
    (1, 37, 40, 64, 1),
    (2, 49, 40, 64, 7),
    (1, 64, 40, 64, 32),
    (2, 96, 3, 16, 32),
])
def test_rwkv6_wkv_kernel_matches_plain(dev, with_s0, b, s, h, p, chunk):
    # r, k, v read as strided head views of one fused (B, S, 3D) projection
    rkv = _randn(8, (b, s, 3 * h * p), dev, torch.float32)
    r, k, v = (rkv[..., i * h * p:(i + 1) * h * p].view(b, s, h, p)
               for i in range(3))
    log_w = -torch.clamp(torch.exp(_randn(9, (b, s, h, p), dev,
                                          torch.float32)), 1e-4, 2.5)
    u = 0.5 * _randn(10, (h, p), dev, torch.float32)
    s0 = _randn(11, (b, h, p, p), dev, torch.float32) if with_s0 else None
    got = wkv.rwkv6_wkv_cuda(r, k, v, log_w, u, s0, chunk=chunk)
    want = wkv.rwkv6_wkv_plain(r, k, v, log_w, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("b,s,h,p,n,chunk,shared_bc", [
    (1, 37, 64, 64, 64, 1, True),
    (2, 128, 64, 64, 64, 64, True),
    (1, 256, 64, 64, 64, 128, True),
    (2, 192, 3, 16, 8, 64, False),
])
def test_ssd_scan_kernel_matches_plain(dev, with_s0, b, s, h, p, n, chunk,
                                       shared_bc):
    x = _randn(12, (b, s, h * p), dev, torch.float32).view(b, s, h, p)
    dt = torch.nn.functional.softplus(_randn(13, (b, s, h), dev,
                                             torch.float32))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    if shared_bc:   # one B/C group expanded over the heads (stride 0)
        bc = _randn(14, (b, s, 2 * n), dev, torch.float32)
        b_in = bc[..., None, :n].expand(b, s, h, n)
        c_in = bc[..., None, n:].expand(b, s, h, n)
    else:
        b_in = _randn(14, (b, s, h, n), dev, torch.float32)
        c_in = _randn(15, (b, s, h, n), dev, torch.float32)
    s0 = _randn(16, (b, h, p, n), dev, torch.float32) if with_s0 else None
    got = ssd.ssd_scan_cuda(x, dt, a_log, b_in, c_in, s0, chunk=chunk)
    want = ssd.ssd_scan_plain(x, dt, a_log, b_in, c_in, s0, chunk=chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)


def test_scan_wrappers_count_launches_and_reject_bad_operands(dev):
    ops.reset_launch_counts()
    r = _randn(17, (1, 8, 2, 16), dev, torch.float32)
    u = torch.zeros((2, 16), device=dev)
    ops.rwkv6_wkv(r, r, r, -r.abs(), u, chunk=8)
    dt = torch.ones((1, 8, 2), device=dev)
    ops.ssd_scan(r, dt, torch.zeros(2, device=dev), r, r, chunk=4)
    counts = ops.launch_counts()
    assert (counts["rwkv6_wkv"], counts["ssd_scan"]) == (1, 1)
    with pytest.raises(ValueError):          # past the float32 exp limit
        ops.rwkv6_wkv(r.repeat(1, 8, 1, 1), r.repeat(1, 8, 1, 1),
                      r.repeat(1, 8, 1, 1), -r.abs().repeat(1, 8, 1, 1), u,
                      chunk=64)
    with pytest.raises(ValueError):          # chunk does not divide S
        ops.ssd_scan(r, dt, torch.zeros(2, device=dev), r, r, chunk=3)
    with pytest.raises(ValueError):          # float64 operands
        ops.rwkv6_wkv(r.double(), r.double(), r.double(), r.double(),
                      u.double(), chunk=8)


# every value tile the hosts can pick, at the chunk lengths prefill meets
# (1 for a prime prompt length), with and without s0, through strided views;
# the wrappers' private _launch forces the tile
def _wkv_args(dev, b, s, h, p, with_s0, seed=40):
    rkv = _randn(seed, (b, s, 3 * h * p + 4), dev, torch.float32)
    r, k, v = (rkv[..., i * h * p:(i + 1) * h * p].view(b, s, h, p)
               for i in range(3))
    log_w = -torch.clamp(torch.exp(_randn(seed + 1, (b, s, h, p), dev,
                                          torch.float32)), 1e-4, 2.5)
    u = 0.5 * _randn(seed + 2, (h, p), dev, torch.float32)
    s0 = (_randn(seed + 3, (b, h, p, p), dev, torch.float32) if with_s0
          else None)
    return r, k, v, log_w, u, s0


def _ssd_args(dev, b, s, h, p, n, with_s0, shared_bc=True, seed=50):
    # x, B and C as views of one (B, S, H*P + 2N) buffer, as the model
    # slices its conv output, one B/C group expanded over the heads; dt a
    # slice of a wider buffer (a seq stride of H + 3)
    xbc = _randn(seed, (b, s, h * p + 2 * n), dev, torch.float32)
    x = xbc[..., :h * p].view(b, s, h, p)
    if shared_bc:
        b_in = xbc[..., None, h * p:h * p + n].expand(b, s, h, n)
        c_in = xbc[..., None, h * p + n:].expand(b, s, h, n)
    else:
        b_in = _randn(seed + 1, (b, s, h, n), dev, torch.float32)
        c_in = _randn(seed + 2, (b, s, h, n), dev, torch.float32)
    dt = torch.nn.functional.softplus(
        _randn(seed + 4, (b, s, h + 3), dev, torch.float32))[..., :h]
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    s0 = (_randn(seed + 3, (b, h, p, n), dev, torch.float32) if with_s0
          else None)
    return x, dt, a_log, b_in, c_in, s0


def _assert_scan_close(got, want, tol):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("s,chunk", [(37, 1), (49, 7), (64, 32)])
@pytest.mark.parametrize("p", wkv.HEAD_SIZES)
def test_rwkv6_wkv_every_plan_matches_plain(dev, with_s0, s, chunk, p):
    """Every head size the kernel takes, at chunks 1, 7 and 32."""
    args = _wkv_args(dev, 2, s, 3, p, with_s0)
    got = wkv.rwkv6_wkv_cuda(*args, chunk=chunk)
    want = wkv.rwkv6_wkv_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    _assert_scan_close(got, want, 2e-4)


_SSD_PLANS = [(pt, s, chunk)
              for s, chunk in ((37, 1), (74, 37), (128, 64), (256, 128))
              for pt in ssd.ssd_tiles(64, 64, chunk)]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("pt,s,chunk", _SSD_PLANS)
def test_ssd_scan_every_plan_matches_plain(dev, with_s0, pt, s, chunk):
    args = _ssd_args(dev, 2, s, 8, 64, 64, with_s0)
    got = ssd._launch(*args, chunk, pt)
    want = ssd.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    _assert_scan_close(got, want, 3e-4)


@pytest.mark.parametrize("pt,n,chunk", [(16, 16, 8), (32, 8, 37),
                                        (16, 64, 64)])
def test_ssd_scan_per_head_b_c_every_tile(dev, pt, n, chunk):
    args = _ssd_args(dev, 2, 2 * chunk, 3, 32, n, True, shared_bc=False)
    want = ssd.ssd_scan_plain(*args, chunk=chunk)
    got = ssd._launch(*args, chunk, pt)
    torch.cuda.synchronize()
    _assert_scan_close(got, want, 3e-4)
    with pytest.raises(ValueError):          # wider than P = 32
        ssd._launch(*args, chunk, 64)


# every path of ssd_scan (the plan's, each forced) and rwkv6_wkv, at the
# models' shapes and ragged ones: zamba2-1.2b's heads at chunk 128 and a
# prime prompt (chunk 1, blocks of 64 with a 3-step tail), rwkv6-3b's at
# chunk 32 and a prime prompt, per-head B/C, and the other head sizes
@pytest.mark.parametrize("path", [None, "wgmma", "mma"])
@pytest.mark.parametrize("b,s,h,chunk,shared_bc", [
    (2, 256, 64, 128, True),
    (1, 131, 64, 1, True),
    (2, 100, 3, 50, False),
])
def test_ssd_scan_every_path_matches_plain(dev, path, b, s, h, chunk,
                                           shared_bc):
    args = _ssd_args(dev, b, s, h, 64, 64, True, shared_bc=shared_bc)
    got = ssd._launch(*args, chunk, path=path)
    want = ssd.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    _assert_scan_close(got, want, 3e-4)


@pytest.mark.parametrize("b,s,h,p,chunk,with_s0", [
    (2, 96, 40, 64, 32, True),
    (1, 37, 40, 64, 1, True),
    (2, 53, 3, 32, 1, False),
    (1, 49, 4, 16, 7, True),
    (2, 53, 3, 128, 1, True),
])
def test_rwkv6_wkv_matches_plain_at_model_shapes(dev, b, s, h, p, chunk,
                                                 with_s0):
    args = _wkv_args(dev, b, s, h, p, with_s0)
    got = wkv.rwkv6_wkv_cuda(*args, chunk=chunk)
    want = wkv.rwkv6_wkv_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    _assert_scan_close(got, want, 2e-4)


def test_scan_paths_refuse_what_they_do_not_take(dev):
    sargs = _ssd_args(dev, 1, 16, 2, 32, 16, False)
    with pytest.raises(ValueError, match="path"):   # wgmma: P = N = 64 only
        ssd._launch(*sargs, 8, path="wgmma")
    wargs = _wkv_args(dev, 1, 8, 2, 8, False)
    with pytest.raises(ValueError, match="head size"):   # P 16 to 128
        wkv.rwkv6_wkv_cuda(*wargs, chunk=8)


def test_scan_kernels_are_bitwise_repeatable(dev):
    wargs = _wkv_args(dev, 2, 96, 40, 64, True)
    first = wkv.rwkv6_wkv_cuda(*wargs, chunk=32)
    again = wkv.rwkv6_wkv_cuda(*wargs, chunk=32)
    sargs = _ssd_args(dev, 2, 256, 64, 64, 64, True)
    first += ssd.ssd_scan_cuda(*sargs, chunk=128)
    again += ssd.ssd_scan_cuda(*sargs, chunk=128)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_scan_kernels_graph_capture_after_a_smaller_launch(dev):
    """The first launches are small (under 48 KB of shared memory); a graph
    captured afterwards at zamba2's chunk of 128 (230 KB) and rwkv6's head
    size 128 (82 KB) still replays right."""
    ssd.ssd_scan_cuda(*_ssd_args(dev, 1, 8, 2, 16, 8, False), chunk=8)
    wkv.rwkv6_wkv_cuda(*_wkv_args(dev, 1, 4, 1, 16, False), chunk=4)
    sargs = _ssd_args(dev, 1, 256, 64, 64, 64, True)
    wargs = _wkv_args(dev, 2, 64, 4, 128, True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s_out = ssd._launch(*sargs, 128, 64)
        w_out = wkv.rwkv6_wkv_cuda(*wargs, chunk=32)
    graph.replay()
    torch.cuda.synchronize()
    _assert_scan_close(s_out, ssd.ssd_scan_plain(*sargs, chunk=128), 3e-4)
    _assert_scan_close(w_out, wkv.rwkv6_wkv_plain(*wargs, chunk=32), 2e-4)


def test_scan_wrappers_refuse_misaligned_operands(dev):
    r, k, v, log_w, u, _ = _wkv_args(dev, 1, 8, 2, 16, False)
    buf = _randn(60, (1, 8, 2 * 16 + 1), dev, torch.float32)
    shifted = buf[..., 1:].view(1, 8, 2, 16)          # base off by 4 bytes
    with pytest.raises(ValueError, match="16-byte"):
        wkv.rwkv6_wkv_cuda(shifted, k, v, log_w, u, chunk=8)
    odd_rows = _randn(61, (1, 8, 2 * 16 + 1), dev,
                      torch.float32)[..., :32].view(1, 8, 2, 16)  # stride 33
    with pytest.raises(ValueError, match="16-byte"):
        wkv.rwkv6_wkv_cuda(r, k, odd_rows, log_w, u, chunk=8)
    x, dt, a_log, b_in, c_in, _ = _ssd_args(dev, 1, 8, 2, 16, 8, False)
    with pytest.raises(ValueError, match="16-byte"):
        ssd.ssd_scan_cuda(shifted, dt, a_log, b_in, c_in, chunk=8)
    bad_b = buf[..., None, 1:9].expand(1, 8, 2, 8)
    with pytest.raises(ValueError, match="16-byte"):
        ssd.ssd_scan_cuda(x, dt, a_log, bad_b, c_in, chunk=8)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b", "qwen3-8b",
                                  "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                                  "deepseek-v3-671b"])
def test_smoke_lm_on_the_card_matches_the_cpu(dev, arch):
    from repro_torch.models.registry import resolve
    gpu = resolve(arch, device=dev, seed=2).model
    cpu = resolve(arch, device="cpu").model
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    toks = np.random.default_rng(1).integers(4, 512, (2, 37)).astype(np.int32)
    outs = []
    with torch.inference_mode():
        for model, d in ((gpu, dev), (cpu, torch.device("cpu"))):
            logits, state = model.prefill(torch.as_tensor(toks, device=d),
                                          max_len=48)
            seq = [logits]
            for tok in (5, 17, 42, 99):
                logits, state = model.decode_step(state, torch.full(
                    (2, 1), tok, dtype=torch.int32, device=d))
                seq.append(logits)
            outs.append(torch.stack(seq).cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


def test_moe_ffn_is_bitwise_repeatable_on_the_card(dev):
    """The combine gathers each token's k expert outputs and sums them in
    a fixed order (no atomics), and the dispatch scatter writes at most
    one nonzero value a slot: the same inputs give the same bits, with
    dropping (8 experts, top-2, capacity factor 1.25)."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models.layers import moe
    cfg = smoke_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8, top_k=2, capacity_factor=1.25))
    p = moe.MoE(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    for shape in ((4, 64, cfg.d_model), (8, 1, cfg.d_model)):
        x = _randn(3, shape, dev, torch.float32)
        assert moe.dropped_share(p, cfg, x) > 0
        first, aux = moe.moe_ffn(p, cfg, x)
        for _ in range(3):
            again, aux2 = moe.moe_ffn(p, cfg, x)
            assert torch.equal(first, again) and torch.equal(aux, aux2)


def test_continuous_session_on_the_card(dev):
    """The smoke qwen3-8b's slot table on the card: admission waves
    launch ``flash_attention``, table steps ``flash_decode``; every row
    equals its solo generate behind a 1e-4 top-2 margin; free slots step
    past ``max_len`` and the decode there leaves the cache unchanged."""
    from repro_torch.models.registry import resolve
    from repro_torch.runtime.serving import (ContinuousGenerationSession,
                                             GenerationSession,
                                             greedy_margins)
    model = resolve("qwen3-8b", device=dev, seed=2).model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 512, int(n)).astype(np.int32)
               for n in rng.integers(2, 20, 6)]
    solo = GenerationSession(model, max_len=32)
    ref = [solo.generate_with_lengths(p[None], max_new=8) for p in prompts]
    cont = ContinuousGenerationSession(model, max_slots=4, max_len=32)
    ops.reset_launch_counts()
    got = cont.serve(prompts, max_new=8, refill=True)
    launches = ops.launch_counts()
    assert launches["flash_attention"] > 0 and launches["flash_decode"] > 0
    for p, (m, toks), (lens, out) in zip(prompts, got, ref):
        margins = greedy_margins(model, p, out[0, :min(int(lens[0]) + 1, 8)])
        k = int(np.argmax(margins < 1e-4)) if (margins < 1e-4).any() \
            else len(margins)
        assert np.array_equal(toks[:min(k, m)], out[0, :min(k, m)])
        if k == len(margins):
            assert m == int(lens[0])
    # keep one slot free past max_len, then look at its cache
    cont.reset()
    for p in prompts[:5]:
        cont.admit([p[:4]], max_new=8)
        while cont.live_count:
            cont.step()
    assert int(cont._state["pos"][1]) >= 32
    before = [c["k"][:, 1].clone() for c in cont._state["caches"]]
    cont.admit([prompts[0][:4]], max_new=2)
    cont.step()
    torch.cuda.synchronize()
    for b, c in zip(before, cont._state["caches"]):
        assert torch.equal(b, c["k"][:, 1])


def _ragged_batch(lens, vocab, seed=0):
    rng = np.random.default_rng(seed)
    src = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros(src.shape, np.float32)
    for i, L in enumerate(lens):
        src[i, :L] = rng.integers(4, vocab, L)
        mask[i, :L] = 1.0
    return src, mask


def _tensors(state):
    from repro_torch.nmt.common import _leaves
    return list(_leaves(state))


def _nmt(family, dev):
    from repro_torch.nmt import BiLSTMSeq2Seq, GRUSeq2Seq, RNNConfig
    if family == "marian":
        return MarianTransformer(TransformerConfig(
            vocab_src=64, vocab_tgt=64, d_model=64, heads=4, d_ff=128,
            enc_layers=2, dec_layers=2, max_decode_len=12), device=dev,
            seed=3)
    cls = GRUSeq2Seq if family == "gru" else BiLSTMSeq2Seq
    return cls(RNNConfig(vocab_src=64, vocab_tgt=64, embed=32, hidden=32,
                         layers=2, max_decode_len=12), device=dev, seed=3)


@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_rnn_on_the_card_matches_the_cpu(dev, family):
    """Encoder outputs and carries on a ragged batch, then four decode-step
    logits, on the card and on a CPU copy of the same weights."""
    card = _nmt(family, dev)
    cpu = copy.deepcopy(card).to("cpu")
    src, mask = _ragged_batch([9, 3, 12, 1], 64)
    outs = []
    for model in (card, cpu):
        state = model.make_encode_states()(src, mask).data
        with torch.inference_mode():
            seq = [t.flatten() for t in _tensors(state)]
            for tok in (1, 17, 42, 9):
                state, logits = model.decode_step(state, torch.full(
                    (4,), tok, dtype=torch.int32, device=model.device))
                seq.append(logits.flatten())
            outs.append(torch.cat(seq).cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["gru", "bilstm", "marian"])
def test_split_equals_fused_bitwise_on_the_card(dev, family):
    """``decode(encode(src))`` runs the fused path's operations on the
    card, so its tokens are the fused translate's, bit for bit; states
    encoded on a CPU copy decode on the card through ``to``."""
    from repro_torch.runtime.serving import build_executor
    model = _nmt(family, dev)
    src, mask = _ragged_batch([9, 3, 12, 1, 7, 12, 5, 2], 64, seed=1)
    for forced in (None, 5):
        want = model.make_translate_batched()(src, mask, forced_len=forced)
        got = model.make_decode_from_states()(
            model.make_encode_states()(src, mask), forced_len=forced)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    cpu = copy.deepcopy(model).to("cpu")
    enc, dec = build_executor(model, kind="split")
    host_states = cpu.make_encode_states()(src[:1, :9])
    card_states = enc(src[0, :9])
    assert host_states.payload_bytes() == card_states.payload_bytes()
    for h, c in zip(_tensors((host_states.data, host_states.src_lens)),
                    _tensors((card_states.data, card_states.src_lens))):
        torch.testing.assert_close(h.to(dev), c, rtol=1e-4, atol=1e-4)
    m, out = dec(host_states)                      # the wire: CPU -> card
    assert 0 <= m <= 12 and len(out) == max(m, 1)


# ------------------------------------------------------- training guard --
def _guard_calls(dev):
    """One call of each wrapper on small operands whose first tensor
    requires grad (as a trained projection's output would)."""
    q = _randn(60, (1, 8, 2, 16), dev, torch.float32).requires_grad_(True)
    lens = torch.tensor([8], dtype=torch.int32, device=dev)
    u = torch.zeros((2, 16), device=dev)
    dt = torch.ones((1, 8, 2), device=dev)
    return {
        "flash_attention": lambda: ops.flash_attention(q, q, q, causal=True),
        "flash_decode": lambda: ops.flash_decode(q[:, 0], q, q, lens),
        "rwkv6_wkv": lambda: ops.rwkv6_wkv(q, q, q, -q.abs(), u, chunk=8),
        "ssd_scan": lambda: ops.ssd_scan(q, dt, torch.zeros(2, device=dev),
                                         q, q, chunk=4),
    }


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode",
                                  "rwkv6_wkv", "ssd_scan"])
def test_wrappers_refuse_autograd_and_run_under_no_grad(dev, name):
    """The kernels are forward-only: under autograd with an operand that
    requires grad each wrapper raises before it launches; under no_grad
    the same call launches."""
    call = _guard_calls(dev)[name]
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward-only"):
        call()
    assert ops.launch_counts()[name] == 0
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == 1


def test_marian_teacher_kernel_path_matches_training_path(dev):
    cfg = TransformerConfig(vocab_src=500, vocab_tgt=500, d_model=128,
                            heads=2, d_ff=256, enc_layers=2, dec_layers=2,
                            max_decode_len=20, max_src_len=64)
    model = MarianTransformer(cfg, device=dev, seed=2)
    rng = np.random.default_rng(1)
    src = torch.as_tensor(rng.integers(4, 500, (3, 11)), dtype=torch.int32,
                          device=dev)
    mask = torch.ones((3, 11), device=dev)
    mask[1, 6:] = 0.0
    mask[2, 2:] = 0.0
    tgt = torch.as_tensor(rng.integers(4, 500, (3, 9)), dtype=torch.int32,
                          device=dev)
    model.requires_grad_(True)
    ops.reset_launch_counts()
    with torch.no_grad():
        kern = model.forward_teacher(src, mask, tgt, kernels=True)
        train = model.forward_teacher(src, mask, tgt)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 2 + 2 * 2
    torch.testing.assert_close(kern, train, rtol=1e-4, atol=1e-4)
    with pytest.raises(RuntimeError, match="forward-only"):
        model.forward_teacher(src, mask, tgt, kernels=True)
    loss = model.loss({"src": src, "src_mask": mask, "tgt_in": tgt,
                       "tgt_out": tgt, "tgt_mask": torch.ones((3, 9),
                                                              device=dev)})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)


# ------------------------------------------ windows, whisper's shapes --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,lens,window", [
    (2, 1500, 1500, 20, 20, 64, False, None, 0),   # whisper's encoder
    (4, 16, 1500, 20, 20, 64, False, (1500, 700, 1, 0), 0),  # cross
    (1, 200, 200, 8, 2, 128, True, None, 1),
    (2, 300, 300, 4, 4, 64, True, None, 64),
    (2, 130, 130, 4, 4, 64, True, (130, 90), 7),   # a window past the
                                                   # prefix: empty rows
    (1, 100, 100, 4, 4, 32, True, None, 500),      # wider than T
])
def test_flash_attention_window_and_long_keys_match_plain(
        dev, dtype, b, s, t, h, hkv, d, causal, lens, window):
    q = _randn(4, (b, s, h, d), dev, dtype)
    k = _randn(5, (b, t, hkv, d), dev, dtype)
    v = _randn(6, (b, t, hkv, d), dev, dtype)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                     device=dev)
    for bq in fa.BLOCK_Q:
        got = fa.flash_attention_cuda(q, k, v, lengths, causal=causal,
                                      window=window, block_q=bq)
        want = fa.flash_attention_plain(q, k, v, lengths, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,lens,window", [
    (4, 1500, 20, 20, 64, (1500, 700, 1, 0), 0),    # whisper's cross decode
    (1, 4200, 32, 8, 128, (4150,), 4096),           # linear window
    (2, 2048, 8, 8, 64, (2047, 2048), 64),          # splits before the start
    (2, 512, 8, 8, 64, (600, 513), 16),             # past the cache
    (3, 256, 8, 2, 64, (1, 100, 256), 1),
])
def test_flash_decode_window_matches_plain(dev, dtype, b, t, h, hkv, d, lens,
                                           window):
    q = _randn(7, (b, h, d), dev, dtype)
    kc = _randn(8, (b, t, hkv, d), dev, dtype)
    vc = _randn(9, (b, t, hkv, d), dev, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = da.flash_decode_cuda(q, kc, vc, lengths, window=window)
    want = da.flash_decode_plain(q, kc, vc, lengths, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


@pytest.mark.parametrize("arch", ["whisper-large-v3", "qwen3-8b-swa",
                                  "zamba2-1.2b-swa"])
def test_smoke_whisper_and_swa_on_the_card_match_the_cpu(dev, arch):
    """Smoke whisper (frames with a ragged prefix mask) and the smoke
    long-decode variants (window 8: a 12-token prefill into a ring of 8,
    past the window, then decode) on the card against the CPU."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import LM
    base = arch.removesuffix("-swa")
    cfg = smoke_config(base)
    if arch.endswith("-swa"):
        cfg = dataclasses.replace(cfg, sliding_window=8)
    gpu = LM(cfg, device=dev, seed=2)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    toks = rng.integers(4, 512, (2, 12)).astype(np.int32)
    kw = {}
    if cfg.is_encoder_decoder:
        mask = np.ones((2, 16), np.float32)
        mask[1, 9:] = 0.0
        kw = dict(frames=rng.standard_normal((2, 16, cfg.d_model)).astype(
            np.float32), frame_mask=mask)
    outs = []
    with torch.inference_mode():
        for model, d in ((gpu, dev), (cpu, torch.device("cpu"))):
            logits, state = model.prefill(
                torch.as_tensor(toks[:, :6], device=d), max_len=8,
                **{k: torch.as_tensor(v, device=d) for k, v in kw.items()})
            seq = [logits]
            for tok in (5, 17, 42, 99, 7, 3):          # past position 8
                logits, state = model.decode_step(state, torch.full(
                    (2, 1), tok, dtype=torch.int32, device=d))
                seq.append(logits)
            seq.append(model.prefill(torch.as_tensor(toks, device=d),
                                     max_len=16, **{
                                         k: torch.as_tensor(v, device=d)
                                         for k, v in kw.items()})[0])
            outs.append(torch.stack(seq).cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)


# ------------------------------------------- sequence-sharded decode --
QW_LENS = (37, 256, 100, 5, 180, 64, 1, 129)    # a qwen3-8b table step


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,hkv,d,lens,window", [
    (8, 256, 32, 8, 128, QW_LENS, None),            # qwen3-8b, 4 splits
    (8, 256, 32, 8, 128, (0, 256, 300, 1, 0, 9, 256, 2), None),
    (4, 32, 32, 8, 128, (0, 32, 7, 40), None),      # one split
    (3, 256, 8, 2, 64, (256, 100, 3), 40),          # window
])
def test_flash_decode_stats_match_plain(dev, dtype, b, t, h, hkv, d, lens,
                                        window):
    """return_stats: the output bitwise as without stats, and (m, l)
    within 2e-5 of the plain twin's (relative for l), from the combine
    pass with splits and from the main kernel with one: ragged lengths,
    length 0 (m = -1e30, l = the slot count) and lengths past the
    cache."""
    q = _randn(40, (b, h, d), dev, dtype)
    kc = _randn(41, (b, t, hkv, d), dev, dtype)
    vc = _randn(42, (b, t, hkv, d), dev, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, m, l = da.flash_decode_cuda(q, kc, vc, lengths, window=window,
                                     return_stats=True)
    plain = da.flash_decode_plain(q, kc, vc, lengths, window=window,
                                  return_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(out, da.flash_decode_cuda(q, kc, vc, lengths,
                                                 window=window))
    assert m.dtype == l.dtype == torch.float32 and m.shape == (b, h)
    torch.testing.assert_close(out.float(), plain[0].float(),
                               rtol=_tol(dtype), atol=_tol(dtype))
    torch.testing.assert_close(m, plain[1], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l, plain[2], rtol=2e-5, atol=2e-5)


def test_flash_decode_stats_under_a_cuda_graph(dev):
    """A captured stats call reads the lengths on the device at replay."""
    b, t, h, hkv, d = 8, 256, 32, 8, 128
    q = _randn(43, (b, h, d), dev, torch.float32)
    kc = _randn(44, (b, t, hkv, d), dev, torch.float32)
    vc = _randn(45, (b, t, hkv, d), dev, torch.float32)
    lengths = torch.tensor(QW_LENS, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.flash_decode_cuda(q, kc, vc, lengths, return_stats=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = da.flash_decode_cuda(q, kc, vc, lengths, return_stats=True)
    for lens in (QW_LENS, (1, 2, 3, 0, 256, 255, 300, 128)):
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = da.flash_decode_plain(q, kc, vc, lengths, return_stats=True)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_merged_slices_equal_the_whole_cache_on_the_card(dev, n):
    """flash_decode(return_stats=True) on n slices of qwen3-8b's decode
    cache, merged by merge_decode_stats, against the whole cache's
    flash_decode: the sequence-sharded decode's arithmetic on one card."""
    b, t, h, hkv, d = 8, 256, 32, 8, 128
    q = _randn(46, (b, h, d), dev, torch.float32)
    kc = _randn(47, (b, t, hkv, d), dev, torch.float32)
    vc = _randn(48, (b, t, hkv, d), dev, torch.float32)
    lengths = torch.tensor((0,) + QW_LENS[1:], dtype=torch.int32, device=dev)
    s = t // n
    parts = [da.flash_decode_cuda(
        q, kc[:, i * s:(i + 1) * s], vc[:, i * s:(i + 1) * s],
        (lengths - i * s).clamp(min=0), return_stats=True) for i in range(n)]
    got = da.merge_decode_stats(*zip(*parts))
    want = da.flash_decode_cuda(q, kc, vc, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_sharded_session_on_a_one_card_nccl_mesh(dev, tmp_path):
    """The smoke qwen3-8b through make_sharded_session on a 1x1 NCCL mesh
    (tp: the caches' slots over the size-1 model axis, so the decode runs
    attn_decode_seq_sharded: the stats kernel and two all_reduces a
    layer) serves the unsharded session's tokens behind a 1e-4 margin,
    and launches flash_decode."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import resolve
    from repro_torch.runtime.serving import GenerationSession, greedy_margins
    from repro_torch.runtime.sharded import make_sharded_session

    model = resolve("qwen3-8b", device=dev, seed=3).model
    toks = np.random.default_rng(4).integers(4, 512, (4, 12)).astype(
        np.int32)
    lens = np.array([12, 7, 12, 9], np.int32)
    m_ref, ref = GenerationSession(model, max_len=32).generate_with_lengths(
        toks, max_new=8, lengths=lens)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        sess = make_sharded_session(
            model, make_host_mesh((1, 1), ("data", "model"), "cuda"),
            max_len=32, batch_size=4, layout="tp")
        ops.reset_launch_counts()
        m_got, got = sess.generate_with_lengths(toks, max_new=8,
                                                lengths=lens)
        assert ops.launch_counts()["flash_decode"] > 0
    finally:
        dist.destroy_process_group()
    for row, (t, n) in enumerate(zip(toks, lens)):
        margins = greedy_margins(model, t[:n], ref[row])
        low = np.flatnonzero(margins < 1e-4)
        k = int(low[0]) if low.size else len(margins)
        np.testing.assert_array_equal(got[row, :k], ref[row, :k])
        if not low.size:
            assert m_got[row] == m_ref[row]


def test_sharded_graphs_equal_eager_on_a_one_card_nccl_mesh(dev, tmp_path):
    """The smoke qwen3-8b sharded on a 1x1 NCCL mesh (tp) from its CUDA
    graphs, the collectives of attn_decode_seq_sharded captured: the
    session's decode and prefill, the slot table's steps and admission
    waves, and two compiled train steps all equal graphs.eager()'s
    bitwise; the replays count flash_decode's launches."""
    import datetime

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import resolve
    from repro_torch.runtime import graphs
    from repro_torch.runtime.sharded import make_sharded_session, shard_lm
    from repro_torch.training.train_loop import (compile_train_step,
                                                 init_train_state,
                                                 make_train_step)

    rng = np.random.default_rng(5)
    toks = rng.integers(4, 512, (4, 12)).astype(np.int32)
    lens = np.array([12, 7, 12, 9], np.int32)
    prompts = [rng.integers(4, 512, int(n)).astype(np.int32)
               for n in rng.integers(3, 12, 6)]
    stream = rng.integers(1, 512, (2, 4, 17)).astype(np.int32)
    batches = [{"tokens": s[:, :-1], "targets": s[:, 1:]} for s in stream]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"), "cuda")
        sess = make_sharded_session(
            resolve("qwen3-8b", device=dev, seed=3).model, mesh, max_len=32,
            batch_size=4, layout="tp")
        table = make_sharded_session(
            resolve("qwen3-8b", device=dev, seed=3).model, mesh,
            continuous=True, max_slots=4, max_len=32, batch_size=4,
            layout="tp")

        def run():
            out = list(sess.generate_with_lengths(toks, max_new=8,
                                                  lengths=lens))
            for m, t in table.serve(prompts, max_new=6):
                out += [np.asarray([m]), t]
            return out

        with graphs.eager():
            want = run()
        for _ in range(2):
            ops.reset_launch_counts()
            got = run()
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert ops.launch_counts()["flash_decode"] > 0
        assert sess.model._step_graphs.captures == 1
        assert table._graphs.captures == 1 and table._waves.captures > 0

        runs = {}
        for mode in ("eager", "graph"):
            lm, _ = shard_lm(resolve("qwen3-8b", device=dev, seed=3).model,
                             mesh, batch_size=4, layout="tp")
            state = init_train_state(lm)
            step = compile_train_step(make_train_step(lm), lm)
            losses = []
            for batch in batches:
                if mode == "eager":
                    with graphs.eager():
                        state, m = step(state, batch)
                else:
                    state, m = step(state, batch)
                losses.append((m["loss"].clone(), m["grad_norm"].clone()))
            runs[mode] = (losses, [p.detach().clone()
                                   for p in state.params.values()])
            if mode == "graph":
                assert step.graphs.captures == 1
                assert step.graphs.replays == 1
        for (a, b), (c, d) in zip(runs["eager"][0], runs["graph"][0]):
            assert torch.equal(a, c) and torch.equal(b, d)
        assert all(torch.equal(a, b) for a, b in zip(runs["eager"][1],
                                                     runs["graph"][1]))
    finally:
        dist.destroy_process_group()


# --------------------------------------- the Hopper redesign's paths --
_FA_SHAPES = [   # b, s, t, h, hkv, d, causal, lens, window
    (2, 77, 77, 4, 4, 16, False, (77, 20), None),
    (2, 53, 91, 4, 2, 32, True, (91, 30), None),
    (1, 130, 130, 4, 4, 64, True, None, None),       # rep 1, rows past 128
    (2, 129, 200, 16, 4, 64, False, (200, 65), None),  # rep 4, ragged
    (1, 300, 300, 32, 4, 128, True, None, 64),       # rep 8, windowed
    (2, 37, 37, 8, 1, 128, True, (37, 1), None),     # rep 8, short
    (1, 200, 200, 2, 2, 128, True, (0,), None),      # a row with no key
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["wgmma", "mma", None])
@pytest.mark.parametrize("b,s,t,h,hkv,d,causal,lens,window", _FA_SHAPES)
def test_flash_attention_every_path_matches_plain(dev, dtype, path, b, s, t,
                                                  h, hkv, d, causal, lens,
                                                  window):
    """Both kernels (and the plan's choice) at every head dim the path
    has: ragged, causal, windowed, GQA groups of 1, 4 and 8, rows and
    keys straddling the tiles' edges."""
    if path == "wgmma" and d not in fa.WGMMA_HEAD_DIMS:
        pytest.skip(f"the wgmma kernel has no head dim {d}")
    q = _randn(50, (b, s, h, d), dev, dtype)
    k = _randn(51, (b, t, hkv, d), dev, dtype)
    v = _randn(52, (b, t, hkv, d), dev, dtype)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                     device=dev)
    got = fa.flash_attention_cuda(q, k, v, lengths, causal=causal,
                                  window=window, path=path)
    want = fa.flash_attention_plain(q, k, v, lengths, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))


_DA_SHAPES = [   # b, t, h, hkv, d, lens, window
    (2, 70, 4, 4, 16, (0, 70), None),
    (3, 130, 12, 4, 32, (130, 5, 64), None),
    (8, 256, 8, 8, 64, (1, 37, 256, 100, 64, 65, 200, 255), None),
    (2, 2048, 32, 8, 64, (2047, 33), 64),            # rep 4, many splits
    (8, 256, 32, 4, 128, QW_LENS, None),             # rep 8
    (2, 96, 32, 2, 128, (96, 5), None),              # rep 16
    (1, 4200, 32, 8, 128, (4150,), 4096),            # qwen3-8b-swa
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["mma", "cores", None])
@pytest.mark.parametrize("b,t,h,hkv,d,lens,window", _DA_SHAPES)
def test_flash_decode_every_path_matches_plain(dev, dtype, path, b, t, h, hkv,
                                               d, lens, window):
    """Both decode paths (and the plan's choice) with the combine in the
    kernel: output and return_stats' (m, l) against the plain twin, the
    output the same bits with and without stats and on a second call."""
    if path == "mma" and d not in da.MMA_HEAD_DIMS:
        pytest.skip(f"the tensor-core path has no head dim {d}")
    q = _randn(53, (b, h, d), dev, dtype)
    kc = _randn(54, (b, t, hkv, d), dev, dtype)
    vc = _randn(55, (b, t, hkv, d), dev, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, m, l = da.flash_decode_cuda(q, kc, vc, lengths, window=window,
                                     return_stats=True, path=path)
    again = da.flash_decode_cuda(q, kc, vc, lengths, window=window,
                                 path=path)
    want, wm, wl = da.flash_decode_plain(q, kc, vc, lengths, window=window,
                                         return_stats=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), want.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    torch.testing.assert_close(m, wm, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(l, wl, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("path", ["mma", "cores"])
def test_flash_decode_graph_replays_100_times_and_leaves_counters_zero(
        dev, path):
    """One launch a call under a CUDA graph: 100 replays with new lengths
    written on the device each time, each output against the plain
    version, and every split counter back at zero afterwards."""
    b, t, h, hkv, d = 8, 256, 32, 4, 128
    q = _randn(56, (b, h, d), dev, torch.bfloat16)
    kc = _randn(57, (b, t, hkv, d), dev, torch.bfloat16)
    vc = _randn(58, (b, t, hkv, d), dev, torch.bfloat16)
    lengths = torch.tensor(QW_LENS, dtype=torch.int32, device=dev)
    assert da.decode_splits(b, hkv, t)[0] > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.flash_decode_cuda(q, kc, vc, lengths, path=path)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = da.flash_decode_cuda(q, kc, vc, lengths, path=path)
    rng = np.random.default_rng(7)
    for _ in range(100):
        lengths.copy_(torch.as_tensor(rng.integers(-1, t + 40, size=b),
                                      dtype=torch.int32))
        graph.replay()
        want = da.flash_decode_plain(q, kc, vc, lengths)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    torch.cuda.synchronize()
    assert int((da.counter_buffer(dev) != 0).sum()) == 0


# ------------------------------------------------------------ step graphs --
def _twice_counted(fn):
    """``fn()`` twice, the launch counts of the second call (the first may
    capture, and its warm-ups launch)."""
    fn()
    ops.reset_launch_counts()
    out = fn()
    return out, ops.launch_counts()


@pytest.mark.parametrize("family", ["gru", "bilstm", "marian"])
def test_translate_graphs_equal_eager_bitwise(dev, family):
    """The default translate and both split legs replay CUDA graphs; their
    tokens and lengths equal ``graphs.eager()``'s bit for bit, with two
    keys interleaved, in EOS and forced modes, and replayed launches count
    as the eager ones do."""
    from repro_torch.runtime import graphs
    model = _nmt(family, dev)
    batches = (_ragged_batch([9, 3, 12, 1, 7, 12, 5, 2], 64, seed=1),
               _ragged_batch([4, 6], 64, seed=2))
    translate = model.make_translate_batched()
    enc, dec = model.make_encode_states(), model.make_decode_from_states()

    def run(forced):
        return [o for src, mask in batches for o in
                translate(src, mask, forced_len=forced)
                + dec(enc(src, mask), forced_len=forced)]

    for forced in (None, 5):
        with graphs.eager():
            want, eager_counts = _twice_counted(lambda: run(forced))
        got, counts = _twice_counted(lambda: run(forced))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert counts == eager_counts
    cache = model._step_graphs
    # per key: the translate's state and step, the encoder's graph, the
    # decode leg's step (and its state's graph: Marian's init_cache)
    assert cache.captures == 2 * (5 if family == "marian" else 4)
    assert len(cache) == 6 and cache.replays > 0


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b", "zamba2-1.2b",
                                  "qwen3-moe-30b-a3b"])
def test_session_graphs_equal_eager_bitwise(dev, arch):
    """GenerationSession's default decode replays one graph a step:
    tokens and lengths equal the eager loop's bitwise, B=1 and B=4 keys
    interleaved; the slot table's graph serves with refill as the eager
    table does."""
    from repro_torch.models.registry import resolve
    from repro_torch.runtime import graphs
    from repro_torch.runtime.serving import (ContinuousGenerationSession,
                                             GenerationSession)
    model = resolve(arch, device=dev, seed=2).model
    rng = np.random.default_rng(4)
    batch = rng.integers(4, 512, (3, 9)).astype(np.int32)
    prompts = [rng.integers(4, 512, int(n)).astype(np.int32)
               for n in (5, 9, 9, 5, 9, 5)]
    sess = GenerationSession(model, max_len=32)
    cont = ContinuousGenerationSession(model, max_slots=4, max_len=32)

    def run():
        outs = []
        for _ in range(2):
            outs += sess.generate_with_lengths(batch, max_new=10)
            outs += sess.generate_with_lengths(batch[:1], max_new=7)
        cont.reset()
        for m, toks in cont.serve(prompts, max_new=6, refill=True):
            outs += [np.asarray([m]), toks]
        return outs

    with graphs.eager():
        want, eager_counts = _twice_counted(run)
    got, counts = _twice_counted(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert counts == eager_counts
    assert model._step_graphs.captures == 2 and cont._graphs.captures == 1


def _tree_bits(tree):
    from repro_torch.runtime import graphs
    return [t.clone() for t in graphs.leaves(tree)]


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b", "zamba2-1.2b",
                                  "qwen3-moe-30b-a3b", "whisper-large-v3"])
def test_prefill_graphs_equal_eager_bitwise(dev, arch):
    """GenerationSession's prefill replays one graph per prompt block,
    written into its decode key's state: the logits and every state
    tensor equal the eager prefill's bitwise, two blocks interleaved, and
    a replay counts the launches an eager prefill makes."""
    from repro_torch.models.registry import resolve
    from repro_torch.runtime import graphs
    from repro_torch.runtime.serving import GenerationSession
    model = resolve(arch, device=dev, seed=2).model
    rng = np.random.default_rng(5)
    sess = GenerationSession(model, max_len=32)
    if model.cfg.is_encoder_decoder:
        toks = rng.integers(4, 512, (2, 6)).astype(np.int32)
        frames = rng.standard_normal((2, 16, model.cfg.d_model)).astype(
            np.float32)
        blocks = [(toks, None, torch.as_tensor(f))
                  for f in (frames, frames[:, :12])]
    else:
        blocks = [(*sess._bucket_pad(
            rng.integers(4, 512, (3, n)).astype(np.int32), None, 8), None)
            for n in (9, 5)]

    def prefill(block, graph):
        with torch.inference_mode():
            logits, state, _ = sess._prefill(*block, graph=graph)
            return [logits.clone()] + _tree_bits(state)

    for block in blocks:
        want, eager_counts = _twice_counted(lambda: prefill(block, False))
        got, counts = _twice_counted(lambda: prefill(block, True))
        assert counts == eager_counts
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for block in blocks:                       # the keys interleaved
        want = prefill(block, False)
        for g, w in zip(prefill(block, True), want):
            assert torch.equal(g, w)
    assert sum(len(e.prefills) for e in
               model._step_graphs.entries()) == len(blocks)
    assert graphs.totals()["replays"] > 0


def test_admission_wave_graphs_equal_eager_bitwise(dev):
    """The slot table's admission waves replay one graph per (batch,
    width, ragged) key: with refill, waves padded past their rows while
    other slots are live, every step's stream and the table's state
    equal the eager table's bitwise."""
    from repro_torch.models.registry import resolve
    from repro_torch.runtime import graphs
    from repro_torch.runtime.serving import ContinuousGenerationSession
    model = resolve("qwen3-8b", device=dev, seed=2).model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(4, 512, int(n)).astype(np.int32)
               for n in (5, 9, 3, 7, 9, 2, 6, 4, 8)]
    cont = ContinuousGenerationSession(model, max_slots=4, max_len=32)

    def run():
        cont.reset()
        out = [np.asarray(s, np.int64).reshape(-1)
               for s in (cont.admit(prompts[:1], max_new=6),)]
        head = 1
        while head < len(prompts) or cont.live_count:
            take = min(cont.free_slots, len(prompts) - head)
            if take:
                cont.admit(prompts[head:head + take], max_new=6,
                           req_ids=list(range(head, head + take)))
                head += take
            stream, _ = cont.step()
            out.append(np.asarray(stream, np.int64).reshape(-1))
        return out + [t.cpu() for t in _tree_bits(
            (cont._state, cont._tok, cont._done))]

    with graphs.eager():
        want = run()
    for _ in range(2):
        got = run()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (torch.equal(g, w) if isinstance(g, torch.Tensor)
                    else np.array_equal(g, w))
    assert cont._waves.captures == len(cont._waves) > 1
    assert cont._waves.replays > 0


@pytest.mark.parametrize("what", ["qwen3-8b", "rwkv6-3b", "marian", "gru"])
def test_train_step_graphs_equal_eager_bitwise(dev, what):
    """compile_train_step replays one graph per batch key: 3 steps (two
    keys for the NMT models) from the graphs equal eager's bitwise, every
    loss and grad norm and every parameter and moment, eager being
    bitwise equal to itself first; no kernel launches."""
    from repro_torch.launch import train_nmt as tn
    from repro_torch.models.registry import resolve
    from repro_torch.runtime import graphs
    from repro_torch.training.optimizer import cosine_schedule
    from repro_torch.training.train_loop import (compile_train_step,
                                                 init_train_state,
                                                 make_train_step)
    rng = np.random.default_rng(8)
    sched = cosine_schedule(1e-3, warmup_steps=1, total_steps=4)
    if what in ("marian", "gru"):
        build = lambda: tn.build_model(what, device=dev, seed=3)
        src, tgt = tn.corpus_tokens("de-en", build().cfg, size=256)
        feed = tn.batches(src, tgt, batch=8)
        b0, b1 = next(feed), next(feed)
        batches = [b0, b1, b0, b1]
        make = lambda m: tn.make_nmt_train_step(m, sched)
    else:
        build = lambda: resolve(what, device=dev, seed=2).model
        toks = rng.integers(1, 512, (2, 17)).astype(np.int32)
        batches = [{"tokens": toks[:, :-1], "targets": toks[:, 1:]}] * 3
        make = lambda m: make_train_step(m, lr_schedule=sched)

    def run():
        model = build()
        state = init_train_state(model)
        step = compile_train_step(make(model), model)
        mets = []
        for b in batches:
            state, m = step(state, b)
            mets += [m["loss"].clone(), m["grad_norm"].clone()]
        return mets + [t.detach().clone() for t in (
            list(state.params.values()) + list(state.opt.mu.values())
            + list(state.opt.nu.values()) + [state.opt.step])], step

    with graphs.eager():
        want, _ = run()
        again, _ = run()
    assert all(torch.equal(a, b) for a, b in zip(again, want))
    ops.reset_launch_counts()
    got, step = run()
    assert not any(ops.launch_counts().values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # every call but the first (the cache's warm-up) is a replay: a later
    # key's first call replays its graph after the capture
    keys = len({tuple(np.shape(v) for v in b.values()) for b in batches})
    assert step.graphs.captures == keys
    assert step.graphs.replays == len(batches) - 1
