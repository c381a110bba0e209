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
@pytest.mark.parametrize("p,p_tile", [(64, 16), (64, 32), (64, 64),
                                      (128, 64), (32, 32), (16, 16)])
def test_rwkv6_wkv_every_plan_matches_plain(dev, with_s0, s, chunk, p,
                                            p_tile):
    args = _wkv_args(dev, 2, s, 3, p, with_s0)
    got = wkv._launch(*args, chunk, p_tile)
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
    captured afterwards at zamba2's chunk of 128 (230 KB) and rwkv6-3b's
    widest tile still replays right."""
    ssd.ssd_scan_cuda(*_ssd_args(dev, 1, 8, 2, 16, 8, False), chunk=8)
    wkv.rwkv6_wkv_cuda(*_wkv_args(dev, 1, 4, 1, 16, False), chunk=4)
    sargs = _ssd_args(dev, 1, 256, 64, 64, 64, True)
    wargs = _wkv_args(dev, 2, 64, 40, 64, True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s_out = ssd._launch(*sargs, 128, 64)
        w_out = wkv._launch(*wargs, 32, 64)
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


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
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
