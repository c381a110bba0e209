"""The port's attention wrappers on CPU tensors (the kernels' plain
versions) against the JAX Pallas kernels in interpret mode and against
the reference oracles, mirroring the cases of ``tests/test_kernels.py``.

Tolerances are those of ``tests/test_kernels.py``: 2e-5 in float32 (the
two sides reduce in different orders), 2e-2 in bfloat16.  Interpret mode
is slow, so each case is one or two tiny shapes; S and T are chosen not
to be multiples of any block, so the JAX wrapper's padding path runs.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here it is checked that a non-CPU tensor can
never take the plain path.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from _torch_threads import cap_threads

cap_threads()

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(x, dtype):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------- flash attention --
@pytest.mark.parametrize("b,s,h,hkv,d,dtype", [
    (1, 40, 4, 4, 16, "f32"),     # MHA, ragged S=T
    (2, 24, 4, 2, 16, "f32"),     # GQA rep=2
    (1, 40, 4, 2, 16, "bf16"),
])
def test_flash_attention_causal_matches_pallas_and_ref(b, s, h, hkv, d, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_randn(i, shp), dtype)
        for i, shp in enumerate([(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)]))
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == (b, s, h, d)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, block_q=32,
                                     block_k=32, interpret=True), tol)
    _close(got, jref.attention_ref(jq, jk, jv, causal=True), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_length_masking_matches_pallas(causal):
    b, s, h, d = 3, 40, 2, 16
    jq, tq = _pair(_randn(11, (b, s, h, d)), "f32")
    jk, tk = _pair(_randn(12, (b, s, h, d)), "f32")
    jv, tv = _pair(_randn(13, (b, s, h, d)), "f32")
    lens = np.asarray([40, 17, 1], np.int32)
    got = tops.flash_attention(tq, tk, tv, torch.from_numpy(lens),
                               causal=causal)
    _close(got, jops.flash_attention(jq, jk, jv, jnp.asarray(lens),
                                     causal=causal, block_q=16, block_k=16,
                                     interpret=True), F32_TOL)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal,
                                   lengths=jnp.asarray(lens)), F32_TOL)


def test_flash_attention_noncausal_cross_shape_matches_ref():
    """S != T, non-causal: the Marian cross-attention shape."""
    jq, tq = _pair(_randn(21, (2, 7, 4, 16)), "f32")
    jk, tk = _pair(_randn(22, (2, 19, 4, 16)), "f32")
    jv, tv = _pair(_randn(23, (2, 19, 4, 16)), "f32")
    lens = np.asarray([19, 5], np.int32)
    got = tops.flash_attention(tq, tk, tv, torch.from_numpy(lens),
                               causal=False)
    _close(got, jref.attention_ref(jq, jk, jv, causal=False,
                                   lengths=jnp.asarray(lens)), F32_TOL)
    _close(got, tref.attention_ref(tq, tk, tv, causal=False,
                                   lengths=torch.from_numpy(lens)), F32_TOL)


def test_flash_attention_length_equals_full_is_identity():
    q, k, v = (torch.from_numpy(_randn(i, (2, 20, 4, 16))) for i in (1, 2, 3))
    a = tops.flash_attention(q, k[:, :, :2], v[:, :, :2], causal=True)
    b = tops.flash_attention(q, k[:, :, :2], v[:, :, :2],
                             torch.full((2,), 20, dtype=torch.int32),
                             causal=True)
    assert torch.equal(a, b)


def test_flash_attention_length_one_attends_single_key():
    q, k, v = (torch.from_numpy(_randn(i, (1, 20, 2, 16))) for i in (4, 5, 6))
    out = tops.flash_attention(q, k, v, torch.tensor([1], dtype=torch.int32),
                               causal=False)
    _close(out, v[:, :1].expand_as(out).numpy(), 1e-5)


def test_flash_attention_fully_masked_row_averages_every_key():
    """length 0: the kernels' degenerate contract (the ref returns NaN)."""
    q, k, v = (torch.from_numpy(_randn(i, (1, 6, 2, 16))) for i in (7, 8, 9))
    out = tops.flash_attention(q, k, v, torch.tensor([0], dtype=torch.int32),
                               causal=False)
    _close(out, v.mean(dim=1, keepdim=True).expand_as(out).numpy(), 1e-5)


def test_causal_offset_zero_differs_from_ref_only_when_s_ne_t():
    """The kernels' causal mask is at offset 0; the oracle aligns queries
    to the last S keys.  Both packages' oracles agree with each other."""
    jq, tq = _pair(_randn(31, (1, 5, 2, 16)), "f32")
    jk, tk = _pair(_randn(32, (1, 9, 2, 16)), "f32")
    jv, tv = _pair(_randn(33, (1, 9, 2, 16)), "f32")
    _close(tref.attention_ref(tq, tk, tv, causal=True),
           jref.attention_ref(jq, jk, jv, causal=True), F32_TOL)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, block_q=8,
                                     block_k=8, interpret=True), F32_TOL)
    assert not np.allclose(got.numpy(), np.asarray(
        jref.attention_ref(jq, jk, jv, causal=True)), atol=1e-3)


# ----------------------------------------------------------- flash decode --
@pytest.mark.parametrize("b,s,h,hkv,d,dtype", [
    (2, 40, 4, 4, 16, "f32"),
    (3, 24, 4, 2, 16, "f32"),
    (2, 40, 4, 1, 16, "bf16"),
])
def test_flash_decode_matches_pallas_and_ref(b, s, h, hkv, d, dtype):
    jq, tq = _pair(_randn(41, (b, h, d)), dtype)
    jk, tk = _pair(_randn(42, (b, s, hkv, d)), dtype)
    jv, tv = _pair(_randn(43, (b, s, hkv, d)), dtype)
    lens = np.asarray([1, s // 2 + 1, s][:b], np.int32)
    got = tops.flash_decode(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == (b, h, d)
    tol = BF16_TOL if dtype == "bf16" else F32_TOL
    _close(got, jops.flash_decode(jq, jk, jv, jnp.asarray(lens), block_s=16,
                                  interpret=True), tol)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)), tol)
    _close(tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens)),
           jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)), tol)


def test_flash_decode_reads_the_folded_cache_through_strides():
    """Marian's (B,T,H*D) cache viewed as (B,T,H,D) gives the same result
    as a contiguous copy of the same numbers."""
    b, t, h, d = 2, 12, 4, 8
    cache_k = torch.from_numpy(_randn(51, (b, t, h * d)))
    cache_v = torch.from_numpy(_randn(52, (b, t, h * d)))
    q = torch.from_numpy(_randn(53, (b, h * d)))
    lens = torch.tensor([3, 12], dtype=torch.int32)
    kv = cache_k.view(b, t, h, d), cache_v.view(b, t, h, d)
    out = tops.flash_decode(q.view(b, h, d), *kv, lens)
    want = tops.flash_decode(q.view(b, h, d).clone(), kv[0].contiguous(),
                             kv[1].contiguous(), lens)
    assert torch.equal(out, want)
    jout = jops.flash_decode(jnp.asarray(q.numpy()).reshape(b, h, d),
                             jnp.asarray(kv[0].numpy()),
                             jnp.asarray(kv[1].numpy()),
                             jnp.asarray(lens.numpy()), block_s=8,
                             interpret=True)
    _close(out, jout, F32_TOL)


def test_flash_decode_length_one_attends_slot_zero():
    q = torch.from_numpy(_randn(61, (1, 2, 16)))
    k, v = (torch.from_numpy(_randn(i, (1, 30, 2, 16))) for i in (62, 63))
    out = tops.flash_decode(q, k, v, torch.tensor([1], dtype=torch.int32))
    _close(out, v[:, 0].numpy(), 1e-5)


# ------------------------------------------------------------- no fallback --
def test_cpu_path_takes_plain_versions_and_launches_nothing():
    tops.reset_launch_counts()
    q = torch.from_numpy(_randn(71, (1, 8, 2, 16)))
    tops.flash_attention(q, q, q, causal=False)
    tops.flash_decode(q[:, 0], q, q, torch.tensor([8], dtype=torch.int32))
    assert tops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                    "rwkv6_wkv": 0, "ssd_scan": 0}


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU goes to the kernel wrapper, which launches or
    raises; here (no card) it must raise, never compute a result."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, q, q, lens, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_decode(q[:, 0], q, q, lens)
    assert tops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                    "rwkv6_wkv": 0, "ssd_scan": 0}


def test_cuda_wrappers_reject_cpu_tensors():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        tda.flash_decode_cuda(q[:, 0], q, q,
                              torch.ones((1,), dtype=torch.int32))


def test_missing_nvcc_raises_at_build_not_at_import(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_library()
    finally:
        _build.load_library.cache_clear()


_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float}


@pytest.mark.parametrize("source", _build.SOURCES)
def test_ctypes_signatures_match_the_c_entry_points(source):
    """Each extern "C" entry point's parameters, read from its source, are
    the argtypes ``load_library`` gives it: a parameter added or removed
    on one side fails here, not at the first launch on the card."""
    entries = re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                         (_build.CSRC / source).read_text())
    assert entries
    for name, params in entries:
        types = []
        for param in params.split(","):
            words = param.replace("*", " * ").split()
            types.append(ctypes.c_void_p if "*" in words
                         else _C_TYPES[words[0]])
        assert _build._SIGNATURES[name] == types, name


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
