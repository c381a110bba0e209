"""The port's Marian transformer against the JAX reference, same weights.

Weights come only through ``repro_torch.convert.marian_params_from_jax``
(``jax.random`` and ``torch.Generator`` draw different numbers).  Encoder
outputs and per-step decode logits are held to 1e-5 against the JAX
``attn_impl="xla"`` path in float32 (the reductions run in another
order).  Token sequences are held equal on weights whose argmax margin
is checked to be far above that tolerance at every step.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.data.tokenizer import EOS_ID, PAD_ID
from repro.models.registry import resolve as j_resolve
from repro.nmt import MarianTransformer as JMarian
from repro.nmt import TransformerConfig as JConfig
from repro_torch.convert import marian_params_from_jax
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as tops
from repro_torch.models.registry import nmt_config
from repro_torch.models.registry import resolve as t_resolve
from repro_torch.nmt import MarianTransformer as TMarian
from repro_torch.nmt import TransformerConfig as TConfig
from repro_torch.nmt.transformer import make_executors

V = 64
TOL = 1e-5
SIZE = dict(vocab_src=V, vocab_tgt=V, d_model=32, heads=4, d_ff=64,
            enc_layers=2, dec_layers=2, max_decode_len=16, max_src_len=64)


def _models(cfg=None, key=0, eos_bias=None):
    """(jax model, jax params, port model) on the same weights.

    ``eos_bias`` sharpens the tiny random model (larger output and target
    embedding scales) and biases EOS so rows stop at different steps."""
    return _cached_models(tuple(sorted((cfg or SIZE).items())), key, eos_bias)


@functools.lru_cache(maxsize=None)
def _cached_models(cfg_items, key, eos_bias):
    cfg = dict(cfg_items)
    jm = JMarian(JConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(key))
    if eos_bias is not None:
        params["out"]["w"] = params["out"]["w"] * 4.0
        params["tgt_embed"] = params["tgt_embed"] * 4.0
        params["out"]["b"] = params["out"]["b"].at[EOS_ID].set(eos_bias)
    tm = TMarian(TConfig(**cfg), device="cpu")
    tm.load_state_dict(marian_params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    return jm, params, tm


def _ragged(seed, lens):
    rng = np.random.default_rng(seed)
    src = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros(src.shape, np.float32)
    for i, L in enumerate(lens):
        src[i, :L] = rng.integers(4, V, L)
        mask[i, :L] = 1.0
    return src, mask


def _min_margin(jm, params, src, mask, steps):
    """Smallest top-1 minus top-2 logit gap along the greedy trajectory."""
    enc, m = jm.encode(params, jnp.asarray(src), jnp.asarray(mask))
    st = jm.init_cache(params, enc, m)
    tok = jnp.full((src.shape[0],), 1, jnp.int32)
    gaps = []
    for _ in range(steps):
        st, lg = jm.decode_step(params, st, tok)
        top2 = jnp.sort(lg, axis=-1)[:, -2:]
        gaps.append(float(jnp.min(top2[:, 1] - top2[:, 0])))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    return min(gaps)


def test_converter_covers_every_parameter_with_dense_transposed():
    jm, params, tm = _models()
    sd = marian_params_from_jax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    w = np.asarray(params["enc"][0]["attn"]["q"]["w"])
    np.testing.assert_array_equal(sd["enc.0.attn.q.weight"].numpy(), w.T)


def test_batched_encoder_matches_jax():
    jm, params, tm = _models()
    src, mask = _ragged(0, [5, 9, 3, 7])
    je, _ = jm.encode(params, jnp.asarray(src), jnp.asarray(mask))
    with torch.inference_mode():
        te, _ = tm.encode(torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=TOL, atol=TOL)


def test_batched_decode_step_logits_match_jax():
    jm, params, tm = _models(key=1)
    src, mask = _ragged(1, [6, 2, 9])
    je, jmask = jm.encode(params, jnp.asarray(src), jnp.asarray(mask))
    jst = jm.init_cache(params, je, jmask)
    with torch.inference_mode():
        te, tmask = tm.encode(torch.from_numpy(src), torch.from_numpy(mask))
        tst = tm.init_cache(te, tmask)
        rng = np.random.default_rng(2)
        for _ in range(5):
            tok = rng.integers(4, V, 3).astype(np.int32)
            jst, jl = jm.decode_step(params, jst, jnp.asarray(tok))
            tst, tl = tm.decode_step(tst, torch.from_numpy(tok))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


def test_per_sequence_path_matches_jax_per_sequence_path():
    jm, params, tm = _models(key=2)
    src = np.random.default_rng(3).integers(4, V, 7).astype(np.int32)
    je, jmask = jm.encode(params, jnp.asarray(src))
    jst = jm.init_cache(params, je, jmask)
    with torch.inference_mode():
        te, tmask = tm.encode(torch.from_numpy(src))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=TOL,
                                   atol=TOL)
        tst = tm.init_cache(te, tmask)
        for tok in (1, 9, 33, 5):
            jst, jl = jm.decode_step(params, jst, jnp.asarray(tok, jnp.int32))
            tst, tl = tm.decode_step(tst, torch.tensor(tok,
                                                       dtype=torch.int32))
            assert tl.shape == (V,)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("forced_len", [None, 9])
def test_translate_batched_tokens_equal_jax(forced_len):
    jm, params, tm = _models(key=0, eos_bias=5.0)
    src, mask = _ragged(0, [5, 9, 3, 7])
    assert _min_margin(jm, params, src, mask, 16) > 1e-3
    jl, jt = jm.make_translate_batched(params)(src, mask,
                                               forced_len=forced_len)
    tl, tt = tm.make_translate_batched()(src, mask, forced_len=forced_len)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    if forced_len is None:
        assert len(set(tl.tolist())) > 1          # rows stop at EOS apart
        assert EOS_ID not in tt[tl < 16]          # EOS slot PAD-masked
        i = int(np.argmin(tl))
        assert np.all(tt[i, tl[i]:] == PAD_ID)
    else:
        assert tt.shape == (4, forced_len)


def test_per_sequence_translate_and_host_loop_match_jax():
    jm, params, tm = _models(key=0, eos_bias=5.0)
    src, mask = _ragged(0, [5, 9, 3, 7])
    translate_j, translate_t = jm.make_translate(params), tm.make_translate()
    for i, L in enumerate([5, 9, 3, 7]):
        m_j, t_j = translate_j(src[i, :L])
        m_t, t_t = translate_t(src[i, :L])
        assert m_t == m_j
        np.testing.assert_array_equal(t_t, np.asarray(t_j))
    hl, ht = tm.make_translate_batched(compiled=False)(src, mask)
    bl, bt = tm.make_translate_batched()(src, mask)
    np.testing.assert_array_equal(hl, bl)
    for i, m in enumerate(bl):
        np.testing.assert_array_equal(ht[i, :m], bt[i, :m])


def test_pallas_interpret_path_agrees_with_port():
    """One case through the JAX Pallas kernels in interpret mode."""
    cfg = dict(SIZE, max_decode_len=6, max_src_len=16)
    jp = JMarian(JConfig(**cfg), attn_impl="pallas")
    _, params, tm = _models(cfg, key=0, eos_bias=5.0)
    src, mask = _ragged(4, [5, 3])
    je, _ = jp.encode(params, jnp.asarray(src), jnp.asarray(mask))
    with torch.inference_mode():
        te, _ = tm.encode(torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=TOL, atol=TOL)
    jl, jt = jp.make_translate_batched(params)(src, mask, forced_len=4)
    tl, tt = tm.make_translate_batched()(src, mask, forced_len=4)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_array_equal(tt, np.asarray(jt))


def test_executors_match_translate_and_clip_vocab():
    _, _, tm = _models(key=0, eos_bias=5.0)
    executor, batched = make_executors(tm)
    src, mask = _ragged(0, [5, 9, 3, 7])
    lens, toks = tm.make_translate_batched()(src, mask)
    outs = batched(src, [5, 9, 3, 7])
    auto = batched(src)                     # lengths from trailing PADs
    for i, L in enumerate([5, 9, 3, 7]):
        m, t = executor(src[i, :L])
        assert m == outs[i][0] == auto[i][0] == int(lens[i])
        np.testing.assert_array_equal(t, toks[i, :m])
        np.testing.assert_array_equal(outs[i][1], t)
    big = src[0, :5].copy()
    big[0] = 10 * V                         # out of the model's vocabulary
    clipped = big.copy()
    clipped[0] = V - 1
    assert executor(big)[0] == executor(clipped)[0]


def test_forced_len_beyond_cache_raises():
    _, _, tm = _models()
    with pytest.raises(ValueError, match="max_decode_len"):
        tm.make_translate_batched()(np.ones((1, 3), np.int32), forced_len=17)


def test_cpu_translate_launches_no_kernel():
    _, _, tm = _models()
    tops.reset_launch_counts()
    tm.make_translate_batched()(np.ones((2, 4), np.int32), forced_len=3)
    assert tops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                    "rwkv6_wkv": 0, "ssd_scan": 0}


# ---------------------------------------------------------------- registry --
@pytest.mark.parametrize("scale", [1.0, 0.25, 0.1])
def test_registry_scale_rules_match_jax(scale):
    want = j_resolve("cnmt:en-zh", scale=scale, vocab=500,
                     max_decode_len=12).cfg
    got = nmt_config("en-zh", scale=scale, vocab=500, max_decode_len=12)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if scale == 1.0:                    # the paper's width: built on the card
        assert (got.d_model, got.heads, got.d_ff, got.enc_layers,
                got.dec_layers, got.max_src_len) == (512, 8, 2048, 6, 6, 512)
        return
    r = t_resolve("zh-en", scale=scale, vocab=500, max_decode_len=12,
                  device="cpu")
    assert r.name == "cnmt:en-zh" and r.pair == "en-zh" and r.cfg == got


@pytest.mark.parametrize("name", ["qwen3_8b", "whisper-large-v3"])
def test_registry_later_slices_raise_not_implemented(name):
    with pytest.raises(NotImplementedError):
        t_resolve(name, device="cpu")


def test_registry_unknown_name_raises_key_error():
    with pytest.raises(KeyError):
        t_resolve("cnmt:xx-yy", device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TMarian(TConfig(**SIZE))
    assert resolve_device("cpu").type == "cpu"
