"""The port's BiLSTM (de-en) and GRU (fr-en) against the JAX reference,
same weights.

Weights come only through ``repro_torch.convert.gru_params_from_jax`` /
``bilstm_params_from_jax``.  Encoder outputs, carries and per-step decode
logits are held to 1e-5 in float32 (the reductions run in another
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
from repro.nmt import BiLSTMSeq2Seq as JBiLSTM
from repro.nmt import GRUSeq2Seq as JGRU
from repro.nmt import RNNConfig as JConfig
from repro_torch.convert import bilstm_params_from_jax, gru_params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.models.registry import nmt_config
from repro_torch.models.registry import resolve as t_resolve
from repro_torch.nmt import BiLSTMSeq2Seq as TBiLSTM
from repro_torch.nmt import GRUSeq2Seq as TGRU
from repro_torch.nmt import RNNConfig as TConfig

V = 64
TOL = 1e-5
SIZE = dict(vocab_src=V, vocab_tgt=V, embed=32, hidden=32, layers=2,
            max_decode_len=16)
FAMILIES = {"gru": (JGRU, TGRU, gru_params_from_jax),
            "bilstm": (JBiLSTM, TBiLSTM, bilstm_params_from_jax)}
LENS = [5, 9, 3, 7]
# per family, an EOS bias under which the rows of ``ragged(0, LENS)`` stop
# at different steps with every greedy margin above 1e-3
EOS_BIAS = {"gru": 0.4, "bilstm": 0.15}


@functools.lru_cache(maxsize=None)
def rnn_models(family, key=0, eos_bias=None):
    """(jax model, jax params, port model on the CPU) on the same weights.

    ``eos_bias`` sharpens the tiny random model (larger output and target
    embedding scales) and biases EOS so rows stop at different steps."""
    jcls, tcls, convert = FAMILIES[family]
    jm = jcls(JConfig(**SIZE))
    params = jm.init(jax.random.PRNGKey(key))
    if eos_bias is not None:
        params["out"]["w"] = params["out"]["w"] * 4.0
        params["tgt_embed"] = params["tgt_embed"] * 4.0
        params["out"]["b"] = params["out"]["b"].at[EOS_ID].set(eos_bias)
    tm = tcls(TConfig(**SIZE), device="cpu")
    tm.load_state_dict(convert(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm


def ragged(seed, lens, vocab=V):
    """A prefix-padded (B, max(lens)) batch and its float32 mask."""
    rng = np.random.default_rng(seed)
    src = np.zeros((len(lens), max(lens)), np.int32)
    mask = np.zeros(src.shape, np.float32)
    for i, L in enumerate(lens):
        src[i, :L] = rng.integers(4, vocab, L)
        mask[i, :L] = 1.0
    return src, mask


def jax_state(family, jm, params, src, mask):
    """The reference's batched decode state of a batch."""
    if family == "gru":
        return jm.encode(params, src, mask)
    enc, carries, m = jm.encode(params, src, mask)
    return (carries, enc, m)


def min_margin(family, jm, params, src, mask, steps):
    """Smallest top-1 minus top-2 logit gap along the greedy trajectory."""
    st = jax_state(family, jm, params, jnp.asarray(src), jnp.asarray(mask))
    tok = jnp.full((src.shape[0],), 1, jnp.int32)
    step = jax.jit(lambda st, tok: jm.decode_step(params, st, tok))
    gaps = []
    for _ in range(steps):
        st, lg = step(st, tok)
        top2 = jnp.sort(lg, axis=-1)[:, -2:]
        gaps.append(float(jnp.min(top2[:, 1] - top2[:, 0])))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    return min(gaps)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _carries_close(got, want):
    jl = jax.tree_util.tree_leaves(want)
    tl = [t for h_c in got for t in h_c]
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        _close(t, j)


# --------------------------------------------------------------- converter --
@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_converter_covers_every_parameter(family):
    jm, params, tm = rnn_models(family)
    sd = FAMILIES[family][2](jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    cell = params["enc"] if family == "gru" else params["enc"][0]["fwd"]
    name = "enc.wx" if family == "gru" else "enc.0.fwd.wx"
    np.testing.assert_array_equal(sd[name].numpy(), np.asarray(cell["wx"]))
    np.testing.assert_array_equal(sd["out.weight"].numpy(),
                                  np.asarray(params["out"]["w"]).T)


def test_gru_is_one_layer_whatever_layers_says():
    one = TGRU(TConfig(**dict(SIZE, layers=1)), device="cpu")
    two = TGRU(TConfig(**SIZE), device="cpu", seed=0)
    assert set(one.state_dict()) == set(two.state_dict())
    for a, b in zip(one.state_dict().values(), two.state_dict().values()):
        assert torch.equal(a, b)
    jparams = JGRU(JConfig(**SIZE)).init(jax.random.PRNGKey(0))
    assert set(gru_params_from_jax(jax.tree.map(np.asarray, jparams))) == \
        set(two.state_dict())


# ----------------------------------------------------------------- encoder --
@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_batched_encoder_matches_jax_on_ragged_masks(family):
    jm, params, tm = rnn_models(family)
    src, mask = ragged(0, LENS)
    jout = jm.encode(params, jnp.asarray(src), jnp.asarray(mask))
    with torch.inference_mode():
        tout = tm.encode(torch.from_numpy(src), torch.from_numpy(mask))
    if family == "gru":
        _close(tout, jout)
        return
    (te, tc, tmask), (je, jc, _) = tout, jout
    _close(te, je)
    _carries_close(tc, jc)
    assert torch.equal(tmask, torch.from_numpy(mask))
    assert torch.all(te[torch.from_numpy(mask) == 0] == 0)   # pads emit 0


@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_per_sequence_encoder_matches_jax_and_the_trimmed_batch_row(family):
    jm, params, tm = rnn_models(family)
    src, mask = ragged(0, LENS)
    with torch.inference_mode():
        batched = tm.encode(torch.from_numpy(src), torch.from_numpy(mask))
        for i, L in enumerate(LENS):
            row = src[i, :L]
            jout = jm.encode(params, jnp.asarray(row))
            tout = tm.encode(torch.from_numpy(row))
            if family == "gru":
                _close(tout, jout)
                torch.testing.assert_close(tout, batched[i], rtol=TOL,
                                           atol=TOL)
                continue
            _close(tout[0], jout[0])
            _carries_close(tout[1], jout[1])
            torch.testing.assert_close(tout[0], batched[0][i, :L], rtol=TOL,
                                       atol=TOL)
            for (h, c), (bh, bc) in zip(tout[1], batched[1]):
                torch.testing.assert_close(h, bh[i], rtol=TOL, atol=TOL)
                torch.testing.assert_close(c, bc[i], rtol=TOL, atol=TOL)


# ----------------------------------------------------------------- decoder --
@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_batched_decode_step_logits_match_jax(family):
    jm, params, tm = rnn_models(family, key=1)
    src, mask = ragged(1, [6, 2, 9])
    jst = jax_state(family, jm, params, jnp.asarray(src), jnp.asarray(mask))
    tst = tm.make_encode_states()(src, mask).data   # the decode state
    with torch.inference_mode():
        rng = np.random.default_rng(2)
        for _ in range(5):
            tok = rng.integers(4, V, 3).astype(np.int32)
            jst, jl = jm.decode_step(params, jst, jnp.asarray(tok))
            tst, tl = tm.decode_step(tst, torch.from_numpy(tok))
            _close(tl, jl)


@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_per_sequence_decode_step_logits_match_jax(family):
    jm, params, tm = rnn_models(family, key=2)
    src = np.random.default_rng(3).integers(4, V, 7).astype(np.int32)
    jout = jm.encode(params, jnp.asarray(src))
    jst = jout if family == "gru" else (jout[1], jout[0], jout[2])
    with torch.inference_mode():
        tout = tm.encode(torch.from_numpy(src))
        tst = tout if family == "gru" else (tout[1], tout[0], tout[2])
        for tok in (1, 9, 33, 5):
            jst, jl = jm.decode_step(params, jst, jnp.asarray(tok, jnp.int32))
            tst, tl = tm.decode_step(tst, torch.tensor(tok,
                                                       dtype=torch.int32))
            assert tl.shape == (V,)
            _close(tl, jl)


# --------------------------------------------------------------- translate --
@pytest.mark.parametrize("forced_len", [None, 6])
@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_translate_batched_tokens_equal_jax(family, forced_len):
    jm, params, tm = rnn_models(family, eos_bias=EOS_BIAS[family])
    src, mask = ragged(0, LENS)
    assert min_margin(family, jm, params, src, mask, 16) > 1e-3
    jl, jt = jm.make_translate_batched(params)(src, mask,
                                               forced_len=forced_len)
    tl, tt = tm.make_translate_batched()(src, mask, forced_len=forced_len)
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    if forced_len is None:
        assert len(set(tl.tolist())) > 1          # rows stop at EOS apart
        i = int(np.argmin(tl))
        assert np.all(tt[i, tl[i]:] == PAD_ID)    # EOS slot PAD-masked
    else:
        assert tt.shape == (4, forced_len)


@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_per_sequence_translate_and_host_loop_match(family):
    jm, params, tm = rnn_models(family, eos_bias=EOS_BIAS[family])
    src, mask = ragged(0, LENS)
    translate_j, translate_t = jm.make_translate(params), tm.make_translate()
    for i, L in enumerate(LENS):
        m_j, t_j = translate_j(src[i, :L])
        m_t, t_t = translate_t(src[i, :L])
        assert m_t == m_j
        np.testing.assert_array_equal(t_t, np.asarray(t_j))
    hl, ht = tm.make_translate_batched(compiled=False)(src, mask)
    bl, bt = tm.make_translate_batched()(src, mask)
    np.testing.assert_array_equal(hl, bl)
    for i, m in enumerate(bl):
        np.testing.assert_array_equal(ht[i, :m], bt[i, :m])
    tops.reset_launch_counts()
    tm.make_translate_batched()(src, mask, forced_len=3)
    assert sum(tops.launch_counts().values()) == 0    # no kernel on the CPU


# ---------------------------------------------------------------- registry --
@pytest.mark.parametrize("scale", [1.0, 0.25, 0.1])
@pytest.mark.parametrize("pair", ["de-en", "fr-en"])
def test_registry_scale_rules_match_jax(pair, scale):
    want = j_resolve(f"cnmt:{pair}", scale=scale, vocab=500,
                     max_decode_len=12).cfg
    got = nmt_config(pair, scale=scale, vocab=500, max_decode_len=12)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got, TConfig)
    if scale == 1.0:                    # the paper's width: built on the card
        assert (got.embed, got.hidden, got.layers) == (
            (500, 500, 2) if pair == "de-en" else (256, 256, 1))
        return
    name = "en-de" if pair == "de-en" else f"cnmt:{pair}"
    r = t_resolve(name, scale=scale, vocab=500, max_decode_len=12,
                  device="cpu")
    assert (r.name, r.family, r.pair, r.cfg) == (f"cnmt:{pair}", "nmt", pair,
                                                 got)
    assert isinstance(r.model, TBiLSTM if pair == "de-en" else TGRU)
    assert r.model.device.type == "cpu"


@pytest.mark.parametrize("family", ["gru", "bilstm"])
def test_rnn_models_default_to_cuda_and_raise_without_it(family):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        FAMILIES[family][1](TConfig(**SIZE))
