"""The split placement's two legs on the port, for the paper's three
models, against the port's fused path and the JAX reference's legs.

``encode -> EncoderStates -> decode_from_states`` runs the fused path's
operations on one device, so it is held BITWISE equal to
``make_translate_batched``; against JAX, tokens are held equal (on
weights whose greedy margins are far above float32 noise) and
``payload_bytes()`` byte for byte, since the engine prices the ship time
with it.  The last test is ``tests/test_faults.py``'s decode-leg
failover scenario on the port's engine and GRU legs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401
from repro.data.tokenizer import EOS_ID
from repro.nmt import MarianTransformer as JMarian
from repro.nmt import TransformerConfig as JTConfig
from repro.runtime.serving import build_executor as j_build_executor
from repro_torch.convert import marian_params_from_jax
from repro_torch.core.faults import FaultSchedule, RetryPolicy, TierOutage
from repro_torch.core.latency_model import (ActivationCostModel,
                                            DeviceProfile,
                                            LinearLatencyModel)
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.tx_estimator import LinkModel, TxEstimator
from repro_torch.nmt import EncoderStates
from repro_torch.nmt import MarianTransformer as TMarian
from repro_torch.nmt import TransformerConfig as TTConfig
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import build_executor
from test_torch_rnn import EOS_BIAS, min_margin, ragged, rnn_models
from _torch_threads import cap_threads

cap_threads()

V = 64
LENS = [5, 9, 3, 7]
MARIAN = dict(vocab_src=V, vocab_tgt=V, d_model=32, heads=4, d_ff=64,
              enc_layers=2, dec_layers=2, max_decode_len=16, max_src_len=64)
FAMILIES = ["gru", "bilstm", "marian"]


@functools.lru_cache(maxsize=None)
def models(family):
    """(jax model, jax params, port model on the CPU) on the same weights,
    sharpened and EOS-biased so rows stop at different steps."""
    if family != "marian":
        return rnn_models(family, eos_bias=EOS_BIAS[family])
    jm = JMarian(JTConfig(**MARIAN))
    params = jm.init(jax.random.PRNGKey(0))
    params["out"]["w"] = params["out"]["w"] * 4.0
    params["tgt_embed"] = params["tgt_embed"] * 4.0
    params["out"]["b"] = params["out"]["b"].at[EOS_ID].set(5.0)
    tm = TMarian(TTConfig(**MARIAN), device="cpu")
    tm.load_state_dict(marian_params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    return jm, params, tm


def _margin(family, src, mask):
    jm, params, _ = models(family)
    if family != "marian":
        return min_margin(family, jm, params, src, mask, 16)
    st = jm.init_cache(params, *jm.encode(params, jnp.asarray(src),
                                          jnp.asarray(mask)))
    tok = jnp.full((src.shape[0],), 1, jnp.int32)
    step = jax.jit(lambda st, tok: jm.decode_step(params, st, tok))
    gaps = []
    for _ in range(16):
        st, lg = step(st, tok)
        top2 = jnp.sort(lg, axis=-1)[:, -2:]
        gaps.append(float(jnp.min(top2[:, 1] - top2[:, 0])))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    return min(gaps)


@pytest.mark.parametrize("family", FAMILIES)
def test_encoder_states_payload_and_batch_match_jax(family):
    jm, params, tm = models(family)
    src, mask = ragged(0, LENS)
    jst = jm.make_encode_states(params)(src, mask)
    tst = tm.make_encode_states()(src, mask)
    assert tst.payload_bytes() == jst.payload_bytes() > 0
    assert tst.batch == jst.batch == len(LENS)
    jl = jax.tree_util.tree_leaves((jst.data, jst.src_lens))
    tl = list(repro_torch.nmt.common._leaves((tst.data, tst.src_lens)))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tl] == \
        [(tuple(j.shape), str(j.dtype)) for j in jl]
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(tst.src_lens.numpy(), LENS)


@pytest.mark.parametrize("forced_len", [None, 6])
@pytest.mark.parametrize("family", FAMILIES)
def test_split_decode_equals_fused_bitwise(family, forced_len):
    _, _, tm = models(family)
    src, mask = ragged(3, [10, 7, 4])
    lens_f, toks_f = tm.make_translate_batched()(src, mask,
                                                 forced_len=forced_len)
    states = tm.make_encode_states()(src, mask)
    lens_s, toks_s = tm.make_decode_from_states()(states,
                                                  forced_len=forced_len)
    np.testing.assert_array_equal(lens_s, lens_f)
    np.testing.assert_array_equal(toks_s, toks_f)


@pytest.mark.parametrize("family", FAMILIES)
def test_split_tokens_equal_jax_split_tokens(family):
    jm, params, tm = models(family)
    src, mask = ragged(0, LENS)
    assert _margin(family, src, mask) > 1e-3
    jl, jt = jm.make_decode_from_states(params)(
        jm.make_encode_states(params)(src, mask))
    tl, tt = tm.make_decode_from_states()(tm.make_encode_states()(src, mask))
    np.testing.assert_array_equal(tl, np.asarray(jl))
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert len(set(tl.tolist())) > 1              # rows stop at EOS apart


@pytest.mark.parametrize("family", FAMILIES)
def test_build_executor_split_legs(family):
    jm, params, tm = models(family)
    enc, dec = build_executor(tm, kind="split", vocab_clip=V)
    j_enc, j_dec = j_build_executor(jm, kind="split", params=params,
                                    vocab_clip=V)
    fused = tm.make_translate_batched()
    src, _ = ragged(0, LENS)
    for i, L in enumerate(LENS):
        row = src[i, :L]
        states = enc(row)
        assert isinstance(states, EncoderStates) and states.batch == 1
        m, out = dec(states)
        lens, toks = fused(row[None])
        assert m == int(lens[0])
        np.testing.assert_array_equal(out, toks[0, :max(m, 1)])
        assert dec(states.to("cpu"))[0] == m      # the wire: same states
    j_m, j_out = j_dec(j_enc(src[1, :LENS[1]]))  # the reference's legs
    assert (j_m, np.asarray(j_out).tolist()) == (
        lambda r: (r[0], r[1].tolist()))(dec(enc(src[1, :LENS[1]])))
    big = src[0, :5].copy()
    big[0] = 10 * V                               # outside the vocabulary
    clipped = big.copy()
    clipped[0] = V - 1
    np.testing.assert_array_equal(dec(enc(big))[1], dec(enc(clipped))[1])


def test_split_value_errors():
    _, _, tm = models("gru")
    with pytest.raises(ValueError, match="faults"):
        build_executor(tm, kind="split", faults=[0])
    with pytest.raises(ValueError, match="make_encode_states"):
        build_executor(object(), kind="split")
    _, _, marian = models("marian")
    states = marian.make_encode_states()(np.ones((1, 3), np.int32))
    with pytest.raises(ValueError, match="max_decode_len"):
        marian.make_decode_from_states()(states, forced_len=17)


def test_encoder_states_payload_and_wire_move():
    st = EncoderStates(data=((torch.ones((2, 3, 4)),),),
                       src_lens=torch.tensor([3, 2], dtype=torch.int32))
    assert st.payload_bytes() == 2 * 3 * 4 * 4 + 2 * 4
    moved = st.to("cpu")
    assert moved is not st and moved.batch == 2
    assert torch.equal(moved.data[0][0], st.data[0][0])


# ----------------------------------------------- decode-leg failover ----
def test_split_decode_failover_exact_and_engine_rehomes():
    """``tests/test_faults.py``'s scenario on the port: the shipped
    EncoderStates are the recovery unit, and the engine re-homes a split
    plan's decode leg when its tier dies while states are in flight."""
    _, _, model = rnn_models("gru")
    model = type(model)(dataclasses.replace(model.cfg, max_decode_len=24),
                        device="cpu")
    model.load_state_dict(rnn_models("gru")[2].state_dict())
    fused = model.make_translate_batched()
    enc, dec = build_executor(model, kind="split")

    rng = np.random.default_rng(3)
    toks = rng.integers(3, 64, 9).astype(np.int32)
    lens_f, toks_f = fused(toks[None, :], np.ones((1, 9), np.float32))
    states = enc(toks)
    m1, out1 = dec(states)
    m2, out2 = dec(states)                        # "another tier" = same fn
    assert m1 == m2 == int(lens_f[0])
    np.testing.assert_array_equal(out1, out2)
    np.testing.assert_array_equal(out1, toks_f[0, :max(m1, 1)])

    links = LinkModel(3)
    links.add_link(1, 2, TxEstimator(init_rtt_s=4e-3, bandwidth_bps=1e9))
    tiers = [
        Tier(DeviceProfile("dev", LinearLatencyModel(3e-4, 5e-3, 2e-3),
                           0.05), name="dev"),
        Tier(DeviceProfile("edge", LinearLatencyModel(2e-5, 2.5e-3, 4e-3),
                           0.05),
             name="edge", rtt_fn=lambda t: 5e-3, bandwidth_bps=200e6,
             encode_executor=enc, decode_executor=dec),
        Tier(DeviceProfile("cloud", LinearLatencyModel(1e-5, 1e-4, 2e-3),
                           0.05),
             name="cloud", rtt_fn=lambda t: 90e-3, bandwidth_bps=20e6,
             decode_executor=dec),
    ]
    eng = CollaborativeEngine(
        n2m=LinearN2M(1.0, 0.0), tiers=tiers, seed=0,
        links=links, activation=ActivationCostModel(512, 4),
        inter_rtt_fns={(1, 2): lambda t: 4e-3}, allow_split=True,
        faults=FaultSchedule(outages=(TierOutage(2, 2.0, 8.0),)),
        retry=RetryPolicy())
    rng = np.random.default_rng(11)
    for i in range(60):
        eng.submit(rng.integers(3, 64, int(rng.integers(8, 200)))
                   .astype(np.int32), now_s=float(i) * 0.2)
    assert eng.decode_failovers > 0
    rehomed = [r for r in eng.results
               if r.plan is not None and not r.shed and r.attempts > 1
               and r.failed_tiers == (2,)]
    assert len(rehomed) >= eng.decode_failovers
    for r in rehomed:
        assert r.device != 2
        assert r.plan.decode_tier == r.device
        assert r.m_out >= 1                      # decoded from the states
