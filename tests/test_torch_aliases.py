"""The reference's deprecated aliases in the port: each warns
``DeprecationWarning`` with the reference's message and delegates, as
``tests/test_bigmodel_serving.py`` holds the reference's:
``make_paper_model`` to ``models.registry.resolve``, and
``make_tier_executor``, ``make_batched_tier_executor``,
``make_split_tier_executors`` and ``make_faulty_executor`` to
``build_executor``.  Both packages export them from the same places.
"""

import numpy as np
import pytest

import repro.nmt as j_nmt
import repro.runtime as j_runtime
import repro_torch.nmt as nmt
import repro_torch.runtime as runtime
from repro_torch.configs import smoke_config
from repro_torch.models.model import LM
from repro_torch.models.registry import resolve
from repro_torch.nmt import GRUSeq2Seq
from repro_torch.runtime.serving import (
    GenerationSession,
    TierFaultError,
    build_executor,
    make_batched_tier_executor,
    make_faulty_executor,
    make_split_tier_executors,
    make_tier_executor,
)
from _torch_threads import cap_threads

cap_threads()

ALIASES = ("make_tier_executor", "make_batched_tier_executor",
           "make_split_tier_executors", "make_faulty_executor",
           "make_prefill_step", "make_serve_step")


@pytest.fixture(scope="module")
def lm_session():
    cfg = smoke_config("qwen3-8b")
    return cfg, GenerationSession(LM(cfg, device="cpu", seed=0), max_len=32)


def test_aliases_are_exported_where_the_reference_exports_them():
    for name in ALIASES:
        assert name in j_runtime.__all__ and name in runtime.__all__, name
    assert "make_paper_model" in j_nmt.__all__
    assert "make_paper_model" in nmt.__all__


def test_make_paper_model_shim_warns_and_delegates():
    from repro_torch.nmt.registry import make_paper_model

    with pytest.warns(DeprecationWarning, match="make_paper_model"):
        model, pair = make_paper_model("fr-en", scale=0.1, vocab=128,
                                       device="cpu")
    assert isinstance(model, GRUSeq2Seq) and pair == "fr-en"
    want = resolve("cnmt:fr-en", scale=0.1, vocab=128, device="cpu").model
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              want.state_dict().items()):
        assert np.array_equal(a.numpy(), b.numpy()), n


def test_build_executor_solo_and_alias_agree(lm_session):
    cfg, sess = lm_session
    new = build_executor(sess, kind="solo", max_new=4,
                         vocab_clip=cfg.vocab_size)
    with pytest.warns(DeprecationWarning, match="make_tier_executor"):
        old = make_tier_executor(sess, max_new=4, vocab_clip=cfg.vocab_size)
    toks = np.arange(4, 10, dtype=np.int32)
    m_n, t_n = new(toks)
    m_o, t_o = old(toks)
    assert m_n == m_o and np.array_equal(np.asarray(t_n), np.asarray(t_o))


def test_build_executor_batched_alias_warns_and_agrees(lm_session):
    cfg, sess = lm_session
    with pytest.warns(DeprecationWarning, match="make_batched_tier_executor"):
        old = make_batched_tier_executor(sess, max_new=4)
    new = build_executor(sess, kind="batched", max_new=4)
    block = np.arange(4, 16, dtype=np.int32).reshape(2, 6)
    for (m_o, t_o), (m_n, t_n) in zip(old(block), new(block)):
        assert m_o == m_n and np.array_equal(t_o, t_n)


def test_make_faulty_executor_alias_warns_and_injects():
    with pytest.warns(DeprecationWarning, match="make_faulty_executor"):
        wrapped = make_faulty_executor(lambda t: (1, t), {0},
                                       message="boom")
    assert wrapped.calls["n"] == 0
    with pytest.raises(TierFaultError, match="boom"):
        wrapped(np.zeros(3, np.int32))
    assert wrapped(np.zeros(3, np.int32))[0] == 1
    assert wrapped.calls == {"n": 2, "faults": 1}


def test_build_executor_split_matches_deprecated_name():
    model = resolve("cnmt:fr-en", scale=0.1, vocab=128, max_decode_len=24,
                    device="cpu").model
    enc, dec = build_executor(model, kind="split")
    with pytest.warns(DeprecationWarning, match="make_split_tier_executors"):
        enc_o, dec_o = make_split_tier_executors(model)
    toks = np.arange(3, 9, dtype=np.int32)
    m_n, out_n = dec(enc(toks))
    m_o, out_o = dec_o(enc_o(toks))
    assert m_n == m_o and np.array_equal(np.asarray(out_n),
                                         np.asarray(out_o))
    # the reference's params= has nothing to carry here
    with pytest.warns(DeprecationWarning), \
            pytest.raises(ValueError, match="params"):
        make_split_tier_executors(model, {})
