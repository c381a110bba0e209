"""The port's MoE and MLA LMs served and trained on the CPU, against the
JAX package.

The smoke qwen3-moe-30b-a3b, moonshot-v1-16b-a3b and deepseek-v3-671b
(the weights drawn by JAX and carried across, as in
``tests/test_torch_moe_lm.py``): ``generate_with_lengths`` on a ragged
batch and the continuous slot table against the reference's sessions
on the same weights, and the reference's ``test_train_step_reduces_loss``
cases (MTP and aux included) and the training CLI on the port.

The smoke MoE configs are drop-free (``capacity_factor = E / top_k``),
so a row's tokens do not depend on the other rows of its batch.  Tokens
are compared only behind a top-2 logit margin of at least 1e-4
(``greedy_margins``); the tests assert that their inputs have one.
"""

import numpy as np
import pytest

from repro.runtime.serving import ContinuousGenerationSession as JContinuous
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.configs import smoke_config
from repro_torch.launch import train as train_cli
from repro_torch.models.model import LM
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    greedy_margins,
)
from repro_torch.training.train_loop import init_train_state, make_train_step
from test_torch_moe_lm import ARCHS, _batch, _pair
from _torch_threads import cap_threads

cap_threads()

MARGIN = 1e-4


def _prompts(arch, seed, lens):
    rng = np.random.default_rng(seed)
    vocab = smoke_config(arch).vocab_size
    return [rng.integers(3, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_with_lengths_matches_jax(arch):
    """A ragged batch through both packages' ``GenerationSession``: the
    same tokens and pre-EOS lengths, every token behind a clear
    margin."""
    jm, params, model = _pair(arch)
    lens = np.array([11, 4, 8], np.int32)
    toks = np.zeros((3, 11), np.int32)
    for i, p in enumerate(_prompts(arch, 4, lens)):
        toks[i, :len(p)] = p
    max_new = 6
    j_lens, j_out = (np.asarray(a) for a in JSession(
        jm, params, max_len=32).generate_with_lengths(
            toks, max_new=max_new, lengths=lens))
    t_lens, t_out = GenerationSession(model, max_len=32).generate_with_lengths(
        toks, max_new=max_new, lengths=lens)
    for i, n in enumerate(lens):
        margins = greedy_margins(model, toks[i, :n], t_out[i])
        assert margins.min() >= MARGIN, (i, margins)
    np.testing.assert_array_equal(t_lens, j_lens)
    np.testing.assert_array_equal(t_out, j_out)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_table_matches_jax(arch):
    """The port's ContinuousGenerationSession in both modes and the
    reference's (continuous) on the same weights and prompts: the same
    tokens and lengths per row, each equal to the port's solo
    generation."""
    jm, params, model = _pair(arch)
    prompts = _prompts(arch, 5, (3, 8, 5, 2, 7, 4))
    sess = GenerationSession(model, max_len=32)
    solo = []
    for p in prompts:
        lens, out = sess.generate_with_lengths(p[None, :], max_new=6)
        m = int(lens[0])
        margins = greedy_margins(model, p, out[0, :min(m + 1, 6)])
        assert margins.min() >= MARGIN, margins
        solo.append((m, out[0, :min(m + 1, 6)]))
    want = JContinuous(jm, params, max_slots=4, max_len=32).serve(
        prompts, max_new=6, refill=True)
    for refill in (True, False):
        got = ContinuousGenerationSession(model, max_slots=4,
                                          max_len=32).serve(
            prompts, max_new=6, refill=refill)
        for (m_w, t_w), (m_g, t_g), (m_s, t_s) in zip(want, got, solo):
            assert m_g == m_w == m_s
            np.testing.assert_array_equal(t_g, np.asarray(t_w))
            np.testing.assert_array_equal(t_g, t_s)



@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reduces_loss(arch):
    """The reference's ``tests/test_training_runtime.py`` case on the
    port: 8 AdamW steps on one batch lower the loss (MTP and aux
    included)."""
    model = LM(smoke_config(arch), device="cpu")
    model.load_state_dict(_pair(arch)[2].state_dict())
    state = init_train_state(model)
    step = make_train_step(model)
    batch = _batch(arch)
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["aux"]))
        if model.cfg.mtp_depth:
            assert np.isfinite(float(m["mtp_ce"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]



def test_train_cli_trains_the_smoke_deepseek_v3():
    losses = train_cli.main(["--arch", "deepseek-v3-671b", "--smoke",
                             "--device", "cpu", "--steps", "4", "--batch",
                             "2", "--seq", "16"])
    assert len(losses) == 4 and np.all(np.isfinite(losses))
