"""The continuous slot table under a sliding window, on the CPU against
the JAX package: smoke qwen3-8b-swa (window 8) with ``max_len`` at the
window (its resident caches are rings) and past it (linear caches of
``max_len`` slots decoded under the window, the shapes an admission
prefill writes), both modes against JAX's ``ContinuousGenerationSession``
on the same weights.  Tokens and pre-EOS lengths are equal, each emitted
token behind a top-2 logit margin of at least 1e-4 that the test asserts
(rows decode at another batch shape than ``greedy_margins``; see
``tests/test_torch_continuous.py``).
"""

import jax
import numpy as np
import pytest

from repro.models.model import LM as JLM
from repro.runtime.serving import (
    ContinuousGenerationSession as JContinuousSession,
)
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.model import LM
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    greedy_margins,
)
from test_torch_swa import WINDOW, _swa_smoke
from _torch_threads import cap_threads

cap_threads()


@pytest.mark.parametrize("max_len,max_new", [(WINDOW, 4), (24, 12)])
def test_continuous_session_matches_jax_under_the_window(max_len, max_new):
    """The slot table on smoke qwen3-8b-swa (window 8): its resident
    attention caches have the shapes of an admission prefill (a ring of 8
    slots at ``max_len`` 8, a linear cache of 24 slots decoded under the
    window past it), and both modes serve the tokens and pre-EOS lengths
    of JAX's session on the same weights, each emitted token behind a
    top-2 margin of at least 1e-4."""
    jm = JLM(_swa_smoke("qwen3-8b", jax_side=True))
    params = jm.init(jax.random.PRNGKey(0))
    model = LM(_swa_smoke("qwen3-8b"), device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params),
                                             model.cfg), strict=True)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, model.cfg.vocab_size, size=int(n)).astype(
        np.int32) for n in rng.integers(2, max_len - max_new + 1, size=6)]
    for refill in (True, False):
        sess = ContinuousGenerationSession(model, max_slots=4,
                                           max_len=max_len)
        assert sess._state["caches"][0]["k"].shape[2] == max_len
        got = sess.serve(prompts, max_new=max_new, refill=refill)
        want = JContinuousSession(jm, params, max_slots=4,
                                  max_len=max_len).serve(
            prompts, max_new=max_new, refill=refill)
        for p, (m_w, t_w), (m_g, t_g) in zip(prompts, want, got):
            assert m_g == m_w
            np.testing.assert_array_equal(t_g, np.asarray(t_w))
            emitted = np.asarray(t_g)[:min(m_g + 1, max_new)]
            assert greedy_margins(model, p, emitted).min() >= 1e-4
