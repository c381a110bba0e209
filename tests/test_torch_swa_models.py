"""qwen3-8b-swa and zamba2-1.2b-swa (the long_500k variants) at smoke size,
window 8, against the JAX package on the same converted weights: a
prefill longer than the window decoding on a linear cache, and a prefill
into a window-sized state decoding as a ring past the window.  Logits
within 1e-4 (float32; the two packages reduce in different orders).
The layers and the plain kernels under a window are
``tests/test_torch_swa.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import LM as JLM
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.model import LM
from test_torch_swa import WINDOW, _close, _swa_smoke
from _torch_threads import cap_threads

cap_threads()
@pytest.mark.parametrize("name", ["qwen3-8b", "zamba2-1.2b"])
def test_swa_models_match_jax_past_the_window(name):
    """Prefill 12 tokens (past the window of 8) into a linear state of 20
    slots, and 6 tokens into a window-sized state (a ring), then 4 decode
    steps each (the ring wraps at position 8): logits within 1e-4 of
    JAX's."""
    jm = JLM(_swa_smoke(name, jax_side=True))
    params = jm.init(jax.random.PRNGKey(0))
    model = LM(_swa_smoke(name), device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params),
                                             model.cfg), strict=True)
    rng = np.random.default_rng(5)
    for s, max_len in ((12, 20), (6, WINDOW)):
        toks = rng.integers(4, model.cfg.vocab_size, (2, s)).astype(np.int32)
        jl, js = jm.prefill(params, jnp.asarray(toks), max_len=max_len)
        tl, ts = model.prefill(torch.as_tensor(toks), max_len=max_len)
        _close(tl, jl, 1e-4)
        attn = [c for c in ts["caches"] if "k" in c][0]
        assert attn["k"].shape[2] == max(s, max_len)
        for step in range(4):
            tok = np.full((2, 1), 5 + 11 * step, np.int32)
            jl, js = jm.decode_step(params, js, jnp.asarray(tok))
            tl, ts = model.decode_step(ts, torch.as_tensor(tok))
            _close(tl, jl, 1e-4)

