"""``repro_torch.launch.big_model_serving`` against
``examples/big_model_serving.py``, on the example's weights.

The JAX example runs in process (``runpy.run_path``, ``REPRO_SMOKE=1``:
smoke qwen3-8b and rwkv6-3b, PRNGKeys 0 and 1); its params go through
``repro_torch.convert`` into the port's models, which the launcher then
serves on the CPU.  The batched generate and every routed request's
tokens equal the reference sessions' up to the first token whose top-2
logit margin is under 1e-4 (float-tolerance parity), and each routed
output is what the port's own session gives for that request (bitwise:
the same B=1 path).
"""

import runpy
from pathlib import Path

import jax
import numpy as np
import pytest

from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import big_model_serving
from repro_torch.models.model import LM
from repro_torch.runtime.serving import GenerationSession, greedy_margins
from test_torch_examples import assert_behind_margin
from _torch_threads import cap_threads

cap_threads()

EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / \
    "big_model_serving.py"
TIERS = {"edge-rwkv": "edge", "pod-qwen": "cloud"}


def port_lm(arch, params):
    model = LM(smoke_config(arch), device="cpu")
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params),
                                             model.cfg), strict=True)
    return model


@pytest.fixture(scope="module")
def served():
    """(the example's globals, the port's models, the launcher's result)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_SMOKE", "1")
        g = runpy.run_path(str(EXAMPLE), run_name="example")
        models = {"cloud": port_lm("qwen3-8b", g["params"]),
                  "edge": port_lm("rwkv6-3b", g["edge_params"])}
        res = big_model_serving.main(["--device", "cpu"], **models)
    return g, models, res


def test_batched_generate_gives_the_reference_tokens(served):
    g, models, res = served
    np.testing.assert_array_equal(res["prompts"], g["prompts"])
    want = np.asarray(g["out"])
    assert res["tokens"].shape == want.shape == (4, 8)
    for i, (p, w) in enumerate(zip(res["prompts"], want)):
        assert_behind_margin(w, res["tokens"][i],
                             greedy_margins(models["cloud"], p, w),
                             f"generate row {i}")


def test_routed_requests_give_the_reference_tokens(served):
    """Each of the 6 requests ran on a tier's real executor; its output is
    the port session's own, and the reference session's behind the
    margin."""
    g, models, res = served
    s = res["stats"]
    assert s["requests"] == len(res["routed"]) == 6 and s["shed"] == 0
    assert {name for name, *_ in res["routed"]} <= set(TIERS)
    j_sess = {"edge": g["edge_sess"], "cloud": g["sess"]}
    for name, toks, m, out in res["routed"]:
        tier = TIERS[name]
        model = models[tier]
        toks = np.minimum(toks, model.cfg.vocab_size - 1)
        lens, row = GenerationSession(model, max_len=48).generate_with_lengths(
            toks[None], max_new=8)
        assert m == int(lens[0])
        np.testing.assert_array_equal(out, row[0, :max(m, 1)])
        _, want = j_sess[tier].generate_with_lengths(toks[None], max_new=8)
        want = np.asarray(want)[0]
        assert_behind_margin(want, row[0], greedy_margins(model, toks, want),
                             f"{name} request of {len(toks)} tokens")
