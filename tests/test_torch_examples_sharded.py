"""``repro_torch.launch.big_model_serving`` in a ``torch.distributed``
world of 4: the reference example's ``len(jax.devices()) >= 4`` branch.

Four gloo ranks on the CPU (``tests/_torch_examples_worker.py``, one
spawn) run the launcher's ``main`` at smoke size: qwen3-8b is served by
``make_sharded_session`` over a 2x2 mesh, rank 0 drives the engine and
the others follow.  Its batched generate and every request it routed to
the sharded qwen3 tier equal the unsharded session's tokens on the same
seeded weights up to the first token behind a top-2 logit margin under
1e-4 (sharded and unsharded products may round differently in the last
bits).
"""

import numpy as np
import pytest

from repro_torch.models.registry import resolve
from repro_torch.runtime.serving import GenerationSession, greedy_margins
from test_torch_examples import assert_behind_margin
from _torch_spawn import join, spawn
from _torch_threads import cap_threads

cap_threads()

WORKER = __file__.replace("test_torch_examples_sharded.py",
                          "_torch_examples_worker.py")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(each rank's result, the unsharded qwen3 session on the same
    weights)."""
    workdir = str(tmp_path_factory.mktemp("examples_sharded"))
    procs = spawn(WORKER, workdir)
    cloud = resolve("qwen3-8b", size="smoke", device="cpu", seed=0).model
    return join(procs, workdir), GenerationSession(cloud, max_len=48)


def test_rank_zero_drives_and_the_others_follow(sharded):
    outs, _ = sharded
    assert all(o is None for o in outs[1:])
    res = outs[0]
    assert res["layout"] in ("ddp", "tp")
    assert res["stats"]["requests"] == len(res["routed"]) == 6
    assert res["stats"]["shed"] == 0


def test_sharded_tokens_equal_the_unsharded_session(sharded):
    outs, sess = sharded
    res, model = outs[0], sess.model
    want = sess.generate(res["prompts"], max_new=8)
    for i, (p, w) in enumerate(zip(res["prompts"], want)):
        assert_behind_margin(w, res["tokens"][i], greedy_margins(model, p, w),
                             f"generate row {i}")
    pod = [r for r in res["routed"] if r[0] == "pod-qwen"]
    assert pod, "no request reached the sharded tier"
    for _, toks, m, out in pod:
        toks = np.minimum(toks, model.cfg.vocab_size - 1)
        lens, row = sess.generate_with_lengths(toks[None], max_new=8)
        got = np.full(8, -1, np.int32)
        got[:len(out)] = out
        want = row[0].copy()
        want[max(int(lens[0]), 1):] = -1
        assert_behind_margin(want, got, greedy_margins(model, toks, row[0]),
                             f"pod request of {len(toks)} tokens")
