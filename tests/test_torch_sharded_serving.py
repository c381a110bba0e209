"""Sharded serving of the configurations ``tests/test_torch_sharded.py``
leaves out, on 4 gloo ranks of the CPU, against the unsharded port.

One spawn (``tests/_torch_sharded_serving_worker.py``) serves every case
through ``make_sharded_session`` on a (2, 2) ``("data", "model")`` mesh:
smoke qwen3-8b-swa (window 8) under ``tp``, ``ddp`` and ``auto``, its
12 new tokens decoding past the window; deepseek-v3-671b (MLA) and both
MoE models (drop-free, as ``smoke_config`` sets them) under ``tp`` and
``auto``; whisper-large-v3 with 16 frames under ``tp`` and ``auto``; and
qwen3-8b-swa's continuous slot table under ``tp``.  Each is held against
the unsharded session on the same weights: tokens equal up to the first
one behind a top-2 logit margin under 1e-4 (a rank runs other batch
shapes, so logits may differ in the last bits; ROADMAP C), the same on
every rank.  The unsharded port is held against JAX by the per-family
test files.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models.model import LM
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    greedy_margins,
)
from test_torch_swa import _swa_smoke
from _torch_spawn import join, spawn
from _torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_sharded_serving_worker.py")
MARGIN, MAX_LEN, MAX_NEW = 1e-4, 32, 12
SWA = "qwen3-8b-swa"
SESSION_CASES = ((SWA, "tp"), (SWA, "ddp"), (SWA, "auto"),
                 ("deepseek-v3-671b", "tp"), ("deepseek-v3-671b", "auto"),
                 ("qwen3-moe-30b-a3b", "tp"), ("qwen3-moe-30b-a3b", "auto"),
                 ("moonshot-v1-16b-a3b", "tp"),
                 ("moonshot-v1-16b-a3b", "auto"),
                 ("whisper-large-v3", "tp"), ("whisper-large-v3", "auto"))
CONTINUOUS_CASE = (SWA, "tp")


def _cfg(name):
    return _swa_smoke("qwen3-8b") if name == SWA else smoke_config(name)


def _case(name, cfg, seed):
    """B=4 prompts of 12 tokens, ragged (5-12) where every mixer is
    position-masked and no frames ride along; whisper's 16 random frames
    (B, T, D) with the full prefix."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab_size, (4, 12)).astype(np.int32)
    frames = lens = None
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal(
            (4, cfg.encoder.max_frames, cfg.d_model)).astype(np.float32)
    else:
        lens = np.array([12, 5, 9, 12], np.int32)
    return {"tokens": toks, "lengths": lens, "frames": frames}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Each rank's outputs of the one 4-process run and, computed while
    it runs, the unsharded sessions' tokens and their margin cuts."""
    workdir = str(tmp_path_factory.mktemp("sharded_serving"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # smoke shapes; leave the cores to the ranks
    try:
        return _run(workdir)
    finally:
        torch.set_num_threads(threads)


def _run(workdir):
    names = sorted({n for n, _ in SESSION_CASES})
    cfgs = {n: _cfg(n) for n in names}
    ports = {n: LM(cfgs[n], device="cpu", seed=0) for n in names}
    prompts = {n: _case(n, cfgs[n], i) for i, n in enumerate(names)}
    rng = np.random.default_rng(7)
    cont = [rng.integers(4, 512, int(n)).astype(np.int32)
            for n in rng.integers(3, 13, 6)]
    torch.save({"cfgs": cfgs, "weights": {n: m.state_dict()
                                          for n, m in ports.items()},
                "prompts": prompts, "session_cases": SESSION_CASES,
                "continuous_case": CONTINUOUS_CASE,
                "continuous_prompts": cont, "max_len": MAX_LEN,
                "max_new": MAX_NEW}, os.path.join(workdir, "inputs.pt"))
    procs = spawn(WORKER, workdir)

    ref, cuts = {}, {}
    for name in names:
        case = prompts[name]
        m, toks = GenerationSession(ports[name], max_len=MAX_LEN)\
            .generate_with_lengths(case["tokens"], max_new=MAX_NEW,
                                   lengths=case["lengths"],
                                   frames=case["frames"])
        ref[name] = (m, toks)
        lens = case["lengths"] if case["lengths"] is not None else \
            [case["tokens"].shape[1]] * len(toks)
        cuts[name] = [_cut(ports[name], p[:n], t, f) for p, n, t, f in zip(
            case["tokens"], lens, toks, case["frames"]
            if case["frames"] is not None else [None] * len(toks))]
    model = ports[CONTINUOUS_CASE[0]]
    ref["continuous"] = ContinuousGenerationSession(
        model, max_slots=4, max_len=MAX_LEN).serve(cont, max_new=MAX_NEW)
    cuts["continuous"] = [_cut(model, p, t, None)
                          for p, (_, t) in zip(cont, ref["continuous"])]
    return {"outs": join(procs, workdir), "ref": ref, "cuts": cuts}


def _cut(model, prompt, tokens, frames) -> int:
    """How many leading ``tokens`` (a greedy continuation of ``prompt``)
    stand behind a top-2 logit margin of at least 1e-4."""
    low = np.flatnonzero(greedy_margins(model, prompt, tokens,
                                        frames=frames) < MARGIN)
    return int(low[0]) if low.size else len(tokens)


def _assert_rows_equal(cuts, want, got, m_want, m_got):
    """Rows of ``got`` equal ``want`` up to each row's margin cut, and so
    do the pre-EOS lengths of the rows held whole; the cuts keep most of
    the tokens."""
    kept = total = 0
    for i, (n, w, g) in enumerate(zip(cuts, want, got)):
        np.testing.assert_array_equal(np.asarray(g)[:n], np.asarray(w)[:n])
        if n == len(w):
            assert m_got[i] == m_want[i], i
        kept, total = kept + n, total + len(w)
    assert kept >= 0.75 * total, (kept, total)


@pytest.mark.parametrize("name,layout", SESSION_CASES)
def test_sharded_session_serves_the_unsharded_tokens(run, name, layout):
    """generate_with_lengths on the mesh: the same on every rank, and the
    unsharded session's tokens behind the margin."""
    got = [o["sessions"][(name, layout)] for o in run["outs"]]
    for g in got[1:]:
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        np.testing.assert_array_equal(g["m"], got[0]["m"])
    if layout != "auto":
        assert got[0]["layout"] == layout
    m_ref, out_ref = run["ref"][name]
    _assert_rows_equal(run["cuts"][name], out_ref, got[0]["tokens"], m_ref,
                       got[0]["m"])


def test_sharded_swa_slot_table_matches_unsharded(run):
    """qwen3-8b-swa's continuous slot table on the mesh (rows over data,
    slots over model): the unsharded slot table's tokens behind the
    margin, the same on every rank."""
    got = run["outs"][0]["continuous"]
    for out in run["outs"][1:]:
        assert [m for m, _ in out["continuous"]] == [m for m, _ in got]
        for (_, a), (_, b) in zip(out["continuous"], got):
            np.testing.assert_array_equal(a, b)
    want = run["ref"]["continuous"]
    _assert_rows_equal(run["cuts"]["continuous"], [t for _, t in want],
                       [t for _, t in got], [m for m, _ in want],
                       [m for m, _ in got])
