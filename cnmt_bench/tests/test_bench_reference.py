"""The plain references against the program at a tiny size on the CPU:
the same weights (made by the benchmark, loaded into both), the program's
decode step fed the reference's teacher-forced inputs."""

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from cnmt_bench.lib import check, system, weights
from cnmt_bench.lib.harness import load_module


def _program_logits(model, fam, src, lens, tgt_in):
    """The program's logits of every target position: its batched encode
    and state, then one decode step a position."""
    mask = (torch.arange(src.shape[1])[None] < lens[:, None]).float()
    with torch.inference_mode():
        if fam == "marian":
            enc, m = model.encode(src, mask)
            state = model.init_cache(enc, m)
        else:
            enc, carries, m = model.encode(src, mask)
            state = (carries, enc, m)
        out = []
        for t in range(tgt_in.shape[1]):
            state, logits = model.decode_step(state, tgt_in[:, t])
            out.append(logits)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("fam", sorted(TINY))
def test_reference_matches_program(fam):
    name, widths = TINY[fam]
    ref = load_module(ROOT / f"cnmt_bench/reference/{fam}.py")
    params = weights.make(ref.param_spec(widths), 2**31 + 17, "cpu")
    config = {"program": {"name": name, "scale": 0.05, "vocab": 64,
                          "max_decode_len": 32}, "widths": widths}
    model = system.build_model(config, params, torch.device("cpu"))
    rng = np.random.default_rng(3)
    lens = torch.tensor([5, 9, 1, 7])
    src = torch.zeros((4, 9), dtype=torch.long)
    for i, n in enumerate(lens.tolist()):
        src[i, :n] = torch.as_tensor(rng.integers(4, 64, n))
    tgt_in = torch.as_tensor(rng.integers(4, 64, (4, 6)))
    tgt_in[:, 0] = 1
    with torch.inference_mode():
        want = ref.logits(params, widths, src, lens, tgt_in)
    got = _program_logits(model, fam, src, lens, tgt_in)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1.0)


@pytest.mark.parametrize("fam", sorted(TINY))
def test_served_tokens_have_no_gap(fam):
    """The program's greedy answers through its public batched translate
    are the reference's best token at every position."""
    name, widths = TINY[fam]
    ref = load_module(ROOT / f"cnmt_bench/reference/{fam}.py")
    params = weights.make(ref.param_spec(widths), 5, "cpu")
    config = {"program": {"name": name, "scale": 0.05, "vocab": 64,
                          "max_decode_len": 32}, "widths": widths}
    model = system.build_model(config, params, torch.device("cpu"))
    translate = model.make_translate_batched()
    rng = np.random.default_rng(9)
    lens = [3, 8, 6]
    block = np.zeros((3, 8), np.int32)
    for i, n in enumerate(lens):
        block[i, :n] = rng.integers(4, 64, n)
    mask = (np.arange(8)[None] < np.array(lens)[:, None]).astype(np.float32)
    _, toks = translate(block, mask, 12)
    reqs = [type("R", (), {"rid": i, "tokens": block[i, :n]})()
            for i, n in enumerate(lens)]
    answers = {i: toks[i, :m] for i, m in enumerate([12, 4, 9])}
    gaps = check.widest_gaps(ref, params, widths, reqs, answers,
                             torch.device("cpu"))
    assert gaps["positions"] == 25
    assert gaps["program"] <= 1e-6
