"""A run whose timed path is broken underneath comes out not correct:
a decode step that returns its state unchanged, and a token altered
where it is produced.  (The cells are served models on one card: no
batch mean to halve, no exchange between cards to drop.)  The tiny cells
run the whole harness on the CPU, the look for a card skipped."""

import time

import pytest
import torch

from cnmt_bench.lib import harness
from repro_torch.nmt.lstm import BiLSTMSeq2Seq
from repro_torch.nmt.transformer import MarianTransformer

CLASSES = {"marian": MarianTransformer, "bilstm": BiLSTMSeq2Seq}


def _run(root, cell):
    return harness.run_cell(root, cell, 2**31 + 3, 1.0, False,
                            torch.device("cpu"), time.perf_counter())


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _state_unchanged(step):
    def broken(self, state, token):
        _, logits = step(self, _clone(state), token)
        return state, logits
    return broken


def _token_altered(step):
    def broken(self, state, token):
        state, logits = step(self, state, token)
        logits = logits.clone()
        logits[..., 7] += 1e3          # every row now emits token 7
        return state, logits
    return broken


@pytest.mark.parametrize("cell", ["tiny-marian.docs", "tiny-bilstm.docs",
                                  "tiny-marian.chat"])
def test_sound_run_is_correct(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["logit_gap"]["value"] <= 1e-6
    assert r["checks"]["positions_compared"]["value"] > 0


@pytest.mark.parametrize("fault", [_state_unchanged, _token_altered])
@pytest.mark.parametrize("fam", sorted(CLASSES))
def test_broken_step_is_not_correct(tiny_root, monkeypatch, fam, fault):
    cls = CLASSES[fam]
    monkeypatch.setattr(cls, "decode_step", fault(cls.decode_step))
    r = _run(tiny_root, f"tiny-{fam}.docs")
    assert not r["correct"]
    assert r["checks"]["logit_gap"]["value"] > \
        r["checks"]["logit_gap"]["limit"]
