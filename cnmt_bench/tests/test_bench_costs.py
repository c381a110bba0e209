"""The frozen FLOP and byte counts against counts made by hand."""

import json
from types import SimpleNamespace

import pytest

from conftest import ROOT
from cnmt_bench.lib import costs, peaks
from cnmt_bench.lib.harness import load_module


def _widths(name):
    return json.loads((ROOT / f"cnmt_bench/configs/{name}.json")
                      .read_text())["widths"]


def test_marian_request_flops_by_hand():
    w = _widths("marian-en-zh")
    ref = load_module(ROOT / "cnmt_bench/reference/marian.py")
    d, f, v = 512, 2048, 65001
    n, m = 3, 2
    # encoder layer: q,k,v,o projections of 3 tokens, 3x3 scores and
    # weighted sums, the two FFN products
    enc = 6 * (4 * 2 * n * d * d + 2 * (2 * n * n * d) + 2 * (2 * n * d * f))
    cross_kv = 6 * 2 * (2 * n * d * d)
    # decoder token t: self q,k,v,o; t keys; cross q,o; n keys; FFN; head
    tok = lambda t: 6 * (4 * 2 * d * d + 4 * t * d + 2 * 2 * d * d
                         + 4 * n * d + 2 * 2 * d * f) + 2 * d * v
    assert ref.request_flops(w, n, m) == pytest.approx(
        enc + cross_kv + tok(1) + tok(2), rel=1e-12)


def test_bilstm_request_flops_by_hand():
    w = _widths("bilstm-de-en")
    ref = load_module(ROOT / "cnmt_bench/reference/bilstm.py")
    e = h = 500
    v = 8000
    n, m = 4, 3
    # per layer and direction: input and recurrent products of 4 gates,
    # then the 2H -> H projection; layer 2 reads H
    enc = 2 * (2 * (2 * n * e * 4 * h + 2 * n * h * 4 * h)
               + 2 * n * 2 * h * h)
    tok = 2 * (2 * e * 4 * h + 2 * h * 4 * h) + 4 * n * h \
        + 2 * 2 * h * h + 2 * h * v
    assert ref.request_flops(w, n, m) == pytest.approx(enc + m * tok,
                                                       rel=1e-12)


def test_attention_launch_counts_by_hand():
    flops, nbytes = costs.encoder_attention([3, 5], 8)
    assert flops == 4 * 9 * 8 + 4 * 25 * 8
    assert nbytes == 4 * 3 * 8 * 4 + 4 * 5 * 8 * 4
    flops, nbytes = costs.decode_attention([1, 7], 8)
    assert flops == 4 * 1 * 8 + 4 * 7 * 8
    assert nbytes == (2 * 8 + 16) * 4 + (2 * 7 * 8 + 16) * 4
    assert costs.bound_s(flops, nbytes) == pytest.approx(
        max(flops / (495e12 / 3), nbytes / 3.35e12))


def test_marian_block_bounds_by_hand():
    w = {"d_model": 8, "enc_layers": 2, "dec_layers": 3}
    block = SimpleNamespace(rows=2, src_lens=[3, 5], steps=2)
    by_bytes = lambda b: b / peaks.HBM_BYTES_PER_S
    enc = 2 * by_bytes((3 + 5) * 4 * 8 * 4)
    cross = by_bytes(((2 * 3 * 8 + 16) + (2 * 5 * 8 + 16)) * 4)
    self1 = by_bytes(2 * (2 * 1 * 8 + 16) * 4)
    self2 = by_bytes(2 * (2 * 2 * 8 + 16) * 4)
    got = costs.marian_block_bounds(block, w)
    assert got["flash_attention"] == pytest.approx(enc)
    assert got["flash_decode"] == pytest.approx(3 * (self1 + self2
                                                     + 2 * cross))
