"""The control on the card at a size a test run holds: the reference in
TF32 (the precision below the configuration's float32) must fail the
``logit_gap`` limit the program's sound runs keep.  Skips without a
card; ``control.py`` reads the same at the cells' own sizes."""

import json

import pytest
import torch

from conftest import add_tiny_cells
from cnmt_bench import control

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_tf32_control_fails_the_limit_the_program_keeps(tmp_path, card):
    root = add_tiny_cells(tmp_path)
    cfg_path = root / "cnmt_bench/configs/tiny-marian.json"
    cfg = json.loads(cfg_path.read_text())
    # Marian at scale 0.25: 3 + 3 layers of width 128, 4000 words
    cfg["program"].update(scale=0.25, vocab=4000, max_decode_len=64)
    cfg["widths"].update(d_model=128, heads=2, d_ff=512, enc_layers=3,
                         dec_layers=3, vocab_src=4000, vocab_tgt=4000,
                         max_decode_len=64)
    limit = json.loads((control.ROOT / "cnmt_bench/configs/"
                        "marian-en-zh.json").read_text())["check"][
                            "logit_gap_limit"]
    cfg["check"]["logit_gap_limit"] = limit
    cfg_path.write_text(json.dumps(cfg))
    mix_path = root / "cnmt_bench/traffic/tiny-docs.json"
    mix = json.loads(mix_path.read_text())
    mix["lengths"].update(n_max=48, m_max=64)
    mix["per_call"] = 64
    mix["tiers"][0]["batch_size"] = 16
    mix["check"]["sample"] = 4096
    mix_path.write_text(json.dumps(mix))
    rows = list(control.readings(root, "tiny-marian.docs", [1, 2, 3],
                                 {1, 2, 3}, 8.0, card))
    assert all(r["program"] <= limit and r["unserved"] == 0 for r in rows)
    assert min(r["control"] for r in rows) > limit
