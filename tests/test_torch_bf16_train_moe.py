"""The port's bfloat16 train step of the MoE families on the CPU against
the reference's: qwen3-moe-30b-a3b, moonshot-v1-16b-a3b and
deepseek-v3-671b (MLA, MTP), each on the first four batches whose
routing is decided at bf16 (the same experts on the port's bf16 and
float32 forwards, each choice clear of ``tests/test_torch_bf16.py``'s
margin on both: a choice nearer a tie than bf16 rounding moves the
router's logits is not decided at bf16, ROADMAP C.15).  The yardstick
and the rule are ``tests/test_torch_bf16_train.py``'s (split from it to
keep each file near a minute on one worker); so is the remat check.
"""

import pytest

from test_torch_bf16_train import (
    check_step,
    test_remat_equals_the_plain_bf16_step_bitwise as _remat_case,
)
from _torch_threads import cap_threads

cap_threads()

MOE = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "deepseek-v3-671b")


@pytest.mark.parametrize("arch", MOE)
def test_bf16_moe_train_step_matches_the_reference(arch):
    check_step(arch)


@pytest.mark.parametrize("arch", MOE)
def test_remat_equals_the_plain_bf16_moe_step_bitwise(arch):
    _remat_case(arch)
