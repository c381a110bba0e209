"""Operations and bytes of the attention kernels' launches, counted from
the traffic's lengths and the configuration's widths: valid positions
only (a row's real keys), float32 operands, each input byte read once
and each output byte written once, whatever the kernel reads again.
FLOPs follow ``models/costs.py``: 4 x keys x d_model a query (scores
and the weighted sum)."""

from __future__ import annotations

from typing import Sequence

from cnmt_bench.lib import peaks

F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the 3 x TF32 rate and bytes over HBM bandwidth."""
    return max(flops / peaks.FP32_3XTF32_FLOPS,
               nbytes / peaks.HBM_BYTES_PER_S)


def encoder_attention(lens: Sequence[int], d: int) -> tuple:
    """(flops, bytes) of one non-causal self-attention launch over rows of
    source lengths ``lens``: Q, K, V read and O written at real rows."""
    flops = sum(4 * n * n * d for n in lens)
    nbytes = sum(4 * n * d * F32 for n in lens)
    return float(flops), float(nbytes)


def decode_attention(keys: Sequence[int], d: int) -> tuple:
    """(flops, bytes) of one decode-attention launch: one query a row
    against ``keys[i]`` cached positions (K and V read, q read, out
    written)."""
    flops = sum(4 * k * d for k in keys)
    nbytes = sum((2 * k * d + 2 * d) * F32 for k in keys)
    return float(flops), float(nbytes)


def marian_block_bounds(block, w) -> dict:
    """Bound seconds of each attention kernel over one Marian block:
    ``enc_layers`` encoder launches, then per decode step
    ``dec_layers`` self-attention launches (step s sees s + 1 keys in
    every row) and as many cross-attention launches (a row's source)."""
    d = w["d_model"]
    enc = w["enc_layers"] * bound_s(*encoder_attention(block.src_lens, d))
    cross = bound_s(*decode_attention(block.src_lens, d))
    dec = 0.0
    for s in range(block.steps):
        dec += bound_s(*decode_attention([s + 1] * block.rows, d)) + cross
    return {"flash_attention": enc, "flash_decode": w["dec_layers"] * dec}
