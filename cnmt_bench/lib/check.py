"""What decides ``correct``: the served tokens held against the plain
reference, after the window.

A sample of the requests the card served, drawn from the seed and
holding the longest, goes through the reference once, teacher-forced on
the tokens the program served.  At every served position the gap is how
far the served token's logit lies below the reference's best; the number
compared is the widest gap.  A greedy decoder that computes what the
configuration states serves the reference's best token up to rounding
(gap 0, or a hair where two logits all but tie); a wrong step, a lost
state or an altered token lies below it by the logits' own spread.

The control reads the same positions with the reference computed in the
next precision down (TF32 products for float32): at each position the
gap of the token the lower precision puts first.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from cnmt_bench.lib import traffic as traffic_lib

SAMPLE_STREAM = 7
BLOCK_POSITIONS = 16384   # rows x longest sequence a reference block holds


def sample(served, card_index: int, tokens: Dict[int, np.ndarray],
           seed: int, size: int) -> list:
    """Up to ``size`` card-served requests: the one with the longest
    answer, and the rest drawn from ``seed``."""
    pool = [s for s in served if s.device == card_index and s.rid in tokens]
    if not pool:
        return []
    longest = max(range(len(pool)), key=lambda i: (pool[i].m, -pool[i].rid))
    rest = [i for i in range(len(pool)) if i != longest]
    rng = traffic_lib.rng_for(seed, SAMPLE_STREAM)
    pick = rng.permutation(len(rest))[:max(size - 1, 0)]
    return [pool[longest]] + [pool[rest[i]] for i in sorted(pick)]


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on or off for the duration (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def widest_gaps(reference, params, widths: Dict, requests: list,
                answers: Dict[int, np.ndarray], device, *,
                control: bool = False) -> Dict[str, float]:
    """``{"program": g, "positions": k}`` and, with ``control``, the
    control's ``"control"`` gap, over every served position of
    ``requests`` (each with ``rid``, source ``tokens``), their answers
    from ``answers``; rows in blocks of similar length, at most
    ``BLOCK_POSITIONS`` rows x positions a block."""
    order = sorted(requests, key=lambda r: (max(len(answers[r.rid]),
                                                len(r.tokens)), r.rid))
    blocks, rows = [], []
    for r in order:
        width = max(len(answers[r.rid]), len(r.tokens))
        if rows and (len(rows) + 1) * width > BLOCK_POSITIONS:
            blocks.append(rows)
            rows = []
        rows.append(r)
    if rows:
        blocks.append(rows)
    out = {"program": 0.0, "positions": 0}
    if control:
        out["control"] = 0.0
    bos = int(widths["bos_id"])
    with torch.inference_mode():
        for rows in blocks:
            n = max(len(r.tokens) for r in rows)
            t = max(len(answers[r.rid]) for r in rows)
            src = np.zeros((len(rows), n), np.int64)
            ans = np.zeros((len(rows), t), np.int64)
            tgt_in = np.zeros((len(rows), t), np.int64)
            valid = np.zeros((len(rows), t), bool)
            for j, r in enumerate(rows):
                a = answers[r.rid]
                src[j, :len(r.tokens)] = r.tokens
                ans[j, :len(a)] = a
                tgt_in[j, 0] = bos
                tgt_in[j, 1:len(a)] = a[:-1]
                valid[j, :len(a)] = True
            src_t = torch.as_tensor(src, device=device)
            lens_t = torch.as_tensor([len(r.tokens) for r in rows],
                                     device=device)
            tgt_t = torch.as_tensor(tgt_in, device=device)
            ans_t = torch.as_tensor(ans, device=device)
            valid_t = torch.as_tensor(valid, device=device)
            with tf32(False):
                ref = reference.logits(params, widths, src_t, lens_t, tgt_t)
            best = ref.max(dim=-1).values
            gap = best - ref.gather(-1, ans_t[..., None])[..., 0]
            out["program"] = max(out["program"],
                                 float(gap[valid_t].max()))
            out["positions"] += int(valid.sum())
            if control:
                with tf32(True):
                    low = reference.logits(params, widths, src_t, lens_t,
                                           tgt_t)
                first = low.argmax(dim=-1)
                cgap = best - ref.gather(-1, first[..., None])[..., 0]
                out["control"] = max(out["control"],
                                     float(cgap[valid_t].max()))
                del low
            del ref
    return out


def verdict(served, card_index: int, answers: Dict[int, np.ndarray],
            gaps: Dict[str, float], limit: float) -> Dict[str, Dict]:
    """The numbers compared, each with its limit: the widest logit gap;
    requests never served (shed, or on the card with no answer); card
    answers whose length is not what the request asked for (a modelled
    tier's answer length is its estimate)."""
    unserved = sum(1 for s in served if s.device < 0
                   or (s.device == card_index and s.rid not in answers))
    wrong_len = sum(1 for s in served if s.device == card_index and (
        s.m_out != s.m or (s.rid in answers and len(answers[s.rid]) != s.m)))
    return {"logit_gap": {"value": gaps["program"], "limit": limit},
            "unserved": {"value": unserved, "limit": 0},
            "wrong_length": {"value": wrong_len, "limit": 0},
            "positions_compared": {"value": gaps["positions"],
                                   "limit": 1}}


def passed(checks: Dict[str, Dict]) -> bool:
    """Every number within its limit (positions compared: at least)."""
    ok = all(c["value"] <= c["limit"] for k, c in checks.items()
             if k != "positions_compared")
    return ok and checks["positions_compared"]["value"] >= \
        checks["positions_compared"]["limit"]
