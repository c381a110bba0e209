"""The system under test, as the benchmark drives it: ``repro_torch``'s
NMT model behind its ``CollaborativeEngine``.  This is the one module of
the benchmark that imports the program.

The card tier's ``batched_executor`` is :class:`Adapter`.  It calls only
the model's public batched translate (``make_translate_batched()``, the
step-graph path on the card) and runs each block to its longest member's
output length through ``forced_len``, as a batched greedy decoder runs
until its last row has finished (random weights emit no EOS, so the
traffic says how long each answer is); each request is credited with its
own length.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.calibration import fit_device, measure_seq2seq_grid
from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M, prefilter_pairs
from repro_torch.models.registry import resolve
from repro_torch.runtime import graphs
from repro_torch.runtime.engine import CollaborativeEngine, Tier

from cnmt_bench.lib import traffic as traffic_lib
from cnmt_bench.lib.trace import span


@dataclasses.dataclass
class Block:
    """One block the card ran: rows, padded source width, each row's
    source length and output length, the steps decoded (the longest
    output), and when it ran on the host clock."""

    rows: int
    width: int
    src_lens: List[int]
    out_lens: List[int]
    steps: int
    start_s: float
    end_s: float


class Adapter:
    """The card tier's ``batched_executor``: ``(block (b, w), lengths) ->
    [(m, tokens)]``.  Before each ``submit_batch`` the loop tells it the
    output length of every request (:meth:`expect`); it keeps each
    served request's tokens for the check after the window."""

    def __init__(self, model, tracing: bool = False):
        self.translate = model.make_translate_batched()
        self.tracing = tracing
        self._expect: Dict[bytes, collections.deque] = {}
        self.blocks: List[Block] = []
        self.served: Dict[int, np.ndarray] = {}

    def expect(self, requests) -> None:
        self._expect.clear()
        for r in requests:
            self._expect.setdefault(r.tokens.tobytes(),
                                    collections.deque()).append((r.rid, r.m))

    def __call__(self, block, lengths) -> List[tuple]:
        with span("bench.adapter", self.tracing):
            return self._run(block, lengths)

    def _run(self, block, lengths) -> List[tuple]:
        t0 = time.perf_counter()
        block = np.asarray(block, np.int32)
        lens = np.asarray(lengths, np.int64)
        rows = [self._expect[block[i, :n].tobytes()].popleft()
                for i, n in enumerate(lens)]
        steps = max(m for _, m in rows)
        mask = (np.arange(block.shape[1])[None] < lens[:, None]).astype(
            np.float32)
        _, tokens = self.translate(block, mask, steps)
        out = []
        for i, (rid, m) in enumerate(rows):
            self.served[rid] = tokens[i, :m].copy()
            out.append((m, tokens[i, :m]))
        self.blocks.append(Block(len(rows), int(block.shape[1]),
                                 [int(n) for n in lens],
                                 [m for _, m in rows], int(steps), t0,
                                 time.perf_counter()))
        return out


def build_model(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's model at the configuration's widths, holding
    ``weights`` (every parameter, by name, checked by
    ``load_state_dict(strict=True)``)."""
    build = config["program"]
    model = resolve(build["name"], scale=build.get("scale", 1.0),
                    vocab=build["vocab"],
                    max_decode_len=build["max_decode_len"],
                    device=device).model
    for key, want in config["widths"].items():
        if hasattr(model.cfg, key) and getattr(model.cfg, key) != want:
            raise ValueError(f"the program built {key}="
                             f"{getattr(model.cfg, key)}, the configuration "
                             f"states {want}")
    model.load_state_dict(weights, strict=True)
    return model


def calibrate(model, grid: Dict, vocab: int) -> DeviceProfile:
    """The card's T_exe plane from forced-length translates at B=1 on the
    mix's grid (``measure_seq2seq_grid`` + ``fit_device``)."""
    translate = model.make_translate_batched()

    def forced(tokens, m):
        lens, out = translate(np.asarray(tokens, np.int32)[None], None, m)
        return int(lens[0]), out[0]

    n, m, t = measure_seq2seq_grid(forced, grid["n"], lambda _: grid["m"],
                                   reps=grid["reps"], vocab=vocab)
    return fit_device("card", n, m, t)


def n2m_of(mix: Dict) -> LinearN2M:
    """The scheduler's N -> M regressor, fitted on the mix's own pool."""
    n, m = traffic_lib.length_pool(mix["lengths"],
                                   int(mix["lengths"]["pool_size"]))
    return LinearN2M().fit(*prefilter_pairs(n.astype(float),
                                            m.astype(float)))


def build_engine(mix: Dict, adapter: Adapter, card: DeviceProfile,
                 n2m: LinearN2M, seed: int) -> tuple:
    """``(engine, card tier index)``: the mix's tiers in order, the card
    carrying ``adapter``; a modelled tier gets the plane frozen in the
    mix, a remote tier its RTT trace, aligned to the window's start."""
    tiers, card_index = [], None
    for spec in mix["tiers"]:
        rtt_fn, bandwidth = None, 100e6
        link = spec.get("link")
        if link is not None:
            trace = traffic_lib.RttTrace(link["profile"], link["trace_seed"],
                                         link["duration_s"])
            rtt_fn, bandwidth = trace.rtt_at, float(link["bandwidth_bps"])
        if spec["device"] == "card":
            card_index = len(tiers)
            tiers.append(Tier(card, name=spec["name"],
                              batch_size=int(spec["batch_size"]),
                              batched_executor=adapter, rtt_fn=rtt_fn,
                              bandwidth_bps=bandwidth))
        elif spec["device"] == "modelled":
            plane = LinearLatencyModel(**spec["plane"])
            tiers.append(Tier(DeviceProfile(spec["name"], plane,
                                            float(spec["noise_frac"])),
                              name=spec["name"],
                              servers=int(spec.get("servers", 1)),
                              rtt_fn=rtt_fn, bandwidth_bps=bandwidth))
        else:
            raise ValueError(f"unknown tier device {spec['device']!r}")
    engine = CollaborativeEngine(tiers=tiers, n2m=n2m,
                                 seed=int(seed) % 2**32)
    return engine, card_index


def nominal_card() -> DeviceProfile:
    """A plane for a card that is the only tier (nothing to choose)."""
    return DeviceProfile("card", LinearLatencyModel())


def capture_seconds() -> float:
    """The program's running total of CUDA-graph capture time."""
    return float(graphs.totals()["capture_s"])


def release() -> None:
    """Drop every graph the program holds and hand the allocator's cached
    blocks back (the caller drops its references to the model first)."""
    graphs.release_all()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
