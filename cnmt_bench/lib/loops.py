"""The measured window: a closed loop over a backlog, or an open loop over
a schedule of due times.  Both feed the engine through ``submit_batch``
and record, per request, what the client saw; the host spans around the
engine and around the card's executor; and the program's capture time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

from cnmt_bench.lib import system
from cnmt_bench.lib.trace import CALL_SPAN, Slice, Summary, span


@dataclasses.dataclass
class Served:
    """One request as the client saw it.  ``latency_s`` is the wait from
    its due time to its submission plus the engine's ``latency_s``."""

    rid: int
    tokens: object         # the source tokens (numpy int32)
    m: int
    device: int            # engine tier index, -1 if shed
    m_out: int
    latency_s: float
    late_s: float          # how late the generator submitted it


@dataclasses.dataclass
class Window:
    length_s: float
    served: List[Served]
    engine_s: float        # host seconds inside submit_batch
    adapter_s: float       # host seconds inside the card's executor
    blocks: list           # the card's blocks run in the window
    capture_s: float       # the program's graph capture seconds in it
    card_index: int
    slice: Optional[Summary] = None
    slice_blocks: Optional[list] = None


def _submit(engine, adapter, calls, now_s, tracing) -> tuple:
    adapter.expect(calls)
    t0 = time.perf_counter()
    with span(CALL_SPAN, tracing):
        results = engine.submit_batch([r.tokens for r in calls], now_s=now_s)
    return results, time.perf_counter() - t0


def _served(r, res, late_s: float) -> Served:
    device = -1 if res.shed else int(res.device)
    return Served(r.rid, r.tokens, r.m, device, int(res.m_out),
                  late_s + float(res.latency_s), late_s)


def _finish(start, served, engine_s, adapter, blocks0, cap0, card_index,
            profiler) -> Window:
    length = time.perf_counter() - start
    blocks = adapter.blocks[blocks0:]
    win = Window(length, served, engine_s,
                 sum(b.end_s - b.start_s for b in blocks), blocks,
                 system.capture_seconds() - cap0, card_index)
    if profiler is not None:
        win.slice = profiler.close()
        win.slice_blocks = [b for b in blocks
                            if b.start_s >= profiler.start_s] \
            if profiler.start_s is not None else []
    return win


def closed_loop(engine, adapter, card_index: int,
                calls: Iterator[list], seconds: float,
                profiler: Optional[Slice] = None) -> Window:
    """Submit the backlog's calls back to back until ``seconds`` have
    passed; the window ends with the last call."""
    tracing = profiler is not None
    served, engine_s = [], 0.0
    blocks0, cap0 = len(adapter.blocks), system.capture_seconds()
    start = time.perf_counter()
    while (elapsed := time.perf_counter() - start) < seconds:
        if profiler is not None:
            profiler.before_call(elapsed)
        call = next(calls)
        results, dt = _submit(engine, adapter, call, elapsed, tracing)
        engine_s += dt
        served += [_served(r, res, 0.0) for r, res in zip(call, results)]
    return _finish(start, served, engine_s, adapter, blocks0, cap0,
                   card_index, profiler)


def open_loop(engine, adapter, card_index: int, schedule: list,
              profiler: Optional[Slice] = None) -> Window:
    """Submit each request once it is due, every request due since the
    last call in one ``submit_batch``; the window ends once the last is
    served.  A request's latency counts from its due time."""
    tracing = profiler is not None
    served, engine_s = [], 0.0
    blocks0, cap0 = len(adapter.blocks), system.capture_seconds()
    start = time.perf_counter()
    i = 0
    while i < len(schedule):
        now = time.perf_counter() - start
        if schedule[i].due_s > now:
            with span("bench.generator_sleep", tracing):
                time.sleep(schedule[i].due_s - now)
            continue
        if profiler is not None:
            profiler.before_call(now)
        j = i
        while j < len(schedule) and schedule[j].due_s <= now:
            j += 1
        call = schedule[i:j]
        results, dt = _submit(engine, adapter, call, now, tracing)
        engine_s += dt
        served += [_served(r, res, now - r.due_s)
                   for r, res in zip(call, results)]
        i = j
    return _finish(start, served, engine_s, adapter, blocks0, cap0,
                   card_index, profiler)
