"""The program's own spans and counters in a traced slice.

With ``repro_torch.runtime.telemetry``'s spans on, each step of the
program (``repro_torch.engine.*``, ``repro_torch.nmt.*``,
``repro_torch.graphs.capture``) is a ``record_function`` range on the
profiler's timeline, beside the device's kernels.  :func:`reduce` splits
them off the slice's events, so that ``trace.reduce`` sees the events it
sees without them (its summary and ``idle_by_host`` labels stay as they
are), and puts every idle gap of the device, the short ones too, down to
the innermost program span at the gap's middle (``none``: no program
span).

The profiler's device timestamps drift from its host clock (on the card
by up to ~5 ms a second, with jumps), so a gap's middle read on the
recorded clock can fall milliseconds away from what the host was doing
then:
:func:`reduce` first moves the device's events back onto the host's
clock, anchored at every copy to pageable host memory (its runtime call
returns only once the copy has ended), and reports how well that holds.
The gaps are then those of ``trace.reduce`` over the moved events, so
the seconds of ``by_program`` add up to that slice's idle time.

:func:`program_counters` reads the program's counters
(``graphs.captures``, ``graphs.replays``, ``graphs.capture_s``,
``graphs.keys_built``), and is empty for a program without them; the
readers below return nothing when the slice holds no program span or the
counters are absent.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

from cnmt_bench.lib import trace

PROGRAM = "repro_torch."
NONE = "none"
# the idle shares: the spans whose innermost idle each one sums
ENGINE = tuple(PROGRAM + "engine." + s
               for s in ("submit_batch", "route", "batch", "complete"))
LAUNCH = (PROGRAM + "nmt.steps",)
FETCH = (PROGRAM + "nmt.fetch",)
# no program span, or only the block's executor call: the benchmark's own
# adapter and loop
OUTSIDE = (NONE, PROGRAM + "engine.execute")
SHARES = {"idle_engine_pct": ENGINE, "idle_launch_pct": LAUNCH,
          "idle_fetch_pct": FETCH, "idle_outside_program_pct": OUTSIDE}


def _on_device(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


class _Events:
    """A profiler stand-in holding a list of events, for ``trace.reduce``."""

    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


class _Moved:
    """A device event moved by ``shift_ns`` onto the host's clock."""

    def __init__(self, e, shift_ns: int):
        self._e, self._shift = e, shift_ns

    def start_ns(self):
        return trace._times(self._e)[0] + self._shift

    def duration_ns(self):
        a, b = trace._times(self._e)
        return b - a

    def __getattr__(self, name):
        return getattr(self._e, name)


@dataclasses.dataclass
class Reduced:
    """A slice reduced with the program's spans apart.

    ``summary`` is ``trace.reduce`` of the slice without them, as the
    profiler recorded it; ``aligned`` the same with the device's events
    moved onto the host's clock (:func:`clock_offsets`), in which
    ``by_program`` puts each idle gap down to the innermost program span
    at its middle (``by_program_raw``: the same on the recorded clock).
    ``clock``: the anchors, the offset's range, and how far the moved
    device work still starts before its launch (0 on a sound clock)."""

    summary: Optional[trace.Summary]
    aligned: Optional[trace.Summary] = None
    by_program: Dict[str, float] = dataclasses.field(default_factory=dict)
    by_program_raw: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    clock: Dict[str, float] = dataclasses.field(default_factory=dict)


def clock_offsets(events) -> List[Tuple[int, int]]:
    """``(device time, device clock less host clock)`` at every copy to
    pageable host memory, whose runtime call returns only once the copy
    has ended: the copy's end is put at the call's return.  On the card
    the profiler's device timestamps drift from its host clock by up to
    ~5 ms a second, and jump: a 3 s slice has read offsets of -29 to
    +8 ms."""
    calls = {e.correlation_id(): e for e in events
             if not _on_device(e) and e.name().startswith("cudaMemcpy")}
    anchors = []
    for e in events:
        if _on_device(e) and "DtoH" in e.name() and "Pageable" in e.name():
            call = calls.get(e.correlation_id())
            if call is not None:
                end = trace._times(e)[1]
                anchors.append((end, end - trace._times(call)[1]))
    return sorted(anchors)


def _offset_at(anchors: List[Tuple[int, int]], t: int) -> int:
    """The offset at device time ``t``: linear between the anchors, the
    nearest one's outside them, 0 without any."""
    if not anchors:
        return 0
    i = bisect.bisect_left(anchors, (t, -2**63))
    if i == 0:
        return anchors[0][1]
    if i == len(anchors):
        return anchors[-1][1]
    (t0, o0), (t1, o1) = anchors[i - 1], anchors[i]
    return o0 + (o1 - o0) * (t - t0) // max(t1 - t0, 1)


def reduce(prof) -> Reduced:
    """The slice's :class:`Reduced` (``summary`` None when the slice holds
    no call span; ``by_program`` empty when it holds no program span)."""
    events = list(prof.profiler.kineto_results.events())
    program, rest = [], []
    for e in events:
        if e.name().startswith(PROGRAM):
            if not _on_device(e):
                a, b = trace._times(e)
                program.append((a, b, e.name()))
        else:
            rest.append(e)
    out = Reduced(trace.reduce(_Events(rest)))
    if out.summary is None or not program:
        return out
    anchors = clock_offsets(rest)
    moved = [_Moved(e, -_offset_at(anchors, trace._times(e)[0]))
             if _on_device(e) else e for e in rest]
    out.aligned = trace.reduce(_Events(moved))
    out.by_program = _idle_by_span(moved, program)
    out.by_program_raw = _idle_by_span(rest, program)
    offsets = [o for _, o in anchors]
    out.clock = {"anchors": len(anchors),
                 "offset_min_us": min(offsets, default=0) / 1e3,
                 "offset_max_us": max(offsets, default=0) / 1e3,
                 "lead_us": _lead(moved) / 1e3}
    return out


def _idle_by_span(events, program) -> Dict[str, float]:
    """Idle seconds of the slice by innermost program span at each gap's
    middle (``NONE``: none)."""
    lo, hi, busy = _busy(events)
    gaps, cursor = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    by_span: Dict[str, float] = {}
    mids = [(a + b) // 2 for a, b in gaps]
    for (a, b), name in zip(gaps, _innermost_at(program, mids)):
        name = name or NONE
        by_span[name] = by_span.get(name, 0.0) + (b - a) * 1e-9
    return by_span


def _lead(events) -> int:
    """The most by which device work starts before the runtime call that
    launched it started (ns; 0 when none does)."""
    calls = {e.correlation_id(): trace._times(e)[0] for e in events
             if not _on_device(e) and e.name().startswith("cuda")}
    lead = 0
    for e in events:
        if _on_device(e) and not e.is_user_annotation():
            at = calls.get(e.correlation_id())
            if at is not None:
                lead = max(lead, at - trace._times(e)[0])
    return lead


def _busy(events) -> Tuple[int, int, List[Tuple[int, int]]]:
    """The slice's hull (its call spans) and the union of device work in
    it, by ``trace.reduce``'s rules."""
    device, calls = [], []
    for e in events:
        a, b = trace._times(e)
        name = e.name()
        if _on_device(e):
            if not (name.startswith("bench.") or e.is_user_annotation()):
                device.append((a, b))
        elif name == trace.CALL_SPAN:
            calls.append((a, b))
    lo = min(a for a, _ in calls)
    hi = max(b for _, b in calls)
    clipped = [(max(a, lo), min(b, hi)) for a, b in device]
    return lo, hi, trace._union([(a, b) for a, b in clipped if b > a])


def _innermost_at(spans: List[Tuple[int, int, str]],
                  times: List[int]) -> List[Optional[str]]:
    """For each of ``times`` (ascending), the name of the innermost span
    containing it (spans of one thread nest); None where none does."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_shares(reduced: Reduced) -> Dict[str, float]:
    """The idle shares (% of the slice) of ``SHARES``, on the host's
    clock; empty without program spans."""
    s = reduced.aligned
    if s is None or not reduced.by_program or s.window_s <= 0:
        return {}
    return {metric: 100.0 * sum(reduced.by_program.get(n, 0.0)
                                for n in names) / s.window_s
            for metric, names in SHARES.items()}


GRAPH_COUNTERS = {"graphs.captures": 0, "graphs.replays": 0,
                  "graphs.capture_s": 0.0, "graphs.keys_built": 0}


def program_counters() -> Dict[str, float]:
    """The program's counters now (the graphs' four at 0 until counted);
    empty for a program that has none."""
    try:
        from repro_torch.runtime import telemetry
    except ImportError:
        return {}
    return {**GRAPH_COUNTERS, **telemetry.snapshot()["counters"]}


def delta(before: Dict[str, float],
          after: Dict[str, float]) -> Dict[str, float]:
    return {k: after[k] - before.get(k, 0) for k in after}


def key_metrics(moved: Dict[str, float]) -> Dict[str, float]:
    """``graph_keys_built`` and ``capture_ms_per_key`` (None with no key
    built) from the counters' change over a window; empty without them."""
    if "graphs.keys_built" not in moved:
        return {}
    keys = moved.get("graphs.keys_built", 0)
    return {"graph_keys_built": keys,
            "capture_ms_per_key": (1e3 * moved.get("graphs.capture_s", 0.0)
                                   / keys if keys else None)}
