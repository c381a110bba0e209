"""The traced run's profiler slice and what it reduces to.

``torch.profiler`` traces the last calls of the window (CPU and CUDA
activity); the benchmark's own spans (``bench.*``, ``record_function``)
mark the calls and the blocks, so the slice is exactly the calls it
covers.  From the slice:

* ``busy_s``: the union of the intervals in which a kernel, copy or set
  ran on the device, inside the hull of the slice's ``bench.call`` spans
  (``window_s``);
* device time by kernel name, for the rooflines and ``device_ops``;
* the idle gaps, each labelled by what the host was doing at its middle:
  the innermost ``bench.*`` span and the innermost other host event.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

CALL_SPAN = "bench.call"
SHORT_GAP_NS = 20_000        # shorter idle gaps are summed, not labelled


def span(name: str, tracing: bool):
    """A ``record_function`` span while tracing, else nothing."""
    if tracing:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _times(e) -> Tuple[int, int]:
    try:
        start, dur = e.start_ns(), e.duration_ns()
    except AttributeError:                      # older kineto bindings
        start, dur = int(e.start_us() * 1000), int(e.duration_us() * 1000)
    return int(start), int(start + dur)


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # device seconds by event name
    idle_by_host: Dict[str, float]      # idle seconds by host activity

    def seconds_matching(self, needle: str) -> float:
        return sum(v for k, v in self.kernel_s.items() if needle in k)

    def top(self, table: Dict[str, float], k: int = 10) -> list:
        return [[name, sec] for name, sec in
                sorted(table.items(), key=lambda kv: -kv[1])[:k]]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans: List[Tuple[int, int, str]], t: int) -> Optional[str]:
    """Name of the latest-starting span that contains ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name)
    return None if best is None else best[1]


def reduce(prof) -> Optional[Summary]:
    """The slice's summary, or None when it holds no call span."""
    device, bench, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        a, b = _times(e)
        name = e.name()
        if "cuda" in str(e.device_type()).lower():
            # a span's mirror on the device timeline is no device work
            if not (name.startswith("bench.") or e.is_user_annotation()):
                device.append((a, b, name))
        elif name.startswith("bench."):
            bench.append((a, b, name))
        else:
            host.append((a, b, name))
    calls = [(a, b) for a, b, n in bench if n == CALL_SPAN]
    if not calls:
        return None
    lo = min(a for a, _ in calls)
    hi = max(b for _, b in calls)
    kernel_s: Dict[str, float] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            clipped.append((a, b))
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-9
    busy = _union(clipped)
    idle: Dict[str, float] = {}
    host.sort()
    bench.sort()
    cursor = lo
    for a, b in busy + [(hi, hi)]:
        if a - cursor >= SHORT_GAP_NS:
            mid = (a + cursor) // 2
            label = (f"{_innermost(bench, mid) or 'outside'}/"
                     f"{_innermost(_near(host, mid), mid) or 'python'}")
        else:
            label = "gaps under 20 us"
        if a > cursor:
            idle[label] = idle.get(label, 0.0) + (a - cursor) * 1e-9
        cursor = max(cursor, b)
    return Summary(window_s=(hi - lo) * 1e-9,
                   busy_s=sum(b - a for a, b in busy) * 1e-9,
                   kernel_s=kernel_s, idle_by_host=idle)


def _near(sorted_spans: List[Tuple[int, int, str]], t: int,
          reach_ns: int = 10**9) -> List[Tuple[int, int, str]]:
    """The spans starting within ``reach_ns`` before ``t`` (host events
    are short; a bisect keeps the gap labelling linear)."""
    i = bisect.bisect_right(sorted_spans, (t, 2**63, ""))
    j = bisect.bisect_left(sorted_spans, (t - reach_ns, -1, ""))
    return sorted_spans[j:i]


class Slice:
    """Profiles the calls that start at or after ``from_s`` seconds into
    the window, to the window's end (:meth:`close`)."""

    def __init__(self, from_s: float):
        self.from_s = from_s
        self.prof = None
        self.start_s: Optional[float] = None

    @staticmethod
    def warm() -> None:
        """Start the profiler's machinery once in set-up, so its first
        start inside the window costs what every later one does."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def before_call(self, elapsed_s: float) -> None:
        if self.prof is None and elapsed_s >= self.from_s:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.start_s = time.perf_counter()

    def close(self) -> Optional[Summary]:
        if self.prof is None:
            return None
        torch.cuda.synchronize()
        self.prof.stop()
        return reduce(self.prof)
