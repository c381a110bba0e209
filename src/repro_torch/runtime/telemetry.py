"""The port's own spans and counters, on the device trace's clock.

A span (:func:`span`) names a step of the program: the engine's routing,
batching, one block's execution and its completion; an NMT decode's
upload, graph lookup, state graph, step replays, token columns and fetch;
a graph capture.  A counter (:func:`count`) counts what happens, whether
or not spans are on: the graphs' captures, replays, capture seconds and
keys built.

Spans are off by default; :func:`enable` is the one switch.  Off,
:func:`span` costs one flag check and returns one shared object that
does nothing.  On, while a ``torch.profiler`` runs, a span enters
``torch.profiler.record_function`` with its name, so that it lies on the
same timeline as the device's kernels and copies (a profiler's reduction
puts each idle gap of the device down to the innermost span at its
middle); with no profiler running it enters none.  Either way it keeps a
record of its own: its name, its start and end on
``time.perf_counter_ns``, its parent span, the block it belongs to and
its attributes.  The records go into a ring of :data:`RING` entries (the
oldest overwritten), read by :func:`records`; the totals by name (count,
seconds, self seconds: a span's time less its children's) by
:func:`snapshot`.

A block is one ``batched_executor`` call of the engine: the span that
runs it takes ``block=True`` and gets a new block id (its ``block``),
which every span inside it inherits (0: none); a later span of the same
block names it (``block=<id>``).  No span sits inside a loop over requests
or decode steps; a span wraps the loop.

Every name starts with ``repro_torch.``.  One process, one thread: the
program's serving and graph paths are single-threaded.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import ops

RING = 65536               # records kept; the oldest are overwritten

Record = collections.namedtuple(
    "Record", "index name start_ns end_ns parent block attrs")
Record.__doc__ = """One span: its index (spans numbered as they start),
name, start and end (``time.perf_counter_ns``), the index of its parent
(-1: none), its block id (0: none) and its attributes (None: none)."""


class _State:
    def __init__(self):
        self.on = False
        self.counters: Dict[str, float] = {}
        self.totals: Dict[str, List[float]] = {}  # name -> [n, s, self s]
        self.ring: List[Optional[Record]] = [None] * RING
        self.written = 0          # records written since the reset
        self.started = 0          # spans started since the reset
        self.blocks = 0           # block ids given since the reset
        self.stack: List["_Span"] = []


_STATE = _State()


class _NoSpan:
    """What :func:`span` returns while spans are off."""

    __slots__ = ()
    block = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "new_block", "index", "parent", "block",
                 "start_ns", "child_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.new_block = attrs.pop("block", 0)
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _STATE
        # on the profiler's timeline while one runs; outside it a
        # record_function would only cost (~9 us a span)
        self._rf = (torch.profiler.record_function(self.name)
                    if torch._C._autograd._profiler_enabled() else _NO_SPAN)
        self._rf.__enter__()
        parent = st.stack[-1] if st.stack else None
        self.index = st.started
        st.started += 1
        self.parent = -1 if parent is None else parent.index
        if self.new_block is True:
            st.blocks += 1
            self.block = st.blocks
        elif self.new_block:
            self.block = int(self.new_block)
        else:
            self.block = 0 if parent is None else parent.block
        self.child_ns = 0
        st.stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        st = _STATE
        if st.stack and st.stack[-1] is self:
            st.stack.pop()
        dur = end - self.start_ns
        if st.stack:
            st.stack[-1].child_ns += dur
        tot = st.totals.get(self.name)
        if tot is None:
            tot = st.totals[self.name] = [0, 0.0, 0.0]
        tot[0] += 1
        tot[1] += dur * 1e-9
        tot[2] += (dur - self.child_ns) * 1e-9
        st.ring[st.written % RING] = Record(
            self.index, self.name, self.start_ns, end, self.parent,
            self.block, self.attrs or None)
        st.written += 1
        self._rf.__exit__(*exc)
        return False


def enable(on: bool) -> None:
    """Turn spans on or off (counters always count)."""
    _STATE.on = bool(on)
    _STATE.stack.clear()


def enabled() -> bool:
    return _STATE.on


def span(name: str, **attrs):
    """A context manager timing one step of the program; ``block=True``
    starts a new block, ``block=<id>`` joins one.  Off, the shared no-op
    (whose ``block`` is 0)."""
    if not _STATE.on:
        return _NO_SPAN
    return _Span(name, attrs)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` (whether spans are on or off)."""
    c = _STATE.counters
    c[name] = c.get(name, 0) + n


def counter(name: str):
    """The counter's value (0 if never counted)."""
    return _STATE.counters.get(name, 0)


def zero(prefix: str) -> None:
    """Drop every counter whose name starts with ``prefix``."""
    c = _STATE.counters
    for name in [k for k in c if k.startswith(prefix)]:
        del c[name]


def snapshot() -> Dict[str, dict]:
    """``counters``: every counter; ``spans``: by name, ``count``,
    ``total_s`` and ``self_s`` of the spans ended; ``launches``: the
    kernel wrappers' launch counts (:func:`ops.launch_counts`)."""
    return {"counters": dict(_STATE.counters),
            "spans": {name: {"count": int(n), "total_s": s, "self_s": own}
                      for name, (n, s, own) in _STATE.totals.items()},
            "launches": ops.launch_counts()}


def records() -> List[Record]:
    """The spans ended since the last :func:`reset` that the ring still
    holds, in the order they started."""
    st = _STATE
    if st.written <= RING:
        held = st.ring[:st.written]
    else:
        i = st.written % RING
        held = st.ring[i:] + st.ring[:i]
    return sorted(held, key=lambda r: r.index)


def reset() -> None:
    """Drop every counter, span total and record, and the block ids (the
    switch and the kernel wrappers' launch counts stay as they are)."""
    st = _STATE
    st.counters.clear()
    st.totals.clear()
    st.ring = [None] * RING
    st.written = st.started = st.blocks = 0
    st.stack.clear()
