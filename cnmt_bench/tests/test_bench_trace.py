"""The program's spans in a traced slice (``lib/program_trace.py``): a
hand-made profiler of bench spans, program spans, runtime calls and
device kernels; and one tiny cell through ``program_idle.measure`` on
the CPU.

* ``trace.reduce``'s summary (``idle_by_host`` and all) is the same with
  and without the program's spans, which :func:`program_trace.reduce`
  sets apart (left in, they would relabel the gaps);
* every idle gap, the short ones too, lands in ``by_program`` under the
  innermost program span at its middle, and the shares read from it
  add up to the slice's idle share;
* device events recorded on a clock ahead of the host's are moved back
  by the offset at the copies to pageable memory;
* the counters' readers.
"""

import time

import pytest
import torch

from cnmt_bench.lib import program_trace, trace

US = 1000       # the events below are in microseconds; kineto's are ns


class Ev:
    def __init__(self, name, a, b, cuda=False, annotation=False, corr=0):
        self._name, self.a, self.b = name, a * US, b * US
        self.cuda, self.annotation, self.corr = cuda, annotation, corr

    def name(self):
        return self._name

    def correlation_id(self):
        return self.corr

    def moved(self, by_us):
        return Ev(self._name, self.a / US + by_us, self.b / US + by_us,
                  self.cuda, self.annotation, self.corr)

    def device_type(self):
        return "DeviceType.CUDA" if self.cuda else "DeviceType.CPU"

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a

    def is_user_annotation(self):
        return self.annotation


class Prof:
    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return list(self._events)


P = "repro_torch."
BENCH = [Ev("bench.call", 0, 1000, annotation=True),
         Ev("bench.adapter", 100, 900, annotation=True)]
# the copy to pageable memory ends as its call returns: clocks agree
HOST = [Ev("cudaGraphLaunch", 210, 260, corr=1),
        Ev("cudaMemcpyAsync", 610, 900, corr=2)]
DEVICE = [Ev("kernel_a", 150, 200, cuda=True),
          Ev("kernel_b", 260, 590, cuda=True, corr=1),
          Ev("kernel_c", 300, 400, cuda=True, corr=1),
          Ev("Memcpy DtoH (Device -> Pageable)", 870, 900, cuda=True,
             corr=2),
          Ev("kernel_d", 905, 990, cuda=True),
          Ev("bench.adapter", 150, 990, cuda=True, annotation=True)]
PROGRAM = [Ev(P + "engine.submit_batch", 10, 990, annotation=True),
           Ev(P + "engine.route", 20, 80, annotation=True),
           Ev(P + "engine.execute", 100, 900, annotation=True),
           Ev(P + "nmt.upload", 110, 150, annotation=True),
           Ev(P + "nmt.steps", 200, 600, annotation=True),
           Ev(P + "nmt.fetch", 600, 880, annotation=True),
           Ev(P + "engine.complete", 910, 980, annotation=True),
           # a span's mirror on the device timeline
           Ev(P + "nmt.steps", 250, 590, cuda=True, annotation=True)]
# gaps: [0,150) route, [200,260) steps, [590,870) fetch, [900,905)
# submit_batch (short), [990,1000) none (short)
IDLE = {P + "engine.route": 150e-6, P + "nmt.steps": 60e-6,
        P + "nmt.fetch": 280e-6, P + "engine.submit_batch": 5e-6,
        "none": 10e-6}


def test_idle_by_host_is_unchanged_by_the_program_spans():
    plain = trace.reduce(Prof(BENCH + HOST + DEVICE))
    got = program_trace.reduce(Prof(BENCH + HOST + DEVICE + PROGRAM))
    assert got.summary == plain
    assert got.aligned == plain               # the clocks agree
    assert plain.idle_by_host == pytest.approx(
        {"bench.call/python": 150e-6, "bench.adapter/cudaGraphLaunch": 60e-6,
         "bench.adapter/cudaMemcpyAsync": 280e-6, "gaps under 20 us": 15e-6})
    # left among the host events, a program span would relabel a gap
    mixed = trace.reduce(Prof(BENCH + HOST + DEVICE + PROGRAM))
    assert "bench.call/repro_torch.engine.route" in mixed.idle_by_host


def test_every_gap_lands_under_its_innermost_program_span():
    got = program_trace.reduce(Prof(BENCH + HOST + DEVICE + PROGRAM))
    s = got.aligned
    assert got.by_program == pytest.approx(IDLE)
    assert got.by_program_raw == pytest.approx(IDLE)
    assert sum(got.by_program.values()) == pytest.approx(
        s.window_s - s.busy_s)
    assert got.clock == {"anchors": 1, "offset_min_us": 0.0,
                         "offset_max_us": 0.0, "lead_us": 0.0}
    shares = program_trace.idle_shares(got)
    assert shares == pytest.approx({"idle_engine_pct": 15.5,
                                    "idle_launch_pct": 6.0,
                                    "idle_fetch_pct": 28.0,
                                    "idle_outside_program_pct": 1.0})
    idle_pct = 100.0 * (1 - s.busy_s / s.window_s)
    rest = 100.0 * got.by_program.get(P + "nmt.upload", 0.0) / s.window_s
    assert sum(shares.values()) + rest == pytest.approx(idle_pct)


def test_device_events_are_moved_back_onto_the_host_clock():
    """The device's clock 100 us ahead: on the recorded clock the gaps'
    middles fall under other spans; moved back, they fall as before."""
    ahead = [e.moved(100) for e in DEVICE]
    got = program_trace.reduce(Prof(BENCH + HOST + ahead + PROGRAM))
    assert got.clock["offset_min_us"] == got.clock["offset_max_us"] == 100
    assert got.clock["lead_us"] == 0.0
    assert got.aligned == trace.reduce(Prof(BENCH + HOST + DEVICE))
    assert got.by_program == pytest.approx(IDLE)
    assert got.by_program_raw != pytest.approx(IDLE)
    assert got.summary == trace.reduce(Prof(BENCH + HOST + ahead))


def test_the_offset_is_linear_between_anchors():
    anchors = [(1000, 10), (2000, 30)]
    assert [program_trace._offset_at(anchors, t)
            for t in (0, 1000, 1500, 2000, 5000)] == [10, 10, 20, 30, 30]
    assert program_trace._offset_at([], 123) == 0


def test_without_program_spans_nothing_is_read():
    got = program_trace.reduce(Prof(BENCH + HOST + DEVICE))
    assert got.summary is not None and got.by_program == {}
    assert program_trace.idle_shares(got) == {}
    none = program_trace.reduce(Prof(HOST + DEVICE + PROGRAM))
    assert none.summary is None and none.by_program == {}


def test_innermost_of_nested_spans():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 90, "d")]
    assert program_trace._innermost_at(spans, [5, 25, 40, 55, 70, 95, 120]) \
        == ["a", "c", "b", "a", "d", "a", None]


def test_key_metrics():
    assert program_trace.key_metrics({}) == {}
    assert program_trace.key_metrics(
        {"graphs.keys_built": 0, "graphs.capture_s": 0.0}) == \
        {"graph_keys_built": 0, "capture_ms_per_key": None}
    got = program_trace.key_metrics(
        {"graphs.keys_built": 4, "graphs.capture_s": 0.2,
         "graphs.captures": 8})
    assert got == pytest.approx({"graph_keys_built": 4,
                                 "capture_ms_per_key": 50.0})


def test_a_tiny_cell_on_the_cpu(tiny_root, monkeypatch):
    from cnmt_bench import program_idle
    from repro_torch.runtime import telemetry

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    got = program_idle.measure(tiny_root, "tiny-bilstm.docs", 2**31 + 5, 0.5,
                               0.2, 1, torch.device("cpu"),
                               time.perf_counter())
    assert not telemetry.enabled()
    t = got["traced"]
    assert sum(v for _, v in t["idle_by_program"]) == pytest.approx(
        t["window_s"] * t["idle_pct_aligned"] / 100)
    names = {name for name, _ in t["idle_by_program"]}
    assert names <= {P + "engine." + s for s in
                     ("submit_batch", "route", "batch", "execute",
                      "complete")} | {P + "nmt." + s for s in
                                      ("upload", "prep", "steps", "columns",
                                       "fetch")} | {"none"}
    # on the CPU nothing runs on a device: one gap, the whole slice
    assert len(names) == 1
    assert not any(P in label for label, _ in t["idle_gaps"])
    assert set(t["program_metrics"]) == {
        "idle_engine_pct", "idle_launch_pct", "idle_fetch_pct",
        "idle_outside_program_pct", "graph_keys_built",
        "capture_ms_per_key"}
    assert t["spans"][P + "engine.execute"]["count"] > 0
    assert t["spans"][P + "nmt.steps"]["count"] > 0
    assert len(got["cost"]["off"]) == len(got["cost"]["on"]) == 2
