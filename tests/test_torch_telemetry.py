"""The port's spans and counters (``repro_torch.runtime.telemetry``) on the
CPU, the graph paths stubbed (``tests/_torch_graph_stub.py``).

* off (the default): ``span`` is one shared no-op, no span site enters
  ``torch.profiler.record_function`` or keeps a record, and the
  ``graphs.*`` counters still count;
* on, a span lies on a running profiler's timeline, and enters no
  ``record_function`` while none runs;
* on: a translate of two blocks through ``CollaborativeEngine.
  submit_batch`` records the ``engine.*`` and ``nmt.*`` spans under the
  right parents, one block id a block, and each name's self seconds are
  its durations less its children's;
* ``graphs.totals()`` is a view of the module's three counters, and a
  one-key cache alternating two keys builds (and counts) four keys.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.models.registry import resolve
from repro_torch.runtime import graphs, telemetry
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from _torch_graph_stub import StubCache, stub_active
from _torch_threads import cap_threads

cap_threads()

P = "repro_torch."
ENGINE = {P + "engine." + s for s in
          ("submit_batch", "route", "batch", "execute", "complete")}
NMT = {P + "nmt." + s for s in
       ("upload", "graphs", "prep", "steps", "columns", "fetch")}


@pytest.fixture
def stub_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "GraphCache", StubCache)
    monkeypatch.setattr(graphs, "active", stub_active)
    telemetry.reset()
    yield
    telemetry.enable(False)
    telemetry.reset()


@pytest.fixture(scope="module")
def bilstm():
    return resolve("cnmt:de-en", scale=0.02, vocab=40, max_decode_len=6,
                   device="cpu", seed=3).model


def _engine(model, steps=4):
    """One card tier of 2-row blocks whose executor is the model's batched
    translate at ``steps`` tokens; returns (engine, the blocks it ran)."""
    translate = model.make_translate_batched()
    blocks = []

    def executor(block, lengths):
        block = np.asarray(block, np.int32)
        mask = (np.arange(block.shape[1])[None]
                < np.asarray(lengths)[:, None]).astype(np.float32)
        _, toks = translate(block, mask, steps)
        blocks.append(block.shape)
        return [(steps, toks[i]) for i in range(len(lengths))]

    tier = Tier(DeviceProfile("card", LinearLatencyModel()), name="card",
                batch_size=2, batched_executor=executor)
    n2m = LinearN2M().fit(np.array([2.0, 4.0, 6.0]), np.array([2.0, 4, 6]))
    return CollaborativeEngine(tiers=[tier], n2m=n2m, seed=0), blocks


def _requests():
    # two lengths, two rows each: two blocks of exact widths 3 and 5
    rng = np.random.default_rng(0)
    return [rng.integers(3, 40, n).astype(np.int32) for n in (3, 5, 3, 5)]


def test_off_is_one_shared_no_op_and_records_nothing(stub_graphs, bilstm,
                                                     monkeypatch):
    telemetry.enable(False)
    assert telemetry.span("repro_torch.x") is telemetry.span("repro_torch.y")
    assert telemetry.span("repro_torch.x", block=True).block == 0

    monkeypatch.setattr(torch.profiler, "record_function", _refused)
    engine, blocks = _engine(bilstm)
    results = engine.submit_batch(_requests(), now_s=0.0)
    assert len(blocks) == 2 and all(r.m_out == 4 for r in results)
    assert telemetry.records() == []
    snap = telemetry.snapshot()
    assert snap["spans"] == {}
    assert snap["counters"]["graphs.keys_built"] == 2
    assert snap["counters"]["graphs.captures"] == 4      # prep + step a key
    assert snap["counters"]["graphs.replays"] > 0
    assert snap["counters"]["graphs.capture_s"] > 0
    assert set(snap["launches"]) >= {"flash_attention", "flash_decode"}
    bilstm.__dict__.pop("_step_graphs", None)


def test_on_records_engine_and_nmt_spans_by_block(stub_graphs, bilstm):
    telemetry.enable(True)
    engine, blocks = _engine(bilstm)
    engine.submit_batch(_requests(), now_s=0.0)
    recs = telemetry.records()
    telemetry.enable(False)
    bilstm.__dict__.pop("_step_graphs", None)
    assert len(blocks) == 2
    by_index = {r.index: r for r in recs}
    names = {r.name for r in recs}
    assert ENGINE | NMT | {P + "graphs.capture"} <= names
    assert all(r.name.startswith(P) for r in recs)

    def parent(r):
        return by_index[r.parent].name if r.parent >= 0 else None

    (top,) = [r for r in recs if r.parent < 0]
    assert top.name == P + "engine.submit_batch"
    for r in recs:
        if r.name in ENGINE - {P + "engine.submit_batch"}:
            assert parent(r) == top.name
        if r.name in NMT:
            assert parent(r) == P + "engine.execute"
        if r.name == P + "graphs.capture":
            assert parent(r) == P + "nmt.graphs"
            assert r.attrs["kind"] == "translate"
        assert by_index.get(r.parent, top).start_ns <= r.start_ns
        assert r.end_ns <= by_index.get(r.parent, r).end_ns

    execs = [r for r in recs if r.name == P + "engine.execute"]
    assert [e.block for e in execs] == [1, 2]
    assert [(e.attrs["rows"], e.attrs["width"]) for e in execs] == \
        [(2, 3), (2, 5)]
    assert [sorted(e.attrs["requests"]) for e in execs] == [[0, 2], [1, 3]]
    for e in execs:
        inside = [r for r in recs if r.name in NMT and r.parent == e.index]
        assert {r.name for r in inside} == NMT
        assert {r.block for r in inside} == {e.block}
    completes = [r for r in recs if r.name == P + "engine.complete"]
    assert [c.block for c in completes] == [1, 2, 0]
    assert {r.block for r in recs
            if r.name in ("repro_torch.engine.route",
                          "repro_torch.engine.batch")} == {0}

    # self seconds: each span's duration less its children's
    spans = telemetry.snapshot()["spans"]
    for name, tot in spans.items():
        mine = [r for r in recs if r.name == name]
        dur = sum(r.end_ns - r.start_ns for r in mine)
        kids = sum(c.end_ns - c.start_ns for r in mine for c in recs
                   if c.parent == r.index)
        assert tot["count"] == len(mine)
        assert tot["total_s"] == pytest.approx(dur * 1e-9, rel=1e-9)
        assert tot["self_s"] == pytest.approx((dur - kids) * 1e-9, rel=1e-9,
                                              abs=1e-12)


def _refused(*args, **kwargs):
    raise AssertionError("record_function entered")


def test_on_the_profilers_timeline_only_while_it_runs(monkeypatch):
    telemetry.reset()
    cpu = [torch.profiler.ProfilerActivity.CPU]
    try:
        with torch.profiler.profile(activities=cpu) as prof:
            with telemetry.span("repro_torch.off"):
                torch.ones(4).sum()
            telemetry.enable(True)
            with telemetry.span("repro_torch.on"):
                torch.ones(4).sum()
        names = {e.name() for e in prof.profiler.kineto_results.events()}
        assert "repro_torch.on" in names and "repro_torch.off" not in names
        monkeypatch.setattr(torch.profiler, "record_function", _refused)
        with telemetry.span("repro_torch.no_profiler"):
            pass
    finally:
        telemetry.enable(False)
    assert [r.name for r in telemetry.records()] == \
        ["repro_torch.on", "repro_torch.no_profiler"]
    telemetry.reset()


def test_a_span_that_raises_is_recorded_and_closed():
    telemetry.reset()
    telemetry.enable(True)
    try:
        with pytest.raises(ValueError):
            with telemetry.span("repro_torch.outer"):
                with telemetry.span("repro_torch.inner", block=True):
                    raise ValueError("boom")
        with telemetry.span("repro_torch.after"):
            pass
    finally:
        telemetry.enable(False)
    outer, inner, after = telemetry.records()
    assert (outer.name, inner.name, after.name) == \
        ("repro_torch.outer", "repro_torch.inner", "repro_torch.after")
    assert inner.parent == outer.index and after.parent == -1
    assert (outer.block, inner.block, after.block) == (0, 1, 0)
    telemetry.reset()


def test_the_ring_keeps_the_newest_records_in_order():
    telemetry.reset()
    telemetry.enable(True)
    extra = 10
    try:
        for _ in range(telemetry.RING + extra):
            with telemetry.span("repro_torch.tick"):
                pass
    finally:
        telemetry.enable(False)
    recs = telemetry.records()
    assert len(recs) == telemetry.RING
    assert [r.index for r in recs] == list(
        range(extra, telemetry.RING + extra))
    assert telemetry.snapshot()["spans"]["repro_torch.tick"]["count"] == \
        telemetry.RING + extra
    telemetry.reset()


def test_graph_totals_are_a_view_of_the_counters(stub_graphs, bilstm):
    engine, _ = _engine(bilstm)
    engine.submit_batch(_requests(), now_s=0.0)
    engine.submit_batch(_requests(), now_s=1.0)
    bilstm.__dict__.pop("_step_graphs", None)
    c = telemetry.snapshot()["counters"]
    assert graphs.totals() == {"captures": c["graphs.captures"],
                               "replays": c["graphs.replays"],
                               "capture_s": c["graphs.capture_s"]}
    assert c["graphs.captures"] == 4 and c["graphs.keys_built"] == 2
    graphs.reset_totals()
    assert graphs.totals() == {"captures": 0, "replays": 0,
                               "capture_s": 0.0}
    assert telemetry.counter("graphs.keys_built") == 0


def test_an_evicted_key_counts_again_when_rebuilt():
    telemetry.reset()
    cache = graphs.GraphCache(max_keys=1)
    built = []
    for key in ("a", "b", "a", "b"):
        cache.get(key, lambda key=key: built.append(key) or object())
    assert built == ["a", "b", "a", "b"]
    assert telemetry.counter("graphs.keys_built") == 4
    cache.get("b", lambda: pytest.fail("a kept key is not rebuilt"))
    assert telemetry.counter("graphs.keys_built") == 4
    telemetry.reset()


@pytest.mark.parametrize("key, kind", [
    (("translate", ((2, 3),), 6), "translate"), ("table", "table"),
    ((4, 16, True), "tuple"), (None, "none")])
def test_key_kind(key, kind):
    assert graphs.key_kind(key) == kind
