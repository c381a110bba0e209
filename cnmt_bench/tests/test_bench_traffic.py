"""The traffic generator: one seed gives one traffic, another seed the same
work in another order with other tokens."""

import json

import numpy as np

from conftest import ROOT
from cnmt_bench.lib import traffic


def _mix(name):
    return json.loads((ROOT / f"cnmt_bench/traffic/{name}.json").read_text())


def _calls(mix, seed, k=3):
    it = traffic.backlog(mix, seed, 65001)
    return [next(it) for _ in range(k)]


def test_backlog_same_seed_same_traffic_other_seed_other_order():
    mix = _mix("docs.en-zh")
    a, b, c = (_calls(mix, 2**31 + 5), _calls(mix, 2**31 + 5),
               _calls(mix, 7))
    flat = lambda calls: [r for call in calls for r in call]
    for x, y in zip(flat(a), flat(b)):
        assert x.m == y.m and np.array_equal(x.tokens, y.tokens)
    assert [len(r.tokens) for r in flat(a)] != [len(r.tokens) for r in flat(c)]
    assert all(len(call) == mix["per_call"] for call in a)


def test_schedule_same_multiset_for_every_seed():
    mix = _mix("chat.en-zh")
    mix["arrival"]["rate_hz"] = 50.0
    a = traffic.schedule(mix, 11, 65001, 10.0)
    b = traffic.schedule(mix, 11, 65001, 10.0)
    c = traffic.schedule(mix, 2**33 + 1, 65001, 10.0)
    assert [(r.due_s, r.m) for r in a] == [(r.due_s, r.m) for r in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    assert len(a) == len(c) == 500
    assert sorted((len(r.tokens), r.m) for r in a) == \
        sorted((len(r.tokens), r.m) for r in c)
    gaps = lambda s: np.diff([0.0] + [r.due_s for r in s])
    assert np.allclose(sorted(gaps(a)), sorted(gaps(c)))
    assert [r.m for r in a] != [r.m for r in c]
    assert abs(a[-1].due_s - 10.0) < 1e-9
    assert all(np.diff([r.due_s for r in a]) >= 0)


def test_length_laws():
    docs = _mix("docs.en-zh")["lengths"]
    chat = _mix("chat.en-zh")["lengths"]
    law = lambda x: {k: v for k, v in x.items()
                     if k not in ("pool_size", "source")}
    assert law(docs) == law(chat)
    n, m = traffic.length_pool(docs, docs["pool_size"])
    assert 16 <= np.median(n) <= 20 and n.min() >= 1 and n.max() <= 200
    slope = np.polyfit(n, m, 1)[0]
    assert 0.65 < slope < 0.75 and m.min() >= 1 and m.max() <= 200
    chat = _mix("chat.de-en")["lengths"]
    n, m = traffic.length_pool(chat, chat["pool_size"])
    assert 13 <= np.median(n) <= 17 and n.max() <= 200
    assert 0.9 < np.polyfit(n, m, 1)[0] < 1.0


def test_rtt_trace_is_cp2_and_repeats():
    a = traffic.RttTrace("cp2", 1, 600)
    b = traffic.RttTrace("cp2", 1, 600)
    assert np.array_equal(a.rtt_s, b.rtt_s)
    assert 0.025 < float(np.median(a.rtt_s)) < 0.045
    assert a.rtt_at(0.0) == a.rtt_s[0]
    assert a.rtt_at(600.5) == a.rtt_at(0.5)
