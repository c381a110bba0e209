"""The port's compiled prefill and admission waves on the CPU.

On the card ``GenerationSession`` replays one prefill graph per prompt
block, which writes the decode state of its step-graph entry in place
(``LM.prefill(into=)``), and a slot table replays one graph per
admission-wave key: the bucketed prefill, its rows copied into the
resident table and the carried token and ``done`` written.  Here the
graphs are stubbed (``tests/test_torch_graphs.py``'s ``StubCache``: a
replay runs the captured function again and writes its outputs where the
capture's were), so the bookkeeping around them runs as on the card:
static inputs copied in, a key's first call run for real before its
capture, the keys' LRU bounds.

* the stubbed graph path equals ``graphs.eager()`` bitwise (the prefill's
  logits and decode state, the generated tokens, the slot table's state)
  and the JAX reference's tokens, on the attention, rwkv6, mamba2, MoE
  and whisper smoke plans, two keys interleaved;
* a slot table with refill, including a wave of three rows padded to
  four while another slot is live: the padding row lands on the first
  real row's slot with that row's values, never on the live slot;
* the host-side checks: a session refuses ragged lengths on a recurrent
  plan before any capture, ``LM.prefill`` called directly still raises
  its ``ValueError``s, and ``check=False`` skips them;
* keys evicted least recently used first, and CPU sessions never capture.
"""

import numpy as np
import pytest
import torch

from repro.runtime.serving import ContinuousGenerationSession as JCont
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.runtime import graphs
from repro_torch.runtime import serving
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    greedy_margins,
)
from _torch_threads import cap_threads
from test_torch_graphs import StubCache, _drop_graphs, _lm_pair, stub_graphs

cap_threads()

MARGIN = 1e-4
LM_ARCHS = ("qwen3-8b", "rwkv6-3b", "zamba2-1.2b", "qwen3-moe-30b-a3b")


def _equal_trees(got, want):
    a, b = graphs.leaves(got), graphs.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _blocks(sess, model, seed=3):
    """Two prompt blocks of one batch bucket: ragged widths 9 and 20 for a
    position-masked plan, exact widths 9 and 5 for a recurrent one."""
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    if sess.supports_ragged:
        return [(rng.integers(3, vocab, (3, 9)).astype(np.int32),
                 np.asarray([9, 4, 6], np.int32)),
                (rng.integers(3, vocab, (3, 20)).astype(np.int32),
                 np.asarray([20, 13, 1], np.int32))]
    return [(rng.integers(3, vocab, (3, n)).astype(np.int32), None)
            for n in (9, 5)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_graph_equals_eager_and_jax(stub_graphs, arch):
    jm, params, model = _lm_pair(arch)
    sess = GenerationSession(model, max_len=32)
    blocks = _blocks(sess, model)
    max_new = 4

    def prefill(toks, lens, graph):
        padded, lens_in = sess._bucket_pad(toks, lens, max_new)
        with torch.inference_mode():
            logits, state, _ = sess._prefill(padded, lens_in, None,
                                             graph=graph)
            return logits.clone(), graphs.clone(state)

    want = [prefill(t, n, graph=False) for t, n in blocks]
    with graphs.eager():
        want_toks = [sess.generate_with_lengths(t, lengths=n,
                                                max_new=max_new)
                     for t, n in blocks]
    assert "_step_graphs" not in model.__dict__
    for _ in range(2):                  # first calls capture, then replays
        for (t, n), (w_logits, w_state), w_toks in zip(blocks, want,
                                                       want_toks):
            logits, state = prefill(t, n, graph=True)
            assert torch.equal(logits, w_logits)
            _equal_trees(state, w_state)
            got = sess.generate_with_lengths(t, lengths=n, max_new=max_new)
            for g, w in zip(got, w_toks):
                np.testing.assert_array_equal(g, w)
    # one decode key (one batch bucket), one prefill graph per block
    cache = model._step_graphs
    assert len(cache) == 1 and cache.captures == 1
    entry = cache.entries()[0]
    assert len(entry.prefills) == 2 and entry.prefills.captures == 2
    # 2 blocks x 2 rounds x (a prefill and a generate), but the first
    # block's first prefill ran for real (the cache's warm-up); the
    # second block's first call replayed its graph after the capture
    assert entry.prefills.replays == 2 * 2 * 2 - 1
    (t, n), (lens, out) = blocks[0], want_toks[0]
    j_lens, j_out = (np.asarray(a) for a in JSession(
        jm, params, max_len=32).generate_with_lengths(t, lengths=n,
                                                      max_new=max_new))
    np.testing.assert_array_equal(lens, j_lens)
    np.testing.assert_array_equal(out[out != 0], j_out[out != 0])
    _drop_graphs(model)


def test_whisper_prefill_graph_equals_eager_and_jax(stub_graphs):
    jm, params, model = _lm_pair("whisper-large-v3")
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((2, 16, model.cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(4, model.cfg.vocab_size, (2, 6)).astype(np.int32)
    sess = GenerationSession(model, max_len=16)
    cases = [frames, frames[:, :12]]    # two frame counts: two decode keys

    def prefill(f, graph):
        with torch.inference_mode():
            logits, state, _ = sess._prefill(toks, None, torch.as_tensor(f),
                                             graph=graph)
            return logits.clone(), graphs.clone(state)

    want = [prefill(f, graph=False) for f in cases]
    with graphs.eager():
        want_toks = [sess.generate(toks, max_new=8, frames=f) for f in cases]
    for _ in range(2):
        for f, (w_logits, w_state), w_toks in zip(cases, want, want_toks):
            logits, state = prefill(f, graph=True)
            assert torch.equal(logits, w_logits)
            _equal_trees(state, w_state)
            np.testing.assert_array_equal(
                sess.generate(toks, max_new=8, frames=f), w_toks)
    cache = model._step_graphs
    assert len(cache) == 2
    assert all(len(e.prefills) == 1 for e in cache.entries())
    ref = np.asarray(JSession(jm, params, max_len=16).generate(
        toks, max_new=8, frames=frames))
    got = want_toks[0]
    for i in range(2):
        margins = greedy_margins(model, toks[i], got[i], frames=frames[i])
        assert margins.min() >= MARGIN, margins
        np.testing.assert_array_equal(got[i], ref[i, :len(got[i])])
    _drop_graphs(model)


def test_sessions_of_one_model_share_its_prefill_graphs(stub_graphs):
    """A second session of the model (same ``max_len``) finds the decode
    key and the block's graph the first one made, and still prefills its
    own prompt: its tokens are its eager tokens, not the first's."""
    _, _, model = _lm_pair("qwen3-8b")
    rng = np.random.default_rng(11)
    a, b = (rng.integers(3, model.cfg.vocab_size, (2, 7)).astype(np.int32)
            for _ in range(2))
    first, second = (GenerationSession(model, max_len=24) for _ in range(2))
    with graphs.eager():
        want = first.generate_with_lengths(b, max_new=5)
    first.generate_with_lengths(a, max_new=5)       # captures the block
    got = second.generate_with_lengths(b, max_new=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    entry = model._step_graphs.entries()[0]
    assert len(model._step_graphs) == 1 and entry.prefills.captures == 1
    assert entry.prefills.replays == 1
    _drop_graphs(model)


def _table(sess):
    return graphs.clone((sess._state, sess._tok, sess._done))


def _padded_wave(sess, prompts):
    """Slot 0 admitted and stepped twice, then a wave of three prompts
    (padded to four rows) while slot 0 is live; returns the table before
    and after the wave and the tokens of six more steps."""
    sess.reset()
    sess.admit([prompts[0]], max_new=12)
    sess.step()
    sess.step()
    before = _table(sess)
    slots = sess.admit(prompts[1:4], max_new=8)
    after = _table(sess)
    streams = [sess.step()[0] for _ in range(6)]
    return slots, before, after, streams


def test_padded_wave_never_writes_a_live_slot(stub_graphs):
    jm, params, model = _lm_pair("qwen3-8b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, model.cfg.vocab_size, n).astype(np.int32)
               for n in (5, 7, 3, 6)]
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=32)
    with graphs.eager():
        want = _padded_wave(sess, prompts)
    assert len(sess._waves) == 0
    for _ in range(2):                  # the wave's key: captured, replayed
        got = _padded_wave(sess, prompts)
        assert got[0] == want[0] == [1, 2, 3]
        for g, w in zip(got[1:3], want[1:3]):
            _equal_trees(g, w)
        assert got[3] == want[3]
    wave = sess._waves.peek((4, 8, True))
    # the (4, 8) key is the table's second: captured, then replayed for
    # its first wave; then replayed in the second round
    assert wave is not None and sess._waves.replays == 3
    assert sess._waves.captures == 2
    assert wave.rows.tolist() == [1, 2, 3, 1]   # padding: the first slot
    assert wave.src.tolist() == [0, 1, 2, 0]    # ... with its row's values
    # the live slot 0 is as the steps left it; the padding row wrote slot
    # 1 with row 0's values, as the real row did
    before, after = got[1], got[2]
    for b, a in zip(graphs.leaves(before[0]["caches"]),
                    graphs.leaves(after[0]["caches"])):
        assert torch.equal(a[:, 0], b[:, 0])
    assert torch.equal(after[1][0], before[1][0])
    assert not bool(after[2][0]) and not bool(after[2][1:].any())


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b"])
def test_continuous_waves_equal_jax_and_eager(stub_graphs, arch):
    jm, params, model = _lm_pair(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, model.cfg.vocab_size,
                            size=int(rng.choice([3, 8]))).astype(np.int32)
               for _ in range(9)]
    # the reference's slot table seeds zamba2's conv buffer at the wrong
    # shape (see ContinuousGenerationSession): its solo session stands in
    solo = JSession(jm, params, max_len=48)
    want = (JCont(jm, params, max_slots=4, max_len=48).serve(
        prompts, max_new=8, refill=True) if arch == "qwen3-8b" else
        [tuple(a[0] for a in solo.generate_with_lengths(p[None], max_new=8))
         for p in prompts])
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=48)
    with graphs.eager():
        eager = sess.serve(prompts, max_new=8, refill=True)
        eager_table = _table(sess)
    sess.reset()
    got = sess.serve(prompts, max_new=8, refill=True)
    _equal_trees(_table(sess), eager_table)
    sess.reset()                        # wave graphs outlive a reset
    again = sess.serve(prompts, max_new=8, refill=True)
    _equal_trees(_table(sess), eager_table)
    assert sess._waves.captures == len(sess._waves) > 0
    assert sess._waves.replays > 0 and sess._graphs.captures == 1
    for (m_w, t_w), (m_e, t_e), (m_g, t_g), (m_a, t_a) in zip(
            want, eager, got, again):
        assert m_g == m_w == m_e == m_a
        np.testing.assert_array_equal(t_g, np.asarray(t_w)[:len(t_g)])
        np.testing.assert_array_equal(t_g, t_e)
        np.testing.assert_array_equal(t_g, t_a)


def test_prefill_and_wave_keys_are_evicted_least_recently_used(
        stub_graphs, monkeypatch):
    monkeypatch.setattr(serving, "SESSION_PREFILL_KEYS", 2)
    monkeypatch.setattr(serving, "WAVE_GRAPH_KEYS", 2)
    _, _, model = _lm_pair("rwkv6-3b")
    rng = np.random.default_rng(9)
    blocks = [rng.integers(3, model.cfg.vocab_size, (2, n)).astype(np.int32)
              for n in (4, 6, 8, 4)]
    sess = GenerationSession(model, max_len=24)
    with graphs.eager():
        want = [sess.generate_with_lengths(b, max_new=5) for b in blocks]
    got = [sess.generate_with_lengths(b, max_new=5) for b in blocks]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    entry = model._step_graphs.entries()[0]
    # widths 4, 6, 8 captured; 8 evicted 4; 4 came back as a new capture;
    # every key's first call, the cache's first aside, replayed its graph
    assert [k[0] for k in entry.prefills.keys()] == [(2, 8), (2, 4)]
    assert entry.prefills.captures == 4 and entry.prefills.replays == 3
    _drop_graphs(model)

    cont = ContinuousGenerationSession(model, max_slots=2, max_len=24)
    with graphs.eager():
        want = cont.serve([b[0] for b in blocks], max_new=3)
    cont.reset()
    got = cont.serve([b[0] for b in blocks], max_new=3)
    for (m_g, t_g), (m_w, t_w) in zip(got, want):
        assert m_g == m_w
        np.testing.assert_array_equal(t_g, t_w)
    # three wave widths through two keys: at least one was evicted
    assert cont._waves.max_keys == 2 and len(cont._waves) == 2
    assert cont._waves.captures >= 3
    assert set(cont._waves.keys()) <= {(1, n, False) for n in (4, 6, 8)}


def test_host_checks_before_a_captured_prefill(stub_graphs):
    _, _, model = _lm_pair("rwkv6-3b")
    toks = np.full((2, 6), 7, np.int32)
    sess = GenerationSession(model, max_len=16)
    with pytest.raises(ValueError, match="position-masked"):
        sess.generate_with_lengths(toks, lengths=[6, 3], max_new=4)
    assert "_step_graphs" not in model.__dict__      # refused on the host
    ragged = torch.tensor([6, 3], dtype=torch.int32)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="position-masked"):
            model.prefill(torch.as_tensor(toks), lengths=ragged)
        model.prefill(torch.as_tensor(toks), lengths=ragged, check=False)

    _, _, whisper = _lm_pair("whisper-large-v3")
    frames = torch.zeros((1, 8, whisper.cfg.d_model))
    mask = torch.tensor([[1, 1, 0, 1, 0, 0, 0, 0]], dtype=torch.float32)
    tok = torch.full((1, 3), 7, dtype=torch.int32)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="prefix"):
            whisper.prefill(tok, frames=frames, frame_mask=mask)
        whisper.prefill(tok, frames=frames, frame_mask=mask, check=False)


def test_prefill_into_a_state_equals_the_returned_state():
    _, _, model = _lm_pair("zamba2-1.2b")
    toks = torch.as_tensor(np.arange(3, 21, dtype=np.int32).reshape(2, 9))
    with torch.inference_mode():
        want_logits, want = model.prefill(toks, max_len=16)
        into = graphs.clone(want)
        for t in graphs.leaves(into):
            t.fill_(3)                  # stale values everywhere
        logits, got = model.prefill(toks, max_len=16, into=into)
    assert got is into and torch.equal(logits, want_logits)
    _equal_trees(got, want)


def test_cpu_sessions_never_capture_a_prefill(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU path captured a graph")

    monkeypatch.setattr(graphs.GraphCache, "capture", refuse)
    monkeypatch.setattr(graphs.GraphCache, "run_and_capture", refuse)
    _, _, model = _lm_pair("qwen3-8b")
    toks = np.full((3, 5), 7, np.int32)
    GenerationSession(model, max_len=16).generate(toks, max_new=4)
    cont = ContinuousGenerationSession(model, max_slots=4, max_len=16)
    cont.serve([toks[0], toks[1, :3], toks[2, :2]], max_new=4)
    assert len(cont._waves) == 0 and len(cont._graphs) == 0
    assert "_step_graphs" not in model.__dict__
    assert isinstance(StubCache(), graphs.GraphCache)
