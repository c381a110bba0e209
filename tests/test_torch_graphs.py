"""The port's compiled decode (``repro_torch.runtime.graphs``) on the CPU.

On the card every default decode path captures one step over static
buffers into a CUDA graph and replays it once per token.  Here, with no
card, the step loop runs in Python, and a stub stands in for the graph
(:class:`StubCache`: its "replay" runs the captured step again and writes
its outputs into the tensors the capture returned, as a graph rewrites
the same memory), so the bookkeeping around the graphs runs as on the
card: static inputs copied in, the state's graph, the step index on the
device, warm-ups that leave the buffers as they were, LRU keys and the
launch counts.  The stub (``tests/_torch_graph_stub.py``) refuses host
transfers while it captures (``.tolist``, ``.item``, ``.cpu``, ``bool``
of a tensor, ``torch.as_tensor`` of host data), as the card would.

* the static-buffer loop equals the loop it replaced (a copy of the old
  ``scan_greedy_steps`` / ``batched_greedy_decode`` below) bitwise, on
  random logits tables and on Marian, the BiLSTM and the GRU, in EOS,
  ``keep_eos`` and ``forced_len`` modes;
* the graph path (stubbed) equals the JAX reference on the tokens the
  existing tests compare (``batched_greedy_decode`` of Marian, BiLSTM and
  GRU; ``GenerationSession`` on attention, rwkv6, mamba2, MoE and
  whisper smoke plans; ``ContinuousGenerationSession`` with refill) and
  the eager path (``graphs.eager()``) bitwise, keys interleaved;
* the cache's keys, LRU eviction, ``eager()`` nesting, launch counts;
  a capture raises on a CPU tensor and CPU sessions never capture.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.runtime.serving import ContinuousGenerationSession as JCont
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID
from repro_torch.kernels import ops
from repro_torch.models.model import LM
from repro_torch.nmt import common
from repro_torch.runtime import graphs
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    greedy_margins,
)
from _torch_graph_stub import StubCache, stub_active
from _torch_threads import cap_threads
from test_torch_marian import _min_margin as marian_margin
from test_torch_marian import _models as marian_models
from test_torch_marian import _ragged as marian_ragged
from test_torch_rnn import EOS_BIAS, min_margin, ragged, rnn_models

cap_threads()

MARGIN = 1e-4


# ------------------------------------------------- the loop it replaced ---
def old_scan_greedy_steps(decode_step, state, token0, batch, steps, *,
                          keep_eos=False, forced=False):
    """``nmt.common.scan_greedy_steps`` before the step graphs, verbatim."""
    done = torch.zeros((batch,), dtype=torch.bool, device=token0.device)
    tok = token0
    emits, lives = [], []
    for i in range(steps):
        emit, live, done = common.greedy_update(tok, done, keep_eos=keep_eos,
                                                forced=forced)
        emits.append(emit)
        lives.append(live)
        if i + 1 < steps:
            state, logits = decode_step(state, tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if not emits:
        empty = torch.zeros((batch, 0), dtype=torch.int32,
                            device=token0.device)
        return empty.sum(dim=1, dtype=torch.int32), empty
    lengths = torch.stack(lives, dim=1).sum(dim=1, dtype=torch.int32)
    return lengths, torch.stack(emits, dim=1)


def old_batched_greedy_decode(decode_step, init_state, batch, max_len,
                              forced_len=None):
    """``nmt.common.batched_greedy_decode`` before the step graphs."""
    steps = forced_len if forced_len is not None else max_len
    bos = torch.full((batch,), BOS_ID, dtype=torch.int32)
    state, logits = decode_step(init_state, bos)
    token0 = torch.argmax(logits, dim=-1).to(torch.int32)
    return old_scan_greedy_steps(decode_step, state, token0, batch, steps,
                                 keep_eos=False, forced=forced_len is not None)


# ----------------------------------------------------------- the stub -----
@pytest.fixture
def stub_graphs(monkeypatch):
    """The graph paths on the CPU, through :class:`StubCache`."""
    monkeypatch.setattr(graphs, "GraphCache", StubCache)
    monkeypatch.setattr(graphs, "active", stub_active)
    graphs.reset_totals()
    yield
    graphs.reset_totals()


def _drop_graphs(model):
    model.__dict__.pop("_step_graphs", None)


# ----------------------------------------------- loop == the old loop -----
def _table_step(table):
    """A decode_step over a fixed random logits table: logits depend on the
    token and a per-row offset, so rows hit EOS at different steps."""
    def step(state, tok):
        pos = state["pos"]
        logits = table[(tok.long() * 7 + pos.long()) % table.shape[0]]
        pos.add_(1)
        return state, logits
    return step


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["eos", "keep_eos", "forced"])
def test_static_loop_equals_the_old_scan_on_random_tables(seed, mode):
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn((53, 11), generator=gen)
    table[:, EOS_ID] += 0.6                 # EOS often, not always
    b, steps = 5, 13
    tok0 = torch.randint(3, 11, (b,), generator=gen, dtype=torch.int32)
    kw = dict(keep_eos=mode == "keep_eos", forced=mode == "forced")
    want = old_scan_greedy_steps(
        _table_step(table), {"pos": torch.arange(b)}, tok0, b, steps, **kw)
    got = common.scan_greedy_steps(
        _table_step(table), {"pos": torch.arange(b)}, tok0, b, steps, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if mode == "eos":
        assert len(set(want[0].tolist())) > 1     # rows end apart
    for n in (0, 1):                              # the edge step counts
        got = common.scan_greedy_steps(
            _table_step(table), {"pos": torch.arange(b)}, tok0, b, n, **kw)
        want = old_scan_greedy_steps(
            _table_step(table), {"pos": torch.arange(b)}, tok0, b, n, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _nmt(family):
    if family == "marian":
        jm, params, tm = marian_models(key=0, eos_bias=5.0)
        src, mask = marian_ragged(0, [5, 9, 3, 7])
        return jm, params, tm, src, mask
    jm, params, tm = rnn_models(family, eos_bias=EOS_BIAS[family])
    src, mask = ragged(0, [5, 9, 3, 7])
    return jm, params, tm, src, mask


@functools.lru_cache(maxsize=None)
def _nmt_margin(family):
    """The smallest top-2 margin along the reference's greedy path."""
    jm, params, _, src, mask = _nmt(family)
    if family == "marian":
        return marian_margin(jm, params, src, mask, 16)
    return min_margin(family, jm, params, src, mask, 16)


def _nmt_state(family, tm, src, mask):
    src_t, mask_t = torch.as_tensor(src), torch.as_tensor(mask)
    if family == "marian":
        enc, m = tm.encode(src_t, mask_t)
        return tm.init_cache(enc, m)
    if family == "gru":
        return tm.encode(src_t, mask_t)
    return tm._state(src_t, mask_t)


@pytest.mark.parametrize("forced_len", [None, 6])
@pytest.mark.parametrize("family", ["marian", "bilstm", "gru"])
def test_static_loop_equals_the_old_decode_on_the_nmt_models(family,
                                                             forced_len):
    _, _, tm, src, mask = _nmt(family)
    with torch.inference_mode():
        want = old_batched_greedy_decode(
            tm.decode_step, _nmt_state(family, tm, src, mask), 4,
            tm.cfg.max_decode_len, forced_len)
        got = common.batched_greedy_decode(
            tm.decode_step, _nmt_state(family, tm, src, mask), 4,
            tm.cfg.max_decode_len, forced_len, device=torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# --------------------------------------- the graph path == JAX, == eager --
@pytest.mark.parametrize("forced_len", [None, 6])
@pytest.mark.parametrize("family", ["marian", "bilstm", "gru"])
def test_nmt_graph_path_equals_jax_and_eager(stub_graphs, family,
                                             forced_len):
    jm, params, tm, src, mask = _nmt(family)
    assert _nmt_margin(family) > 1e-3
    jl, jt = jm.make_translate_batched(params)(src, mask,
                                               forced_len=forced_len)
    translate = tm.make_translate_batched()
    other = ragged(1, [4, 2])                 # a second key, interleaved
    with graphs.eager():
        want = translate(src, mask, forced_len=forced_len)
        want_other = translate(*other)
    _drop_graphs(tm)
    for _ in range(2):
        got = translate(src, mask, forced_len=forced_len)
        got_other = translate(*other)
        for g, w in zip(got + got_other, want + want_other):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.asarray(jl))
    np.testing.assert_array_equal(got[1], np.asarray(jt))
    cache = tm._step_graphs
    assert len(cache) == 2 and cache.captures == 4   # state + step, twice
    steps = forced_len or tm.cfg.max_decode_len
    # one replay of each state graph when it is made, then per call one of
    # the state's and one of the step's per token
    assert cache.replays == 2 + 2 * (1 + steps) + 2 * (
        1 + tm.cfg.max_decode_len)
    # the split legs: encode + decode == the fused translate, bitwise
    enc = tm.make_encode_states()
    dec = tm.make_decode_from_states()
    states = enc(src, mask)
    first = [t.clone() for t in graphs.leaves(states.data)]
    enc(*other)                               # must not touch ``states``
    assert all(torch.equal(a, b)
               for a, b in zip(first, graphs.leaves(states.data)))
    for _ in range(2):
        lens, toks = dec(states, forced_len=forced_len)
        np.testing.assert_array_equal(lens, want[0])
        np.testing.assert_array_equal(toks, want[1])
    assert all(torch.equal(a, b)              # the payload is not consumed
               for a, b in zip(first, graphs.leaves(states.data)))
    _drop_graphs(tm)


def test_nmt_graph_keys_follow_batch_and_width(stub_graphs):
    _, _, tm, src, mask = _nmt("gru")
    translate = tm.make_translate_batched()
    translate(src, mask, forced_len=3)
    translate(src, mask)                      # forced_len: a replay count
    translate(src[:2], mask[:2])
    translate(src[:, :6], mask[:, :6])
    keys = tm._step_graphs.keys()
    assert len(keys) == 3
    assert {k[0] for k in keys} == {"translate"}
    assert tm._step_graphs.captures == 6
    _drop_graphs(tm)


LM_ARCHS = ("qwen3-8b", "rwkv6-3b", "zamba2-1.2b", "qwen3-moe-30b-a3b")
_LMS = {}


def _lm_pair(arch):
    if arch not in _LMS:
        jm = (JLM(j_smoke_config(arch)) if arch == "whisper-large-v3"
              else JLM(j_smoke_config(arch), mixer_impl="pallas"))
        params = jm.init(jax.random.PRNGKey(0))
        model = LM(smoke_config(arch), device="cpu")
        model.load_state_dict(lm_params_from_jax(
            jax.tree.map(np.asarray, params), model.cfg), strict=True)
        _LMS[arch] = (jm, params, model)
    return _LMS[arch]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_session_graph_path_equals_jax_and_eager(stub_graphs, arch):
    jm, params, model = _lm_pair(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(3, model.cfg.vocab_size, (3, 9)).astype(np.int32)
    short = rng.integers(3, model.cfg.vocab_size, (1, 9)).astype(np.int32)
    max_new = 6
    j_lens, j_out = (np.array(a) for a in JSession(
        jm, params, max_len=32).generate_with_lengths(toks, max_new=max_new))
    sess = GenerationSession(model, max_len=32)
    with graphs.eager():
        want = sess.generate_with_lengths(toks, max_new=max_new)
        want_short = sess.generate_with_lengths(short, max_new=max_new)
    assert "_step_graphs" not in model.__dict__
    for _ in range(2):                        # B=4 and B=1 keys interleaved
        got = sess.generate_with_lengths(toks, max_new=max_new)
        got_short = sess.generate_with_lengths(short, max_new=max_new)
        for g, w in zip(got + got_short, want + want_short):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], j_lens)
    t_out = got[1]
    np.testing.assert_array_equal(t_out[t_out != 0], j_out[t_out != 0])
    cache = model._step_graphs
    assert len(cache) == 2 and cache.captures == 2
    assert cache.replays == 4 * (max_new - 1)
    _drop_graphs(model)


def test_whisper_session_graph_path_equals_jax_and_eager(stub_graphs):
    arch = "whisper-large-v3"
    jm, params, model = _lm_pair(arch)
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 16, model.cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(4, model.cfg.vocab_size, (2, 6)).astype(np.int32)
    sess = GenerationSession(model, max_len=16)
    with graphs.eager():
        want = sess.generate(toks, max_new=8, frames=frames)
        want_short = sess.generate(toks, max_new=8, frames=frames[:, :12])
    for _ in range(2):                        # 16 and 12 frames: two keys
        got = sess.generate(toks, max_new=8, frames=frames)
        got_short = sess.generate(toks, max_new=8, frames=frames[:, :12])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_short, want_short)
    assert len(model._step_graphs) == 2
    ref = np.asarray(JSession(jm, params, max_len=16).generate(
        toks, max_new=8, frames=frames))
    for i in range(2):
        margins = greedy_margins(model, toks[i], got[i], frames=frames[i])
        assert margins.min() >= MARGIN, margins
        np.testing.assert_array_equal(got[i], ref[i, :len(got[i])])
    _drop_graphs(model)


def test_continuous_graph_path_equals_jax_and_eager(stub_graphs):
    jm, params, model = _lm_pair("qwen3-8b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, model.cfg.vocab_size,
                            size=int(rng.integers(2, 9))).astype(np.int32)
               for _ in range(9)]
    want = JCont(jm, params, max_slots=4, max_len=48).serve(
        prompts, max_new=8, refill=True)
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=48)
    with graphs.eager():
        eager = sess.serve(prompts, max_new=8, refill=True)
    assert len(sess._graphs) == 0
    sess.reset()
    got = sess.serve(prompts, max_new=8, refill=True)
    sess.reset()                              # the graph outlives a reset
    again = sess.serve(prompts, max_new=8, refill=True)
    assert sess._graphs.captures == 1 and sess._graphs.replays > 0
    for (m_w, t_w), (m_e, t_e), (m_g, t_g), (m_a, t_a) in zip(
            want, eager, got, again):
        assert m_g == m_w == m_e == m_a
        np.testing.assert_array_equal(t_g, np.asarray(t_w))
        np.testing.assert_array_equal(t_g, t_e)
        np.testing.assert_array_equal(t_g, t_a)


# ---------------------------------------------------------- the cache ----
def test_cache_keys_are_least_recently_used_first_out():
    cache = StubCache(max_keys=2)
    made = []

    class Entry:
        def __init__(self, key):
            buf = torch.zeros(1)
            self.graph = cache.capture(lambda: buf.add_(1), static=buf)
            made.append((key, self.graph))

    for key in ("a", "b"):
        cache.get(key, lambda: Entry(key))
    assert cache.get("a", lambda: Entry("x")) is not None   # a: newest
    assert len(made) == 2
    cache.get("c", lambda: Entry("c"))        # evicts b, the oldest
    assert cache.keys() == ["a", "c"]
    assert made[1][1].graph.fn is None        # b's graph released
    assert made[0][1].graph.fn is not None
    assert cache.captures == 3 and len(cache) == 2
    plain = cache.capture(lambda: None)
    cache.get("d", lambda: plain)             # a bare graph as the entry
    cache.get("e", lambda: Entry("e"))
    assert cache.keys() == ["d", "e"] and plain.graph.fn is not None
    cache.get("f", lambda: Entry("f"))
    assert cache.keys() == ["e", "f"] and plain.graph.fn is None
    with pytest.raises(ValueError):
        graphs.GraphCache(max_keys=0)


def test_capture_leaves_static_buffers_and_counts_replayed_launches():
    cache = StubCache()
    buf = torch.zeros(3)

    def step():
        buf.add_(1)
        ops.flash_decode.launches += 2       # what two wrapper calls count
        return None

    ops.reset_launch_counts()
    g = cache.capture(step, static=buf)
    assert torch.equal(buf, torch.zeros(3))   # warm-up undone
    assert ops.launch_counts()["flash_decode"] == 2   # the warm-up's only
    assert g.launches == {"flash_decode": 2}
    g.replay(3)
    assert torch.equal(buf, torch.full((3,), 3.0))
    assert ops.launch_counts()["flash_decode"] == 2 + 6
    g.replay(0)
    assert ops.launch_counts()["flash_decode"] == 8
    assert cache.replays == 3 and cache.capture_s >= 0.0
    ops.reset_launch_counts()


def test_eager_nests():
    cuda = torch.device("cuda")
    assert not graphs.is_eager() and graphs.active(cuda)
    assert not graphs.active("cpu")
    with graphs.eager():
        with graphs.eager():
            assert graphs.is_eager()
        assert graphs.is_eager() and not graphs.active(cuda)
    assert not graphs.is_eager() and graphs.active(cuda)
    with pytest.raises(RuntimeError):
        with graphs.eager():
            raise RuntimeError("unwinds")
    assert not graphs.is_eager()


def test_capture_raises_on_a_cpu_tensor():
    called = []
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.GraphCache().capture(lambda: called.append(1),
                                    static={"x": torch.zeros(2)})
    assert not called


def test_cpu_paths_never_capture(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU path captured a graph")

    monkeypatch.setattr(graphs.GraphCache, "capture", refuse)
    _, _, tm, src, mask = _nmt("gru")
    tm.make_translate_batched()(src, mask)
    tm.make_decode_from_states()(tm.make_encode_states()(src, mask))
    _, _, model = _lm_pair("qwen3-8b")
    toks = np.full((2, 5), 7, np.int32)
    GenerationSession(model, max_len=16).generate(toks, max_new=4)
    cont = ContinuousGenerationSession(model, max_slots=2, max_len=16)
    cont.serve([toks[0], toks[1, :3]], max_new=4)
    assert len(cont._graphs) == 0
    assert "_step_graphs" not in tm.__dict__
    assert "_step_graphs" not in model.__dict__


def test_greedy_columns_masks_as_greedy_update():
    cols = torch.tensor([[5, EOS_ID, 6, EOS_ID], [EOS_ID, 3, 3, 3],
                         [4, 4, 4, 4]], dtype=torch.int32)
    lens, toks = common.greedy_columns(cols)
    assert lens.tolist() == [1, 0, 4]
    assert toks.tolist() == [[5, PAD_ID, PAD_ID, PAD_ID], [PAD_ID] * 4,
                             [4, 4, 4, 4]]
    lens, toks = common.greedy_columns(cols, keep_eos=True)
    assert lens.tolist() == [1, 0, 4]
    assert toks.tolist() == [[5, EOS_ID, PAD_ID, PAD_ID],
                             [EOS_ID, PAD_ID, PAD_ID, PAD_ID], [4, 4, 4, 4]]
    lens, toks = common.greedy_columns(cols, forced=True)
    assert lens.tolist() == [4, 4, 4] and torch.equal(toks, cols)
