"""The compiled sharded paths on 4 gloo ranks of the CPU: a
``ShardedLM``'s sessions and train step from (stubbed) CUDA graphs.

On the card a sharded session replays one graph a decode step, a
prefill and an admission wave, and ``compile_train_step`` one graph a
train step, each with the step's NCCL collectives captured inside.  Here
one spawn (``tests/_torch_graphs_sharded_worker.py``) runs every case on
a (2, 2) ``("data", "model")`` mesh with the graphs stubbed
(``tests/_torch_graph_stub.py``: a replay runs the captured step again,
and a capture refuses host transfers, ``.tolist``, ``.item``, ``.cpu``,
``torch.as_tensor`` of host data, as the card would), under ``tp`` and
``ddp``:

* ``GenerationSession`` (a B=4 ragged key and a B=1 key, decode and
  prefill graphs) and the slot table (step and admission waves) from the
  graphs equal ``graphs.eager()`` bitwise on every rank, and their
  tokens the unsharded JAX sessions' on the same weights behind a top-2
  margin of 1e-4;
* ``prefill(into=)`` equals ``prefill()`` and ``copy_rows(src_rows=)``
  (a wave's padded static rows) the host-list copy it replaced, bitwise,
  neither making a host transfer; the replaced copy does make one;
* every decode-state leaf keeps its storage across a decode step, a
  prefill into it and a wave (what a re-running stub cannot see: a graph
  replays the addresses it captured);
* ``compile_train_step`` over a ``ShardedLM``: two steps from the graph
  equal two under ``graphs.eager()`` bitwise, metrics and state;
* ``_gather`` / ``_block`` (plain ``all_gather_into_tensor`` and views)
  equal the ``DTensor`` forms they replaced, on one- and two-axis specs;
  a sharded LM's session graphs share its LM's pool;
  ``graphs.release_all()`` drops every graph (a teardown's first step).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.runtime.serving import ContinuousGenerationSession as JContinuous
from repro.runtime.serving import GenerationSession as JSession
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_to_jax
from repro_torch.models.model import LM
from repro_torch.runtime.serving import greedy_margins
from repro_torch.runtime import graphs
from _torch_graph_stub import (
    HostTransferInCapture,
    StubCache,
    host_transfers_refused,
)
from _torch_spawn import join, spawn
from _torch_threads import cap_threads

cap_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_graphs_sharded_worker.py")
MARGIN, MAX_LEN, MAX_NEW = 1e-4, 32, 8
SESSION_CASES = (("qwen3-8b", "tp"), ("qwen3-8b", "ddp"),
                 ("zamba2-1.2b", "tp"))
TABLE_CASES = (("qwen3-8b", "tp"), ("qwen3-8b", "ddp"))
TRAIN_CASES = (("qwen3-8b", "tp"), ("qwen3-8b", "ddp"))
ARCHS = ("qwen3-8b", "zamba2-1.2b")


def _prompts(name, vocab, seed):
    """B=4 prompts of 12 tokens, ragged (5-12) where the plan takes it."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, vocab, (4, 12)).astype(np.int32)
    lens = np.array([12, 7, 12, 9], np.int32) if name == "qwen3-8b" else None
    return toks, lens


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Each rank's outputs of the one 4-process run and, computed while
    it runs, the JAX sessions' tokens on the port's seeded weights and
    the unsharded port's margin cuts along them."""
    workdir = str(tmp_path_factory.mktemp("graphs_sharded"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # smoke shapes; leave the cores to the ranks
    try:
        return _run(workdir)
    finally:
        torch.set_num_threads(threads)


def _run(workdir):
    ports = {n: LM(smoke_config(n), device="cpu", seed=0) for n in ARCHS}
    prompts = {n: _prompts(n, smoke_config(n).vocab_size, i)
               for i, n in enumerate(ARCHS)}
    other = {n: _prompts(n, smoke_config(n).vocab_size, 10 + i)
             for i, n in enumerate(ARCHS)}
    rng = np.random.default_rng(3)
    short = {n: rng.integers(4, smoke_config(n).vocab_size, (1, 9)).astype(
        np.int32) for n in ARCHS}
    cont = [rng.integers(4, 512, int(rng.integers(4, 12))).astype(np.int32)
            for _ in range(6)]
    stream = rng.integers(1, 512, (2, 4, 9)).astype(np.int32)
    batches = [{"tokens": s[:, :-1], "targets": s[:, 1:]} for s in stream]
    torch.save({"weights": {n: m.state_dict() for n, m in ports.items()},
                "prompts": prompts, "other": other, "short": short,
                "continuous": cont, "batches": batches,
                "session_cases": SESSION_CASES, "table_cases": TABLE_CASES,
                "train_cases": TRAIN_CASES},
               os.path.join(workdir, "inputs.pt"))
    procs = spawn(WORKER, workdir)

    jax_out, cuts = {}, {}
    for name in ARCHS:
        tree, _ = lm_params_to_jax(ports[name].state_dict(), ports[name].cfg)
        jm, params = JLM(j_smoke_config(name)), jax.tree.map(jnp.asarray,
                                                             tree)
        toks, lens = prompts[name]
        m, out = JSession(jm, params, max_len=MAX_LEN).generate_with_lengths(
            toks, max_new=MAX_NEW, lengths=lens)
        jax_out[name] = (np.asarray(m), np.asarray(out))
        rows = [t[:n] for t, n in zip(toks, lens if lens is not None
                                      else [toks.shape[1]] * len(toks))]
        cuts[name] = [_cut(ports[name], p, t)
                      for p, t in zip(rows, jax_out[name][1])]
        if name == "qwen3-8b":
            jax_out["continuous"] = JContinuous(
                jm, params, max_slots=4, max_len=MAX_LEN).serve(cont,
                                                                max_new=6)
            cuts["continuous"] = [_cut(ports[name], p, np.asarray(t))
                                  for p, (_, t) in zip(
                                      cont, jax_out["continuous"])]
    return {"outs": join(procs, workdir), "jax": jax_out, "cuts": cuts}


def _cut(model, prompt, tokens) -> int:
    """How many leading ``tokens`` (a greedy continuation of ``prompt``)
    stand behind a top-2 logit margin of at least 1e-4 on the unsharded
    port."""
    low = np.flatnonzero(greedy_margins(model, prompt, tokens) < MARGIN)
    return int(low[0]) if low.size else len(tokens)


def _rows_equal(cuts, want, got, m_want, m_got):
    """Rows of ``got`` equal ``want`` up to each row's margin cut, and so
    do the pre-EOS lengths of the rows held whole; the cuts keep most of
    the tokens."""
    kept = total = 0
    for i, (n, w, g) in enumerate(zip(cuts, want, got)):
        np.testing.assert_array_equal(np.asarray(g)[:n], np.asarray(w)[:n])
        if n == len(w):
            assert m_got[i] == m_want[i], i
        kept, total = kept + n, total + len(w)
    assert kept >= 0.75 * total, (kept, total)


def _equal(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


# ------------------------------------------------------------ sessions --
@pytest.mark.parametrize("name,layout", SESSION_CASES)
def test_session_graphs_equal_eager(run, name, layout):
    """Both keys, twice from the graphs (captures, then replays only) ==
    graphs.eager()'s bitwise on every rank; the same on every rank."""
    recs = [o["sessions"][(name, layout)] for o in run["outs"]]
    for rec in recs:
        assert rec["layout"] == layout
        for got in rec["graph"]:
            assert _equal(got, rec["eager"])
        assert _equal(rec["eager"], recs[0]["eager"])
        # two decode keys, each a step graph and one prefill graph
        assert rec["keys"] == 2 and rec["captures"] == 2
        assert rec["prefill_captures"] == 2
        assert rec["replays"] == 4 * (MAX_NEW - 1)
        assert rec["prefill_replays"] == 2          # the second run's
        assert rec["shared_pool"]


@pytest.mark.parametrize("name,layout", SESSION_CASES)
def test_session_graph_tokens_match_jax(run, name, layout):
    """The graph path's B=4 tokens == the unsharded JAX session's behind
    the margin."""
    m_got, out_got = run["outs"][0]["sessions"][(name, layout)]["graph"][1][
        :2]
    m_jax, out_jax = run["jax"][name]
    _rows_equal(run["cuts"][name], out_jax, out_got, m_jax, m_got)


@pytest.mark.parametrize("name,layout", SESSION_CASES)
def test_prefill_into_equals_prefill(run, name, layout):
    """prefill(check=False, into=) == prefill() bitwise, into the same
    storage, with no host transfer; so are the specs."""
    for out in run["outs"]:
        rec = out["sessions"][(name, layout)]
        assert rec["into_is_into"] and rec["into_equal"]
        assert rec["into_storage"] and rec["into_specs"]


@pytest.mark.parametrize("name,layout", SESSION_CASES)
def test_copy_rows_src_rows_equals_the_host_copy(run, name, layout):
    """copy_rows(slots, src_rows) with a wave's padded static rows ==
    copy_rows(list) == the host-list copy it replaced, bitwise, for waves
    whose slots some ranks hold none of; the replaced copy reads the
    device inside a capture, the new one does not."""
    for out in run["outs"]:
        rec = out["sessions"][(name, layout)]
        assert rec["rows_equal"] == [True] * 4
        assert rec["old_rows_refused"]


@pytest.mark.parametrize("name,layout", SESSION_CASES)
def test_state_leaves_keep_their_storage(run, name, layout):
    """A decode step, a prefill into the state and a wave keep every
    leaf's storage, and each session key's state still holds the
    buffers its step graph was captured over."""
    for out in run["outs"]:
        rec = out["sessions"][(name, layout)]
        assert rec["step_storage"] and rec["decode_storage"]
        assert rec["rows_storage"] == [True] * 4


# ---------------------------------------------------------- slot table --
@pytest.mark.parametrize("name,layout", TABLE_CASES)
def test_slot_table_graphs_equal_eager(run, name, layout):
    """serve from the step and wave graphs, twice (reset between) ==
    graphs.eager()'s: every row, the table's bits; its buffers kept."""
    for out in run["outs"]:
        rec = out["tables"][(name, layout)]
        for got in rec["graph"]:
            assert len(got) == len(rec["eager"])
            for (m_g, t_g), (m_e, t_e) in zip(got, rec["eager"]):
                assert m_g == m_e
                np.testing.assert_array_equal(t_g, t_e)
        assert rec["bits_equal"] == [True, True] and rec["storage"]
        assert rec["step_captures"] == 1 and rec["step_replays"] > 0
        assert rec["wave_captures"] >= 2 and rec["wave_replays"] > 0


@pytest.mark.parametrize("name,layout", TABLE_CASES)
def test_slot_table_graph_tokens_match_jax(run, name, layout):
    got = run["outs"][0]["tables"][(name, layout)]["graph"][1]
    want = run["jax"]["continuous"]
    _rows_equal(run["cuts"]["continuous"], [np.asarray(t) for _, t in want],
                [t for _, t in got], [m for m, _ in want], [m for m, _ in got])


# ------------------------------------------------------------ training --
@pytest.mark.parametrize("name,layout", TRAIN_CASES)
def test_compiled_sharded_train_step_equals_eager(run, name, layout):
    """Two compiled steps (the first real, then captured; the second a
    replay) == two under graphs.eager(), bitwise: every metric and this
    rank's parameters, moments and counter."""
    for out in run["outs"]:
        rec = out["train"][(name, layout)]
        eager, graph = rec["eager"], rec["graph"]
        assert eager["captures"] == 0
        assert graph["captures"] == 1 and graph["replays"] == 1
        for m_e, m_g in zip(eager["metrics"], graph["metrics"]):
            assert m_e.keys() == m_g.keys()
            for k in m_e:
                assert torch.equal(m_e[k], m_g[k]), k
        assert len(eager["state"]) == len(graph["state"])
        for a, b in zip(eager["state"], graph["state"]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    losses = [float(m["loss"]) for m in run["outs"][0]["train"][
        (name, layout)]["graph"]["metrics"]]
    assert np.all(np.isfinite(losses))


# ----------------------------------------------------------- the pieces --
def test_gather_and_block_equal_dtensor(run):
    """_block (views) and _gather (all_gather_into_tensor per mesh dim)
    == distribute_tensor / DTensor.full_tensor bitwise, and the gather
    gives the whole back, on every rank."""
    for out in run["outs"]:
        assert out["gathers"] == [True] * len(out["gathers"])


def test_capture_guard_refuses_host_transfers():
    """The stub's guard: host reads and host-data tensors raise inside a
    capture, device work does not, and everything is restored after."""
    x = torch.arange(4)
    with host_transfers_refused():
        y = torch.as_tensor(x) + 1
        for call in (x.tolist, x.cpu, x.numpy, lambda: x[0].item(),
                     lambda: x.new_tensor(4.0),
                     lambda: bool(x.any()), lambda: torch.as_tensor([1]),
                     lambda: torch.as_tensor(np.zeros(2)),
                     lambda: torch.tensor(3, device="cpu")):
            with pytest.raises(HostTransferInCapture):
                call()
        assert torch.tensor(0.5, dtype=torch.float16).dtype == \
            torch.float16                   # a host scalar argument
    assert x.tolist() == [0, 1, 2, 3] and bool(y.all())
    assert torch.as_tensor([1]).tolist() == [1]


def test_release_all_drops_every_graph():
    """graphs.release_all() (what a process group's teardown needs first:
    NCCL destroys a communicator only once the graphs that captured its
    collectives are gone) releases every cache's graphs; a cache then
    captures anew."""
    caches = [StubCache(), StubCache(max_keys=2)]
    buf = torch.zeros(1)
    made = [c.get("k", lambda c=c: c.capture(lambda: buf.add_(1),
                                             static=buf)) for c in caches]
    graphs.release_all()
    assert [len(c) for c in caches] == [0, 0]
    assert all(g.graph.fn is None for g in made)
    again = caches[0].get("k", lambda: caches[0].capture(
        lambda: buf.add_(1), static=buf))
    again.replay(2)
    assert caches[0].captures == 2 and float(buf) == 2.0
