"""The examples' launchers in ``repro_torch.launch`` against the examples.

Each launcher runs in process on the CPU under ``REPRO_SMOKE=1``, and
the JAX example beside it through ``runpy.run_path`` (same smoke
streams):

* ``quickstart``'s N->M fit and five decisions, ``fault_tolerant_
  serving``'s three engines' stats and ``partitioned_serving``'s modelled
  A/B stats are numpy on both sides and equal the reference's bitwise;
* ``partitioned_serving``'s split legs run on the reference's BiLSTM
  weights (through ``repro_torch.convert``): split == fused bitwise on
  the port, and the port's tokens equal the reference's up to the first
  whose top-2 logit margin is under 1e-4 (float-tolerance parity: a
  token behind a closer margin may flip in the last bits);
* ``collaborative_serving``'s edge executor, on the reference's weights,
  gives the reference translate's tokens behind the same margin, corpus
  tokens past the 1000-word vocabulary clamped as the reference's
  embedding gather clamps them; it and ``multitier_serving`` serve every
  request of their smoke streams;
* every launcher defaults to ``cuda`` and raises ``RuntimeError`` without
  a card.

``big_model_serving`` is in ``tests/test_torch_examples_lm.py``.
"""

import math
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import resolve as j_resolve
from repro_torch.convert import bilstm_params_from_jax
from repro_torch.data.tokenizer import BOS_ID, EOS_ID, PAD_ID
from repro_torch.launch import (big_model_serving, collaborative_serving,
                                fault_tolerant_serving, multitier_serving,
                                partitioned_serving, quickstart)
from repro_torch.models.registry import resolve
from _torch_threads import cap_threads

cap_threads()

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
MARGIN = 1e-4           # top-2 logit margin behind a compared token
CPU = ["--device", "cpu"]
LAUNCHERS = [quickstart, fault_tolerant_serving, partitioned_serving,
             collaborative_serving, multitier_serving, big_model_serving]


@pytest.fixture(autouse=True)
def smoke(monkeypatch):
    monkeypatch.setenv("REPRO_SMOKE", "1")


def run_example(name):
    """The JAX example's module globals after it ran (smoke streams)."""
    return runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="example")


def same(a, b) -> bool:
    """Bitwise equality of nested stats (NaN equals NaN)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def assert_behind_margin(want, got, margins, what):
    """``got`` equals ``want`` up to the first position whose top-2 margin
    (``margins[i]``: the logits that chose ``want[i]``) is under
    :data:`MARGIN`."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, what
    diff = np.flatnonzero(want != got)
    if diff.size:
        assert (margins[:diff[0] + 1] < MARGIN).any(), (
            f"{what}: differs at token {diff[0]} above the margin: "
            f"{got.tolist()} != {want.tolist()}")


def padded_row(m, tokens, steps):
    """An NMT output ``(m_out, tokens)`` as its full greedy row: the ``m``
    tokens, then EOS (unless the cap stopped it), then PAD."""
    row = np.full(steps, PAD_ID, np.int32)
    row[:m] = np.asarray(tokens)[:m]
    if m < steps:
        row[m] = EOS_ID
    return row


def nmt_margins(model, src, tokens):
    """The port's top-2 margin behind each of ``tokens`` (a greedy decode
    of ``src`` at B=1), teacher-forced on ``tokens``."""
    out = []
    with torch.inference_mode():
        state = model.make_encode_states()(np.asarray(src)[None]).data
        tok = torch.full((1,), BOS_ID, dtype=torch.int32)
        for t in tokens:
            state, logits = model.decode_step(state, tok)
            top2 = torch.topk(logits[0], 2).values
            out.append(float(top2[0] - top2[1]))
            tok = torch.full((1,), int(t), dtype=torch.int32)
    return np.asarray(out)


def port_bilstm(params, max_decode_len):
    """The port's BiLSTM de-en at the examples' size (scale 0.15, vocab
    1000) holding the reference's ``params``."""
    tm = resolve("cnmt:de-en", scale=0.15, vocab=1000,
                 max_decode_len=max_decode_len, device="cpu").model
    tm.load_state_dict(bilstm_params_from_jax(jax.tree.map(np.asarray,
                                                           params)),
                       strict=True)
    return tm


# ------------------------------------------------------------ device ------
@pytest.mark.parametrize("launcher", LAUNCHERS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_launcher_defaults_to_cuda_and_raises_without_a_card(
        launcher, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main([])


# ------------------------------------------------------- numpy only -------
def test_quickstart_equals_the_example():
    """The N->M fit within 1e-5 relative (numpy's and XLA's float32
    least squares round differently: tests/test_torch_core.py), each
    decision's route equal and its predictions within 1e-5 relative;
    given the reference's fit, the five decisions bitwise."""
    g = run_example("quickstart")
    want = [g["sched"].decide(n, t, g["tx"]) for t, n in quickstart.REQUESTS]
    assert want[-1] == g["d"]
    got = quickstart.main(CPU)
    np.testing.assert_allclose(got["n2m"], (g["n2m"].gamma, g["n2m"].delta),
                               rtol=1e-5)
    for d_got, d_want in zip(got["decisions"], want, strict=True):
        assert d_got.device == d_want.device
        np.testing.assert_allclose(
            [d_got.t_edge_pred, d_got.t_cloud_pred, d_got.m_hat],
            [d_want.t_edge_pred, d_want.t_cloud_pred, d_want.m_hat],
            rtol=1e-5)

    def reference_fit(self, n, m):
        self.gamma, self.delta = g["n2m"].gamma, g["n2m"].delta
        return self

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(quickstart.LinearN2M, "fit", reference_fit)
        got = quickstart.main(CPU)
    for d_got, d_want in zip(got["decisions"], want, strict=True):
        assert same(tuple(vars(d_got).values()), tuple(vars(d_want).values()))


# the crash engine's edge tier times its real executor: latencies differ
TIMED = {"total_latency_s", "mean_latency_s", "p50_latency_s",
         "p95_latency_s"}


def test_fault_tolerant_serving_equals_the_example_bitwise():
    """Part 1's no-retry and failover stats bitwise; part 2's crash
    engine's routes, attempts and fault counters bitwise (its latencies
    carry the executor's measured time)."""
    got = fault_tolerant_serving.main(CPU)
    g = run_example("fault_tolerant_serving")
    no_retry = g["build"](None)
    for i, n in enumerate(g["lengths"]):
        no_retry.submit(np.zeros(int(n), np.int32), now_s=i / g["RATE_HZ"])
    for name, want in (("no-retry", no_retry.stats()), ("failover", g["s"])):
        assert same(got[name], want), name
    crash = {k: v for k, v in got["crash"].items() if k not in TIMED}
    want = {k: v for k, v in g["eng"].stats().items() if k not in TIMED}
    assert same(crash, want)
    assert got["failover"]["availability"] == 1.0
    assert got["no-retry"]["fault_lost"] > 0


def test_partitioned_serving_equals_the_example():
    """Part 2's modelled stats bitwise; part 1 on the example's weights:
    split == fused bitwise on the port (the launcher asserts it too), the
    payload byte for byte, the tokens behind the margin."""
    g = run_example("partitioned_serving")
    tm = port_bilstm(g["params"], 48)
    got = partitioned_serving.main(CPU, model=tm)
    for mode in ("whole-only", "split-capable"):
        assert same(got[mode], g["stats"][mode]), mode
    split = got["split"]
    np.testing.assert_array_equal(split["src"], g["src"])
    assert split["payload"] == g["payload"]
    m = split["m_split"]
    assert m == split["m_fused"]
    np.testing.assert_array_equal(split["tokens"],
                                  split["fused_tokens"][:max(m, 1)])
    want = np.asarray(g["toks_f"], np.int32)[0]
    assert_behind_margin(want, split["fused_tokens"],
                         nmt_margins(tm, g["src"], want), "split leg")


# ---------------------------------------------------- model-backed --------
@pytest.fixture(scope="module")
def edge_bilstm():
    """The collaborative and multitier examples' BiLSTM (max_decode_len
    64, PRNGKey(0)): the reference model, its params and the port's."""
    jm = j_resolve("cnmt:de-en", scale=0.15, vocab=1000,
                   max_decode_len=64).model
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, port_bilstm(params, 64)


def test_collaborative_executor_gives_the_reference_tokens(edge_bilstm):
    """The launcher's edge executor on the reference's weights, on the
    first corpus sources of its stream (tokens up to 31999 into a
    1000-word vocabulary), against the reference translate's tokens."""
    from repro_torch.data.synthetic import make_corpus

    jm, params, tm = edge_bilstm
    forced, executor = collaborative_serving.edge_translates(tm)
    translate = jm.make_translate(params)
    _, eval_ = make_corpus("de-en", 2200, seed=1, with_tokens=True).split(2000)
    assert max(int(s[:64].max()) for s in eval_.src[:4]) >= 1000
    for src in eval_.src[:4]:
        src = src[:64]
        want = padded_row(*translate(src), 64)
        got = padded_row(*executor(src), 64)
        assert_behind_margin(want, got,
                             nmt_margins(tm, np.minimum(src, 999), want),
                             "edge executor")
    m, toks = forced(eval_.src[0][:8], 5)
    assert m == 5 and toks.shape == (5,)


def test_collaborative_serving_launcher_runs_on_the_cpu(edge_bilstm, capsys):
    """The smoke stream of 30 requests on the reference's weights, each
    served, on a finite plane."""
    res = collaborative_serving.main(CPU, model=edge_bilstm[2])
    assert "streaming 30 requests" in capsys.readouterr().out
    s = res["stats"]
    assert s["requests"] == 30 and s["shed"] == 0
    assert all(np.isfinite(res["plane"]))
    assert res["plane"][0] >= 0 and res["plane"][1] >= 0


def test_multitier_serving_launcher_runs_on_the_cpu(edge_bilstm, capsys):
    """The main stream of 60 (a 10-arrival burst) and the overload burst
    of 40 under an 80 ms SLO, on the reference's weights: every request
    accounted for."""
    res = multitier_serving.main(CPU, model=edge_bilstm[2])
    out = capsys.readouterr().out
    assert "overall SLO attainment" in out
    assert res["stats"]["requests"] == 60 and len(res["burst_tiers"]) == 10
    served, met, shed = res["slo"]
    assert served + shed == 40 and met <= served
    assert res["slo_stats"]["requests"] == 100
    assert sum(res["stats"]["tier_frac"].values()) == pytest.approx(1.0)
