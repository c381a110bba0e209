"""The slice end to end on the CPU: the port's ``CollaborativeEngine``
against the JAX package's.

With modelled tiers, stub executors and a fake clock, the two engines are
the same numpy program, so every per-request field and ``stats()`` are
held bit-for-bit, split placements included.  With a real tiny Marian
tier on each side (the JAX model and the port on the same converted
weights), and with real tiny GRU split legs on each side, the
translations the engines serve are held equal.
"""

import itertools
import time

import jax
import numpy as np
import pytest
import torch  # noqa: F401

import repro_torch  # noqa: F401
from repro.core import faults as jfaults
from repro.core import latency_model as jlat
from repro.core import length_regressor as jlen
from repro.core import profiles as jprof
from repro.core import tx_estimator as jtx
from repro.data.tokenizer import EOS_ID
from repro.nmt import GRUSeq2Seq as JGRU
from repro.nmt import MarianTransformer as JMarian
from repro.nmt import RNNConfig as JRNNConfig
from repro.nmt import TransformerConfig as JConfig
from repro.runtime import engine as jengine
from repro.runtime.serving import build_executor as j_build_executor
from repro_torch.convert import gru_params_from_jax, marian_params_from_jax
from repro_torch.core import faults as tfaults
from repro_torch.core import latency_model as tlat
from repro_torch.core import length_regressor as tlen
from repro_torch.core import profiles as tprof
from repro_torch.core import tx_estimator as ttx
from repro_torch.kernels import ops as tops
from repro_torch.nmt import GRUSeq2Seq as TGRU
from repro_torch.nmt import MarianTransformer as TMarian
from repro_torch.nmt import RNNConfig as TRNNConfig
from repro_torch.nmt import TransformerConfig as TConfig
from repro_torch.nmt.transformer import make_executors
from repro_torch.runtime import engine as tengine
from repro_torch.runtime.serving import build_executor as t_build_executor
from test_torch_rnn import min_margin
from _torch_threads import cap_threads

cap_threads()

PKGS = {"jax": (jlat, jlen, jprof, jfaults, jengine, jtx),
        "torch": (tlat, tlen, tprof, tfaults, tengine, ttx)}


@pytest.fixture
def fake_clock(monkeypatch):
    """perf_counter advancing 1 ms per read, restartable per engine run,
    so measured stub executions are identical on both sides."""
    state = {}

    def restart():
        state["it"] = itertools.count()

    restart()
    monkeypatch.setattr(time, "perf_counter",
                        lambda: 1e-3 * next(state["it"]))
    return restart


def _stub_executor(tokens):
    return 3, np.array([7, 7, EOS_ID], np.int32)


def _stub_batched(block, lengths):
    return [(int(L) % 5 + 1, np.arange(int(L) % 5 + 1)) for L in lengths]


def _split_tiers(lat, engine, **legs):
    """``tests/test_partitioned.py``'s classic split regime: a slow
    device, a fast-encoding edge, a fast-decoding cloud behind a slow
    client link.  ``legs`` gives the edge and cloud tiers their split
    executors (modelled without them)."""
    return [
        engine.Tier(lat.DeviceProfile("dev", lat.LinearLatencyModel(
            3e-4, 5e-3, 2e-3), 0.05), name="dev"),
        engine.Tier(lat.DeviceProfile("edge", lat.LinearLatencyModel(
            2e-5, 2.5e-3, 4e-3), 0.05), name="edge", rtt_fn=lambda t: 5e-3,
            bandwidth_bps=200e6, encode_executor=legs.get("enc"),
            decode_executor=legs.get("dec")),
        engine.Tier(lat.DeviceProfile("cloud", lat.LinearLatencyModel(
            1e-5, 1e-4, 2e-3), 0.05), name="cloud", rtt_fn=lambda t: 90e-3,
            bandwidth_bps=20e6, decode_executor=legs.get("dec")),
    ]


def _split_engine(pkg, n2m, **legs):
    lat, _, _, _, engine, tx = PKGS[pkg]
    links = tx.LinkModel(3)
    links.add_link(1, 2, tx.TxEstimator(init_rtt_s=4e-3, bandwidth_bps=1e9))
    return engine.CollaborativeEngine(
        tiers=_split_tiers(lat, engine, **legs), n2m=n2m, seed=0,
        links=links, activation=lat.ActivationCostModel(512, 4),
        inter_rtt_fns={(1, 2): lambda t: 4e-3}, allow_split=True)


def _build(pkg, config):
    lat, lenr, prof, faults, engine, _ = PKGS[pkg]
    edge = lat.DeviceProfile("edge", lat.LinearLatencyModel(5e-4, 2e-3, 1e-2))
    cloud = lat.DeviceProfile("cloud",
                              lat.LinearLatencyModel(4e-4, 1.8e-3, 8e-3), 0.08)
    rtt = prof.make_profile("cp2", seed=1)
    n2m = lenr.LinearN2M(0.7, 1.2)
    if config == "two-tier":
        edge = lat.DeviceProfile("edge",
                                 lat.LinearLatencyModel(1e-3, 5e-3, 2e-2))
        tiers = [engine.Tier(edge, executor=_stub_executor),
                 engine.Tier(cloud, rtt_fn=lambda t: float(rtt.rtt_at(t)))]
        return engine.CollaborativeEngine(tiers=tiers, n2m=n2m, seed=0)
    if config == "batched-deadlines":
        pod = lat.DeviceProfile("pod", lat.LinearLatencyModel(2e-4, 8e-4, 4e-3))
        tiers = [engine.Tier(edge, servers=1, queue_capacity=2),
                 engine.Tier(pod, servers=2, batch_size=4,
                             per_seq_overhead_s=2e-3,
                             batched_executor=_stub_batched,
                             rtt_fn=lambda t: 0.2 * float(rtt.rtt_at(t))),
                 engine.Tier(cloud, servers=4, batch_size=8,
                             rtt_fn=lambda t: float(rtt.rtt_at(t)))]
        return engine.CollaborativeEngine(tiers=tiers, n2m=n2m, seed=3,
                                          hedge_margin_s=0.005)
    if config == "split":
        return _split_engine(pkg, n2m)
    # online refits are left out: the planes' least-squares fits agree
    # only to a tolerance (test_torch_core), so decisions after a refit
    # are not bitwise
    assert config == "faults"
    tiers = [engine.Tier(edge, servers=2),
             engine.Tier(cloud, rtt_fn=lambda t: float(rtt.rtt_at(t)))]
    return engine.CollaborativeEngine(
        tiers=tiers, n2m=n2m, seed=5,
        faults=faults.FaultSchedule(outages=(faults.TierOutage(1, 3.0, 6.0),)),
        retry=faults.RetryPolicy(max_retries=2))


def _drive(eng, deadlines):
    rng = np.random.default_rng(7)
    out = []
    for i in range(40):
        toks = rng.integers(4, 500, int(rng.integers(2, 60))).astype(np.int32)
        out.append(eng.submit(toks, now_s=0.3 * i,
                              deadline_s=0.4 if deadlines and i % 3 else None))
    slot = [rng.integers(4, 500, int(rng.integers(2, 30))).astype(np.int32)
            for _ in range(9)]
    out += eng.submit_batch(slot, now_s=12.5,
                            deadline_s=0.5 if deadlines else None)
    return out, eng.stats()


def _plan(plan):
    return None if plan is None else (plan.encode_tier, plan.decode_tier)


def _record(r):
    d = r.decision
    plan_t = (None if d.plan_t_pred is None else
              sorted((_plan(p), t) for p, t in d.plan_t_pred.items()))
    return (r.req_id, r.device, r.n, r.m_out, r.latency_s, r.wait_s,
            r.tier_name, r.shed, r.deadline_s, r.attempts, r.failed_tiers,
            r.retry_after_s, _plan(r.plan), d.tier, d.t_pred, d.m_hat,
            _plan(d.plan), plan_t)


@pytest.mark.parametrize("config", ["two-tier", "batched-deadlines",
                                    "faults", "split"])
def test_engines_agree_bitwise_with_modelled_tiers(fake_clock, config):
    runs = {}
    for pkg in PKGS:
        fake_clock()
        runs[pkg] = _drive(_build(pkg, config),
                           deadlines=config == "batched-deadlines")
    (jres, jstats), (tres, tstats) = runs["jax"], runs["torch"]
    assert [_record(r) for r in tres] == [_record(r) for r in jres]
    assert tstats == jstats
    assert len({r.device for r in tres}) > 1      # routing really varies
    if config == "split":
        assert tstats["split"] > 0


# ----------------------------------------------------- real Marian tiers --
V = 64
SIZE = dict(vocab_src=V, vocab_tgt=V, d_model=32, heads=4, d_ff=64,
            enc_layers=2, dec_layers=2, max_decode_len=12, max_src_len=64)


def _jax_executors(jm, params):
    """The reference-side twin of ``make_executors``."""
    translate = jm.make_translate_batched(params)

    def executor(tokens):
        toks = np.minimum(np.asarray(tokens, np.int32), V - 1)[None]
        lens, out = translate(toks)
        m = int(lens[0])
        return m, np.asarray(out)[0, :m]

    def batched(block, lengths):
        toks = np.minimum(np.asarray(block, np.int32), V - 1)
        mask = (np.arange(toks.shape[1])[None] < np.asarray(lengths)[:, None])
        lens, out = translate(toks, mask.astype(np.float32))
        return [(int(m), np.asarray(out)[i, :int(m)])
                for i, m in enumerate(np.asarray(lens))]

    return executor, batched


def _recording(fn, log):
    def wrapped(*args):
        out = fn(*args)
        log.append(out)
        return out
    return wrapped


def test_real_marian_tier_serves_the_same_translations():
    jm = JMarian(JConfig(**SIZE))
    params = jm.init(jax.random.PRNGKey(0))
    params["out"]["w"] = params["out"]["w"] * 4.0
    params["tgt_embed"] = params["tgt_embed"] * 4.0
    params["out"]["b"] = params["out"]["b"].at[EOS_ID].set(5.0)
    tm = TMarian(TConfig(**SIZE), device="cpu")
    tm.load_state_dict(marian_params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
    executors = {"jax": _jax_executors(jm, params),
                 "torch": make_executors(tm)}
    served = {}
    tops.reset_launch_counts()
    rng = np.random.default_rng(3)
    solo_reqs = [rng.integers(4, 3 * V, int(rng.integers(2, 9)))
                 for _ in range(6)]
    block = [rng.integers(4, V, L) for L in (3, 7, 5, 8)]
    for pkg, (solo, batched) in executors.items():
        lat, lenr, _, _, engine, _ = PKGS[pkg]
        # the first pass compiles every JAX shape; the second is held.
        # Arrivals 1000 s of virtual time apart (the RTT is constant) and
        # no compile inside the held pass keep every queue empty, so the
        # measured times cannot move a decision
        for log in ([], []):
            edge = lat.DeviceProfile(
                "marian", lat.LinearLatencyModel(1e-4, 1e-3, 1e-2), 0.0)
            far = lat.DeviceProfile("far",
                                    lat.LinearLatencyModel(0.0, 0.0, 1e3))
            eng = engine.CollaborativeEngine(
                tiers=[engine.Tier(edge, executor=_recording(solo, log),
                                   batch_size=4,
                                   batched_executor=_recording(batched,
                                                               log)),
                       engine.Tier(far, rtt_fn=lambda t: 0.01)],
                n2m=lenr.LinearN2M(0.7, 1.2), seed=0)
            res = [eng.submit(t, now_s=1000.0 * i)
                   for i, t in enumerate(solo_reqs)]
            res += eng.submit_batch(block, now_s=10000.0)
        assert {r.device for r in res} == {0}
        assert [r.wait_s for r in res] == [0.0] * len(res)
        served[pkg] = ([r.m_out for r in res], log)
    (jm_out, jlog), (tm_out, tlog) = served["jax"], served["torch"]
    assert tm_out == jm_out
    assert len(set(tm_out)) > 1
    flat = lambda log: [x for item in log
                        for x in (item if isinstance(item, list) else [item])]
    for (mj, tj), (mt, tt) in zip(flat(jlog), flat(tlog)):
        assert mt == mj
        np.testing.assert_array_equal(tt, tj)
    # the CPU path ran the plain attention, never a kernel
    assert tops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                    "rwkv6_wkv": 0, "ssd_scan": 0}


# ------------------------------------------------- real GRU split legs --
def test_real_gru_split_legs_serve_the_same_translations():
    """Both engines on the split regime, each with real tiny GRU legs on
    the edge (encode + decode) and the cloud (decode), on the same
    converted weights.  Plans, devices and the decoded translations are
    held equal, which needs every queue empty: both engines book each
    leg's measured wall time, and a JAX leg meeting a new source length
    compiles first (a few tenths of a second alone, more on a loaded
    host).  So every leg shape is run once before the engines start, and
    arrivals are 1000 s of virtual time apart (the RTTs are constant);
    every request must then find its queue empty (``wait_s == 0``)."""
    cfg = dict(vocab_src=V, vocab_tgt=V, embed=32, hidden=32, layers=1,
               max_decode_len=16)
    jm = JGRU(JRNNConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(0))
    params["out"]["w"] = params["out"]["w"] * 4.0
    params["tgt_embed"] = params["tgt_embed"] * 4.0
    params["out"]["b"] = params["out"]["b"].at[EOS_ID].set(0.4)
    tm = TGRU(TRNNConfig(**cfg), device="cpu")
    tm.load_state_dict(gru_params_from_jax(jax.tree.map(np.asarray, params)))
    legs = {"jax": j_build_executor(jm, kind="split", params=params,
                                    vocab_clip=V),
            "torch": t_build_executor(tm, kind="split", vocab_clip=V)}
    rng = np.random.default_rng(4)
    reqs = [rng.integers(4, V, int(rng.integers(8, 40))).astype(np.int32)
            for _ in range(12)]
    src = np.zeros((len(reqs), max(map(len, reqs))), np.int32)
    mask = np.zeros(src.shape, np.float32)
    for i, t in enumerate(reqs):
        src[i, :len(t)], mask[i, :len(t)] = t, 1.0
    # every greedy margin ten times the 1e-5 the logits agree to, or more
    assert min_margin("gru", jm, params, src, mask, 16) > 1e-4
    served = {}
    for pkg, (enc, dec) in legs.items():
        for t in reqs:                   # compile every leg shape first
            dec(enc(t))
        log = []
        eng = _split_engine(pkg, PKGS[pkg][1].LinearN2M(1.0, 0.0),
                            enc=enc, dec=_recording(dec, log))
        res = [eng.submit(t, now_s=1000.0 * i) for i, t in enumerate(reqs)]
        assert [r.wait_s for r in res] == [0.0] * len(reqs)
        served[pkg] = ([(r.device, _plan(r.plan), r.m_out, r.shed)
                        for r in res], log, eng.stats()["split"])
    (jrec, jlog, jsplit), (trec, tlog, tsplit) = served["jax"], served["torch"]
    assert trec == jrec
    assert tsplit == jsplit == len(tlog) > 0
    assert len({p for _, p, _, _ in trec}) > 1    # whole and split plans
    for (mj, tj), (mt, tt) in zip(jlog, tlog):
        assert mt == mj
        np.testing.assert_array_equal(tt, np.asarray(tj))
