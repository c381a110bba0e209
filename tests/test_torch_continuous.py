"""The port's continuous in-flight batching on the CPU: every test of
``tests/test_continuous_batching.py``, on the port, plus the port's
session against the JAX one on the same weights.

Three layers, as in the reference's file:

* ``ContinuousGenerationSession`` — block mode (``refill=False``),
  continuous mode (eviction and prefill into the live batch), admission
  into a half-live table and the recurrent plans' exact-width admission
  (rwkv6, and zamba2's mamba2 layers) reproduce the solo
  ``GenerationSession.generate_with_lengths`` row for row; free slots
  step past ``max_len`` without harm; the JAX session on the same
  weights gives the same rows.
* ``CollaborativeEngine.serve_continuous`` — with no admission pressure
  it agrees with ``submit_batch`` per request; under bursts the table
  never oversubscribes and every dropped request carries a shed record.
* ``SimTier(continuous=True)`` — the DES twin's pins on the port's
  simulator (its bitwise equality with the JAX simulator under load is
  ``tests/test_torch_simulator.py``'s ``continuous`` case).

Which pins are bitwise.  The same session on the same inputs (before
and after ``reset``) gives the same tokens whatever the shapes, because
it repeats the same arithmetic.  Across batch shapes it does not: the
table decodes at B=``max_slots``, solo at B=1, and each admission wave
prefills at its own (batch, width) bucket, so a GEMM's kernel and the
reduction order of a row can change, and a row's logits may differ in
the last bits.  Rows are then held equal on tokens and pre-EOS lengths
only behind a top-2 logit margin of at least 1e-4
(``greedy_margins``), and each fixture asserts that its prompts have
one, so the pins here are exact on tokens.  The scheduler and the DES
compute in numpy and are bitwise.

Property-based invariants (seeded shim or real hypothesis) run against
an in-memory slot-table double that drives the port's
``serve_continuous``: EDF across deadline classes with FIFO inside each,
no drop without a shed record, and slot-table conservation.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import smoke_config as j_smoke_config
from repro.models.model import LM as JLM
from repro.runtime.serving import (
    ContinuousGenerationSession as JContinuousSession,
)
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.latency_model import DeviceProfile, LinearLatencyModel
from repro_torch.core.length_regressor import LinearN2M
from repro_torch.core.scheduler import MultiTierScheduler, SchedTier
from repro_torch.core.simulator import (
    RequestStream,
    SimTier,
    make_poisson_stream,
    simulate_des,
)
from repro_torch.launch import continuous_serving
from repro_torch.models.model import LM
from repro_torch.models.registry import resolve
from repro_torch.runtime.engine import CollaborativeEngine, Tier
from repro_torch.runtime.serving import (
    ContinuousGenerationSession,
    GenerationSession,
    build_executor,
    greedy_margins,
)
from _torch_threads import cap_threads

cap_threads()

MARGIN = 1e-4


# ------------------------------------------------------------ fixtures ----
@pytest.fixture(scope="module")
def lm_bundle():
    """The smoke qwen3-8b: JAX model and params, and the port's model
    carrying the same weights."""
    jm = JLM(j_smoke_config("qwen3-8b"))
    params = jm.init(jax.random.PRNGKey(0))
    model = LM(smoke_config("qwen3-8b"), device="cpu")
    model.load_state_dict(
        lm_params_from_jax(jax.tree.map(np.asarray, params), model.cfg),
        strict=True)
    return model.cfg, jm, params, model


def _solo(model, prompts, max_new, max_len=48):
    """Each prompt's solo ``generate_with_lengths``; asserts that every
    emitted token stands behind a top-2 margin of at least 1e-4."""
    sess = GenerationSession(model, max_len=max_len)
    ref = []
    for p in prompts:
        lens, out = sess.generate_with_lengths(p[None, :], max_new=max_new)
        m = int(lens[0])
        emitted = out[0, :min(m + 1, max_new)]      # EOS, if any, included
        margins = greedy_margins(model, p, emitted)
        assert margins.min() >= MARGIN, margins
        ref.append((m, np.asarray(out[0])))
    return ref


@pytest.fixture(scope="module")
def solo_outputs(lm_bundle):
    """Per-prompt reference outputs of the solo device-loop path."""
    cfg, _, _, model = lm_bundle
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size,
                            size=int(rng.integers(2, 9))).astype(np.int32)
               for _ in range(9)]
    return prompts, _solo(model, prompts, 8)


def _flat_tier_profile(beta: float = 0.01) -> DeviceProfile:
    return DeviceProfile("npu", LinearLatencyModel(0.0, 0.0, beta), 0.0)


def _assert_matches_solo(results, ref):
    for i, ((m_ref, out_ref), (m, toks)) in enumerate(zip(ref, results)):
        assert m == m_ref, f"row {i}: m {m} != {m_ref}"
        assert np.array_equal(toks[:m], out_ref[:m]), f"row {i} tokens"


# ----------------------------------------- session-level parity pins ------
@pytest.mark.parametrize("bucket_shapes", [True, False])
def test_block_mode_matches_solo(lm_bundle, solo_outputs, bucket_shapes):
    """refill=False (block to completion) == the solo outputs, with the
    admission waves padded to shape buckets or at their exact shape."""
    _, _, _, model = lm_bundle
    prompts, ref = solo_outputs
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=48,
                                       bucket_shapes=bucket_shapes)
    _assert_matches_solo(sess.serve(prompts, max_new=8, refill=False), ref)


def test_continuous_refill_matches_solo(lm_bundle, solo_outputs):
    """Eviction + prefill into the live batch never changes a row's
    tokens."""
    _, _, _, model = lm_bundle
    prompts, ref = solo_outputs
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=48)
    res = sess.serve(prompts, max_new=8, refill=True)
    _assert_matches_solo(res, ref)
    assert sess.peak_live == 4
    assert sess.n_prefills >= 2


def test_prefill_into_live_batch_is_exact(lm_bundle, solo_outputs):
    """Drive admit/step by hand: a row admitted into a HALF-LIVE table
    (other rows mid-decode) still reproduces its solo output."""
    _, _, _, model = lm_bundle
    prompts, ref = solo_outputs
    sess = ContinuousGenerationSession(model, max_slots=3, max_len=48)
    assert sess.admit(prompts[:2], max_new=8, req_ids=[0, 1]) == [0, 1]
    done = {}
    for _ in range(3):                       # decode a few steps
        for rid, m, toks in sess.step()[1]:
            done[rid] = (m, toks)
    assert sess.admit([prompts[2]], max_new=8, req_ids=[2]) == [2]
    while sess.live_count:
        for rid, m, toks in sess.step()[1]:
            done[rid] = (m, toks)
    _assert_matches_solo([done[i] for i in range(3)], ref[:3])


@pytest.mark.parametrize("arch,low", [("rwkv6-3b", 2), ("zamba2-1.2b", 3)])
def test_recurrent_plan_exact_width_admission(arch, low):
    """Recurrent plans admit in exact-width groups; outputs == solo.
    zamba2's mamba2 layers need prompts of at least conv_width - 1 = 3
    tokens (ROADMAP C.7); its shared attention block decodes against
    the resident KV cache."""
    model = resolve(arch, device="cpu", seed=1).model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, model.cfg.vocab_size,
                            size=int(rng.integers(low, 7))).astype(np.int32)
               for _ in range(5)]
    assert len({len(p) for p in prompts}) > 1
    ref = _solo(model, prompts, 6)
    cont = ContinuousGenerationSession(model, max_slots=3, max_len=48)
    assert not cont.supports_ragged
    _assert_matches_solo(cont.serve(prompts, max_new=6, refill=True), ref)


def test_session_reset_keeps_outputs_stable(lm_bundle, solo_outputs):
    """The same session on the same prompts repeats itself bitwise."""
    _, _, _, model = lm_bundle
    prompts, ref = solo_outputs
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=48)
    first = sess.serve(prompts, max_new=8)
    _assert_matches_solo(first, ref)
    sess.reset()
    assert sess.live_count == 0 and sess.n_steps == 0
    assert sess.n_prefills == 0 and sess.peak_live == 0
    again = sess.serve(prompts, max_new=8)
    for (m1, t1), (m2, t2) in zip(first, again):
        assert m1 == m2 and np.array_equal(t1, t2)


def test_admit_rejects_oversubscription_oversize_and_empty(lm_bundle):
    _, _, _, model = lm_bundle
    sess = ContinuousGenerationSession(model, max_slots=2, max_len=32)
    p = np.arange(3, 9, dtype=np.int32)
    with pytest.raises(ValueError, match="free slots"):
        sess.admit([p, p, p], max_new=4)
    with pytest.raises(ValueError, match="capacity"):
        sess.admit([np.arange(3, 33, dtype=np.int32)], max_new=8)
    with pytest.raises(ValueError, match="empty"):
        sess.admit([p, np.zeros(0, np.int32)], max_new=4)
    assert sess.live_count == 0            # failed admits leave no residue
    assert sess.n_prefills == 0
    assert sess.admit([], max_new=4) == []


def test_encoder_decoder_plans_are_rejected():
    class _Cfg:
        is_encoder_decoder = True

    class _Model:
        cfg = _Cfg()

    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousGenerationSession(_Model())
    with pytest.raises(ValueError, match="max_slots"):
        ContinuousGenerationSession(_Model(), max_slots=0)


def test_free_slots_step_past_max_len(lm_bundle, solo_outputs):
    """One slot serves requests one after another while the other stays
    free: the free slot's position runs far past ``max_len`` (its decode
    writes nothing there), and every request still matches solo."""
    _, _, _, model = lm_bundle
    prompts, ref = solo_outputs
    sess = ContinuousGenerationSession(model, max_slots=2, max_len=16)
    got = []
    for p in prompts[:4]:
        sess.admit([p], max_new=8)
        while sess.live_count:
            got += [(m, t) for _, m, t in sess.step()[1]]
    assert int(sess._state["pos"][1]) >= 2 * sess.max_len
    _assert_matches_solo(got, ref[:4])


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b", "zamba2-1.2b"])
def test_resident_state_has_the_shapes_admission_writes(arch):
    """The table starts from ``init_decode_state``, whose tensors have
    the shapes and dtypes of a prefill's state at any batch."""
    model = resolve(arch, device="cpu", seed=0).model
    sess = ContinuousGenerationSession(model, max_slots=4, max_len=24)
    toks = torch.arange(3, 3 + 2 * 5, dtype=torch.int32).view(2, 5)
    _, fresh = model.prefill(toks, max_len=24)
    for resident, new in zip(sess._state["caches"], fresh["caches"]):
        assert set(resident) == set(new)
        for name, t in resident.items():
            assert t.dtype == new[name].dtype, name
            assert t.shape[0] == new[name].shape[0], name
            assert t.shape[1] == 4 and new[name].shape[1] == 2, name
            assert t.shape[2:] == new[name].shape[2:], name
    assert sess._state["pos"].dtype == fresh["pos"].dtype


def test_matches_the_jax_session_on_the_same_weights(lm_bundle,
                                                     solo_outputs):
    """The reference's ContinuousGenerationSession and the port's, on the
    same weights and prompts: the same tokens and pre-EOS lengths for
    every row (behind the solo fixture's margins), in both modes."""
    _, jm, params, model = lm_bundle
    prompts, ref = solo_outputs
    for refill in (True, False):
        want = JContinuousSession(jm, params, max_slots=4, max_len=48).serve(
            prompts, max_new=8, refill=refill)
        got = ContinuousGenerationSession(model, max_slots=4,
                                          max_len=48).serve(
            prompts, max_new=8, refill=refill)
        for (m_w, t_w), (m_g, t_g) in zip(want, got):
            assert m_g == m_w
            np.testing.assert_array_equal(t_g, np.asarray(t_w))
    _assert_matches_solo(got, ref)


def test_continuous_serving_launcher_runs_on_the_cpu(monkeypatch, capsys):
    """``launch/continuous_serving.py`` at the smoke schedule: both modes
    served every request, and each printed its line."""
    monkeypatch.setenv("REPRO_SMOKE", "1")
    stats = continuous_serving.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "block-to-completion" in out and "continuous (refill=True)" in out
    for s in stats.values():
        assert s["requests"] == 10 and s["shed"] == 0


# ------------------------------------------- engine-level parity pins -----
def test_engine_continuous_matches_submit_batch(lm_bundle, solo_outputs):
    """Admission pressure disabled (one tier, ample queue, simultaneous
    arrivals): serve_continuous agrees with submit_batch per request —
    same m_out, nothing shed, same tier."""
    cfg, _, _, model = lm_bundle
    prompts, ref = solo_outputs
    prof = _flat_tier_profile()

    cont = ContinuousGenerationSession(model, max_slots=4, max_len=48)
    eng_c = CollaborativeEngine(
        n2m=LinearN2M(1.0, 0.0),
        tiers=[Tier(prof, name="npu", servers=1, queue_capacity=64,
                    batch_size=4, continuous_session=cont)], seed=0)
    res_c = eng_c.serve_continuous(prompts, max_new=8)

    sess = GenerationSession(model, max_len=48)
    bexec = build_executor(sess, kind="batched", max_new=8,
                           vocab_clip=cfg.vocab_size)
    eng_b = CollaborativeEngine(
        n2m=LinearN2M(1.0, 0.0),
        tiers=[Tier(prof, name="npu", servers=1, queue_capacity=64,
                    batch_size=4, batched_executor=bexec)], seed=0)
    res_b = eng_b.submit_batch(prompts, now_s=0.0)

    assert [r.m_out for r in res_c] == [r.m_out for r in res_b] \
        == [m for m, _ in ref]
    assert [r.device for r in res_c] == [r.device for r in res_b]
    assert not any(r.shed for r in res_c)
    assert not any(r.shed for r in res_b)
    assert [r.req_id for r in res_c] == list(range(len(prompts)))
    assert all(np.isfinite(r.latency_s) and r.latency_s > 0 for r in res_c)


def test_engine_block_and_refill_same_outputs(lm_bundle, solo_outputs):
    """refill only changes WHEN rows run, never what they compute."""
    _, _, _, model = lm_bundle
    prompts, ref = solo_outputs
    prof = _flat_tier_profile()
    arrivals = np.linspace(0.0, 0.01, len(prompts))
    outs = {}
    for refill in (False, True):
        sess = ContinuousGenerationSession(model, max_slots=4, max_len=48)
        eng = CollaborativeEngine(
            n2m=LinearN2M(1.0, 0.0),
            tiers=[Tier(prof, name="npu", servers=1, queue_capacity=64,
                        batch_size=4, continuous_session=sess)], seed=0)
        res = eng.serve_continuous(prompts, arrival_s=arrivals,
                                   max_new=8, refill=refill)
        outs[refill] = [r.m_out for r in res]
    assert outs[False] == outs[True] == [m for m, _ in ref]


def test_engine_burst_never_oversubscribes_and_sheds_with_record(
        lm_bundle):
    """Bursty simultaneous arrivals against a 2-slot table with a
    1-deep queue: the slot table never exceeds max_slots and every
    dropped request comes back as an explicit shed record."""
    cfg, _, _, model = lm_bundle
    rng = np.random.default_rng(3)
    burst = [rng.integers(3, cfg.vocab_size, size=5).astype(np.int32)
             for _ in range(10)]
    sess = ContinuousGenerationSession(model, max_slots=2, max_len=32)
    eng = CollaborativeEngine(
        n2m=LinearN2M(1.0, 0.0),
        tiers=[Tier(_flat_tier_profile(), name="npu", servers=1,
                    queue_capacity=1, batch_size=2,
                    continuous_session=sess)], seed=0)
    res = eng.serve_continuous(burst, arrival_s=[0.0] * 10,
                               deadline_s=1e-6, max_new=6)
    assert sess.peak_live <= 2
    assert all(r is not None for r in res)
    n_served = sum(not r.shed for r in res)
    n_shed = sum(r.shed for r in res)
    assert n_served + n_shed == 10
    assert n_shed > 0                      # the burst had to shed
    for r in res:
        if r.shed:
            assert r.device == -1 and np.isnan(r.latency_s)


# --------------------------------------------------- DES parity pins ------
def _solo_sched(profile, *, batch_size=1, o=0.0):
    return MultiTierScheduler(
        [SchedTier(profile.name, dataclasses.replace(profile.model), None,
                   batch_size=batch_size, per_seq_overhead_s=o)],
        LinearN2M(1.0, 0.0))


def test_sim_continuous_zero_load_matches_unbatched_bitwise():
    """Zero load: the continuous station reproduces the unbatched
    station bitwise (solo draws, zero wait)."""
    prof = DeviceProfile("t", LinearLatencyModel(1e-4, 2e-3, 1e-3), 0.02)
    rng = np.random.default_rng(5)
    k = 300
    n = rng.integers(2, 60, k).astype(np.float64)
    stream = RequestStream(np.arange(k) * 1.0, n, n, n)
    plain = simulate_des(_solo_sched(prof), stream,
                         [SimTier("t", prof)], seed=0)
    cont = simulate_des(_solo_sched(prof, batch_size=8, o=1e-3), stream,
                        [SimTier("t", prof, batch_size=8,
                                 per_seq_overhead_s=1e-3,
                                 continuous=True)], seed=0)
    assert cont.wait_s.max() == 0.0
    assert np.array_equal(plain.latency_s, cont.latency_s)
    assert np.array_equal(plain.tier, cont.tier)


def test_sim_continuous_charges_overhead_per_live_slot():
    """Two overlapping requests: the second starts while the first is
    live, so it pays exactly one per-slot overhead; the first pays none."""
    prof = DeviceProfile("t", LinearLatencyModel(0.0, 0.0, 0.1), 0.0)
    stream = RequestStream(np.array([0.0, 0.01]),
                           np.full(2, 8.0), np.full(2, 8.0),
                           np.full(2, 8.0))
    r = simulate_des(_solo_sched(prof, batch_size=4, o=0.01), stream,
                     [SimTier("t", prof, batch_size=4,
                              per_seq_overhead_s=0.01, continuous=True)],
                     seed=0)
    assert r.exec_s[0] == pytest.approx(0.1)
    assert r.exec_s[1] == pytest.approx(0.11)
    assert r.wait_s.max() == 0.0           # both found a free slot


def test_sim_continuous_beats_block_under_load():
    """Heterogeneous service + saturating Poisson load: continuous
    strictly improves p95 AND SLO attainment over block-to-completion."""
    prof = DeviceProfile("t", LinearLatencyModel(2e-5, 2e-3, 1e-3), 0.05)
    rng = np.random.default_rng(7)
    k = 800
    n = rng.integers(2, 60, k).astype(np.float64)
    stream = make_poisson_stream(n, n, n, rate_hz=80.0, seed=7, slo_s=0.1)
    kw = dict(servers=1, queue_capacity=256, batch_size=8,
              per_seq_overhead_s=1e-3)
    block = simulate_des(_solo_sched(prof, batch_size=8, o=1e-3), stream,
                         [SimTier("t", prof, **kw)], seed=0)
    cont = simulate_des(_solo_sched(prof, batch_size=8, o=1e-3), stream,
                        [SimTier("t", prof, continuous=True, **kw)],
                        seed=0)
    assert cont.p95_latency_s() < block.p95_latency_s()
    assert cont.slo_attainment() > block.slo_attainment()


def test_sim_continuous_rejects_token_budget():
    with pytest.raises(ValueError, match="per-slot"):
        SimTier("t", _flat_tier_profile(), batch_size=4,
                continuous=True, max_batch_tokens=64)


# ------------------------------------------ property-based invariants -----
class _FakeSlotSession:
    """Deterministic in-memory slot table implementing the protocol
    ``serve_continuous`` drives (admit/step/live_count/free_slots/...).

    A request's decode length is derived from its first prompt token, so
    random traces produce staggered evictions without any model math.
    Slot conservation (live + free == max_slots) is asserted on every
    mutation."""

    def __init__(self, max_slots=4, max_len=64):
        class _Cfg:
            vocab_size = 1 << 30
            is_encoder_decoder = False

        class _Model:
            cfg = _Cfg()

        self.model = _Model()
        self.max_slots = max_slots
        self.max_len = max_len
        self._rows = {}                    # slot -> [req_id, steps_left]
        self.admit_log = []                # req ids in admission order
        self.n_steps = 0
        self.n_prefills = 0
        self.peak_live = 0

    def _check(self):
        assert 0 <= self.live_count <= self.max_slots
        assert self.live_count + self.free_slots == self.max_slots

    @property
    def live_count(self):
        return len(self._rows)

    @property
    def free_slots(self):
        return self.max_slots - len(self._rows)

    def admit(self, prompts, *, max_new, req_ids=None):
        assert len(prompts) <= self.free_slots, "slot oversubscription"
        free = [s for s in range(self.max_slots) if s not in self._rows]
        for j, (p, rid) in enumerate(zip(prompts, req_ids)):
            steps = int(np.asarray(p).reshape(-1)[0]) % max_new + 1
            self._rows[free[j]] = [rid, steps]
            self.admit_log.append(rid)
        self.n_prefills += 1
        self.peak_live = max(self.peak_live, self.live_count)
        self._check()
        return free[:len(prompts)]

    def step(self):
        finished = []
        for s, row in list(self._rows.items()):
            row[1] -= 1
            if row[1] <= 0:
                finished.append((row[0], 1, np.array([1], np.int32)))
                del self._rows[s]
        self.n_steps += 1
        self._check()
        return [], finished


def _fake_engine(max_slots=3, queue_capacity=None):
    sess = _FakeSlotSession(max_slots=max_slots)
    eng = CollaborativeEngine(
        n2m=LinearN2M(1.0, 0.0),
        tiers=[Tier(_flat_tier_profile(), name="npu", servers=1,
                    queue_capacity=queue_capacity, batch_size=max_slots,
                    continuous_session=sess)], seed=0)
    return sess, eng


@pytest.mark.property
@settings(max_examples=25)
@given(tokens=st.lists(st.integers(1, 9), min_size=2, max_size=14),
       classes=st.lists(st.sampled_from([0.5, 2.0, -1.0]), min_size=2,
                        max_size=14),
       slots=st.integers(1, 3))
def test_admission_is_edf_with_fifo_within_class(tokens, classes, slots):
    """All requests arrive together; the wait queue drains earliest
    deadline first, FIFO among equal deadlines (None = last class)."""
    k = min(len(tokens), len(classes))
    tokens, classes = tokens[:k], classes[:k]
    deadlines = [None if c < 0 else c for c in classes]
    sess, eng = _fake_engine(max_slots=slots)
    prompts = [np.array([t, t], np.int32) for t in tokens]
    res = eng.serve_continuous(prompts, deadline_s=deadlines, max_new=8)
    assert not any(r.shed for r in res)
    key = [(np.inf if d is None else d, i) for i, d in enumerate(deadlines)]
    expected = [i for _, i in sorted(zip(key, range(k)))]
    assert sess.admit_log == expected


@pytest.mark.property
@settings(max_examples=25)
@given(tokens=st.lists(st.integers(1, 9), min_size=1, max_size=16),
       gaps=st.lists(st.floats(0.0, 0.02), min_size=1, max_size=16),
       cap=st.integers(0, 2))
def test_no_drop_without_shed_record(tokens, gaps, cap):
    """Every request either completes or comes back as an explicit shed
    record, whatever the queue bound or deadlines."""
    k = min(len(tokens), len(gaps))
    sess, eng = _fake_engine(max_slots=2, queue_capacity=cap)
    prompts = [np.array([t, t], np.int32) for t in tokens[:k]]
    res = eng.serve_continuous(prompts,
                               arrival_s=list(np.cumsum(gaps[:k])),
                               deadline_s=1e-9, max_new=8)
    assert all(r is not None for r in res)
    served = [r for r in res if not r.shed]
    shed = [r for r in res if r.shed]
    assert len(served) + len(shed) == k
    for r in served:
        assert r.m_out >= 1 and np.isfinite(r.latency_s)
    for r in shed:
        assert r.device == -1 and np.isnan(r.latency_s)


@pytest.mark.property
@settings(max_examples=25)
@given(tokens=st.lists(st.integers(1, 9), min_size=1, max_size=20),
       gaps=st.lists(st.floats(0.0, 0.05), min_size=1, max_size=20),
       slots=st.integers(1, 4))
def test_slot_table_conservation_over_random_traces(tokens, gaps, slots):
    """live + free == max_slots across arbitrary arrival/eviction traces
    (asserted inside the fake on every mutation); the table never
    exceeds its capacity and drains at the end."""
    k = min(len(tokens), len(gaps))
    sess, eng = _fake_engine(max_slots=slots)
    prompts = [np.array([t, t], np.int32) for t in tokens[:k]]
    res = eng.serve_continuous(prompts,
                               arrival_s=list(np.cumsum(gaps[:k])),
                               max_new=8)
    assert sess.peak_live <= slots
    assert sess.live_count == 0
    assert sorted(sess.admit_log) == list(range(k))
    assert sum(not r.shed for r in res) == k
