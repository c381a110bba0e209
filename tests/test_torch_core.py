"""Port parity of the numpy layer: data, latency planes, N->M regressor,
scheduler decisions and the package's import isolation.

The scheduler decides in numpy on both sides, so its decisions are held
bit-for-bit against the JAX package with the plane and N->M coefficients
injected.  The planes' and the regressor's ``predict`` compute in float32
on both sides (jnp there, numpy here) and are held bitwise too; their
least-squares fits run through different LAPACK drivers and are held to
1e-5 relative.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

import repro_torch  # noqa: F401
from repro.core import latency_model as jlat
from repro.core import length_regressor as jlen
from repro.core import scheduler as jsched
from repro.core import tx_estimator as jtx
from repro.core.profiles import make_profile as j_make_profile
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.core import latency_model as tlat
from repro_torch.core import length_regressor as tlen
from repro_torch.core import scheduler as tsched
from repro_torch.core import tx_estimator as ttx
from repro_torch.core.calibration import device_from_roofline
from repro_torch.core.profiles import make_profile as t_make_profile
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------------- data --
@pytest.mark.parametrize("pair", ["de-en", "fr-en", "en-zh"])
def test_make_corpus_bitwise(pair):
    a = jsyn.make_corpus(pair, 300, seed=3, with_tokens=True)
    b = tsyn.make_corpus(pair, 300, seed=3, with_tokens=True)
    for field in ("n", "m_real", "m_out"):
        _bitwise(getattr(a, field), getattr(b, field))
    for xs, ys in ((a.src, b.src), (a.tgt, b.tgt)):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            _bitwise(x, y)


def test_token_batcher_blocks_bitwise():
    rng = np.random.default_rng(5)
    jb = jpipe.TokenBatcher(max_batch=4, max_tokens_per_batch=40)
    tb = tpipe.TokenBatcher(max_batch=4, max_tokens_per_batch=40)
    for i in range(23):
        toks = rng.integers(4, 100, int(rng.integers(1, 15))).astype(np.int32)
        jb.add(i, toks)
        tb.add(i, toks)
    while len(jb):
        (ji, jblock), (ti, tblock) = jb.next_batch(), tb.next_batch()
        assert ji == ti
        _bitwise(jblock, tblock)
    assert len(tb) == 0 and tb.next_batch() is None


# ------------------------------------------------------ planes / regressor --
def _coefs(seed):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.uniform(1e-5, 3e-3, 3)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_predict_bitwise_in_float32(seed):
    a_n, a_m, beta = _coefs(seed)
    jm = jlat.LinearLatencyModel(a_n, a_m, beta)
    tm = tlat.LinearLatencyModel(a_n, a_m, beta)
    rng = np.random.default_rng(seed + 10)
    n = rng.integers(1, 200, 50)
    m = rng.uniform(1.0, 150.0, 50)
    for args in ((n, m), (n.astype(np.float64), m), (7, 3.25), (7.0, 11),
                 (float(n[0]), float(m[0]))):
        got = tm.predict(*args)
        assert np.asarray(got).dtype == np.float32
        _bitwise(np.asarray(jm.predict(*args)), np.asarray(got))


@pytest.mark.parametrize("seed", [0, 1])
def test_n2m_predict_bitwise_including_int_inputs(seed):
    rng = np.random.default_rng(seed)
    gamma, delta = float(rng.uniform(0.5, 1.2)), float(rng.uniform(-2, 2))
    jr, tr = jlen.LinearN2M(gamma, delta), tlen.LinearN2M(gamma, delta)
    ints = rng.integers(1, 200, 40)
    for arg in (ints, ints.astype(np.int32), ints.astype(np.float64),
                17, 17.0, np.int64(23)):
        got = tr.predict(arg)
        assert np.asarray(got).dtype == np.float32
        _bitwise(np.asarray(jr.predict(arg)), np.asarray(got))


def test_fits_agree_to_1e5_relative():
    corpus = jsyn.make_corpus("en-zh", 2000, seed=1)
    nf, mf = jlen.prefilter_pairs(corpus.n, corpus.m_real)
    jr = jlen.LinearN2M().fit(nf, mf)
    tr = tlen.LinearN2M().fit(nf, mf)
    np.testing.assert_allclose([tr.gamma, tr.delta], [jr.gamma, jr.delta],
                               rtol=1e-5)
    np.testing.assert_allclose(tr.r2(nf, mf), jr.r2(nf, mf), rtol=1e-5)
    rng = np.random.default_rng(2)
    n = rng.integers(4, 64, 60).astype(np.float64)
    m = rng.integers(2, 64, 60).astype(np.float64)
    t = 1e-4 * n + 2e-3 * m + 5e-3 + rng.normal(0, 1e-4, 60)
    jp = jlat.LinearLatencyModel().fit(n, m, t)
    tp = tlat.LinearLatencyModel().fit(n, m, t)
    np.testing.assert_allclose([tp.alpha_n, tp.alpha_m, tp.beta],
                               [jp.alpha_n, jp.alpha_m, jp.beta], rtol=1e-5)
    np.testing.assert_allclose(tp.r2(n, m, t), jp.r2(n, m, t), rtol=1e-5)


def test_roofline_default_is_h100_not_tpu():
    prof = device_from_roofline("h100", prefill_flops_per_token=1e9,
                                decode_flops_per_token=1e9,
                                decode_bytes_per_token=1e8, mfu=1.0)
    assert prof.model.alpha_n == pytest.approx(1e9 / 67e12)
    assert prof.model.alpha_m == pytest.approx(1e8 / 3.35e12)


# ---------------------------------------------------------------- scheduler --
def _tiers(mod_lat, mod_tx, mod_sched, coefs, rtts):
    tiers = []
    for k, (c, rtt) in enumerate(zip(coefs, rtts)):
        tx = None if rtt is None else mod_tx.TxEstimator(init_rtt_s=rtt)
        tiers.append(mod_sched.SchedTier(f"t{k}",
                                         mod_lat.LinearLatencyModel(*c), tx,
                                         batch_size=1 + k))
    return tiers


@pytest.mark.parametrize("hedge", [0.0, 0.01])
def test_multitier_decisions_bitwise_with_injected_coefficients(hedge):
    coefs = [(2e-3, 9e-3, 4e-2), (4e-4, 1.8e-3, 8e-3), (1e-4, 4e-4, 2e-3)]
    rtts = [None, 0.03, 0.12]
    gamma, delta = 0.7, 1.2
    js = jsched.MultiTierScheduler(
        _tiers(jlat, jtx, jsched, coefs, rtts), jlen.LinearN2M(gamma, delta),
        hedge_margin_s=hedge)
    ts = tsched.MultiTierScheduler(
        _tiers(tlat, ttx, tsched, coefs, rtts), tlen.LinearN2M(gamma, delta),
        hedge_margin_s=hedge)
    jprof, tprof = j_make_profile("cp2", seed=4), t_make_profile("cp2", seed=4)
    rng = np.random.default_rng(9)
    picks = set()
    for i in range(300):
        now = 0.25 * i
        n = int(rng.integers(1, 200))
        q = rng.uniform(0.0, 0.2, 3).tolist()
        rtt = float(jprof.rtt_at(now))
        assert rtt == float(tprof.rtt_at(now))
        for k in (1, 2):
            js.observe_rtt(k, now, rtt * k)
            ts.observe_rtt(k, now, rtt * k)
        jd, td = js.decide(n, now, q), ts.decide(n, now, q)
        assert jd.tier == td.tier
        assert jd.t_pred == td.t_pred
        assert jd.m_hat == td.m_hat
        picks.add(td.tier)
        np.testing.assert_array_equal(
            js.decide_batch(np.array([n, n + 3]), np.array([rtt, 2 * rtt])),
            ts.decide_batch(np.array([n, n + 3]), np.array([rtt, 2 * rtt])))
    assert len(picks) >= 2           # the stream exercises real decisions


def test_cnmt_scheduler_decisions_bitwise():
    edge = (3e-3, 1.1e-2, 5e-2)
    cloud = (6e-4, 2.2e-3, 1e-2)
    js = jsched.CNMTScheduler(
        jlat.DeviceProfile("e", jlat.LinearLatencyModel(*edge)),
        jlat.DeviceProfile("c", jlat.LinearLatencyModel(*cloud)),
        jlen.LinearN2M(0.95, 0.8))
    ts = tsched.CNMTScheduler(
        tlat.DeviceProfile("e", tlat.LinearLatencyModel(*edge)),
        tlat.DeviceProfile("c", tlat.LinearLatencyModel(*cloud)),
        tlen.LinearN2M(0.95, 0.8))
    jt, tt = jtx.TxEstimator(init_rtt_s=0.05), ttx.TxEstimator(init_rtt_s=0.05)
    rng = np.random.default_rng(11)
    for i in range(200):
        now, n = 0.1 * i, int(rng.integers(1, 200))
        rtt = float(rng.uniform(0.01, 0.4))
        jt.observe(now, rtt)
        tt.observe(now, rtt)
        jd, td = js.decide(n, now, jt), ts.decide(n, now, tt)
        assert (jd.device, jd.t_edge_pred, jd.t_cloud_pred, jd.m_hat) == \
            (td.device, td.t_edge_pred, td.t_cloud_pred, td.m_hat)
    n = rng.integers(1, 200, 500)
    rtt = rng.uniform(0.01, 0.4, 500)
    np.testing.assert_array_equal(js.decide_batch(n, rtt),
                                  ts.decide_batch(n, rtt))


# ------------------------------------------------------- import isolation --
_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        hits = _IMPORT_RE.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"


def test_importing_the_port_loads_no_jax_or_reference_modules():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.data\n"
        "import repro_torch.kernels.ops, repro_torch.nmt, repro_torch.convert\n"
        "import repro_torch.models, repro_torch.runtime\n"
        "import repro_torch.nmt.gru, repro_torch.nmt.lstm\n"
        "import repro_torch.core.simulator, repro_torch.core.arrivals\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
