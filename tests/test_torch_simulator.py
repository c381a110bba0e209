"""The port's request-stream simulators and arrival processes against the
JAX package's: the same numpy program, so bitwise equal.

Mirrors ``tests/test_simulator.py`` (the analytic §III replay and Table
I rows), ``tests/test_des.py`` (the queue-aware discrete-event loop:
loaded tiers, batched and continuous stations, deadlines),
``tests/test_partitioned.py`` (the two-leg split service) and the DES
fault cases of ``tests/test_faults.py``.  Streams are small; every field
of every result is compared exactly.  Online refits are left out: the
planes' least-squares fits agree only to a tolerance
(``tests/test_torch_core.py``).
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest

from repro.core import arrivals as jarr
from repro.core import faults as jfaults
from repro.core import latency_model as jlat
from repro.core import length_regressor as jlen
from repro.core import profiles as jprof
from repro.core import scheduler as jsched
from repro.core import simulator as jsim
from repro.core import tx_estimator as jtx
from repro_torch.core import arrivals as tarr
from repro_torch.core import faults as tfaults
from repro_torch.core import latency_model as tlat
from repro_torch.core import length_regressor as tlen
from repro_torch.core import profiles as tprof
from repro_torch.core import scheduler as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core import tx_estimator as ttx

PKGS = {
    "jax": types.SimpleNamespace(arr=jarr, faults=jfaults, lat=jlat,
                                 lenr=jlen, prof=jprof, sched=jsched,
                                 sim=jsim, tx=jtx),
    "torch": types.SimpleNamespace(arr=tarr, faults=tfaults, lat=tlat,
                                   lenr=tlen, prof=tprof, sched=tsched,
                                   sim=tsim, tx=ttx),
}


def _equal(a, b):
    """Exact equality of two results, field by field (NaN == NaN)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def _both(fn):
    return fn(PKGS["jax"]), fn(PKGS["torch"])


# ---------------------------------------------------------------- arrivals --
@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_processes_bitwise(seed):
    def run(p):
        t = np.linspace(0.0, 30.0, 61)
        return (p.arr.poisson_arrivals(40.0, 300, seed=seed, t0=1.5),
                p.arr.bursty_arrivals(300, base_rate_hz=20.0,
                                      peak_factor=4.0, period_s=10.0,
                                      seed=seed),
                p.arr.diurnal_rate(t, 20.0, 4.0, 10.0))
    _equal(*_both(run))


def test_trace_files_round_trip_across_packages(tmp_path):
    arr = jarr.bursty_arrivals(200, base_rate_hz=30.0, seed=3)
    jarr.save_trace(tmp_path / "j.json", arr, meta={"src": "jax"})
    tarr.save_trace(tmp_path / "t.json", arr, meta={"src": "jax"})
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "t.json").read_text()
    _equal(tarr.load_trace(tmp_path / "j.json"), arr)
    _equal(jarr.load_trace(tmp_path / "t.json"), arr)
    with pytest.raises(ValueError):
        tarr.poisson_arrivals(0.0, 5)


def _lengths(k, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(2, 200, k).astype(np.float64)
    m = np.maximum(0.9 * n + rng.normal(0, 3, k), 1.0)
    return n, m


def test_request_streams_bitwise():
    n, m = _lengths(300, 2)

    def run(p):
        return (p.sim.make_stream(n, m, m, duration_s=60.0, seed=4,
                                  slo_s=0.5),
                p.sim.make_poisson_stream(n, m, m, rate_hz=25.0, seed=2),
                p.sim.make_trace_stream(
                    p.arr.poisson_arrivals(25.0, 300, seed=1), n, m,
                    slo_s=np.where(n > 100, 0.8, np.inf)))
    _equal(*_both(run))


# ---------------------------------------------------- analytic replay §III --
def _pair(p):
    edge = p.lat.DeviceProfile("e", p.lat.LinearLatencyModel(
        1.5e-3, 6e-3, 0.008), 0.03)
    cloud = p.lat.DeviceProfile("c", p.lat.LinearLatencyModel(
        3e-4, 1.2e-3, 0.0016), 0.03)
    return edge, cloud


@pytest.mark.parametrize("policy", ["cnmt", "cnmt-probe", "oracle", "gw",
                                    "server"])
def test_analytic_replay_bitwise(policy):
    n, m = _lengths(800, 1)

    def run(p):
        edge, cloud = _pair(p)
        profile = p.prof.make_profile("cp2", seed=0)
        stream = p.sim.make_stream(n, m, m, duration_s=profile.times_s[-1],
                                   seed=0)
        pol = {"oracle": p.sched.OracleScheduler(),
               "gw": p.sched.StaticScheduler(p.sched.EDGE),
               "server": p.sched.StaticScheduler(p.sched.CLOUD)}.get(
                   policy) or p.sched.CNMTScheduler(
                       edge=edge, cloud=cloud, n2m=p.lenr.LinearN2M(0.9, 2.0))
        return p.sim.simulate(
            pol, stream, profile, edge, cloud, seed=3,
            probe_interval_s=5.0 if policy == "cnmt-probe" else None)
    jres, tres = _both(run)
    _equal(jres, tres)
    if policy.startswith("cnmt"):
        assert 0.0 < tres.offload_frac < 1.0       # both tiers exercised


def test_table1_row_bitwise():
    n, m = _lengths(600, 5)

    def run(p):
        edge, cloud = _pair(p)
        profile = p.prof.make_profile("cp1", seed=2)
        stream = p.sim.make_stream(n, m, m, duration_s=profile.times_s[-1],
                                   seed=2)
        cnmt = p.sched.CNMTScheduler(edge=edge, cloud=cloud,
                                     n2m=p.lenr.LinearN2M(0.9, 2.0))
        naive = p.sched.CNMTScheduler(edge=edge, cloud=cloud,
                                      n2m=p.lenr.LinearN2M(0.0, 91.0))
        naive.name = "naive"
        return p.sim.table1_row(dataset="de-en", stream=stream,
                                profile=profile, edge=edge, cloud=cloud,
                                cnmt=cnmt, naive=naive, seed=2)
    _equal(*_both(run))


# -------------------------------------------------------------------- DES --
_DEV, _EDGE, _CLOUD = (3e-4, 5e-3, 2e-3), (2e-5, 2.5e-3, 4e-3), \
    (1e-5, 1e-4, 2e-3)


def _three_tier(p, *, batch=1, continuous=False, npu_cap=8):
    """``tests/test_des.py``'s npu / edge / cloud tiers, optionally with
    batched or continuous stations on the two remote tiers."""
    lat = p.lat
    npu = lat.DeviceProfile("npu", lat.LinearLatencyModel(4e-4, 1.6e-3,
                                                          0.004), 0.05)
    edge = lat.DeviceProfile("edge", lat.LinearLatencyModel(1.5e-4, 6e-4,
                                                            0.008), 0.05)
    cloud = lat.DeviceProfile("cloud", lat.LinearLatencyModel(2e-5, 9e-5,
                                                              0.002), 0.08)
    lan, wan = p.prof.make_profile("cp2", seed=5), \
        p.prof.make_profile("cp1", seed=5)
    extra = dict(batch_size=batch, per_seq_overhead_s=2e-3 if batch > 1
                 else 0.0, continuous=continuous)
    tiers = [p.sim.SimTier("npu", npu, servers=1, queue_capacity=npu_cap),
             p.sim.SimTier("edge", edge, servers=2, queue_capacity=64,
                           link=lan, **extra),
             p.sim.SimTier("cloud", cloud, servers=4, link=wan, **extra)]
    st = p.sched.SchedTier
    sched = p.sched.MultiTierScheduler(
        [st("npu", dataclasses.replace(npu.model), None),
         st("edge", dataclasses.replace(edge.model),
            p.tx.TxEstimator(init_rtt_s=float(lan.rtt_at(0.0))),
            batch_size=batch, per_seq_overhead_s=extra["per_seq_overhead_s"]),
         st("cloud", dataclasses.replace(cloud.model),
            p.tx.TxEstimator(init_rtt_s=float(wan.rtt_at(0.0))),
            batch_size=batch, per_seq_overhead_s=extra["per_seq_overhead_s"])],
        p.lenr.LinearN2M(0.9, 2.0))
    return sched, tiers


def _const_profile(p, rtt_s, bw):
    return p.prof.ConnectionProfile(name="c", times_s=np.array([0.0, 3600.0]),
                                    rtt_s=np.array([rtt_s, rtt_s]),
                                    bandwidth_bps=bw)


def _split_setup(p):
    """``tests/test_partitioned.py``'s classic split regime: a slow
    device, a fast-encoding edge, a fast-decoding cloud behind a slow
    client link, and a fat edge→cloud backbone."""
    lat, tx = p.lat, p.tx
    links = tx.LinkModel(3)
    links.add_link(1, 2, tx.TxEstimator(init_rtt_s=4e-3, bandwidth_bps=1e9))
    sched = p.sched.MultiTierScheduler(
        [p.sched.SchedTier("dev", lat.LinearLatencyModel(*_DEV), None),
         p.sched.SchedTier("edge", lat.LinearLatencyModel(*_EDGE),
                           tx.TxEstimator(init_rtt_s=5e-3,
                                          bandwidth_bps=200e6)),
         p.sched.SchedTier("cloud", lat.LinearLatencyModel(*_CLOUD),
                           tx.TxEstimator(init_rtt_s=90e-3,
                                          bandwidth_bps=20e6))],
        p.lenr.LinearN2M(1.0, 0.0), links=links,
        activation=lat.ActivationCostModel(512, 4), allow_split=True)
    tiers = [p.sim.SimTier("dev", lat.DeviceProfile(
                 "dev", lat.LinearLatencyModel(*_DEV), 0.05)),
             p.sim.SimTier("edge", lat.DeviceProfile(
                 "edge", lat.LinearLatencyModel(*_EDGE), 0.05),
                 link=_const_profile(p, 5e-3, 200e6)),
             p.sim.SimTier("cloud", lat.DeviceProfile(
                 "cloud", lat.LinearLatencyModel(*_CLOUD), 0.05),
                 link=_const_profile(p, 90e-3, 20e6))]
    return sched, tiers


DES_CASES = ["loaded", "batched", "continuous", "deadlines", "split",
             "faults", "split-faults"]


def _des_run(p, case):
    n, m = _lengths(500, 2)
    if case.startswith("split"):
        rng = np.random.default_rng(0)
        arr = np.cumsum(rng.exponential(0.05, 150))
        ns = rng.integers(8, 200, 150).astype(np.float64)
        stream = p.sim.RequestStream(t_arrival_s=arr, n=ns, m_out=ns.copy(),
                                     m_real=ns.copy())
        sched, tiers = _split_setup(p)
        kw = dict(inter_links={(1, 2): _const_profile(p, 4e-3, 1e9)})
        if case == "split-faults":
            kw.update(faults=p.faults.FaultSchedule(
                outages=(p.faults.TierOutage(2, 1.0, 3.0),)),
                retry=p.faults.RetryPolicy())
        return p.sim.simulate_des(sched, stream, tiers, seed=7,
                                  collect_events=True, **kw)
    rate = {"loaded": 80.0, "batched": 120.0, "continuous": 120.0,
            "deadlines": 40.0, "faults": 40.0}[case]
    stream = p.sim.make_poisson_stream(
        n, m, m, rate_hz=rate, seed=2,
        slo_s=0.6 if case in ("deadlines", "faults") else None)
    sched, tiers = _three_tier(
        p, batch=4 if case in ("batched", "continuous") else 1,
        continuous=case == "continuous")
    kw = {}
    if case == "faults":
        kw = dict(faults=p.faults.FaultSchedule(
            outages=(p.faults.TierOutage(2, 2.0, 6.0),),
            link_faults=(p.faults.LinkFault(1, 1.0, 3.0, rtt_factor=4.0),),
            stragglers=(p.faults.Straggler(0, 0.5, 4.0, slowdown=3.0),)),
            retry=p.faults.RetryPolicy(),
            breaker=p.faults.CircuitBreaker())
    return p.sim.simulate_des(sched, stream, tiers, seed=0,
                              collect_events=True, **kw)


@pytest.mark.parametrize("case", DES_CASES)
def test_des_bitwise(case):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # split-faults
        jres, tres = _both(lambda p: _des_run(p, case))
    _equal(jres, tres)
    _equal(jres.summary(), tres.summary())
    assert tres.events and len(set(tres.tier.tolist()) - {-1}) > 1
    if case == "split":
        assert any(e[1] == "xfer" for e in tres.events)   # two-leg service
        ok = tres.served & (tres.tier >= 0)
        resid = tres.latency_s[ok] - (tres.wait_s[ok] + tres.exec_s[ok]
                                      + tres.tx_s[ok])
        assert np.max(np.abs(resid)) < 1e-9
    if case == "faults":
        assert tres.fault_stats is not None and tres.attempts.max() > 1
    if case == "deadlines":
        assert 0.0 < tres.slo_attainment() <= 1.0


def test_split_des_warns_and_falls_back_under_faults():
    with pytest.warns(RuntimeWarning, match="split placement is disabled"):
        res = _des_run(PKGS["torch"], "split-faults")
    assert not any(e[1] == "xfer" for e in res.events)


def test_zero_load_des_matches_the_analytic_replay_bitwise():
    """``tests/test_des.py``'s invariant on the port: 1 s spaced arrivals
    find empty queues, so the DES reproduces ``simulate`` exactly."""
    p = PKGS["torch"]
    edge, cloud = _pair(p)
    n, m = _lengths(400, 1)
    profile = p.prof.make_profile("cp2", seed=0)
    stream = p.sim.RequestStream(t_arrival_s=np.arange(400) * 1.0, n=n,
                                 m_out=m, m_real=m)
    n2m = p.lenr.LinearN2M(0.9, 2.0)
    analytic = p.sim.simulate(p.sched.CNMTScheduler(edge=edge, cloud=cloud,
                                                    n2m=n2m),
                              stream, profile, edge, cloud, seed=0)
    multi = p.sched.MultiTierScheduler(
        [p.sched.SchedTier("e", edge.model, None),
         p.sched.SchedTier("c", cloud.model, p.tx.TxEstimator(
             init_rtt_s=float(profile.rtt_at(0.0))))], n2m)
    des = p.sim.simulate_des(multi, stream,
                             [p.sim.SimTier("e", edge),
                              p.sim.SimTier("c", cloud, link=profile)],
                             seed=0)
    assert des.wait_s.max() == 0.0
    np.testing.assert_array_equal(analytic.device, des.tier)
    np.testing.assert_array_equal(analytic.latency_s, des.latency_s)
