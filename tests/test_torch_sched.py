"""The port's cluster scheduler (``repro_torch.sched``) against ``repro.sched``.

Both packages run the same job tables (sizes from numpy's ``default_rng``)
on the CPU, the port with ``device="cpu"``.  Tolerances: whole chips equal
at every allocate event, fractional chips, event times, ``p`` and the
summaries within ``RTOL = 1e-12`` relative.

- ``SpeedupEstimator``, ``blended_p`` and ``pooled_p_hat`` against
  ``repro.sched.estimator`` (hypothesis over histories, priors, prior
  weights and discounts).
- ``quantize_allocation`` and ``snap_to_slices`` against the NumPy oracles
  of ``repro.sched.quantize`` (hypothesis, oversubscribed pools included:
  equal wherever the renormalizing sums agree), both quirks of ROADMAP.md
  Queue C and its oversubscription input, and M = 1e4 and 1e5 on 4096
  chips.
- ``StragglerDetector`` report sequences against the reference's, and
  ``tests/test_sched.py``'s two straggler tests on the port's classes.
- ``ClusterScheduler`` per event (``use_engine=False``) and delegated to
  the engine, port against JAX, event log for event log: five policies in
  whole and fractional chips, ``min_chips=2``, slice snapping, the arrival
  reschedule, the estimator (seeded by ``report_progress`` history too),
  the four class-aware policies with class weights, the class-aware
  estimator with departed jobs kept, and the two instances that stay on
  the per-event loop in both packages.
- The port's delegated run against its own per-event run on the
  reference tests' instances, at their tolerances; the dropped x64 clause;
  the two held differences of Queue C on their inputs.
- ``lanes``: the per-event loops against ``benchmarks/arrivals.py``'s and
  ``benchmarks/multiclass.py``'s on the same tapes (JAX's multi-class
  tape), the five cross-checks at their benchmarks' bars, ``sched_scale``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import benchmarks.arrivals as barr  # noqa: E402
import benchmarks.multiclass as bmc  # noqa: E402
from repro.core.multiclass import ClassSpec as JaxClassSpec  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro.sched import ClusterScheduler as JaxScheduler  # noqa: E402
from repro.sched import Job as JaxJob  # noqa: E402
from repro.sched import StragglerDetector as JaxStragglers  # noqa: E402
from repro.sched import estimator as jest  # noqa: E402
from repro.sched import quantize as jq  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.kernels.alloc import pairwise_sum  # noqa: E402
from repro_torch.sched import (  # noqa: E402
    ClusterScheduler,
    Job,
    SpeedupEstimator,
    StragglerDetector,
    blended_p,
    pooled_p_hat,
    quantize_allocation,
    snap_to_slices,
)

RTOL = 1e-12
N = 48


def _close(got, want, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0.0, err_msg=what)


# ------------------------------------------------------------- estimator
observations = st.lists(
    st.tuples(st.floats(0.0, 64.0), st.floats(0.0, 50.0)), max_size=10)


@settings(max_examples=80, deadline=None)
@given(history=observations, prior_p=st.floats(0.05, 0.95), prior_weight=st.floats(0.0, 4.0),
       discount=st.floats(0.5, 1.0), chips=st.floats(0.5, 64.0))
def test_estimator_matches_reference(history, prior_p, prior_weight, discount, chips):
    want = jest.SpeedupEstimator(prior_p, prior_weight, discount)
    got = SpeedupEstimator(prior_p, prior_weight, discount)
    for k, t in history:
        want.observe(k, t)
        got.observe(k, t)
    assert got.history == want.history  # zeros are dropped alike
    _close(got.p_hat(), want.p_hat())
    _close(got.rate_at(chips), want.rate_at(chips))


@settings(max_examples=60, deadline=None)
@given(histories=st.lists(observations, min_size=1, max_size=5),
       priors=st.lists(st.floats(0.05, 0.95), min_size=5, max_size=5),
       work=st.lists(st.floats(0.0, 10.0), min_size=5, max_size=5),
       prior_weight=st.floats(0.0, 4.0), discount=st.floats(0.5, 1.0))
def test_blended_and_pooled_p_match_reference(histories, priors, work, prior_weight,
                                              discount):
    pairs = []
    for hist, prior in zip(histories, priors, strict=False):
        a = jest.SpeedupEstimator(prior, prior_weight, discount)
        b = SpeedupEstimator(prior, prior_weight, discount)
        for k, t in hist:
            a.observe(k, t)
            b.observe(k, t)
        pairs.append((a, b))
    want_e, got_e = [a for a, _ in pairs], [b for _, b in pairs]
    w = work[: len(pairs)]
    _close(blended_p(got_e, w), jest.blended_p(want_e, w))
    _close(pooled_p_hat(got_e, priors[0], prior_weight),
           jest.pooled_p_hat(want_e, priors[0], prior_weight))


def test_estimator_clip_bounds_are_the_port_engines():
    from repro_torch.core.estimation import P_CLIP
    from repro_torch.sched import estimator

    assert estimator.P_CLIP is P_CLIP == (0.01, 0.999)


# ------------------------------------------------------------ quantizer
@st.composite
def thetas(draw):
    """Shares summing to at most 1 (some zero), with pools from 1 chip up:
    M > N and M * min_chips > N (oversubscribed) included."""
    m = draw(st.integers(1, 40))
    w = np.array(draw(st.lists(st.floats(0.0, 1e3), min_size=m, max_size=m)))
    zero = np.array(draw(st.lists(st.booleans(), min_size=m, max_size=m)))
    w = np.where(zero, 0.0, w)
    s = w.sum()
    theta = w / s * draw(st.sampled_from([1.0, 0.75])) if s > 0 else w
    return theta, draw(st.integers(1, 64)), draw(st.integers(1, 4))


def _oracle_pairwise(theta, n_chips, min_chips):
    """The NumPy oracle with an oversubscribed row's servable shares
    renormalized by the port's fixed pairwise tree (``kernels/alloc.py``) in place
    of NumPy's ``sum``, the one step where the port differs (ROADMAP.md
    Queue C); and whether the two sums agree."""
    if (theta > 0).sum() * min_chips <= n_chips:
        return jq.quantize_allocation(theta, n_chips, min_chips=min_chips), True
    servable = np.argsort(-theta, kind="stable")[: n_chips // min_chips]
    sub = np.zeros_like(theta)
    sub[servable] = theta[servable]
    tot = float(pairwise_sum(torch.tensor(sub)[None])[0, 0])
    if tot <= 0:
        return np.zeros(theta.shape, np.int64), True
    return jq.quantize_allocation(sub / tot, n_chips, min_chips=min_chips), tot == sub.sum()


@settings(max_examples=200, deadline=None)
@given(case=thetas())
def test_quantize_and_snap_match_numpy_oracle(case):
    """Equal to the NumPy oracle wherever the renormalizing sums agree, and
    to the oracle on the pairwise-renormalized shares everywhere."""
    theta, n_chips, min_chips = case
    want, sums_agree = _oracle_pairwise(theta, n_chips, min_chips)
    got = quantize_allocation(theta, n_chips, min_chips=min_chips, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if sums_agree:
        np.testing.assert_array_equal(got, jq.quantize_allocation(theta, n_chips,
                                                                  min_chips=min_chips))
    # A tensor comes back a tensor on its device.
    got_t = quantize_allocation(torch.tensor(theta), n_chips, min_chips=min_chips)
    assert got_t.device.type == "cpu"
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(snap_to_slices(want, n_chips, device="cpu"),
                                  jq.snap_to_slices(want, n_chips))
    np.testing.assert_array_equal(snap_to_slices(torch.tensor(want), n_chips).numpy(),
                                  jq.snap_to_slices(want, n_chips))


@pytest.mark.parametrize("theta, n_chips, want", [
    # The oracle keeps a subnormal share (JAX's quantizer drops it).
    ([0.0] * 13 + [1.0, 1.11253693e-308], 2, [0] * 13 + [1, 1]),
    # The oracle gives a leftover chip to a job at the min-chips floor.
    ([0, 0, 0.04142012, 0.9112426, 0.04733728, 0], 24, [0, 0, 2, 21, 1, 0]),
])
def test_queue_c_quirks_side_with_the_oracle(theta, n_chips, want):
    theta = np.array(theta)
    assert jq.quantize_allocation(theta, n_chips).tolist() == want
    assert quantize_allocation(theta, n_chips, device="cpu").tolist() == want


def test_queue_c_oversubscribed_renormalizer():
    """theta = [1, 4, 4, 2] / 11 on 10 chips at min_chips 3: three jobs are
    servable, and in exact arithmetic their shares renormalize to [0.4,
    0.4, 0.2], raw chips [4, 4, 2].  The pairwise sum lands on those (the
    floor trims one chip from the first tied job: [0, 3, 4, 3], the exact
    answer); NumPy's sum (and JAX's) one ulp above, raw 3.9999999999999996
    and 1.9999999999999998: [0, 3, 3, 4]."""
    theta = np.array([1.0, 4.0, 4.0, 2.0]) / 11
    assert jq.quantize_allocation(theta, 10, min_chips=3).tolist() == [0, 3, 3, 4]
    got = quantize_allocation(theta, 10, min_chips=3, device="cpu")
    assert got.tolist() == [0, 3, 4, 3]
    assert got.tolist() == _oracle_pairwise(theta, 10, 3)[0].tolist()


@pytest.mark.parametrize("m", [10_000, 100_000])
def test_quantize_oversubscribed_at_cluster_scale(m):
    """``benchmarks/sched_scale.py``'s epoch: heSRPT shares of M sorted
    Pareto sizes on 4096 chips (every M here oversubscribes), and random
    shares, chips equal to the oracle's."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.pareto(1.5, m) + 1.0)[::-1].copy()
    theta = tp.hesrpt(torch.tensor(x), 0.5)
    for th in (theta.numpy(), rng.dirichlet(np.ones(m))):
        want = jq.quantize_allocation(th, 4096)
        got = quantize_allocation(th, 4096, device="cpu")
        np.testing.assert_array_equal(got, want)
        assert got.sum() == 4096


def test_quantize_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_allocation(np.array([0.5, 0.5]), 4)


# ------------------------------------------------------------ stragglers
reports = st.lists(st.tuples(st.sampled_from(["a", "b", "c"]), st.floats(0.0, 2.0),
                             st.floats(-0.5, 2.0)), max_size=30)


@settings(max_examples=60, deadline=None)
@given(seq=reports, threshold=st.floats(0.3, 0.95), patience=st.integers(1, 4))
def test_straggler_reports_match_reference(seq, threshold, patience):
    want, got = JaxStragglers(threshold, patience), StragglerDetector(threshold, patience)
    for step, (job, observed, expected) in enumerate(seq):
        assert got.report(job, observed, expected, step) == want.report(job, observed,
                                                                        expected, step)
    assert got.slow_counts == want.slow_counts
    assert got.events == want.events


def test_straggler_detector_flags_slow_job():
    det = StragglerDetector(threshold=0.7, patience=2)
    assert not det.report("j", observed_rate=1.0, expected_rate=1.0)
    assert not det.report("j", observed_rate=0.5, expected_rate=1.0)
    assert det.report("j", observed_rate=0.5, expected_rate=1.0)
    assert det.events and det.events[0]["action"] == "evict"
    assert not det.report("k", 0.5, 1.0)
    assert not det.report("k", 1.0, 1.0)
    assert not det.report("k", 0.5, 1.0)


def test_straggler_detection_triggers_resize_decision():
    sched = ClusterScheduler(32, policy="hesrpt", device="cpu")
    for i, s in enumerate([8.0, 4.0, 2.0]):
        sched.add_job(Job(f"j{i}", size=s, p=0.5))
    alloc = sched.allocations()
    det = StragglerDetector(threshold=0.7, patience=2)
    expected = alloc["j1"] ** 0.5  # s(k) = k^p
    flagged = False
    for _ in range(3):
        flagged = det.report("j1", observed_rate=0.3 * expected, expected_rate=expected)
        if flagged:
            break
    assert flagged
    sched.n_chips -= 1  # evict one chip from the straggler, re-quantize
    assert sum(sched.allocations().values()) <= 31


# ----------------------------------------------- the scheduler, two packages
def _jobs(seed=11, m=8, *, p=0.5, ps=None, classes=None, prior=None):
    """Job fields from ``default_rng(seed)``: Pareto(1.5) + 1 sizes, one
    exponent ``p`` or per-job ``ps``, class ids from ``classes`` (a list a
    job) and a prior."""
    sizes = np.random.default_rng(seed).pareto(1.5, m) + 1.0
    return [dict(job_id=f"j{i}", size=float(s), p=float(p if ps is None else ps[i]),
                 class_id=0 if classes is None else int(classes[i]), prior_p=prior)
            for i, s in enumerate(sizes)]


def _pair(kw, jobs, *, n_chips=N, prep=None):
    """The same job table in both packages: ``(jax_scheduler, port_scheduler)``;
    ``prep(sched, Job)`` runs on each before the run."""
    out = []
    for cls, job in ((JaxScheduler, JaxJob), (ClusterScheduler, Job)):
        s = cls(n_chips, **kw) if cls is JaxScheduler else cls(n_chips, device="cpu", **kw)
        for j in jobs:
            s.add_job(job(**j))
        if prep is not None:
            prep(s, job)
        out.append(s)
    return out


def _assert_logs_equal(want, got, whole: bool):
    """Event logs equal: the same events in the same order, chips equal
    (fractional ones within RTOL), t and p within RTOL, Python types."""
    assert [(e["event"], e.get("job")) for e in got] == [(e["event"], e.get("job"))
                                                          for e in want]
    for w, g in zip(want, got, strict=True):
        assert type(g["t"]) is float
        _close(g["t"], w["t"], what=str(w))
        if w["event"] != "allocate":
            continue
        assert type(g["p"]) is float
        _close(g["p"], w["p"])
        assert list(g["chips"]) == list(w["chips"])
        if whole:
            assert all(type(c) is int for c in g["chips"].values())
            assert g["chips"] == w["chips"], (w["t"], w["chips"], g["chips"])
        else:
            assert all(type(c) is float for c in g["chips"].values())
            _close(list(g["chips"].values()), list(w["chips"].values()))


def _assert_runs_equal(kw, jobs, *, use_engine, n_chips=N, prep=None, eligible=None):
    a, b = _pair(kw, jobs, n_chips=n_chips, prep=prep)
    if eligible is not None:
        assert a._engine_eligible() is eligible and b._engine_eligible() is eligible
    ra = a.run_fluid_to_completion(use_engine=use_engine)
    rb = b.run_fluid_to_completion(use_engine=use_engine)
    _assert_logs_equal(a.events, b.events, whole=kw.get("quantize", True))
    assert rb["completion_times"].keys() == ra["completion_times"].keys()
    _close(list(rb["completion_times"].values()), list(ra["completion_times"].values()))
    for key in ("total_flow_time", "mean_flow_time", "makespan"):
        assert type(rb[key]) is float
        _close(rb[key], ra[key], what=key)
    return a, b


CLASSES = [i % 2 for i in range(8)]
HET = [0.3 if i % 2 else 0.8 for i in range(8)]
SINGLE = {  # id: (scheduler kwargs, job kwargs)
    **{f"{pol}-{kind}": (dict(policy=pol, quantize=kind == "whole"), {})
       for pol in ("hesrpt", "helrpt", "srpt", "equi", "knee") for kind in ("whole", "fractional")},
    "min_chips=2": (dict(policy="hesrpt", min_chips=2), {}),
    "snap": (dict(policy="hesrpt", snap_slices=True), {}),
}
DELEGATED_ONLY = {
    "estimator-whole": (dict(policy="hesrpt", use_estimator=True, est_discount=0.9),
                        dict(seed=11, m=10, ps=np.random.default_rng(3).uniform(0.3, 0.8, 10),
                             prior=0.5)),
    "estimator-fractional": (dict(policy="hesrpt", use_estimator=True, quantize=False,
                                  est_discount=0.9, est_prior_weight=2.0),
                             dict(ps=np.random.default_rng(4).uniform(0.3, 0.8, 8),
                                  prior=0.45)),
    **{f"class-{pol}": (dict(policy=pol, class_aware=True, class_weights={0: 1.0, 1: 2.5}),
                        dict(seed=9, ps=HET, classes=CLASSES))
       for pol in ("hesrpt_pc", "waterfill", "hesrpt_sd", "hesrpt_blind")},
    "class-hesrpt_pc-snap": (dict(policy="hesrpt_pc", class_aware=True,
                                             snap_slices=True),
                                        dict(seed=9, ps=HET, classes=CLASSES)),
}


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_per_event_matches_jax(case):
    kw, job_kw = SINGLE[case]
    _assert_runs_equal(kw, _jobs(**job_kw), use_engine=False)


@pytest.mark.parametrize("case", sorted(SINGLE) + sorted(DELEGATED_ONLY))
def test_delegated_matches_jax(case):
    kw, job_kw = {**SINGLE, **DELEGATED_ONLY}[case]
    _assert_runs_equal(kw, _jobs(**job_kw), use_engine=True, eligible=True)


def test_arrival_reschedule_matches_jax():
    """``tests/test_sched.py``'s §4.3 heuristic: a job arrives mid-run and
    heSRPT re-runs on the active set (per event), then the rest delegates."""
    a, b = _pair(dict(policy="hesrpt"), [dict(job_id="a", size=8.0, p=0.5),
                                         dict(job_id="b", size=4.0, p=0.5)], n_chips=16)
    for s, job in ((a, JaxJob), (b, Job)):
        s.allocations()
        s.advance_fluid(until_departure=False, dt=0.2)
        s.add_job(job("late", size=1.0, p=0.5))
    alloc = b.allocations()
    assert alloc == a.allocations()
    assert alloc["late"] > 0
    smallest = min(b.active_jobs(), key=lambda j: j.remaining).job_id
    assert alloc[smallest] == max(alloc.values())
    ra, rb = a.run_fluid_to_completion(), b.run_fluid_to_completion()
    _assert_logs_equal(a.events, b.events, whole=True)
    _close(rb["makespan"], ra["makespan"])


def _report_two(s, job):
    del job
    s.allocations()
    for jid in ("j0", "j1"):
        s.report_progress(jid, 0.5, wall_dt=0.25)


def _rerun_with_history(s, job):
    """A first per-event run builds real histories, then a second batch."""
    s.run_fluid_to_completion(use_engine=False)
    for i, sz in enumerate([4.0, 2.5, 1.5, 3.5]):
        s.add_job(job(f"b{i}", size=sz, p=(0.35, 0.75)[i % 2], class_id=i % 2, prior_p=0.5))


def test_estimator_seeded_by_history_matches_jax():
    jobs = [dict(job_id=f"j{i}", size=s, p=0.6, prior_p=0.4) for i, s in enumerate([4.0, 3.0, 2.0])]
    a, b = _assert_runs_equal(dict(policy="hesrpt", use_estimator=True), jobs, use_engine=True,
                              prep=_report_two)
    assert b.jobs["j0"].estimator.history == a.jobs["j0"].estimator.history != []


def test_class_estimator_keeps_departed_observations_like_jax():
    jobs = [dict(job_id=f"a{i}", size=sz, p=(0.35, 0.75)[i % 2], class_id=i % 2, prior_p=0.5)
            for i, sz in enumerate([5.0, 3.0, 2.0, 4.0])]
    for use_engine in (True, False):
        _assert_runs_equal(dict(policy="hesrpt_pc", use_estimator=True, class_aware=True),
                           jobs, use_engine=use_engine, n_chips=32, prep=_rerun_with_history)


@pytest.mark.parametrize("kw, job_kw", [
    (dict(policy="knee", use_estimator=True), dict(prior=0.4)),
    (dict(policy="hesrpt"), dict(ps=HET)),
], ids=["knee-estimator", "heterogeneous-p"])
def test_python_only_instances_match_jax(kw, job_kw):
    """The two instances that stay on the per-event loop in both packages."""
    _assert_runs_equal(kw, _jobs(**job_kw), use_engine=True, eligible=False)


# ----------------------------------- the port's delegation against itself
def _own_pair(kw, jobs, *, n_chips=48, prep=None):
    a, b = (ClusterScheduler(n_chips, device="cpu", **kw) for _ in range(2))
    for s in (a, b):
        for j in jobs:
            s.add_job(Job(**j))
        if prep is not None:
            prep(s, Job)
    assert a._engine_eligible()
    return a, b, a.run_fluid_to_completion(use_engine=True), b.run_fluid_to_completion(
        use_engine=False)


def _chips(s):
    return [e["chips"] for e in s.events if e["event"] == "allocate"]


def _sorted_times(r):
    return np.array(sorted(r["completion_times"].values()))


@pytest.mark.parametrize("policy", ["hesrpt", "equi", "srpt"])
def test_own_delegation_quantized_batch(policy):
    """``tests/test_engine.py``: chips equal at every event, event and flow
    times within 1e-9."""
    rng = np.random.default_rng(11)
    for _ in range(3):
        jobs = [dict(job_id=f"j{i}", size=float(s), p=0.5)
                for i, s in enumerate(rng.pareto(1.5, 12) + 1.0)]
        a, b, ra, rb = _own_pair(dict(policy=policy), jobs)
        assert _chips(a) == _chips(b)
        _close([e["t"] for e in a.events if e["event"] == "allocate"],
               [e["t"] for e in b.events if e["event"] == "allocate"], rtol=1e-9)
        _close(ra["total_flow_time"], rb["total_flow_time"], rtol=1e-9)
        _close(ra["makespan"], rb["makespan"], rtol=1e-9)


@pytest.mark.parametrize("quantize", [True, False])
def test_own_delegation_knee(quantize):
    rng = np.random.default_rng(5)
    jobs = [dict(job_id=f"j{i}", size=float(s), p=0.45)
            for i, s in enumerate(rng.pareto(1.5, 13) + 1.0)]
    a, b, ra, rb = _own_pair(dict(policy="knee", quantize=quantize), jobs)
    _close(_sorted_times(ra), _sorted_times(rb), rtol=1e-10)
    if quantize:
        assert _chips(a) == _chips(b)


@pytest.mark.parametrize("quantize", [False, True])
def test_own_delegation_estimator(quantize):
    """``tests/test_estimation.py``: flows within 1e-8, chips equal."""
    rng = np.random.default_rng(11)
    for _ in range(2):
        sizes, ps = rng.pareto(1.5, 10) + 1.0, rng.uniform(0.3, 0.8, 10)
        jobs = [dict(job_id=f"j{i}", size=float(s), p=float(p), prior_p=0.5)
                for i, (s, p) in enumerate(zip(sizes, ps, strict=True))]
        a, b, ra, rb = _own_pair(dict(policy="hesrpt", use_estimator=True, quantize=quantize,
                                      est_discount=0.9), jobs)
        ids = [f"j{i}" for i in range(10)]
        _close([ra["completion_times"][i] for i in ids], [rb["completion_times"][i] for i in ids],
               rtol=1e-8)
        if quantize:
            assert _chips(a) == _chips(b)


def test_own_delegation_class_estimator_and_history():
    rng = np.random.default_rng(12)
    pk = {0: 0.35, 1: 0.6, 2: 0.8}
    sizes, cls = rng.pareto(1.5, 12) + 1.0, rng.integers(0, 3, 12)
    jobs = [dict(job_id=f"j{i}", size=float(s), p=pk[int(c)], class_id=int(c), prior_p=0.5)
            for i, (s, c) in enumerate(zip(sizes, cls, strict=True))]
    _, _, ra, rb = _own_pair(dict(policy="hesrpt_pc", use_estimator=True, class_aware=True), jobs)
    _close(_sorted_times(ra), _sorted_times(rb), rtol=1e-8)
    seeded = [dict(job_id=f"j{i}", size=s, p=0.6, prior_p=0.4)
              for i, s in enumerate([4.0, 3.0, 2.0])]
    _, _, ra, rb = _own_pair(dict(policy="hesrpt", use_estimator=True), seeded, prep=_report_two)
    _close(_sorted_times(ra), _sorted_times(rb), rtol=1e-8)
    first = [dict(job_id=f"a{i}", size=sz, p=(0.35, 0.75)[i % 2], class_id=i % 2, prior_p=0.5)
             for i, sz in enumerate([5.0, 3.0, 2.0, 4.0])]
    _, _, ra, rb = _own_pair(dict(policy="hesrpt_pc", use_estimator=True, class_aware=True),
                             first, n_chips=32, prep=_rerun_with_history)
    _close([ra["completion_times"][f"b{i}"] for i in range(4)],
           [rb["completion_times"][f"b{i}"] for i in range(4)], rtol=1e-8)


@pytest.mark.parametrize("snap", [False, True])
def test_own_delegation_class_aware_and_snap(snap):
    """``tests/test_multiclass.py``: chips equal at every event, total flow
    within 1e-9; and single-class snapping on 64 chips."""
    rng = np.random.default_rng(9)
    jobs = [dict(job_id=f"j{i}", size=float(s), p=0.3 if i % 2 else 0.8, class_id=i % 2)
            for i, s in enumerate(rng.pareto(1.5, 10) + 1.0)]
    a, b, ra, rb = _own_pair(dict(policy="hesrpt_pc", class_aware=True, snap_slices=snap), jobs)
    assert _chips(a) == _chips(b)
    _close(ra["total_flow_time"], rb["total_flow_time"], rtol=1e-9)
    rng = np.random.default_rng(13)
    jobs = [dict(job_id=f"j{i}", size=float(s), p=0.5)
            for i, s in enumerate(rng.pareto(1.5, 9) + 1.0)]
    a, b, ra, rb = _own_pair(dict(policy="hesrpt", snap_slices=snap), jobs, n_chips=64)
    assert _chips(a) == _chips(b)
    _close(ra["makespan"], rb["makespan"], rtol=1e-9)


def test_delegation_needs_no_x64_flag():
    """JAX's ``_engine_eligible`` refuses without ``jax_enable_x64``; the
    port always runs float64 and delegates regardless (ROADMAP.md Queue C)."""
    jobs = _jobs(m=4)
    try:
        jax.config.update("jax_enable_x64", False)
        a, b = _pair(dict(policy="hesrpt"), jobs)
        assert not a._engine_eligible()
        assert b._engine_eligible()
    finally:
        jax.config.update("jax_enable_x64", True)
    b.run_fluid_to_completion()
    assert all(type(e["t"]) is float for e in b.events)


# ------------------------------------------ held differences (Queue C)
def test_exact_tie_share_lands_on_the_integer():
    """Twelve jobs on 48 chips with every exponent (here every p-hat) 0.5:
    theta * N is (2r - 1) / 3 at rank r, the rank-2 job's exactly 1.0.
    Through ``hesrpt_pc`` torch lands it on 1.0, XLA's per-job ``pow`` and
    sum 1 ulp below, whose floor drops the chip the leftover pass gives
    elsewhere; so the class-aware estimator's first allocation differs by
    one chip on two jobs, and the run after it.  The port's delegated run
    equals its own per-event run, event for event."""
    rng = np.random.default_rng(11)
    sizes, ps, cls = rng.pareto(1.5, 12) + 1.0, rng.uniform(0.3, 0.8, 12), rng.integers(0, 3, 12)
    jobs = [dict(job_id=f"j{i}", size=float(s), p=float(p), class_id=int(c), prior_p=0.5)
            for i, (s, p, c) in enumerate(zip(sizes, ps, cls, strict=True))]
    kw = dict(policy="hesrpt_pc", class_aware=True, use_estimator=True)
    a, b = _pair(kw, jobs)
    want, got = a.allocations(), b.allocations()
    assert sum(got.values()) == sum(want.values()) == N
    assert {k for k in got if got[k] != want[k]} == {"j2", "j7"}
    assert got["j2"] == 1 and want["j2"] == 2  # rank 2: theta * N == 1 exactly
    _, _, ra, rb = _own_pair(kw, jobs)
    _close(_sorted_times(ra), _sorted_times(rb), rtol=RTOL)


def test_delegated_estimator_follows_the_per_event_oracle():
    """On the same twelve jobs (true p from ``uniform(0.3, 0.8)``, priors
    0.5) JAX's delegated estimator run allocates one chip apart from its
    own per-event oracle at the first event; the port's delegated run
    equals that oracle event for event."""
    rng = np.random.default_rng(11)
    sizes, ps = rng.pareto(1.5, 12) + 1.0, rng.uniform(0.3, 0.8, 12)
    jobs = [dict(job_id=f"j{i}", size=float(s), p=float(p), prior_p=0.5)
            for i, (s, p) in enumerate(zip(sizes, ps, strict=True))]
    a, b = _pair(dict(policy="hesrpt", use_estimator=True, est_discount=0.9), jobs)
    a.run_fluid_to_completion(use_engine=False)
    b.run_fluid_to_completion(use_engine=True)
    # The delegated log's p is the blend at the start (the reference's
    # annotation); the per-event log's is each event's.
    assert _chips(b) == _chips(a)
    _close([e["t"] for e in b.events if e["event"] == "allocate"],
           [e["t"] for e in a.events if e["event"] == "allocate"])


# ----------------------------------------------------------------- lanes
def test_stream_trace_is_the_benchmarks():
    for got, want in zip(lanes.stream_trace(40, 1.5, 3), barr.stream_trace(40, 1.5, 3),
                         strict=True):
        np.testing.assert_array_equal(got, want)


def _assert_events_equal(got, want):
    assert len(got) == len(want)
    for (t_g, c_g), (t_w, c_w) in zip(got, want, strict=True):
        _close(t_g, t_w)
        assert c_g == c_w


@pytest.mark.parametrize("kw", [dict(quantize=True), dict(quantize=False, policy="equi"),
                                dict(use_estimator=True, prior_p=0.4, est_discount=0.9)],
                         ids=["whole", "fractional-equi", "estimator"])
def test_run_stream_reference_matches_the_benchmarks(kw):
    arrivals, sizes = lanes.stream_trace(8, 1.5, 2)
    kw = {"policy": "hesrpt", "p": 0.5, "n_chips": 32, "return_events": True, **kw}
    policy = kw.pop("policy")
    flows, events = lanes.run_stream_reference(policy, arrivals, sizes, device="cpu", **kw)
    want_flows, want_events = barr.run_stream_reference(policy, arrivals, sizes, **kw)
    _close(flows, want_flows)
    if kw.get("quantize", True):
        _assert_events_equal(events, want_events)


def _jax_mc_tape(seed=11, n_jobs=10, rate=1.5):
    specs = tuple(JaxClassSpec(*c) for c in lanes.class_grid(2))
    scn = make_scenario("multiclass_poisson", classes=specs)(jax.random.PRNGKey(seed), n_jobs,
                                                             rate)
    return tuple(np.array(v) for v in (scn.arrival_times, scn.x0, scn.p_job, scn.class_ids))


@pytest.mark.parametrize("quantize", [True, False])
def test_run_stream_reference_mc_matches_the_benchmark(quantize):
    tape = _jax_mc_tape()
    kw = dict(n_chips=32, quantize=quantize, return_events=True, class_weights={1: 2.0})
    flows, events = lanes.run_stream_reference_mc("hesrpt_sd", *tape, device="cpu", **kw)
    want_flows, want_events = bmc.run_stream_reference_mc("hesrpt_sd", *tape, **kw)
    _close(flows, want_flows)
    if quantize:
        _assert_events_equal(events, want_events)


def test_cross_checks_pass_their_benchmarks_bars():
    assert lanes.arrivals_cross_check(device="cpu") < 1e-6
    q = lanes.quantized_cross_check(device="cpu")
    assert set(q) == {"chips_exact", "n_events", "worst_epoch_time_rel", "worst_flow_rel"}
    assert q["chips_exact"] and q["n_events"] > 2 * 12 and q["worst_flow_rel"] < 1e-9
    e = lanes.estimation_cross_check(device="cpu")
    assert set(e) == {"worst_flow_rel", "n_cases", "finite"}
    assert e["worst_flow_rel"] < 1e-8 and e["n_cases"] == 4 and e["finite"]
    assert lanes.stream_oracle_check(device="cpu") < 1e-6


@pytest.mark.parametrize("snap", [False, True])
def test_multiclass_cross_check_on_jax_tape_and_own(snap):
    for tape in (_jax_mc_tape(n_jobs=12, rate=1.0), None):
        cc = lanes.multiclass_cross_check(n_jobs=12, snap_slices=snap, tape=tape, device="cpu",
                                          policies=("hesrpt_pc", "hesrpt_sd") if snap else
                                          ("hesrpt_pc", "waterfill", "hesrpt_sd"))
        assert set(cc) == {"chips_exact", "n_events", "worst_continuous_flow_rel",
                           "worst_quantized_flow_rel"}
        assert cc["chips_exact"], cc
        assert cc["worst_continuous_flow_rel"] < 1e-10 and cc["worst_quantized_flow_rel"] < 1e-9


def test_sched_scale_on_the_cpu():
    from repro_torch.core import sweeps

    n_log = len(sweeps.RUN_LOG)
    res = lanes.sched_scale(ms=(100, 1000), repeats=2, device="cpu")
    st_ = res.stats["hesrpt"]
    assert st_["theta_us"].shape == (2, 2) and np.all(st_["theta_us"] > 0)
    assert st_["quantize_us"].shape == (2, 1)
    assert st_["chips_sum"].ravel().tolist() == [4096, 4096]
    rec = sweeps.RUN_LOG[-1]
    assert len(sweeps.RUN_LOG) == min(n_log + 1, sweeps.RUN_LOG_MAX)
    assert rec["kind"] == "sched_scale" and rec["spec"]["ms"] == [100, 1000]
    assert rec["backend"] == "cpu" and rec["n_seeds"] is None
