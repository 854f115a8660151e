"""The port's bounded-slot streaming loop against the JAX package's.

Tapes come from the JAX sampler (``make_scenario("poisson")``) or
``benchmarks.arrivals.stream_trace`` and go to both packages as the same
numpy arrays, float64 throughout.

- ``run_stream`` (continuous, quantized and fused rules; the fused rule
  takes the allocate's plain version on the CPU), ``run_stream_ranked``
  (heSRPT, SRPT, EQUI, and a tape of exact size ties) and
  ``run_stream_source(tape_source(...))`` against JAX's at a pool as wide as
  the tape, at 12 slots (recycling) and at 1 slot (deferred admission):
  every ``StreamResult`` field, flows, sums and ``x_final`` within
  ``RTOL = 1e-12`` relative, counts equal;
- inside the port: with a pool as wide as the tape, ``run_stream`` equals
  ``run`` and ``run_stream_ranked`` equals ``run_ranked`` bit for bit, and
  a batch of rows equals each row alone;
- the windowed means under recycling against the per-event Python oracle
  ``benchmarks.arrivals.run_stream_reference``;
- ``poisson_source`` in distribution (its draws cannot be JAX's);
- ``Sweep(stream=)`` on JAX's tapes against JAX's ``run_sweep``, and the
  spec's round trip through a JAX record;
- the refusals the JAX package makes, a windowed series probe among them
  (probes through the stream loops are held in
  ``tests/test_torch_telemetry.py``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import sweeps as js  # noqa: E402
from repro.core.policies import make_policy as jax_make_policy  # noqa: E402
from repro.core.policies import make_rank_policy as jax_make_rank_policy  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.core import arrivals as ta  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402
from repro_torch.core import telemetry as tt  # noqa: E402

RTOL = 1e-12
P = 0.5
N_JOBS = 60
N_CHIPS = 16
SLOTS = (N_JOBS, 12, 1)  # no recycling, recycling, deferral at almost every arrival
RATES = (1.0, 8.0)
COUNT_FIELDS = ("n_window", "n_arrived_window", "n_admitted", "n_completed",
                "blocked_steps", "occupancy_max")


@functools.lru_cache(maxsize=None)
def _tape(seed=0, n_jobs=N_JOBS, rate=2.0):
    scn = make_scenario("poisson", p=P)(jax.random.key(seed), n_jobs, rate)
    return np.asarray(scn.x0), np.asarray(scn.arrival_times)


def _window(arr):
    span = float(np.max(arr))
    return (0.1 * span, 0.9 * span)


def _rules(kind):
    """(JAX rule, port rule, fused) for one rule kind."""
    if kind == "continuous":
        return (je.continuous_rule(jax_make_policy("hesrpt"), 1.0, dtype=jnp.float64),
                te.continuous_rule(tp.hesrpt, 1.0), False)
    jr = je.quantized_rule(jax_make_policy("hesrpt"), N_CHIPS, dtype=jnp.float64)
    return jr, te.quantized_rule(tp.hesrpt, N_CHIPS), kind == "fused"


def _assert_results_match(got, want):
    """Every StreamResult field: counts equal, the rest within RTOL."""
    for field in want._fields:
        w = getattr(want, field)
        g = getattr(got, field)
        if field == "telemetry" or w is None:
            assert g is None, field
            continue
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape, field
        if field in COUNT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=field)


@pytest.mark.parametrize("windowed", [False, True], ids=["whole", "window"])
@pytest.mark.parametrize("n_slots", SLOTS)
@pytest.mark.parametrize("kind", ["continuous", "quantized", "fused"])
def test_run_stream_matches_jax(kind, n_slots, windowed):
    x, a = _tape()
    jr, tr, fused = _rules(kind)
    window = _window(a) if windowed else None
    want = je.run_stream(jnp.asarray(x), jnp.asarray(a), P, jr, n_slots=n_slots,
                         window=window, record_times=True, fused=fused)
    got = te.run_stream(torch.tensor(x), torch.tensor(a), P, tr, n_slots=n_slots,
                        window=window, record_times=True, fused=fused)
    _assert_results_match(got, want)
    assert int(got.n_admitted) == N_JOBS
    if n_slots == 1:
        assert int(got.blocked_steps) > 0 and int(got.occupancy_max) == 1


def _tie_tape():
    """Sizes drawn from {1, 2, 3}: exact ties among the active jobs."""
    rng = np.random.default_rng(3)
    return rng.integers(1, 4, N_JOBS).astype(np.float64), np.cumsum(rng.exponential(0.5, N_JOBS))


@pytest.mark.parametrize("tape", ["poisson", "ties"])
@pytest.mark.parametrize("n_slots", SLOTS)
@pytest.mark.parametrize("name", ["hesrpt", "srpt", "equi"])
def test_run_stream_ranked_matches_jax(name, n_slots, tape):
    """The arriving job loses every exact tie (x >= x_a), as in JAX."""
    x, a = _tape() if tape == "poisson" else _tie_tape()
    window = _window(a)
    want = je.run_stream_ranked(jnp.asarray(x), jnp.asarray(a), P, 4.0,
                                jax_make_rank_policy(name), n_slots=n_slots, window=window,
                                n_alone=4.0, record_times=True)
    got = te.run_stream_ranked(torch.tensor(x), torch.tensor(a), P, 4.0,
                               tp.make_rank_policy(name), n_slots=n_slots, window=window,
                               n_alone=4.0, record_times=True)
    _assert_results_match(got, want)


@pytest.mark.parametrize("kind", ["continuous", "fused"])
def test_run_stream_source_tape_matches_jax(kind):
    """The same arrival-sorted tape through each package's tape_source:
    120 events at 12 slots, an absolute tolerance, a window."""
    x, a = _tape(seed=1)
    order = np.argsort(a, kind="stable")
    jr, tr, fused = _rules(kind)
    kw = dict(n_slots=12, n_events=120, window=_window(a), n_alone=2.0, x_scale=10.0,
              fused=fused)
    want = je.run_stream_source(je.tape_source(jnp.asarray(x[order]), jnp.asarray(a[order])),
                                P, jr, **kw)
    got = te.run_stream_source(te.tape_source(torch.tensor(x[order]), torch.tensor(a[order])),
                               P, tr, **kw)
    # The port's source runner keeps one value a source row: row 0 here.
    _assert_results_match(te.StreamResult(*(v if v is None else v[0] for v in got)), want)


@pytest.mark.parametrize("kind", ["continuous", "quantized", "fused", "knee"])
def test_run_stream_reduces_to_run_bit_for_bit(kind):
    """A pool as wide as the tape never recycles: completion times equal
    run's bit for bit, for a batch of [2, 4, M] cells at once."""
    x, a = (torch.tensor(np.stack([np.stack([_tape(s, rate=r)[k] for s in range(4)])
                                   for r in (2.0, 8.0)])) for k in (0, 1))
    if kind == "knee":
        rule, fused = te.continuous_rule(tp.make_policy("knee", n_servers=1.0), 1.0), False
    else:
        rule, fused = _rules(kind)[1:]
    want = te.run(x, a, P, rule, fused=fused)
    got = te.run_stream(x, a, P, rule, n_slots=N_JOBS, record_times=True, fused=fused)
    assert torch.isfinite(want.completion_times).all()
    assert torch.equal(got.completion_times, want.completion_times)
    assert (got.n_completed == N_JOBS).all() and (got.blocked_steps == 0).all()
    assert not got.x_final.any()


@pytest.mark.parametrize("name", ["hesrpt", "srpt", "equi"])
def test_run_stream_ranked_reduces_to_run_ranked_bit_for_bit(name):
    x, a = (torch.tensor(np.stack([_tape(s)[k] for s in range(3)])) for k in (0, 1))
    want = te.run_ranked(x, a, P, 1.0, tp.make_rank_policy(name))
    got = te.run_stream_ranked(x, a, P, 1.0, tp.make_rank_policy(name), n_slots=N_JOBS,
                               record_times=True)
    assert torch.equal(got.completion_times, want)


def test_batched_rows_equal_each_row_alone():
    """[3, M] rows at 12 slots with a [3, 1] window column: each row's
    result is its own run's, bit for bit."""
    x, a = (torch.tensor(np.stack([_tape(s)[k] for s in range(3)])) for k in (0, 1))
    rule = te.quantized_rule(tp.hesrpt, N_CHIPS)
    lo, hi = 0.1 * a.amax(-1), 0.9 * a.amax(-1)
    both = te.run_stream(x, a, P, rule, n_slots=12, window=(lo, hi), record_times=True)
    for c in range(3):
        one = te.run_stream(x[c], a[c], P, rule, n_slots=12, window=(lo[c], hi[c]),
                            record_times=True)
        for field in one._fields:
            v = getattr(one, field)
            if v is not None:
                assert torch.equal(getattr(both, field)[c], v), field


@pytest.mark.parametrize("quantize", [False, True], ids=["continuous", "quantized"])
def test_recycled_stream_matches_python_oracle_window(quantize):
    """16 slots under a 100-job tape: windowed mean flow against the
    per-event ClusterScheduler oracle on 64 chips."""
    from benchmarks.arrivals import run_stream_reference, stream_trace

    arr, x = stream_trace(100, rate=2.0, seed=5)
    window = _window(arr)
    in_w = (arr >= window[0]) & (arr < window[1])
    pol = tp.make_policy("hesrpt", n_servers=64)
    rule = te.quantized_rule(pol, 64) if quantize else te.continuous_rule(pol, 64)
    res = te.run_stream(torch.tensor(x), torch.tensor(arr), P, rule, n_slots=16,
                        window=window, n_alone=64)
    flows = run_stream_reference("hesrpt", arr, x, p=P, n_chips=64, quantize=quantize)
    assert int(res.n_window) == int(in_w.sum())
    np.testing.assert_allclose(float(res.mean_flow), float(np.mean(flows[in_w])), rtol=1e-9)


def test_blocked_arrival_defers_not_drops():
    """One slot, two unit jobs: the second arrives at 0.1 into a full pool,
    waits, and its flow counts the wait from its true arrival."""
    rule = te.continuous_rule(tp.hesrpt, 1.0)
    res = te.run_stream(torch.tensor([1.0, 1.0], dtype=torch.float64),
                        torch.tensor([0.0, 0.1], dtype=torch.float64), P, rule,
                        n_slots=1, horizon=8, record_times=True)
    np.testing.assert_allclose(res.completion_times.numpy(), [1.0, 2.0], rtol=1e-12)
    assert int(res.n_admitted) == 2 and int(res.n_completed) == 2
    assert int(res.blocked_steps) >= 1 and int(res.occupancy_max) == 1
    assert float(res.flow_sum) == pytest.approx(1.0 + 1.9, rel=1e-12)


def test_poisson_source_in_distribution():
    """Seeded draws: mean gap 1/rate for each row of a rate column, Pareto
    sizes with minimum 1 and tail P(X > t) = t^-1.5; a run through 8 slots
    completes jobs and never holds more than 8."""
    gen = torch.Generator().manual_seed(0)
    rates = torch.tensor([[0.5], [4.0]], dtype=torch.float64)
    src = te.poisson_source(gen, rates, device="cpu")
    state = src.init()
    n = 20_000
    gaps, sizes = [], []
    for _ in range(n):
        t0 = state[0]
        state = src.advance(state)
        gaps.append(state[0] - t0)
        sizes.append(state[1])
    gaps, sizes = torch.cat(gaps, 1), torch.cat(sizes, 1)
    np.testing.assert_allclose(gaps.mean(1).numpy(), 1.0 / rates[:, 0].numpy(), rtol=0.03)
    assert float(sizes.min()) >= 1.0
    for t in (2.0, 4.0):
        np.testing.assert_allclose(float((sizes > t).double().mean()), t ** -1.5, rtol=0.05)

    rule = te.continuous_rule(tp.hesrpt, 1.0)
    src = te.poisson_source(torch.Generator().manual_seed(1), 1.5, device="cpu")
    res = te.run_stream_source(src, P, rule, n_slots=8, n_events=400)
    assert res.n_completed.shape == (1,)
    assert int(res.n_completed) > 50 and int(res.occupancy_max) <= 8
    assert int(res.n_admitted) >= int(res.n_completed) and float(res.t_final) > 0


def _jax_tapes(spec):
    """The tapes the JAX sweep draws: one key per seed, shared by the rates."""
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p)
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]
    x0 = np.asarray([[np.asarray(c.x0) for c in row] for row in cells])
    arr = np.asarray([[np.asarray(c.arrival_times) for c in row] for row in cells])
    return x0, arr


@pytest.mark.parametrize("label", lanes.STREAM_LABELS)
def test_stream_sweep_matches_jax_on_its_tapes(label):
    """The smoke stream lanes (120 jobs through 16 slots, 2 seeds, rates 1
    and 8): the port's spec is read from the JAX record, runs JAX's tapes
    through simulate_cells, and every stream metric agrees with JAX's
    run_sweep (counts equal, flows and slowdowns within RTOL)."""
    want_spec = dict(lanes.stream_lane_specs(smoke=True))[label]._replace(rates=RATES)
    spec_j = js.Sweep.create(
        want_spec.policies, RATES, n_jobs=want_spec.n_jobs, n_seeds=want_spec.n_seeds,
        p=want_spec.p, n_servers=want_spec.n_servers, n_chips=want_spec.n_chips,
        fused=want_spec.fused, stream=dict(want_spec.stream), metrics=want_spec.metrics,
    )
    res_j = js.run_sweep(spec_j, log=False)
    spec = tsw.Sweep.from_spec_dict(res_j.record()["spec"])
    assert spec == want_spec
    x0, arr = _jax_tapes(spec_j)
    got = tsw.simulate_cells(spec, x0, arr, device="cpu")["hesrpt"]
    for m in spec.metrics:
        want = np.asarray(res_j.stats["hesrpt"][m])
        assert got[m].shape == want.shape == (len(RATES), spec.n_seeds), m
        if m in ("stream_flow", "stream_slowdown"):
            np.testing.assert_allclose(got[m], want, rtol=RTOL, atol=0, err_msg=m)
        else:
            np.testing.assert_array_equal(got[m], want, err_msg=m)


def test_stream_spec_record_round_trip():
    """A stream spec's record has the JAX record's spec keys, and both
    packages' records read back to the same spec."""
    spec = tsw.Sweep.create(("hesrpt", "srpt"), (1.0, 2.0), n_jobs=30, n_seeds=2,
                            stream={"n_slots": 8, "warmup_frac": 0.2, "end_frac": 0.7},
                            metrics=("stream_flow", "stream_blocked"))
    res = tsw.run_sweep(spec, device="cpu")
    rec = res.record()
    assert rec["spec"]["stream"] == [["end_frac", 0.7], ["n_slots", 8], ["warmup_frac", 0.2]]
    assert tsw.Sweep.from_spec_dict(rec["spec"]) == spec
    spec_j = js.Sweep.create(spec.policies, spec.rates, n_jobs=30, n_seeds=2,
                             stream=dict(spec.stream), metrics=spec.metrics)
    jrec = js.SweepResult(spec_j, {}, 0.0, 0.0, "cpu", 1, None, False).record()
    assert set(jrec["spec"]) == set(rec["spec"])
    assert tsw.Sweep.from_spec_dict(jrec["spec"]) == spec
    assert res.stats["srpt"]["stream_blocked"].shape == (2, 2)
    assert tsw.Sweep.create(("hesrpt",), (1.0,), stream={"n_slots": 4}).metrics == (
        "stream_flow", "stream_slowdown")


_REFUSALS = {
    "tensor_p": (ValueError, "scalar p", lambda: te.run_stream(
        torch.ones(3), torch.zeros(3), torch.full((3,), P), te.continuous_rule(tp.hesrpt, 1.0),
        n_slots=2)),
    "tensor_p_ranked": (ValueError, "scalar p", lambda: te.run_stream_ranked(
        torch.ones(3), torch.zeros(3), torch.full((3,), P), 1.0, tp.make_rank_policy("hesrpt"),
        n_slots=2)),
    "telemetry": (ValueError, "stream-mode only", lambda: tt.make_probe(
        mode="series", window=(0.0, 1.0))),
    "drift_scenario": (ValueError, "p_drift cannot stream", lambda: ta.simulate_stream(
        tsc.make_scenario("drift_poisson")(torch.Generator().manual_seed(0), 8, 1.0), P, 1.0,
        tp.hesrpt, n_slots=4, device="cpu")),
    "drift_sweep": (ValueError, "plain tape scenario", lambda: tsw.Sweep.create(
        ("hesrpt",), (1.0,), scenario="drift_poisson", stream={"n_slots": 4})),
    "unknown_key": (ValueError, "unknown stream key", lambda: tsw.Sweep.create(
        ("hesrpt",), (1.0,), stream={"n_slots": 4, "slots": 4})),
    "no_slots": (ValueError, "n_slots >= 1", lambda: tsw.Sweep.create(
        ("hesrpt",), (1.0,), stream={"n_slots": 0})),
    "bad_window": (ValueError, "warmup_frac < end_frac", lambda: tsw.Sweep.create(
        ("hesrpt",), (1.0,), stream={"n_slots": 4, "warmup_frac": 0.9, "end_frac": 0.5})),
    "stream_metric_without_stream": (ValueError, "needs a streaming sweep", lambda:
        tsw.Sweep.create(("hesrpt",), (1.0,), metrics=("stream_flow",))),
    "scalar_metric_in_stream": (ValueError, "not a streaming metric", lambda:
        tsw.Sweep.create(("hesrpt",), (1.0,), stream={"n_slots": 4},
                         metrics=("mean_flowtime",))),
    "superstep_stream": (ValueError, "superstep sweeps take no", lambda: tsw.Sweep.create(
        ("hesrpt",), (1.0,), superstep=True, stream={"n_slots": 4})),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_refusals(case):
    """What the JAX package refuses, the port refuses with its words
    (checked on the JAX side where the JAX package has the case)."""
    exc, match, call = _REFUSALS[case]
    with pytest.raises(exc, match=match):
        call()
    jax_side = {
        "tensor_p": lambda: je.run_stream(jnp.ones(3), jnp.zeros(3), jnp.full(3, P),
                                          je.continuous_rule(jax_make_policy("hesrpt"), 1.0,
                                                             dtype=jnp.float64), n_slots=2),
        "drift_sweep": lambda: js.Sweep.create(("hesrpt",), (1.0,), scenario="drift_poisson",
                                               stream={"n_slots": 4}),
        "unknown_key": lambda: js.Sweep.create(("hesrpt",), (1.0,),
                                               stream={"n_slots": 4, "slots": 4}),
        "bad_window": lambda: js.Sweep.create(
            ("hesrpt",), (1.0,), stream={"n_slots": 4, "warmup_frac": 0.9, "end_frac": 0.5}),
        "stream_metric_without_stream": lambda: js.Sweep.create(
            ("hesrpt",), (1.0,), metrics=("stream_flow",)),
    }.get(case)
    if jax_side is not None:
        with pytest.raises(exc, match=match):
            jax_side()
