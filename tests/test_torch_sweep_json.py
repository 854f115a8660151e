"""``SweepResult``'s JSON text between the two packages, on the CPU.

Each package's ``to_json`` is read by the other's ``from_json``: the spec
comes back equal to the reader's own ``Sweep.create`` of the same
arguments (or the same dict, for a benchmark's dict spec) and every stats
array bit for bit, as float64.  Eight spec kinds: plain poisson, fused
quantized, ``classes``, ``stream``, ``telemetry``, ``superstep``,
``arm="estimator"`` and ``lanes.sched_scale``'s dict spec against
``benchmarks/sched_scale.py::run``'s.  Where the tape is a plain one
(every kind but ``classes`` and the estimator arm), the port's stats come
from JAX's tapes through ``simulate_cells`` and are also held to JAX's at
1e-12; the other two run on the port's own samplers.

Also here: ``per_seed``; ``run_sweep(log=False)`` and
``sched_scale(log=False)`` leaving ``RUN_LOG`` alone; and ``load_sweep``,
``load_sweep_raw`` and ``multiclass_sweep`` with ``shard=True`` on one
process equal to ``shard=False`` (JAX's
``test_sharded_on_single_device_is_noop_equal``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import sweeps as js  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.core import arrivals as ta  # noqa: E402
from repro_torch.core import multiclass as tmc  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402

RTOL = 1e-12
RATES = (1.0, 8.0)
BASE = dict(n_jobs=20, n_seeds=2, n_servers=64.0)
DRIFT_KW = {"p0": 0.8, "p1": 0.3, "drift_frac": 0.5}
KINDS = {
    "poisson": (("hesrpt", "equi"), dict()),
    "fused": (("hesrpt",), dict(n_chips=64, fused=True)),
    "classes": (("hesrpt_pc", "waterfill"), dict(scenario="multiclass_poisson", n_chips=64,
                                                 classes=((0.3, 1.0), (0.7, 1.0)))),
    "stream": (("hesrpt",), dict(n_chips=64, stream={"n_slots": 8, "warmup_frac": 0.2})),
    "telemetry": (("hesrpt",), dict(telemetry=True)),
    "superstep": (("hesrpt", "equi"), dict(superstep=True)),
    "estimator": (("hesrpt",), dict(scenario="drift_poisson", scenario_kw=DRIFT_KW, p=0.8,
                                    arm="estimator",
                                    arm_kw={"discount": 0.9, "prior_weight": 1.0})),
}
OWN_SAMPLERS = ("classes", "estimator")  # tapes with classes or noise: the port draws its own
RUN_FIELDS = ("wall_s", "compile_s", "backend", "device_count", "chunk_seeds", "sharded")


def _specs(kind):
    policies, kw = KINDS[kind]
    return (js.Sweep.create(policies, RATES, **BASE, **kw),
            tsw.Sweep.create(policies, RATES, **BASE, **kw))


def _bits(a) -> bytes:
    return np.ascontiguousarray(a, dtype=np.float64).tobytes()


def _assert_same_stats(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for m, a in want[name].items():
            assert got[name][m].dtype == np.float64, (name, m)
            assert got[name][m].shape == np.shape(a), (name, m)
            assert _bits(got[name][m]) == _bits(a), (name, m)


@functools.lru_cache(maxsize=None)
def _jax_result(kind):
    return js.run_sweep(_specs(kind)[0], log=False)


def _jax_tapes(spec):
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p)
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]
    x0 = np.asarray([[np.asarray(c.x0) for c in row] for row in cells])
    arr = np.asarray([[np.asarray(c.arrival_times) for c in row] for row in cells])
    return x0, arr


def _port_result(kind):
    spec_j, spec = _specs(kind)
    if kind in OWN_SAMPLERS:
        return tsw.run_sweep(spec, log=False, device="cpu")
    stats = tsw.simulate_cells(spec, *_jax_tapes(spec_j), device="cpu")
    want = _jax_result(kind).stats
    for name in spec.policies:
        for m in spec.out_names():
            np.testing.assert_allclose(stats[name][m], want[name][m], rtol=RTOL, atol=1e-12,
                                       err_msg=f"{kind} {name} {m}")
    return tsw.SweepResult(spec, stats, 0.25, backend="cpu", device=torch.device("cpu"))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_jax_reads_the_ports_text(kind):
    res = _port_result(kind)
    back = js.SweepResult.from_json(res.to_json())
    assert back.spec == _specs(kind)[0]
    _assert_same_stats(back.stats, res.stats)
    assert {f: getattr(back, f) for f in RUN_FIELDS} == {f: getattr(res, f) for f in RUN_FIELDS}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_port_reads_jaxs_text(kind):
    res_j = _jax_result(kind)
    back = tsw.SweepResult.from_json(res_j.to_json(), device="cpu")
    assert back.spec == _specs(kind)[1]
    _assert_same_stats(back.stats, res_j.stats)
    assert {f: getattr(back, f) for f in RUN_FIELDS} == {f: getattr(res_j, f)
                                                         for f in RUN_FIELDS}
    assert back.device == torch.device("cpu")
    # and the port writes it back as JAX wrote it
    again = js.SweepResult.from_json(back.to_json())
    assert again.spec == res_j.spec
    _assert_same_stats(again.stats, res_j.stats)


def test_dict_spec_round_trips_both_ways():
    """``lanes.sched_scale``'s result and ``benchmarks/sched_scale.py``'s: the
    same spec dict, and each read by the other package as it was written."""
    from benchmarks.sched_scale import run as jax_sched_scale

    kw = dict(ms=(10, 100), repeats=2, log=False)
    res = lanes.sched_scale(**kw, device="cpu")
    res_j = jax_sched_scale(**kw)
    assert res.spec == res_j.spec
    back_j = js.SweepResult.from_json(res.to_json())
    assert back_j.spec == res.spec
    _assert_same_stats(back_j.stats, res.stats)
    back = tsw.SweepResult.from_json(res_j.to_json(), device="cpu")
    assert isinstance(back.spec, dict) and back.spec == res_j.spec
    _assert_same_stats(back.stats, res_j.stats)
    assert back.compile_s == res_j.compile_s and back.record()["kind"] == "sched_scale"


def test_floats_round_trip_exactly():
    spec = tsw.Sweep.create(("hesrpt",), (1.0 / 3.0,), n_jobs=4, n_seeds=3)
    odd = np.array([[np.nextafter(1.0, 2.0), 5e-324, 1e308]])
    res = tsw.SweepResult(spec, {"hesrpt": {"mean_flowtime": odd}}, 0.1 + 0.2, backend="cpu",
                          device=torch.device("cpu"))
    back = tsw.SweepResult.from_json(res.to_json(), device="cpu")
    assert back.spec == spec and back.spec.rates == (1.0 / 3.0,)
    assert _bits(back.per_seed("hesrpt")) == _bits(odd) and back.wall_s == 0.1 + 0.2
    assert back.device == torch.device("cpu")
    assert tsw.SweepResult.from_json(res.to_json()).device == torch.device("cuda")


def test_per_seed_reads_the_stats_as_jax_does():
    spec_j, spec = _specs("classes")
    res = tsw.run_sweep(spec, log=False, device="cpu")
    assert res.per_seed("hesrpt_pc") is res.stats["hesrpt_pc"][spec.metrics[0]]
    assert res.per_seed("waterfill", "class_flowtime").shape == (len(RATES), 2, 2)
    res_j = _jax_result("classes")
    assert spec.metrics == spec_j.metrics
    assert res_j.per_seed("waterfill", "class_flowtime").shape == (len(RATES), 2, 2)


def test_log_false_leaves_the_run_log_alone():
    spec = tsw.Sweep.create(("hesrpt",), RATES, n_jobs=8, n_seeds=1)
    before = list(tsw.RUN_LOG)
    tsw.run_sweep(spec, log=False, device="cpu")
    lanes.sched_scale(ms=(10,), repeats=1, log=False, device="cpu")
    assert tsw.RUN_LOG == before
    tsw.run_sweep(spec, device="cpu")
    lanes.sched_scale(ms=(10,), repeats=1, device="cpu")
    assert len(tsw.RUN_LOG) == min(len(before) + 2, tsw.RUN_LOG_MAX)
    assert [r["kind"] for r in tsw.RUN_LOG[-2:]] == ["sweep", "sched_scale"]


def test_sharded_on_one_process_is_the_unsharded_run():
    """JAX's ``test_sharded_on_single_device_is_noop_equal`` on the port's
    three wrappers (no process group: one rank holds the whole grid)."""
    kw = dict(n_jobs=20, n_seeds=3, n_servers=64.0, device="cpu")
    for shard in (False, True):
        raw = ta.load_sweep_raw(("hesrpt", "equi"), RATES, shard=shard, **kw)
        means = ta.load_sweep(("hesrpt", "equi"), RATES, n_chips=32, shard=shard, **kw)
        mc = tmc.multiclass_sweep(("hesrpt_pc",), RATES, classes=((0.3, 1.0), (0.7, 1.0)),
                                  n_chips=32, shard=shard, **kw)
        if not shard:
            want = raw, means, mc
    assert want[1] == means
    for got, ref in ((raw, want[0]), (mc["hesrpt_pc"], want[2]["hesrpt_pc"])):
        for key in ref:
            assert _bits(got[key]) == _bits(ref[key]), key
