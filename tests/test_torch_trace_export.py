"""The port's recorded-trace path and Perfetto export against the JAX package's.

The mirror of ``tests/test_trace_export.py``.  Tapes are drawn by the JAX
sampler and handed to both packages as numpy arrays; the port's exporter
(``repro_torch.launch.trace_export``) runs on the port's own run of the tape:

- the recorded ``EngineTrace`` is physically sane (continuous, quantized and
  fused rules) and equals JAX's (chips equal at every event, theta and times
  within ``RTOL = 1e-12``), and composes with a series probe bit for bit;
- ``schedule_to_events`` gives valid trace-event JSON: one completion
  marker a finished job at its completion time, slices only while a job
  holds an allocation, the counter tracks; event for event the JAX
  exporter's list on JAX's run of the same tape (phases, names and tracks
  equal, numbers within ``RTOL``), the probe's series preferred;
- the schema validator rejects each malformation;
- ``export_sample(device="cpu")`` and the CLI (``--device cpu``) write a
  loadable trace.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import telemetry as jt  # noqa: E402
from repro.core.policies import make_policy as jax_make_policy  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro.launch import trace_export as jx  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import telemetry as tt  # noqa: E402
from repro_torch.launch import trace_export  # noqa: E402

RTOL = 1e-12
N_JOBS = 24


def _tape(seed=0, rate=2.0, n_jobs=N_JOBS):
    scn = make_scenario("poisson", p=0.5)(jax.random.key(seed), n_jobs, rate)
    return np.array(scn.x0), np.array(scn.arrival_times)


def _rules(kind):
    if kind == "continuous":
        return (te.continuous_rule(tp.hesrpt, 1.0),
                je.continuous_rule(jax_make_policy("hesrpt"), 1.0, dtype=jnp.float64), 1.0, False)
    return (te.quantized_rule(tp.hesrpt, 64),
            je.quantized_rule(jax_make_policy("hesrpt"), 64, dtype=jnp.float64), 64.0,
            kind == "fused")


def _recorded(kind, seed=0, telemetry=None, jax_telemetry=None):
    """(port result, JAX result, unit) of one recorded run of a JAX tape."""
    x, a = _tape(seed)
    rule, jrule, unit, fused = _rules(kind)
    res = te.run(torch.as_tensor(x), torch.as_tensor(a), 0.5, rule, record=True, fused=fused,
                 telemetry=telemetry)
    jres = je.run(x, a, 0.5, jrule, record=True, fused=fused, telemetry=jax_telemetry)
    return res, jres, unit


# ------------------------------------------------------- trace-path invariants
@pytest.mark.parametrize("kind", ["continuous", "quantized", "fused"])
def test_recorded_trace_is_physically_sane_and_matches_jax(kind):
    res, jres, unit = _recorded(kind)
    alloc = res.trace.alloc.numpy()
    times = res.trace.times.numpy()
    sizes = res.trace.sizes.numpy()
    assert np.all(alloc >= 0)
    assert np.all(alloc.sum(axis=1) <= unit * (1 + 1e-12))
    if unit != 1.0:
        assert np.all(alloc == np.round(alloc))
        np.testing.assert_array_equal(alloc, np.asarray(jres.trace.alloc))
    else:
        np.testing.assert_allclose(alloc, np.asarray(jres.trace.alloc), rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(times, np.asarray(jres.trace.times), rtol=RTOL, atol=0)
    assert np.all(np.diff(times) >= 0)
    assert np.all(np.diff(sizes, axis=0) <= 1e-12)
    done = res.completion_times.numpy()[res.order.numpy()]
    assert np.all(np.isfinite(done))
    for j in range(sizes.shape[1]):
        after = times >= done[j] + 1e-9
        assert np.all(sizes[after, j] == 0.0)
        assert np.all(alloc[after, j] == 0.0)


def test_recorded_trace_composes_with_telemetry_bitforbit():
    probe = tt.make_probe(tt.DEFAULT_METRICS, mode="series")
    plain, _, _ = _recorded("continuous", seed=7)
    probed, _, _ = _recorded("continuous", seed=7, telemetry=probe)
    for a, b in zip(plain.trace, probed.trace, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(probed.trace.times, probed.telemetry.series["t"])


# ------------------------------------------------------------------- exporter
def _assert_events_match(got, want):
    """Event for event: the same phases, names, tracks and keys; numbers
    within RTOL (they come from float sums in two orders)."""
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w), (g, w)
        for k in w:
            if isinstance(w[k], dict):
                assert set(g[k]) == set(w[k])
                for kk, v in w[k].items():
                    if isinstance(v, str):
                        assert g[k][kk] == v
                    else:
                        assert math.isclose(g[k][kk], v, rel_tol=RTOL, abs_tol=1e-9), (k, kk)
            elif isinstance(w[k], float):
                assert math.isclose(g[k], w[k], rel_tol=RTOL, abs_tol=1e-6), (k, g, w)
            else:
                assert g[k] == w[k], (k, g[k], w[k])


@pytest.mark.parametrize("kind", ["continuous", "quantized"])
def test_schedule_to_events_is_valid_complete_and_matches_jax(kind):
    res, jres, unit = _recorded(kind)
    events = trace_export.schedule_to_events(res, alloc_unit=unit, p=0.5)
    trace_export.validate_trace_events(events)
    done = res.completion_times.numpy()
    markers = [e for e in events if e["ph"] == "i"]
    assert len(markers) == int(np.sum(np.isfinite(done)))
    got = sorted(e["ts"] for e in markers)
    want = sorted(float(t) * 1e6 for t in done[np.isfinite(done)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    slices = [e for e in events if e["ph"] == "X"]
    assert slices and all(e["dur"] > 0 for e in slices)
    order = res.order.numpy()
    for e in slices:
        assert e["ts"] + e["dur"] <= float(done[order[e["tid"]]]) * 1e6 + 1e-3
    assert {"efficiency", "utilization", "queue"} <= {e["name"] for e in events if e["ph"] == "C"}
    _assert_events_match(events, jx.schedule_to_events(jres, alloc_unit=unit, p=0.5))


def test_exporter_prefers_telemetry_series_counters():
    res, jres, _ = _recorded(
        "continuous", seed=1, telemetry=tt.make_probe(tt.DEFAULT_METRICS, mode="series"),
        jax_telemetry=jt.make_probe(jt.DEFAULT_METRICS, mode="series", dtype=jnp.float64))
    events = trace_export.schedule_to_events(res, telemetry_series=res.telemetry.series)
    trace_export.validate_trace_events(events)
    assert "entropy" in {e["name"] for e in events if e["ph"] == "C"}
    series = {k: v.numpy() for k, v in res.telemetry.series.items()}
    eff = [e for e in events if e["ph"] == "C" and e["name"] == "efficiency"]
    got = np.array([e["args"]["efficiency"] for e in eff[:-1]])
    np.testing.assert_allclose(got, series["efficiency"][series["dt"] > 0], atol=1e-12)
    _assert_events_match(events, jx.schedule_to_events(
        jres, telemetry_series=jres.telemetry.series))


def test_export_requires_a_recorded_trace():
    x, a = _tape(seed=2, n_jobs=8)
    res = te.run(torch.as_tensor(x), torch.as_tensor(a), 0.5, te.continuous_rule(tp.hesrpt, 1.0))
    with pytest.raises(ValueError, match="record=True"):
        trace_export.schedule_to_events(res)


# ------------------------------------------------------------ schema validator
def test_validator_rejects_each_malformation():
    ok = {"ph": "X", "pid": 0, "tid": 1, "ts": 0.0, "dur": 1.0, "name": "s"}
    trace_export.validate_trace_events([ok])
    bad_cases = [
        [],
        [{**ok, "ph": "Q"}],
        [{k: v for k, v in ok.items() if k != "dur"}],
        [{**ok, "ts": float("nan")}],
        [{**ok, "ts": -1.0}],
        [{**ok, "dur": float("nan")}],
        [{"ph": "C", "pid": 0, "ts": 0.0, "name": "q", "args": {}}],
        [{"ph": "C", "pid": 0, "ts": 0.0, "name": "q", "args": {"q": "hi"}}],
        ["not a dict"],
    ]
    for events in bad_cases:
        with pytest.raises(ValueError):
            trace_export.validate_trace_events(events)


# ----------------------------------------------------------- sample + CLI
@pytest.mark.parametrize("n_chips", [None, 16])
def test_export_sample_on_the_cpu_is_valid(n_chips):
    """The port's own sample (a torch generator's tape): every phase, the
    process and thread names, one marker a job; through the fused allocate,
    event for event the unfused rule's export of the same tape."""
    from repro_torch.core.scenarios import make_scenario as port_scenario
    from repro_torch.core.scenarios import seed_generator

    events = trace_export.export_sample(device="cpu", n_chips=n_chips)
    trace_export.validate_trace_events(events)
    assert {"X", "i", "C", "M"} <= {e["ph"] for e in events}
    names = {e["name"] for e in events if e["ph"] == "M"}
    assert "process_name" in names and "thread_name" in names
    assert sum(1 for e in events if e["ph"] == "i") == 12
    scn = port_scenario("poisson", p=0.5)(seed_generator(0, 0, device="cpu"), 12, 2.0)
    rule = (te.continuous_rule(tp.hesrpt, 1.0) if n_chips is None
            else te.quantized_rule(tp.hesrpt, n_chips))
    unit = float(n_chips or 1.0)
    res = te.run(scn.x0, scn.arrival_times, 0.5, rule, record=True, telemetry=tt.make_probe(
        tt.DEFAULT_METRICS, mode="series", alloc_unit=unit))
    assert events == trace_export.schedule_to_events(
        res, alloc_unit=unit, p=0.5, telemetry_series=res.telemetry.series,
        process_name="hesrpt / poisson (M=12, p=0.5)")


def test_cli_writes_a_loadable_trace(tmp_path):
    out = tmp_path / "trace.json"
    trace_export.main(["--out", str(out), "--jobs", "6", "--rate", "2.0", "--seed", "1",
                       "--n-chips", "16", "--device", "cpu"])
    with open(out) as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    trace_export.validate_trace_events(doc["traceEvents"])
    assert sum(1 for e in doc["traceEvents"] if e["ph"] == "i") == 6
