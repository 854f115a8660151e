"""repro_torch.figures against the JAX package's figure benchmarks.

- ``fig4_policies(quick=True)`` (100 jobs, 3 seeds, 6 KNEE alphas, all five
  p) against ``benchmarks.fig4_policies.run(quick=True)``: both draw the
  same numpy tapes, so every median must agree within ``RTOL = 1e-12``
  relative (the ROADMAP bar for flows);
- ``fig3_trace`` against ``benchmarks.fig3_trace.run``: completion times,
  epoch times, shares and remaining sizes within ``RTOL``, and the trace's
  structure (Thm-7 shares at epoch 0, SJF completion order).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import figures  # noqa: E402

RTOL = 1e-12


@functools.lru_cache(maxsize=1)
def _fig4_pair():
    import benchmarks.fig4_policies as bf

    return bf.run(quick=True), figures.fig4_policies(quick=True, device="cpu")


@pytest.mark.parametrize("p", figures.FIG4.p_values)
def test_fig4_quick_matches_jax(p):
    want, got = _fig4_pair()
    assert set(got.medians[p]) == set(want[p]) == set(figures.FIG4.policies)
    for name, med in want[p].items():
        assert got.medians[p][name] == pytest.approx(med, rel=RTOL, abs=0), name
        assert got.flows[p][name].shape == (figures.QUICK["n_seeds"],)
        assert np.median(got.flows[p][name]) == got.medians[p][name]
    # heSRPT is optimal for a batch: no competitor beats it.
    assert figures.advantage(got.medians)[p] >= 1.0 - 1e-12


def test_fig4_tapes_and_table():
    _, got = _fig4_pair()
    rng = np.random.default_rng(2)
    assert np.array_equal(got.sizes[2], np.sort(rng.pareto(1.5, 100) + 1.0)[::-1])
    table = figures.fig4_table(got.medians)
    assert "max advantage" in table and len(table.splitlines()) == 2 + len(got.medians) + 1


def test_fig3_trace_matches_jax():
    import benchmarks.fig3_trace as b3

    want = b3.run()
    got = figures.fig3_trace(device="cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, atol=0, err_msg=key)
    np.testing.assert_allclose(got["theta_trace"][0], [1 / 9, 3 / 9, 5 / 9], rtol=1e-12)
    ct = got["completion_times"]
    assert ct[2] <= ct[1] <= ct[0]


def test_figures_main_prints_both(capsys):
    assert figures.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Fig 3" in out and "max advantage" in out and "cpu" in out
