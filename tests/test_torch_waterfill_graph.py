"""Water-filling's bisection replayed as one CUDA graph
(``policies.BisectGraph``), and the sweep seeds' generators built from
their spawn keys (``scenarios.seed_generator``).

On the CPU: a graph is ignored (the plain bisection bit for bit), each of
the two fixed-shape engine rules hands one graph to every call and the
cluster scheduler's variable-shape call none, and each seed's generator
has the state of the spawn tree's child.  The ``cuda`` tests hold the
graph against the plain bisection on a card, call after call through one
graph, across a change of shape, and a water-filling sweep with and
without it, bit for bit.

The file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_waterfill_graph.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import estimation, multiclass, policies, scenarios
from repro_torch.core.sweeps import Sweep, run_sweep
from repro_torch.lanes import class_grid

CPU = torch.device("cpu")
N = 256.0


def _batch(rows, m, seed, device, *, per_job_w=True, idle_rows=1):
    """Sizes with departed jobs and ``idle_rows`` rows with none active,
    per-job exponents of four classes and per-job weights."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand(rows, m, generator=g, dtype=torch.float64) * 10.0
    x = torch.where(torch.rand(rows, m, generator=g, dtype=torch.float64) < 0.3, 0.0, x)
    x[:idle_rows] = 0.0
    ids = torch.randint(0, 4, (rows, m), generator=g)
    p = torch.tensor([0.3, 0.4833, 0.6667, 0.85], dtype=torch.float64)[ids]
    w = torch.rand(rows, m, generator=g, dtype=torch.float64) + 0.5 if per_job_w else None
    return x.to(device), p.to(device), None if w is None else w.to(device)


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("per_job_w", [True, False])
def test_graph_is_ignored_off_the_card(per_job_w):
    x, p, w = _batch(5, 33, 1, CPU, per_job_w=per_job_w)
    want = policies.waterfill(x, p, N, w)
    graph = policies.BisectGraph()
    got = policies.waterfill(x, p, N, w, graph=graph)
    assert torch.equal(got, want)
    assert graph._key is None  # nothing captured


@pytest.mark.parametrize("rule", ["class_rule", "estimating_class_rule"])
def test_the_engine_rules_ask_for_the_graph(rule, monkeypatch):
    seen = []
    waterfill = policies.waterfill

    def spy(x, p, n_servers, w=None, **kw):
        seen.append(kw.get("graph"))
        return waterfill(x, p, n_servers, w, **kw)

    monkeypatch.setattr(multiclass, "waterfill", spy)
    x, p, _ = _batch(4, 16, 2, CPU)
    if rule == "class_rule":
        step = multiclass.class_rule("waterfill", n_servers=N)
    else:
        ids = torch.randint(0, 4, (4, 16), generator=torch.Generator().manual_seed(0))
        srule = estimation.estimating_class_rule("waterfill", class_ids=ids, n_classes=4,
                                                 prior_p=0.5, n_servers=N)

        def step(x, p):
            return srule.allocate(srule.init(), x, p)
    for _ in range(2):
        theta, _ = step(x, p)
        assert torch.isfinite(theta).all()
    assert len(seen) == 2 and seen[0] is seen[1]
    assert isinstance(seen[0], policies.BisectGraph)


def test_the_cluster_schedulers_call_takes_no_graph(monkeypatch):
    seen = []
    waterfill = policies.waterfill

    def spy(x, p, n_servers, w=None, **kw):
        seen.append(kw.get("graph"))
        return waterfill(x, p, n_servers, w, **kw)

    monkeypatch.setattr(multiclass, "waterfill", spy)
    x, p, w = _batch(1, 9, 3, CPU, idle_rows=0)
    multiclass.class_theta("waterfill", x[0], p[0], n_servers=64.0, w=w[0])
    assert seen == [None]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, 3500007919])
def test_seed_generator_is_the_spawn_trees_child(seed):
    for index in (0, 1, 2, 17, 255, 1023):
        child = np.random.SeedSequence(seed).spawn(index + 1)[index]
        want = torch.Generator().manual_seed(int(child.generate_state(1)[0]))
        got = scenarios.seed_generator(seed, index, device="cpu")
        assert torch.equal(got.get_state(), want.get_state())


def test_a_sweeps_tapes_do_not_move():
    # The first, a middle and the last seed of a 40-seed draw, each drawn
    # alone from the spawn tree's child.
    spec = Sweep.create(("waterfill",), (0.5, 8.0), scenario="multiclass_poisson", n_jobs=30,
                        n_seeds=40, seed=2**31 + 5, n_servers=N, classes=class_grid(4))
    from repro_torch.core.sweeps import draw_scenario

    scn = draw_scenario(spec, device="cpu")
    sampler = scenarios.make_scenario("multiclass_poisson", classes=spec.classes)
    for s in (0, 19, 39):
        child = np.random.SeedSequence(spec.seed).spawn(s + 1)[s]
        gen = torch.Generator().manual_seed(int(child.generate_state(1)[0]))
        one = sampler(gen, 30, spec.rates)
        assert torch.equal(scn.x0[:, s], one.x0)
        assert torch.equal(scn.arrival_times[:, s], one.arrival_times)
        assert torch.equal(scn.class_ids[:, s], one.class_ids)


# ------------------------------------------------------------ on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(("rows", "m", "per_job_w"),
                         [(3, 7, True), (64, 1000, True), (192, 1000, False), (5, 4097, True)])
def test_graph_is_the_plain_bisection_on_a_card(rows, m, per_job_w):
    dev = _card()
    graph = policies.BisectGraph()
    for seed in range(4):  # one capture, then replays on new data
        x, p, w = _batch(rows, m, 100 + seed, dev, per_job_w=per_job_w)
        want = policies.waterfill(x, p, N, w)
        got = policies.waterfill(x, p, N, w, graph=graph)
        assert torch.equal(got, want)
        assert graph._key[0] == (rows, m)


@pytest.mark.cuda
def test_a_graph_captures_anew_when_the_shape_changes():
    dev = _card()
    graph = policies.BisectGraph()
    for rows, m in [(2, 10), (2, 10), (7, 33), (7, 33), (2, 10)]:
        x, p, w = _batch(rows, m, rows * m, dev)
        assert torch.equal(policies.waterfill(x, p, N, w, graph=graph),
                           policies.waterfill(x, p, N, w))
        assert graph._key[0] == (rows, m)


@pytest.mark.cuda
def test_a_water_filling_sweep_with_and_without_the_graph(monkeypatch):
    dev = _card()
    spec = Sweep.create(("waterfill",), (0.5, 2.0, 8.0), scenario="multiclass_poisson",
                        n_jobs=200, n_seeds=16, seed=2**31 + 77, n_servers=N,
                        classes=class_grid(4),
                        metrics=("mean_flowtime", "mean_slowdown", "makespan", "class_flowtime"))
    graphed = run_sweep(spec, log=False, device=dev).stats["waterfill"]
    monkeypatch.setattr(multiclass, "BisectGraph", lambda: None)  # the plain bisection
    plain = run_sweep(spec, log=False, device=dev).stats["waterfill"]
    for m in spec.metrics:
        np.testing.assert_array_equal(graphed[m], plain[m])
