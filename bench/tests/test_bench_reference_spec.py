"""The plain reference held against formulations of its rules that share no
code with it or with the program: the rounding to whole chips written one
chip at a time in plain Python, the batch loop against the paper's closed
form, and the online loop against a per-job event simulation in plain
Python.  The program's rounding is held against the same plain rule."""

import math

import numpy as np
import pytest
import torch

from bench.reference import scheduler


# ------------------------------------------------------------ whole chips
def _tree_sum(values):
    """The fixed pairwise sum the rule renormalizes by: zero-pad to a power
    of two of at least 32, then add neighbours."""
    n = max(32, 1 << max(len(values) - 1, 0).bit_length())
    v = list(values) + [0.0] * (n - len(values))
    while len(v) > 1:
        v = [v[i] + v[i + 1] for i in range(0, len(v), 2)]
    return v[0]


def plain_whole_chips(theta, n_chips, min_chips):
    """The rule, one row, one chip at a time."""
    M = len(theta)
    active = [j for j in range(M) if theta[j] > 0]
    cap = n_chips // min_chips
    share = list(theta)
    if len(active) > cap:
        kept = set(sorted(active, key=lambda j: (-theta[j], j))[:cap])
        vals = [theta[j] if j in kept else 0.0 for j in range(M)]
        total = _tree_sum(vals)
        share = [v / total if total > 0 else 0.0 for v in vals]
    active = [j for j in range(M) if share[j] > 0]
    raw = [share[j] * n_chips for j in range(M)]
    frac = [raw[j] - math.floor(raw[j]) for j in range(M)]
    chips = [max(math.floor(raw[j]), min_chips) if j in active else 0 for j in range(M)]
    excess = sum(chips) - n_chips
    while excess > 0:  # one round: a chip off each job above the floor
        for j in sorted((j for j in range(M) if chips[j] > min_chips),
                        key=lambda j: (frac[j], j)):
            if excess == 0:
                break
            chips[j] -= 1
            excess -= 1
    left = n_chips - sum(chips)
    for j in sorted(active, key=lambda j: (-frac[j], j))[:left]:
        chips[j] += 1
    return chips


def _thetas(seed, rows, M):
    """Shares with the cases the rule has to decide: ties (shares from a
    few values), many tiny shares (floors that overflow), idle jobs, and
    rows more crowded than the pool."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rows):
        kind = r % 4
        if kind == 0:
            t = rng.random(M)
        elif kind == 1:
            t = rng.integers(1, 4, M) / 7.0
        elif kind == 2:
            t = np.where(rng.random(M) < 0.1, rng.random(M) * 50, rng.random(M) * 1e-3)
        else:
            t = rng.pareto(1.5, M)
        t = np.where(rng.random(M) < 0.2, 0.0, t)
        out.append(t / t.sum() if t.sum() > 0 else t)
    return np.stack(out)


@pytest.mark.parametrize(("n_chips", "min_chips", "M"),
                         [(16, 1, 12), (16, 1, 40), (64, 2, 50), (256, 1, 300), (256, 3, 120)])
def test_whole_chips_follows_the_rule_one_chip_at_a_time(n_chips, min_chips, M):
    theta = _thetas(n_chips * 7 + M, 24, M)
    got = scheduler.whole_chips(torch.as_tensor(theta), n_chips, min_chips)
    for row, t in zip(got.tolist(), theta):
        assert row == plain_whole_chips(t.tolist(), n_chips, min_chips)
        assert sum(row) == (n_chips if (t > 0).any() else 0)


@pytest.mark.parametrize(("n_chips", "min_chips"), [(16, 1), (64, 2), (256, 1)])
def test_the_programs_rounding_follows_the_same_rule(n_chips, min_chips):
    from repro_torch.core.engine import quantize_allocation

    theta = _thetas(n_chips + 3, 24, 60)
    got = quantize_allocation(torch.as_tensor(theta), n_chips, min_chips=min_chips)
    for row, t in zip(got.tolist(), theta):
        assert row == plain_whole_chips(t.tolist(), n_chips, min_chips)


# ------------------------------------------------------------ the batch loop
@pytest.mark.parametrize("p", [0.05, 0.3, 0.5, 0.9, 0.99])
def test_batch_loop_meets_theorem_8(p):
    # Every job present at time 0 on N servers: heSRPT's total flow time in
    # the paper's closed form, jobs ranked largest first,
    # T* = s(N)^-1 sum_k x_k (k^c - (k-1)^c)^(1-p), c = 1/(1-p).
    N, M = 1e6, 40
    xs = np.sort(np.random.default_rng(int(p * 100)).pareto(1.5, M) + 1.0)[::-1].copy()
    k = np.arange(1, M + 1, dtype=np.float64)
    c = 1.0 / (1.0 - p)
    want = float((xs * (k ** c - (k - 1) ** c) ** (1 - p)).sum() / N ** p)
    x = torch.as_tensor(xs[None, :])
    times = scheduler.completion_times(x, torch.zeros_like(x), p, N,
                                       lambda v: scheduler.hesrpt(v, p))
    assert float(times.sum()) == pytest.approx(want, rel=1e-10)


# ------------------------------------------------------------ the online loop
def plain_online(sizes, arrivals, p, n_servers, n_chips=None, rel_tol=1e-9):
    """Departure times of one tape, job by job: at each event, heSRPT's
    shares over the jobs present (Theorem 7, ranks by descending size, ties
    by index), rounded to whole chips by the plain rule where ``n_chips``
    is given; every job advances at rate k^p to the next arrival or
    departure, a tie going to the arrival."""
    Mj = len(sizes)
    order = sorted(range(Mj), key=lambda j: (arrivals[j], j))
    arr = [arrivals[j] for j in order]
    x = [sizes[j] for j in order]
    tol = rel_tol * max(sizes)
    done = [math.inf] * Mj
    t, admitted = 0.0, 0
    c = 1.0 / (1.0 - p)
    while True:
        present = [j for j in range(admitted) if x[j] > 0]
        if not present and admitted == Mj:
            break
        m = len(present)
        rank = {j: r + 1 for r, j in enumerate(sorted(present, key=lambda j: (-x[j], j)))}
        theta = [0.0] * Mj
        for j in present:
            hi, lo = rank[j] / m, (rank[j] - 1) / m
            theta[j] = hi * hi - lo * lo if c == 2.0 else hi ** c - lo ** c
        if n_chips is None:
            k = [v * n_servers for v in theta]
        else:
            k = [float(v) for v in plain_whole_chips(theta, n_chips, 1)]
        rate = [k[j] ** p if k[j] > 0 else 0.0 for j in range(Mj)]
        finish = [(x[j] / rate[j], j) for j in present if rate[j] > 0]
        dt_dep, first = min(finish) if finish else (math.inf, -1)
        t_arr = arr[admitted] if admitted < Mj else math.inf
        dt_arr = max(t_arr - t, 0.0)
        dt = min(dt_dep, dt_arr)
        t_new = t_arr if dt_arr <= dt_dep else t + dt
        for j in present:
            x[j] = x[j] - dt * rate[j]
            if (j == first and dt_dep <= dt_arr) or x[j] <= tol:
                x[j] = 0.0
                done[order[j]] = t_new
        t = t_new
        while admitted < Mj and arr[admitted] <= t:
            admitted += 1
    return done


@pytest.mark.parametrize("n_chips", [None, 16])
def test_online_loop_meets_a_job_by_job_simulation(n_chips):
    from bench.reference import tapes

    rates, Mj, p = [0.5, 2.0, 8.0], 24, 0.5
    x0, arr = tapes.poisson_pareto(2**31 + 3, 1, rates, Mj, 1.5, torch.device("cpu"))
    got = scheduler.completion_times(x0, arr, p, 16.0, lambda v: scheduler.hesrpt(v, p),
                                     n_chips=n_chips)
    for r in range(len(rates)):
        want = plain_online(x0[r].tolist(), arr[r].tolist(), p, 16.0, n_chips)
        assert np.allclose(got[r].numpy(), want, rtol=1e-10, atol=0)
