"""Plain reference of the multi-class online model: the draw of a multi-class
tape, class-weighted water-filling with per-job exponents and weights, and
the event loop in which every job runs at its own exponent.

Written from Berg, Moseley, Wang and Harchol-Balter, "Asymptotically Optimal
Scheduling of Multiple Parallelizable Job Classes" (arXiv:2404.00346): jobs
of class k served by ``n`` of ``N`` divisible servers run at ``n^p_k``.  In
plain PyTorch; it imports nothing of the program.  Every function works row
by row on ``[C, M]`` tensors of any float dtype: in float64 it is what the
benchmark holds the program against, in float32 the control that has to
fail.

Where it departs from the published description:

- the paper's water-filling is stated for a fixed set of jobs; here it is
  re-solved at every arrival and departure over the jobs present, the
  online heuristic the repository's grid runs;
- the weight of a job is its class's ``weight`` (1.0 in every class of the
  benchmarked grid);
- a job departs when it is the first to finish or its size falls to 1e-9
  of the row's largest job, and the clock is pinned to an arrival it lands
  on, ties going to the arrival (the conventions of
  ``scheduler.completion_times``).
"""

from __future__ import annotations

import torch


def draw(gen: torch.Generator, rates, n_jobs: int, classes) -> tuple:
    """Sizes, arrival times and class marks ``[R, M]`` of one seed, float64
    and int64, from ``gen`` (a grid seed's generator): ``M`` uniforms for
    the class marks (the mix's cumulative shares, searched to the right),
    ``M`` Exp(1) gaps scaled by each rate, then ``M`` uniforms for the
    sizes ``scale_k * u^(-1/alpha_k)``; the marks and sizes are shared by
    every rate."""
    dev = gen.device

    def field(name, ids=None):
        v = torch.tensor([c[name] for c in classes], dtype=torch.float64, device=dev)
        return v if ids is None else v[ids]

    mix = field("mix")
    cdf = torch.cumsum(mix / mix.sum(), 0)
    u = torch.rand(n_jobs, dtype=torch.float64, device=dev, generator=gen)
    ids = torch.searchsorted(cdf, u, right=True).clamp(max=len(classes) - 1)
    gaps = torch.empty(n_jobs, dtype=torch.float64, device=dev).exponential_(generator=gen)
    rate = torch.as_tensor(rates, dtype=torch.float64, device=dev).reshape(-1, 1)
    arrivals = torch.cumsum(gaps / rate, -1)
    alpha, scale = field("size_alpha", ids), field("size_scale", ids)
    v = torch.rand(n_jobs, dtype=torch.float64, device=dev, generator=gen)
    sizes = scale * v.clamp(min=torch.finfo(torch.float64).tiny) ** (-1.0 / alpha)
    return sizes.expand_as(arrivals), arrivals, ids.expand_as(arrivals)


def waterfill(x: torch.Tensor, p: torch.Tensor, w: torch.Tensor, n_servers: float) -> torch.Tensor:
    """Shares ``theta`` of the jobs with ``x > 0`` that maximize ``sum_i
    w_i / x_i (theta_i N)^p_i`` under ``sum theta = 1``.

    The optimum meets its KKT condition ``w_i p_i N^p_i theta_i^(p_i - 1) /
    x_i = lambda``, so ``theta_i = exp((a_i - mu) / (1 - p_i))`` with ``a_i =
    log(w_i p_i N^p_i / x_i)`` and ``mu = log lambda`` the root of ``f(mu) =
    sum theta_i - 1``, which falls and is convex.  Newton's method from
    ``mu = max a_i``, where ``f >= 0``, climbs to the root without passing it;
    each row stops when a step no longer raises its ``mu``, and no ``mu``
    passes ``max a_i + (1 - min p_i) log m``, where ``f <= 0``.  The shares are
    then divided by their sum."""
    active = x > 0
    a = torch.where(active, torch.log(w) + torch.log(p) + p * torch.log(
        torch.tensor(n_servers, dtype=x.dtype, device=x.device)) - torch.log(
        torch.where(active, x, 1.0)), -torch.inf)
    inv = torch.where(active, 1.0 / (1.0 - p), 0.0)
    m = active.sum(-1, keepdim=True)
    some = m > 0
    mu = torch.where(some, a.amax(-1, keepdim=True), 0.0)
    p_min = torch.where(active, p, 1.0).amin(-1, keepdim=True)
    cap = mu + (1.0 - p_min) * torch.log(m.clamp(min=1).to(x.dtype))

    def shares(mu):
        return torch.where(active, torch.exp((a - mu) * inv), 0.0)

    going = some.clone()
    for _ in range(200):  # a guard: Newton's steps stop after a few dozen
        th = shares(mu)
        step = (th.sum(-1, keepdim=True) - 1.0) / (th * inv).sum(-1, keepdim=True)
        nxt = torch.minimum(mu + step, cap)
        going = going & (nxt > mu)
        if not bool(going.any()):
            break
        mu = torch.where(going, nxt, mu)
    th = shares(mu)
    return th / th.sum(-1, keepdim=True).clamp(min=torch.finfo(x.dtype).tiny)


def completion_times(x0: torch.Tensor, arrivals: torch.Tensor, p: torch.Tensor,
                     w: torch.Tensor, n_servers: float) -> torch.Tensor:
    """Departure time of every job of every row (``inf`` if it never left)
    under water-filling: at each event the jobs present get
    :func:`waterfill`'s shares of ``n_servers`` and job ``i`` runs at rate
    ``(theta_i N)^p_i`` to the next arrival or departure.  ``p`` and ``w``
    are per job, in the order of ``x0``.  Every job arrives once and departs
    once: ``2M`` steps."""
    C, M = x0.shape
    dev, dtype = x0.device, x0.dtype
    order = torch.argsort(arrivals, dim=-1, stable=True)
    arr, x = arrivals.gather(-1, order), x0.gather(-1, order)
    p, w = p.to(dtype).gather(-1, order), w.to(dtype).gather(-1, order)
    tol = 1e-9 * x0.amax(-1, keepdim=True)  # the program's rel_tol
    idx = torch.arange(M, device=dev)
    admitted = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    t = torch.zeros((C, 1), dtype=dtype, device=dev)
    done = torch.zeros((C, M), dtype=dtype, device=dev)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    for _ in range(2 * M):
        active = (idx < admitted) & (x > 0)
        theta = waterfill(torch.where(active, x, 0.0), p, w, n_servers)
        k = theta * n_servers
        rate = torch.where(k > 0, k ** p, 0.0)
        finish = torch.where(active & (rate > 0), x / rate, inf)
        dt_dep = finish.amin(-1, keepdim=True)
        first = finish.argmin(-1, keepdim=True)
        t_arr = torch.where(admitted < M, arr.gather(-1, admitted.clamp(max=M - 1)), inf)
        dt_arr = (t_arr - t).clamp(min=0.0)
        dt = torch.minimum(dt_dep, dt_arr)
        moved = torch.isfinite(dt)
        dt = torch.where(moved, dt, 0.0)
        arrival = moved & (dt_arr <= dt_dep)
        departure = moved & (dt_dep <= dt_arr)
        t_new = torch.where(arrival, t_arr, t + dt)
        x_new = torch.where(active, x - dt * rate, x)
        gone = ((idx == first) & active & departure) | (active & (x_new <= tol))
        x_new = torch.where(gone, 0.0, x_new)
        done = torch.where(active & (x_new == 0.0), t_new, done)
        admitted = torch.maximum(admitted, torch.searchsorted(arr, t_new, right=True))
        x, t = x_new, t_new
    done = torch.where(x > 0, inf, done)
    return torch.zeros_like(done).scatter_(-1, order, done)


def answers(x0, arrivals, ids, classes, n_servers: float, dtype=torch.float64) -> dict:
    """Each row's mean flow time, mean slowdown (a job's flow over its time
    alone on all ``n_servers``, ``x0 / N^p_k``), makespan and per-class
    mean flow time ``[C, K]`` (``nan`` for a class with no job), in
    float64, from tapes ``[C, M]`` computed in ``dtype``."""
    dev = x0.device
    p = torch.tensor([c["p"] for c in classes], dtype=torch.float64, device=dev)[ids]
    w = torch.tensor([c["weight"] for c in classes], dtype=torch.float64, device=dev)[ids]
    x, arr = x0.to(dtype), arrivals.to(dtype)
    times = completion_times(x, arr, p.to(dtype), w.to(dtype), n_servers).to(torch.float64)
    flows = times - arr.to(torch.float64)
    slow = flows * n_servers ** p / x.to(torch.float64)
    per_class = []
    for k in range(len(classes)):
        mine = ids == k
        n = mine.sum(-1)
        total = torch.where(mine, flows, 0.0).sum(-1)
        per_class.append(torch.where(n > 0, total / n.clamp(min=1), torch.nan))
    return {"mean_flowtime": flows.mean(-1), "mean_slowdown": slow.mean(-1),
            "makespan": times.amax(-1), "class_flowtime": torch.stack(per_class, -1)}
