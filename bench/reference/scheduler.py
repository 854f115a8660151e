"""Plain reference of the heSRPT scheduler path: heSRPT's shares, the rounding
to whole chips, and the event loop that turns job tapes into completion times.

Written from the paper (Berg, Vesilo, Harchol-Balter, "heSRPT: Optimal
Parallel Scheduling of Jobs With Known Sizes", arXiv:1903.09346) and the
semantics the scheduler documents, in plain PyTorch.  It imports nothing of
the program.  Every function works row by row on ``[C, M]`` tensors of any
float dtype: run in float64 it is what the benchmark holds the program
against; run in float32 it is the control that has to fail.

The conventions that decide ties are part of the semantics, so they are
spelled out here:

- ranks: descending remaining size, ties by job index (a stable sort);
- heSRPT's brackets ``(r/m)^c - ((r-1)/m)^c`` with ``c = 1/(1-p)``, the
  power multiplied out for ``c`` in {1, 2, 3};
- whole chips: largest remainder with a one-chip floor; when more jobs are
  active than chips, the largest shares are kept and renormalized by a fixed
  pairwise sum; a floor that overflows the pool is trimmed one chip a job a
  round, each round in ascending order of fractional part; leftover chips
  go by descending fractional part (every order stable by job index);
- the loop: each step advances every row to its next arrival or departure,
  ties to the arrival, and pins the clock to an arrival it lands on; a job
  departs when it is the first to finish or its size falls to ``rel_tol``
  of the row's largest job.
"""

from __future__ import annotations

import torch


def stable_positions(key: torch.Tensor) -> torch.Tensor:
    """Position of each entry of a row in the row's stable ascending sort."""
    order = torch.argsort(key, dim=-1, stable=True)
    pos = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def ranks_desc(x: torch.Tensor) -> torch.Tensor:
    """1-based rank of each job with ``x > 0`` by descending size; 0 elsewhere."""
    active = x > 0
    pos = stable_positions(torch.where(active, -x, torch.inf))
    return torch.where(active, pos + 1, 0)


def _power(b: torch.Tensor, c: float) -> torch.Tensor:
    if c == 1.0:
        return b
    if c == 2.0:
        return b * b
    if c == 3.0:
        return b * b * b
    return b.pow(torch.tensor(c, dtype=b.dtype))


def hesrpt(x: torch.Tensor, p: float) -> torch.Tensor:
    """heSRPT's shares (the paper's Theorem 7)."""
    active = x > 0
    r = ranks_desc(x).to(x.dtype)
    m = active.sum(-1, keepdim=True).clamp(min=1).to(x.dtype)
    c = 1.0 / (1.0 - p)
    theta = _power(r / m, c) - _power((r - 1.0) / m, c)
    return torch.where(active, theta, 0.0)


def pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Row sums as a fixed tree: zero-pad to the next power of two at least
    32, then add neighbours until one entry is left.  ``[C, 1]``."""
    n = max(32, 1 << max(v.shape[-1] - 1, 0).bit_length())
    v = torch.nn.functional.pad(v, (0, n - v.shape[-1]))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v


def whole_chips(theta: torch.Tensor, n_chips: int, min_chips: int = 1) -> torch.Tensor:
    """Shares rounded to whole chips that sum to ``n_chips`` (int64), by the
    largest remainder with a floor of ``min_chips`` a job, in four steps:

    1. a row with more active jobs than ``n_chips // min_chips`` keeps that
       many of its largest shares and renormalizes them;
    2. every active job gets the floor of its share of ``n_chips``, and at
       least ``min_chips``;
    3. where those floors overflow the pool, chips come off the jobs above
       the floor one a round, each round in ascending fractional part,
       until the excess is gone;
    4. the chips left over go one each by descending fractional part.
    """
    inf = torch.tensor(torch.inf, dtype=theta.dtype, device=theta.device)
    positive = theta > 0
    cap = n_chips // min_chips
    crowded = positive.sum(-1, keepdim=True) > cap
    kept = torch.where(positive & (stable_positions(torch.where(positive, -theta, inf)) < cap),
                       theta, 0.0)
    total = pairwise_sum(kept)
    share = torch.where(crowded, torch.where(total > 0, kept / total, 0.0), theta)
    active = share > 0
    raw = share * n_chips
    frac = raw - torch.floor(raw)
    chips = torch.where(active, torch.floor(raw).clamp(min=min_chips), 0.0).to(torch.int64)

    # Step 3 as a water level: round i takes a chip from every job with more
    # than i - 1 chips above the floor, so after i rounds T(i) = sum min(room,
    # i) chips are gone.  With the rooms sorted, T is linear between two
    # rooms: find the first sorted room where T reaches the excess, and the
    # round r inside that stretch; rounds 1..r-1 go whole, round r in part.
    excess = (chips.sum(-1, keepdim=True) - n_chips).clamp(min=0)
    room = (chips - min_chips).clamp(min=0)
    sorted_room = room.sort(-1).values
    below = sorted_room.cumsum(-1) - sorted_room  # the rooms smaller in the order
    higher = room.shape[-1] - torch.arange(room.shape[-1], device=room.device)  # this and after
    reached = below + higher * sorted_room >= excess
    k = reached.to(torch.int64).argmax(-1, keepdim=True)
    need = excess - below.gather(-1, k)
    r = torch.where(excess > 0, (need + higher[k] - 1) // higher[k], 0)
    whole = torch.minimum(room, (r - 1).clamp(min=0))
    last = excess - whole.sum(-1, keepdim=True)
    in_last = (room >= r) & (room > 0)
    first_up = stable_positions(torch.where(in_last, frac, inf)) < last
    chips = chips - whole - (in_last & first_up).to(chips.dtype)

    left = n_chips - chips.sum(-1, keepdim=True)
    largest = stable_positions(torch.where(active, -frac, inf)) < left
    return chips + (active & largest).to(chips.dtype)


def completion_times(x0: torch.Tensor, arrivals: torch.Tensor, p: float, n_servers: float,
                     allocate, *, n_chips: int | None = None, min_chips: int = 1,
                     rel_tol: float = 1e-9) -> torch.Tensor:
    """Departure time of every job of every row (``inf`` if it never left).

    ``allocate(x_active) -> theta`` gives the shares; a job served by ``k``
    servers (``theta * n_servers``, or its whole chips when ``n_chips`` is
    set) runs at rate ``k^p``.  Every job arrives once and departs once:
    ``2M`` steps.
    """
    C, M = x0.shape
    dev, dtype = x0.device, x0.dtype
    order = torch.argsort(arrivals, dim=-1, stable=True)
    arr = arrivals.gather(-1, order)
    x = x0.gather(-1, order)
    tol = rel_tol * x0.amax(-1, keepdim=True)
    idx = torch.arange(M, device=dev)
    admitted = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    t = torch.zeros((C, 1), dtype=dtype, device=dev)
    done = torch.zeros((C, M), dtype=dtype, device=dev)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    for _ in range(2 * M):
        active = (idx < admitted) & (x > 0)
        theta = allocate(torch.where(active, x, 0.0)).to(dtype)
        k = theta * n_servers if n_chips is None else whole_chips(theta, n_chips, min_chips).to(dtype)
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

