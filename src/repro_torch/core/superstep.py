"""Closed-form epoch fusion: the arrival-superstep path.

Port of ``repro.core.superstep``, row-batched over ``[C, M]`` cells.  The
generic loop (``engine.run``) pays one full allocate per event, departures
included.  For the continuous uniform-``p`` power-law family the whole
trajectory of the jobs present is known in closed form (Thm 3/8, the
bracket geometry of ``flowtime.epoch_schedule``), so every departure
between two arrivals is computed analytically:

- :func:`batch_result_closed_form` — an all-present batch takes no loop
  step: one stable sort, one suffix-sum pass, and the exact remaining
  sizes ``x_i(t)`` at any requested times;
- :func:`run_superstep` — online tapes take one step per arrival plus one
  final drain step (``M + 1`` against the generic ``2M``).  Like
  ``engine.run_ranked`` it carries descending-size ranks: departures drop
  the highest ranks and an arrival inserts one, so a step is elementwise
  work, gathers and two cumulative sums, with no sort and no host sync.

Exact here: continuous allocation, scalar ``p`` or scalar drift regimes
(``engine.PDrift``: each row's next boundary is a superstep event of its
own, and each regime has its own bracket table), heSRPT / EQUI / SRPT and
the cumulative-weight ``weighted_hesrpt`` (when weights do not increase
with size; not under drift, as in the JAX package).  Everything else takes
the generic loop.

Ties match ``run_ranked``: tied sizes get adjacent ranks by arrival order,
so under SRPT per-job times permute within a tied group against the generic
loop's ``argmin`` while totals agree; under heSRPT and EQUI they agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import EngineResult, _cells, _drift_rows, _per_job_rows
from repro_torch.core.flowtime import epoch_schedule, rank_bracket_powers, speedup
from repro_torch.core.ranking import ranks_from_order, size_order_desc

SUPERSTEP_POLICIES = ("hesrpt", "equi", "srpt", "weighted_hesrpt")
#: The ones an unweighted ``engine.continuous_rule`` (and so a sweep) can name.
SUPERSTEP_RULE_POLICIES = SUPERSTEP_POLICIES[:3]


def _validate(policy: str, p, weights, p_drift) -> None:
    """Refuse what the closed form cannot represent."""
    if policy not in SUPERSTEP_POLICIES:
        raise ValueError(
            f"superstep path supports {SUPERSTEP_POLICIES}, got {policy!r} "
            "— other policies take the generic per-event loop (engine.run)"
        )
    if policy == "weighted_hesrpt" and weights is None:
        raise ValueError("weighted_hesrpt needs per-job weights")
    if isinstance(p, torch.Tensor) and p.ndim != 0:
        raise ValueError(
            "superstep path needs a scalar p — per-job exponents break the "
            "rank-order departure invariant; use the generic engine.run loop"
        )
    if p_drift is not None:
        if policy == "weighted_hesrpt":
            raise ValueError(
                "weighted_hesrpt + p_drift is not wired on the superstep "
                "path; use the generic engine.run loop"
            )
        if _per_job_rows(p_drift):
            raise ValueError(
                "superstep path needs scalar drift regimes — per-job drift "
                "rows take the generic engine.run loop"
            )


def _bracket_powers(M, p, policy, dtype, device, weights_rank=None):
    """``(a_r^p, A_r^p)`` per rank (``[K, M]`` for a ``[K, 1]`` tensor
    ``p``); SRPT's epoch geometry reads neither, so it gets ones."""
    if policy == "srpt":
        one = torch.ones(M, dtype=dtype, device=device)
        return one, one
    return rank_bracket_powers(
        M, p, policy, weights_rank=weights_rank, dtype=dtype, device=device
    )


def _gap_advance(x_rank, v, T, ap, Ap, rank_active, dt, sN, *, srpt: bool):
    """Advance the rank-space batch ``[C, M]`` through elapsed times
    ``dt[C, 1]``.

    Ranks whose offset ``T_r <= dt`` depart; survivors move to their exact
    remaining size at ``dt``: bracket policies through the virtual time
    ``tau = v_{m'+1} + (dt - T_{m'+1}) s(N) / A_{m'}^p`` (``m'`` the
    surviving count, ``x_r -> x_r - a_r^p tau``); under SRPT only rank
    ``m'`` shrinks, by ``(dt - T_{m'+1}) s(N)``.  Returns ``(x_new, departed)``.
    """
    M = x_rank.shape[-1]
    idx = torch.arange(M, device=x_rank.device)
    dep = rank_active & (T <= dt)
    n_dep = dep.sum(-1, keepdim=True)
    m2 = rank_active.sum(-1, keepdim=True) - n_dep
    i_last = m2.clamp(0, M - 1)  # rank m2 + 1 sits at index m2
    T_start = torch.where(n_dep > 0, T.gather(-1, i_last), 0.0)
    elapsed = torch.clamp(dt - T_start, min=0.0)
    if srpt:
        x_new = torch.where(idx == m2 - 1, x_rank - elapsed * sN, x_rank)
    else:
        v_start = torch.where(n_dep > 0, v.gather(-1, i_last), 0.0)
        A_m2 = Ap.expand_as(x_rank).gather(-1, (m2 - 1).clamp(min=0))
        tau = torch.where(m2 > 0, v_start + elapsed * sN / A_m2, 0.0)
        x_new = x_rank - ap * tau
    return torch.where(dep | ~rank_active, 0.0, torch.clamp(x_new, min=0.0)), dep


class BatchClosedForm(NamedTuple):
    completion_times: torch.Tensor  # [..., M] absolute, input order
    sizes_at: torch.Tensor | None  # [..., K, M] remaining sizes at eval_times


def batch_result_closed_form(
    x, p, policy: str = "hesrpt", *, n_servers, weights=None, t0=0.0, eval_times=None,
) -> BatchClosedForm:
    """Thm-3/8 completion times and trajectory of all-present batches.

    ``x[..., M]`` (a tensor: it sets the device); one stable descending
    sort a row, then the suffix-sum geometry of ``flowtime.epoch_schedule``.
    Completion times come back in input order (zero-size jobs report 0, as
    in the generic loop, which never activates them).  With ``eval_times``
    (``[K]``, absolute), ``sizes_at[..., k, i]`` is job ``i``'s exact
    remaining size at ``eval_times[k]``.  ``weighted_hesrpt`` reads per-job
    ``weights`` (input order).
    """
    _validate(policy, p, weights, None)
    x = torch.as_tensor(x)
    dtype = x.dtype if x.is_floating_point() else torch.float64
    x = x.to(dtype)
    M = x.shape[-1]
    order = torch.argsort(-x, dim=-1, stable=True)  # ties by index, zeros last
    x_desc = x.gather(-1, order)
    rank_active = x_desc > 0
    srpt = policy == "srpt"
    w_rank = None
    if policy == "weighted_hesrpt":
        w = torch.as_tensor(weights, dtype=dtype, device=x.device).expand_as(x)
        w_rank = torch.where(rank_active, w.gather(-1, order), 0.0)
    ap, Ap = _bracket_powers(M, p, policy, dtype, x.device, weights_rank=w_rank)
    v, T = epoch_schedule(x_desc, ap, Ap, rank_active, p, n_servers, srpt=srpt)
    times = torch.zeros_like(x).scatter_(-1, order, torch.where(rank_active, t0 + T, 0.0))
    sizes = None
    if eval_times is not None:
        sN = speedup(torch.as_tensor(n_servers, dtype=dtype, device=x.device), p)
        ts = torch.as_tensor(eval_times, dtype=dtype, device=x.device).reshape(-1)
        at = []
        for tq in ts:
            dt = torch.clamp(tq - t0, min=0.0).expand(*x.shape[:-1], 1)
            x_new, _ = _gap_advance(x_desc, v, T, ap, Ap, rank_active, dt, sN, srpt=srpt)
            at.append(torch.zeros_like(x).scatter_(-1, order, x_new))
        sizes = torch.stack(at, -2)
    return BatchClosedForm(completion_times=times, sizes_at=sizes)


def run_superstep(
    x0, arrival_times, p, n_servers, policy: str = "hesrpt", *, weights=None,
    pre_arrived: bool = False, horizon: int | None = None, t0=0.0, p_drift=None,
) -> EngineResult:
    """The arrival-superstep loop over every cell of ``[..., M]`` tapes.

    Same contract as ``engine.run`` over ``continuous_rule`` for the
    supported family, and the same :class:`~repro_torch.core.engine.EngineResult`
    (``trace`` None).  ``pre_arrived=True`` without drift takes no step
    (:func:`batch_result_closed_form`); online tapes take ``M + 1`` by
    default, plus one a drift boundary.  A step admits one arrival, so
    simultaneous arrivals each take a zero-length step of their own.  ``p``
    is a scalar; ``p_drift`` (scalar regimes, ``engine.PDrift``) supersedes
    it, and a pre-arrived batch under drift takes the loop (``D + 1``
    steps) from its rank-space start.
    """
    _validate(policy, p, weights, p_drift)
    x0, arr_in, lead, dtype = _cells(x0, arrival_times)
    C, M = x0.shape
    dev = x0.device
    order = torch.argsort(arr_in, dim=-1, stable=True)
    w_in = None
    if weights is not None:
        w_in = torch.as_tensor(weights, dtype=dtype, device=dev).expand(*lead, M).reshape(C, M)

    if pre_arrived and p_drift is None:
        batch = batch_result_closed_form(
            x0, p, policy, n_servers=n_servers, weights=w_in, t0=t0
        )
        return EngineResult(
            completion_times=batch.completion_times.reshape(*lead, M),
            x_final=torch.zeros_like(x0).reshape(*lead, M),
            order=order.reshape(*lead, M),
        )

    arr = arr_in.gather(-1, order)
    xs = x0.gather(-1, order)
    idx = torch.arange(M, device=dev)
    srpt = policy == "srpt"
    weighted = policy == "weighted_hesrpt"
    drift = None if p_drift is None else _drift_rows(p_drift, lead, dtype, dev)
    n_drift = 0 if drift is None else drift[0].shape[-1] - 1
    E = ((0 if pre_arrived else M) + n_drift + 1) if horizon is None else horizon
    w_arr = w_in.gather(-1, order) if weighted else None
    if drift is not None and not srpt:
        # One bracket table a regime of each row: [C, D + 1, M].
        n_reg = n_drift + 1
        ap_tab, Ap_tab = (
            tab.expand(C * n_reg, M).reshape(C, n_reg, M)
            for tab in _bracket_powers(M, drift[1].reshape(-1, 1), policy, dtype, dev)
        )
    elif not weighted:
        ap, Ap = _bracket_powers(M, p, policy, dtype, dev)
    sN = speedup(torch.as_tensor(n_servers, dtype=dtype, device=dev), p)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)

    # The batch lives in rank space across steps: x_rank[:, r - 1] is the
    # rank-r job's remaining size.  Departures zero a suffix of the active
    # prefix; an arrival shifts the slots past its rank right by one.  The
    # job-space ranks only serve the per-job read-back of departure offsets.
    t = torch.full((C, 1), float(t0), dtype=dtype, device=dev)
    times = torch.zeros((C, M), dtype=dtype, device=dev)
    if pre_arrived:
        # Every job present: descending sizes put the zero-size (never
        # active) jobs in the last slots, where their ranks (0) leave them.
        active0 = xs > 0
        ranks = ranks_from_order(size_order_desc(xs), active0)
        m = active0.sum(-1, keepdim=True)
        i = torch.full((C, 1), M, dtype=torch.int64, device=dev)
        x_rank = torch.sort(xs, dim=-1, descending=True).values
    else:
        ranks = torch.zeros((C, M), dtype=torch.int64, device=dev)
        m = torch.zeros((C, 1), dtype=torch.int64, device=dev)
        i = torch.zeros((C, 1), dtype=torch.int64, device=dev)
        x_rank = torch.zeros((C, M), dtype=dtype, device=dev)
    w_rank = torch.zeros_like(x_rank) if weighted else None

    for _ in range(E):
        active = ranks > 0
        rank_active = idx < m
        p_now = p
        if drift is not None:
            # Each row's regime and its next boundary, as in engine.run.
            r = torch.searchsorted(drift[0], t, right=True)
            p_now = drift[1].gather(-1, r)
            t_next_drift = drift[0].gather(-1, r)
            sN = speedup(torch.as_tensor(n_servers, dtype=dtype, device=dev), p_now)
            if not srpt:
                r_tab = r[:, :, None].expand(C, 1, M)
                ap = ap_tab.gather(1, r_tab).squeeze(1)
                Ap = Ap_tab.gather(1, r_tab).squeeze(1)
        if weighted:
            ap, Ap = _bracket_powers(M, p, policy, dtype, dev, weights_rank=w_rank)
        v, T = epoch_schedule(x_rank, ap, Ap, rank_active, p_now, n_servers, srpt=srpt)
        # The gap to the next arrival (or drift boundary); with none left,
        # every active job departs analytically in this final drain step.
        t_next_arr = torch.where(i < M, arr.gather(-1, i.clamp(max=M - 1)), inf)
        gap_arr = torch.clamp(t_next_arr - t, min=0.0)
        gap = gap_arr
        if drift is not None:
            gap_drift = torch.clamp(t_next_drift - t, min=0.0)
            gap = torch.minimum(gap_arr, gap_drift)
        has_event = torch.isfinite(gap)
        dt_gap = torch.where(has_event, gap, inf)
        x_rank_adv, dep_rank = _gap_advance(
            x_rank, v, T, ap, Ap, rank_active, dt_gap, sN, srpt=srpt
        )
        m2 = m - dep_rank.sum(-1, keepdim=True)
        T_job = T.gather(-1, torch.where(active, ranks - 1, 0))
        dep_job = active & (T_job <= dt_gap)
        times = torch.where(dep_job, t + T_job, times)
        ranks = torch.where(dep_job, 0, ranks)
        # Pin the clock to the exact arrival (or boundary) time; on the
        # drain step jump to the last departure (rank 1's offset).  A
        # boundary that ties with an arrival admits it.
        admit = has_event
        t_event = t_next_arr
        if drift is not None:
            admit = has_event & (gap_arr <= gap_drift)
            t_event = torch.where(gap_arr <= gap_drift, t_next_arr, t_next_drift)
        t_new = torch.where(has_event, t_event, t + T[:, :1])
        # Admission, as in run_ranked: job i goes in at its rank among the
        # survivors, losing exact-size ties to them (they arrived earlier).
        # Zero-size arrivals never activate but still take their step.
        i_c = i.clamp(max=M - 1)
        x_a = xs.gather(-1, i_c)
        r_a = 1 + (x_rank_adv >= x_a).sum(-1, keepdim=True)
        place = admit & (x_a > 0)
        bumped = torch.where((ranks > 0) & (ranks >= r_a), ranks + 1, ranks)
        ranks = torch.where(place, bumped.scatter(-1, i_c, r_a), ranks)
        x_rank = torch.where(place, _insert(x_rank_adv, x_a, r_a, idx), x_rank_adv)
        if weighted:
            w_adv = torch.where(idx < m2, w_rank, 0.0)
            w_rank = torch.where(place, _insert(w_adv, w_arr.gather(-1, i_c), r_a, idx), w_adv)
        m = m2 + place.to(m.dtype)
        i = i + admit.to(i.dtype)
        t = t_new

    # Never departed (horizon cut) or never admitted: inf, as the generic
    # loop reports (admission runs in arrival order, so job j was admitted
    # iff j < i).
    never_admitted = (idx >= i) & (xs > 0)
    times = torch.where((ranks > 0) | never_admitted, inf, times)
    x_fin = torch.where(
        ranks > 0,
        x_rank.gather(-1, torch.where(ranks > 0, ranks - 1, 0)),
        torch.where(never_admitted, xs, 0.0),
    )
    return EngineResult(
        completion_times=torch.zeros_like(times).scatter_(-1, order, times).reshape(*lead, M),
        x_final=x_fin.reshape(*lead, M),
        order=order.reshape(*lead, M),
    )


def _insert(row, value, r, idx):
    """``row`` with ``value`` put at slot ``r - 1`` and the slots from there
    on shifted right by one (the slot past the active prefix is zero)."""
    shifted = torch.nn.functional.pad(row[..., :-1], (1, 0))
    return torch.where(idx == r - 1, value, torch.where(idx < r - 1, row, shifted))


__all__ = [
    "SUPERSTEP_POLICIES",
    "SUPERSTEP_RULE_POLICIES",
    "BatchClosedForm",
    "batch_result_closed_form",
    "run_superstep",
]
