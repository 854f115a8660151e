"""The allocation rules and the event loop behind every simulator.

Port of the sweep path of ``repro.core.engine``.  Theorem 3 makes the
optimal allocation constant between decision epochs, so every trajectory is
one loop: query an allocation rule at an event, advance every job linearly,
repeat.  ``jax.lax.scan`` becomes a Python loop of ``E`` steps and
``jax.vmap`` over cells becomes a leading batch dim: every tensor in the
loop is ``[C, M]`` (or ``[C, 1]`` per cell), and each step is a fixed
sequence of batched ops with no host sync — no ``.item()``, no branch on a
tensor value — so the loop is bound by launches, not by syncs.

- :func:`continuous_rule` — ``theta`` from a policy, rate ``s(theta N)``.
- :func:`quantized_rule` — ``theta`` rounded to whole chips by
  :func:`quantize_allocation` (largest remainder with a min-chips floor),
  rate ``s(chips)``.
- Over the heSRPT policy both carry a ``fused_variant``: the
  ``kernels/alloc.py`` allocate, which :func:`run` swaps in under
  ``fused=True`` (the CUDA kernel on the card, its plain version on CPU).
- :func:`knee_rule` — KNEE with its ``alpha`` refit from the active
  set's median at every event, continuous or whole chips.
- :func:`run_ranked` — the sort-free fast path for the rank policies,
  carrying descending-size ranks across events.
- ``run(superstep=True)`` — the closed-form arrival-superstep path
  (``core/superstep.py``) for :func:`continuous_rule` over heSRPT, EQUI and
  SRPT: ``M + 1`` steps online, none for a batch.
- ``run(p_drift=)`` — a true exponent that changes in time
  (:class:`PDrift`): each row's regime boundaries are events of their own,
  and the rule sees each row's current ``p`` as a ``[C, 1]`` column, which
  the fused allocate hands to the kernel (one exponent a cell).
- :func:`snap_to_slices` — whole chips snapped to power-of-two slices
  (``quantized_rule(snap_slices=True)``, ``knee_rule`` likewise).

Not ported yet (ROADMAP.md Queue A): ``telemetry``, per-job drift rows and
estimation noise (with the multi-class runs), and the bounded-slot
streaming loop.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.core.flowtime import speedup
from repro_torch.core import policies
from repro_torch.core.policies import Policy, hesrpt, knee
from repro_torch.kernels.alloc import (
    hesrpt_alloc_fused,
    hesrpt_theta_fused,
    round_chips,
    stable_positions,
)

# (x_active, p) -> (alloc, rate) per job: theta for continuous rules, integer
# chips for quantized ones.
AllocRule = Callable[[torch.Tensor, Any], tuple[torch.Tensor, torch.Tensor]]

#: Power-of-two slice sizes (:func:`snap_to_slices`; the JAX package's
#: ``engine`` and ``sched.quantize`` share their own copy).
DEFAULT_SLICES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class PDrift(NamedTuple):
    """Piecewise-constant true speedup exponent: regime changes mid-run.

    ``times`` are the ``D`` regime-change epochs (ascending) and ``values``
    the ``D + 1`` scalar regimes, each ``[D]`` / ``[D + 1]`` for every cell
    or ``[..., D]`` / ``[..., D + 1]`` broadcasting over the cells' lead
    dims (a sweep's drift time differs by rate).  Between ``times[r-1]`` and
    ``times[r]`` the physics, and the ``p`` the rule is shown, use
    ``values[r]``.  Per-job regime rows (``values`` ``[D + 1, M]``, more
    dims than ``times``) are the JAX package's multi-class form and are not
    ported yet.
    """

    times: torch.Tensor  # [D] or [..., D] regime-change epochs, ascending
    values: torch.Tensor  # [D + 1] or [..., D + 1] exponent per regime


def _per_job_rows(p_drift: PDrift) -> bool:
    return torch.as_tensor(p_drift.values).ndim > torch.as_tensor(p_drift.times).ndim


class Observation(NamedTuple):
    """What an allocation rule sees after each epoch (per cell row)."""

    alloc: torch.Tensor  # [C, M] allocation held during the epoch
    rate: torch.Tensor  # [C, M] realized service rate
    dt: torch.Tensor  # [C, 1] epoch length (0 on no-op steps)
    active: torch.Tensor  # [C, M] bool, arrived & unfinished this epoch


class StatefulRule(NamedTuple):
    """An allocation rule with loop-carried state: ``(init, observe,
    allocate)``; see ``repro.core.engine.StatefulRule``."""

    init: Callable[[], Any]
    observe: Callable[[Any, Observation], Any]
    allocate: Callable[[Any, torch.Tensor, Any], tuple[torch.Tensor, torch.Tensor]]


def as_stateful(rule: AllocRule | StatefulRule) -> StatefulRule:
    """Wrap a plain ``(x_active, p) -> (alloc, rate)`` rule as the trivial
    :class:`StatefulRule` (empty state, identity ``observe``)."""
    if isinstance(rule, StatefulRule):
        return rule
    return StatefulRule(
        init=lambda: (),
        observe=lambda state, obs: state,
        allocate=lambda state, x_act, p: rule(x_act, p),
    )


class EngineTrace(NamedTuple):
    """Per-event trajectory (arrival-sorted job order, see ``order``)."""

    alloc: torch.Tensor  # [..., E, M] allocation chosen at each event
    times: torch.Tensor  # [..., E] event start times
    sizes: torch.Tensor  # [..., E, M] remaining sizes at each event start


class EngineResult(NamedTuple):
    completion_times: torch.Tensor  # [..., M] absolute departure times, input order
    x_final: torch.Tensor  # [..., M] remaining sizes at horizon, arrival-sorted
    order: torch.Tensor  # [..., M] arrival-sorted permutation used internally
    trace: EngineTrace | None = None  # populated when ``record=True``


# ----------------------------------------------------------- allocation rules
def finish_alloc(
    theta, p, *, n_alloc, n_chips: int | None, min_chips: int = 1,
    snap_slices: bool = False, slices: tuple[int, ...] = DEFAULT_SLICES, dtype,
):
    """The one ``theta -> (alloc, rate)`` tail the rules share: continuous
    (``n_chips`` None, rate ``s(theta n_alloc)``) or whole chips (rate
    ``s(chips)``), optionally snapped to ``slices`` (:func:`snap_to_slices`)."""
    theta = theta.to(dtype)
    if n_chips is None:
        return theta, speedup(theta * n_alloc, p)
    chips = quantize_allocation(theta, n_chips, min_chips=min_chips)
    if snap_slices:
        chips = snap_to_slices(chips, n_chips, slices=slices)
    return chips, speedup(chips.to(dtype), p)


def continuous_rule(policy: Policy, n_servers, *, dtype=torch.float64) -> AllocRule:
    """The paper's continuously-divisible allocation: ``rate = s(theta N)``.

    Over :func:`~repro_torch.core.policies.hesrpt` the rule carries a
    ``fused_variant`` (``kernels/alloc.py::hesrpt_theta_fused``); over
    heSRPT, EQUI and SRPT a ``superstep_spec`` ``(name, n_servers)``, which
    :func:`run` reads under ``superstep=True``.
    """

    def rule(x_act, p):
        return finish_alloc(policy(x_act, p), p, n_alloc=n_servers, n_chips=None, dtype=dtype)

    from repro_torch.core.superstep import SUPERSTEP_RULE_POLICIES

    name = getattr(policy, "__name__", None)
    if name in SUPERSTEP_RULE_POLICIES and policy is getattr(policies, name):
        rule.superstep_spec = (name, n_servers)
    if policy is hesrpt:

        def fused(x_act, p):
            theta = hesrpt_theta_fused(x_act, p).to(dtype)
            return theta, speedup(theta * n_servers, p)

        rule.fused_variant = fused
    return rule


def quantized_rule(
    policy: Policy, n_chips: int, *, min_chips: int = 1, dtype=torch.float64,
    snap_slices: bool = False, slices: tuple[int, ...] = DEFAULT_SLICES,
) -> AllocRule:
    """Whole chips: largest-remainder rounding of ``theta * n_chips``,
    snapped to power-of-two ``slices`` under ``snap_slices=True``.

    Over heSRPT the rule carries a ``fused_variant``: the
    ``kernels/alloc.py`` rank -> theta -> chips pass, chip-exact vs this
    rule, one kernel launch per event on the card (then the snap).
    """

    def rule(x_act, p):
        return finish_alloc(
            policy(x_act, p), p, n_alloc=n_chips, n_chips=n_chips,
            min_chips=min_chips, snap_slices=snap_slices, slices=slices, dtype=dtype,
        )

    if policy is hesrpt:

        def fused(x_act, p):
            _theta, chips = hesrpt_alloc_fused(x_act, p, n_chips, min_chips=min_chips)
            if snap_slices:
                chips = snap_to_slices(chips, n_chips, slices=slices)
            return chips, speedup(chips.to(dtype), p)

        rule.fused_variant = fused
    return rule


def knee_rule(
    n_servers, *, n_chips: int | None = None, min_chips: int = 1,
    snap_slices: bool = False, dtype=torch.float64,
) -> StatefulRule:
    """KNEE with its per-epoch ``alpha`` refit, as an engine rule.

    At every event ``alpha = median(active remaining sizes) * p / N``, the
    masked median being ``np.median``'s over the active subset (the mean of
    the two middle order statistics), so the state stays empty.
    Continuous when ``n_chips`` is None, else whole chips with a min-chips
    floor (optionally slice-snapped), as :func:`continuous_rule` /
    :func:`quantized_rule`.
    """
    n_alloc = float(n_chips) if n_chips is not None else float(n_servers)

    def rule(x_act, p):
        active = x_act > 0
        m = active.sum(-1, keepdim=True).clamp(min=1)
        v = torch.sort(torch.where(active, x_act, torch.inf), dim=-1, stable=True).values
        med = 0.5 * (v.gather(-1, (m - 1) // 2) + v.gather(-1, m // 2))
        theta = knee(x_act, p, n_alloc, med * p / n_alloc)
        return finish_alloc(
            theta, p, n_alloc=n_alloc, n_chips=n_chips, min_chips=min_chips,
            snap_slices=snap_slices, dtype=dtype,
        )

    return as_stateful(rule)


def _resolve_fused(rule, fused: bool):
    """Swap in the rule's fused allocate when ``fused=True``."""
    if not fused:
        return rule
    fused_rule = getattr(rule, "fused_variant", None)
    if fused_rule is None:
        raise ValueError(
            "fused=True needs a rule with a fused_variant — built by "
            "continuous_rule/quantized_rule over the heSRPT policy"
        )
    return fused_rule


def _resolve_superstep(rule, *, fused: bool, record: bool, p, p_drift):
    """The rule's ``(policy_name, n_servers)`` superstep spec, or
    ``ValueError`` for what the closed form cannot represent (that takes the
    generic per-event loop: drop ``superstep=True``)."""
    fallback = " — this configuration takes the generic per-event loop"
    spec = getattr(rule, "superstep_spec", None)
    if spec is None:
        raise ValueError(
            "superstep=True needs a rule with a superstep_spec — built by "
            "continuous_rule over heSRPT/EQUI/SRPT (quantized and stateful "
            "rules have none)" + fallback
        )
    if fused:
        raise ValueError(
            "superstep=True already replaces the loop; fused= fuses the "
            "per-event allocate" + fallback
        )
    if record:
        raise ValueError("record=True needs the per-event trajectory" + fallback)
    if isinstance(p, torch.Tensor) and p.ndim >= 1:
        raise ValueError(
            "superstep=True needs a scalar p (per-job exponents break the "
            "rank-order departure invariant)" + fallback
        )
    if p_drift is not None and _per_job_rows(p_drift):
        raise ValueError("superstep=True supports scalar drift regimes only" + fallback)
    return spec


def _cells(x0, arrival_times):
    """Flatten ``[..., M]`` tapes to ``[C, M]`` rows; returns the lead shape."""
    x0 = torch.as_tensor(x0)
    dtype = x0.dtype if x0.is_floating_point() else torch.float64
    lead = x0.shape[:-1]
    M = x0.shape[-1]
    x0 = x0.to(dtype).reshape(-1, M)
    arr = torch.as_tensor(arrival_times, device=x0.device).to(dtype)
    arr = arr.expand(*lead, M).reshape(-1, M)
    return x0, arr, lead, dtype


def _drift_rows(p_drift: PDrift, lead, dtype, device):
    """``(times, values)`` of every cell row: ``[C, D + 1]`` boundaries
    with a ``+inf`` past the last (so the next boundary is a gather even
    for ``D = 0``) and ``[C, D + 1]`` regimes."""
    if _per_job_rows(p_drift):
        raise NotImplementedError(
            "per-job drift rows (PDrift.values [D + 1, M]) need the per-job p "
            "of multi-class runs, not ported yet (ROADMAP.md Queue A, item 6)"
        )
    times = torch.as_tensor(p_drift.times, device=device).to(dtype)
    values = torch.as_tensor(p_drift.values, device=device).to(dtype)
    D = times.shape[-1]
    if values.shape[-1] != D + 1:
        raise ValueError(f"PDrift needs D + 1 regimes for D boundaries, got "
                         f"{values.shape[-1]} for {D}")
    C = math.prod(lead)
    times = times.expand(*lead, D).reshape(C, D)
    inf = torch.full((C, 1), torch.inf, dtype=dtype, device=device)
    return torch.cat([times, inf], -1), values.expand(*lead, D + 1).reshape(C, D + 1)


# ------------------------------------------------------------ the event loop
def run(
    x0: torch.Tensor,
    arrival_times: torch.Tensor,
    p,
    rule: AllocRule | StatefulRule,
    *,
    pre_arrived: bool = False,
    horizon: int | None = None,
    rel_tol: float = 1e-9,
    t0=0.0,
    record: bool = False,
    p_drift=None,
    fused: bool = False,
    superstep: bool = False,
    telemetry=None,
) -> EngineResult:
    """Run the event-driven fluid trajectory of every cell to completion.

    ``x0``/``arrival_times`` are ``[..., M]`` tapes (any leading cell dims,
    the arrival times may broadcast); the loop runs all cells together for
    ``E = 2M + D`` steps (``M + D`` with ``pre_arrived=True``, ``D`` the
    drift boundaries, or ``horizon``).  Each step advances every cell to its
    next event (the ``min`` of next departure, next arrival and next drift
    boundary) and re-queries ``rule`` on the active set; steps after a
    cell's last event are no-ops.  ``p`` is one exponent for every job
    and every cell (per-job exponents come with the multi-class runs).

    ``p_drift`` (:class:`PDrift`) supersedes ``p`` with a piecewise-constant
    exponent: each row looks its regime up at its own clock, ``dt`` stops at
    the next boundary, the clock lands exactly on an arrival or a boundary,
    and ties go to the arrival, then the departure, then the boundary, as in
    the JAX scan.  The rule is shown each row's current ``p`` as a ``[C, 1]``
    column.

    ``record=True`` also returns the per-event trajectory; ``fused=True``
    swaps in the rule's ``fused_variant``.  ``superstep=True`` hands the
    run to ``core/superstep.py::run_superstep`` for the rules that carry a
    ``superstep_spec`` (``rel_tol`` is not read there) and raises
    ``ValueError`` for the rest.  Jobs that never depart within the horizon
    report ``inf``.
    """
    if telemetry is not None:
        raise NotImplementedError(
            "engine.run(telemetry=...) is not ported yet (see ROADMAP.md Queue A)"
        )
    if superstep:
        pol_name, n_srv = _resolve_superstep(
            rule, fused=fused, record=record, p=p, p_drift=p_drift
        )
        from repro_torch.core.superstep import run_superstep

        return run_superstep(
            x0, arrival_times, p, n_srv, pol_name,
            pre_arrived=pre_arrived, horizon=horizon, t0=t0, p_drift=p_drift,
        )
    rule = _resolve_fused(rule, fused)
    x0, arr_in, lead, dtype = _cells(x0, arrival_times)
    C, M = x0.shape
    dev = x0.device
    drift = None if p_drift is None else _drift_rows(p_drift, lead, dtype, dev)
    n_drift = 0 if drift is None else drift[0].shape[-1] - 1
    E = ((M if pre_arrived else 2 * M) + n_drift) if horizon is None else horizon
    tol = rel_tol * x0.amax(-1, keepdim=True)

    # Event logic walks arrivals in time order; un-sort at the end.
    order = torch.argsort(arr_in, dim=-1, stable=True)
    arr = arr_in.gather(-1, order)
    x = x0.gather(-1, order)
    idx = torch.arange(M, device=dev)
    i = torch.full((C, 1), M if pre_arrived else 0, dtype=torch.int64, device=dev)
    t = torch.full((C, 1), float(t0), dtype=dtype, device=dev)
    times = torch.zeros((C, M), dtype=dtype, device=dev)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    srule = as_stateful(rule)
    st = srule.init()
    trace = ([], [], []) if record else None

    for _ in range(E):
        active = (idx < i) & (x > 0)
        x_act = torch.where(active, x, 0.0)
        p_now = p
        if drift is not None:
            # The regime at each row's clock (right: a row landed on a
            # boundary already reads the new exponent) and its next boundary.
            r = torch.searchsorted(drift[0], t, right=True)
            p_now = drift[1].gather(-1, r)
            t_next_drift = drift[0].gather(-1, r)
            dt_drift = torch.clamp(t_next_drift - t, min=0.0)
        alloc, rate = srule.allocate(st, x_act, p_now)
        tt = torch.where(active & (rate > 0), x / rate, inf)
        dt_dep = tt.amin(-1, keepdim=True)
        first = tt.argmin(-1, keepdim=True)  # first index on ties, as jnp.argmin
        t_next_arr = torch.where(i < M, arr.gather(-1, i.clamp(max=M - 1)), inf)
        dt_arr = torch.clamp(t_next_arr - t, min=0.0)
        dt = torch.minimum(dt_dep, dt_arr)
        if drift is not None:
            dt = torch.minimum(dt, dt_drift)
        any_event = torch.isfinite(dt)
        dt = torch.where(any_event, dt, 0.0)
        # Landing on an arrival pins t to the exact arrival time so the
        # searchsorted admission below cannot miss it to float rounding (and
        # likewise a drift boundary); ties: arrival, departure, boundary.
        if drift is None:
            admit = any_event & (dt_arr <= dt_dep)
            take_dep = any_event & (dt_dep <= dt_arr)
            t_new = torch.where(admit, t_next_arr, t + dt)
        else:
            admit = any_event & (dt_arr <= torch.minimum(dt_dep, dt_drift))
            take_dep = any_event & (dt_dep <= torch.minimum(dt_arr, dt_drift))
            take_drift = any_event & ~admit & ~take_dep
            t_new = torch.where(
                admit, t_next_arr, torch.where(take_drift, t_next_drift, t + dt)
            )
        x_new = torch.where(active, x - dt * rate, x)
        # The argmin job departs by construction when the departure is the
        # next event; float residue (~eps*x) must not keep it alive.
        departing = (idx == first) & active & take_dep
        x_new = torch.where(departing | (active & (x_new <= tol)), 0.0, x_new)
        times = torch.where(active & (x_new == 0.0), t_new, times)
        i_new = torch.searchsorted(arr, t_new, right=True)
        st = srule.observe(st, Observation(alloc=alloc, rate=rate, dt=dt, active=active))
        if record:
            trace[0].append(alloc)
            trace[1].append(t)
            trace[2].append(x)
        x, t, i = x_new, t_new, torch.maximum(i, i_new)

    # Safety: any job that never departed (pathological rule) -> inf.
    times = torch.where(x > 0, inf, times)
    times_in = torch.zeros_like(times).scatter_(-1, order, times)  # input order
    out_trace = None
    if record:
        out_trace = EngineTrace(
            alloc=torch.stack(trace[0], 1).reshape(*lead, E, M),
            times=torch.cat(trace[1], 1).reshape(*lead, E),
            sizes=torch.stack(trace[2], 1).reshape(*lead, E, M),
        )
    return EngineResult(
        completion_times=times_in.reshape(*lead, M),
        x_final=x.reshape(*lead, M),
        order=order.reshape(*lead, M),
        trace=out_trace,
    )


def run_ranked(
    x0: torch.Tensor,
    arrival_times: torch.Tensor,
    p,
    n_servers,
    rank_policy,
    *,
    horizon: int | None = None,
) -> torch.Tensor:
    """Sort-free fast path of :func:`run` for rank-space policies.

    Rank policies (heSRPT, EQUI, SRPT) never reorder the active jobs between
    events and always finish the current smallest job (rank ``m``) first,
    so the ranks are carried — an arrival inserts one rank, a departure
    drops rank ``m`` — instead of re-sorted at every event.  Ties break by
    arrival order.  Returns completion times ``[..., M]`` in input order
    (``inf`` if never departed).  ``p`` is a scalar.
    """
    x0, arr_in, lead, dtype = _cells(x0, arrival_times)
    C, M = x0.shape
    dev = x0.device
    E = 2 * M if horizon is None else horizon

    order = torch.argsort(arr_in, dim=-1, stable=True)  # one sort in total
    arr = arr_in.gather(-1, order)
    xs = x0.gather(-1, order)
    x = xs
    idx = torch.arange(M, device=dev)
    t = torch.zeros((C, 1), dtype=dtype, device=dev)
    i = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    ranks = torch.zeros((C, M), dtype=torch.int64, device=dev)
    m = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    times = torch.zeros((C, M), dtype=dtype, device=dev)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)

    for _ in range(E):
        theta = rank_policy(ranks, m, p, dtype=dtype)
        rate = speedup(theta * n_servers, p)
        # Next departure: the smallest active job, rank m (argmax: ranks are
        # unique with maximum m, 0 when inactive).
        small = ranks.argmax(-1, keepdim=True)
        has_active = m > 0
        x_s = x.gather(-1, small)
        r_s = rate.gather(-1, small)
        dt_dep = torch.where(has_active & (r_s > 0), x_s / r_s, inf)
        t_next_arr = torch.where(i < M, arr.gather(-1, i.clamp(max=M - 1)), inf)
        dt_arr = torch.clamp(t_next_arr - t, min=0.0)
        dt = torch.minimum(dt_dep, dt_arr)
        any_event = torch.isfinite(dt)
        dt = torch.where(any_event, dt, 0.0)
        admit = any_event & (dt_arr <= dt_dep)
        take_dep = any_event & (dt_dep <= dt_arr)
        t_new = torch.where(admit, t_next_arr, t + dt)
        active = ranks > 0
        x_new = torch.where(active, torch.clamp(x - dt * rate, min=0.0), x)
        # Departure: drop rank m; every other active rank stays valid.
        departing = (idx == small) & active & take_dep
        x_new = torch.where(departing, 0.0, x_new)
        times = torch.where(departing, t_new, times)
        ranks = torch.where(departing, 0, ranks)
        m = m - (take_dep & has_active).to(m.dtype)
        # Arrival: insert job i at its rank among the (post-departure)
        # active set; ties break by index.
        i_c = i.clamp(max=M - 1)
        x_a = xs.gather(-1, i_c)
        still = ranks > 0
        ahead = still & ((x_new > x_a) | ((x_new == x_a) & (idx < i_c)))
        r_a = 1 + ahead.sum(-1, keepdim=True)
        bumped = torch.where(still & (ranks >= r_a), ranks + 1, ranks)
        inserted = bumped.scatter(-1, i_c, r_a)
        ranks = torch.where(admit, inserted, ranks)
        m = m + admit.to(m.dtype)
        i = i + admit.to(i.dtype)
        x, t = x_new, t_new

    times = torch.where((x > 0) | (ranks > 0), inf, times)
    return torch.zeros_like(times).scatter_(-1, order, times).reshape(*lead, M)


# -------------------------------------------------------------- quantization
def quantize_allocation(theta: torch.Tensor, n_chips: int, *, min_chips: int = 1):
    """Largest-remainder rounding of ``theta * n_chips`` with a min-chips floor.

    Port of ``repro.core.engine.quantize_allocation_jax`` over the last dim:
    the oversubscription cut keeps the ``n_chips // min_chips`` largest
    shares (stable on ties) and renormalizes; a floor overflow is trimmed
    in full rounds (a bisection over ``sum(min(cap_j, r))``) plus one
    partial round in ascending-frac order; leftover chips go to the largest
    fractional parts.  The partial trim and the leftover pass are mutually
    exclusive, so one stable argsort serves both.  The renormalizer is the
    fixed pairwise tree the fused kernel uses (``kernels/alloc.py``), which
    keeps fused and unfused chips equal.  Returns int32 chips.
    """
    if n_chips <= 0 or min_chips <= 0 or theta.shape[-1] == 0:
        return torch.zeros(theta.shape, dtype=torch.int32, device=theta.device)
    active0 = theta > 0
    key = torch.where(active0, -theta, torch.inf)
    desc = stable_positions(key)
    return round_chips(theta, active0 & (desc < n_chips // min_chips), n_chips, min_chips)


def snap_to_slices(
    chips: torch.Tensor, n_chips: int, *, slices: tuple[int, ...] = DEFAULT_SLICES
) -> torch.Tensor:
    """Whole chips snapped to slice sizes, row by row over the last dim.

    Port of ``repro.core.engine.snap_to_slices_jax`` (and of the NumPy
    oracle ``sched.quantize.snap_to_slices``): each count snaps down to the
    largest slice ``<= count`` (0 below the smallest), then leftover chips
    go back one upgrade a round: among jobs whose next slice step fits the
    row's leftover pool and whose lost allocation (original - snapped) is
    non-negative, the job with the largest lost allocation moves up one
    slice, ties to the higher index.  Every row takes its rounds together;
    a row with nothing left to upgrade goes through rounds that change
    nothing, and convergence is checked on the host after rounds 1, 2, 4,
    8, ... (one sync each), bounded by ``n_chips`` rounds since every
    upgrade shrinks the pool.  Returns int32 chips.
    """
    shape = chips.shape
    M = shape[-1]
    if chips.numel() == 0:
        return chips.to(torch.int32)
    dev = chips.device
    sl = torch.tensor(sorted(slices), dtype=torch.int64, device=dev)
    S = sl.shape[0]
    chips0 = chips.reshape(-1, M).to(torch.int64)
    idx = torch.arange(M, device=dev)
    down = torch.searchsorted(sl, chips0, right=True) - 1
    snapped = torch.where(down >= 0, sl[down.clamp(min=0)], 0)
    left = n_chips - snapped.sum(-1, keepdim=True)
    # JAX's ~((snapped == 0) & (chips0 == 0)): a job that held no chip snaps
    # to 0 and stays there, so the test is chips0 != 0.
    held = chips0 != 0
    check = 1
    for k in range(1, max(int(n_chips), 0) + 1):
        nxt_i = torch.searchsorted(sl, snapped, right=True)
        nxt = sl[nxt_i.clamp(max=S - 1)]
        step = nxt - snapped
        lost = chips0 - snapped
        elig = (nxt_i < S) & (step <= left) & (lost >= 0) & held
        key = torch.where(elig, lost * M + idx, -1)
        best, j = key.max(-1, keepdim=True)
        go = (best >= 0) & (left > 0)
        snapped = torch.where(go & (idx == j), nxt, snapped)
        left = left - torch.where(go, step.gather(-1, j), 0)
        if k == check:
            if not bool(go.any()):
                break
            check *= 2
    return snapped.to(torch.int32).reshape(shape)


__all__ = [
    "DEFAULT_SLICES",
    "AllocRule",
    "PDrift",
    "EngineResult",
    "EngineTrace",
    "Observation",
    "StatefulRule",
    "as_stateful",
    "continuous_rule",
    "finish_alloc",
    "knee_rule",
    "quantize_allocation",
    "quantized_rule",
    "run",
    "run_ranked",
    "snap_to_slices",
]
