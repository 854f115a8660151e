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

Not ported yet (ROADMAP.md Queue A): ``p_drift``, ``telemetry``, slice
snapping, estimation noise and the bounded-slot streaming loop.
"""

from __future__ import annotations

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

#: Power-of-two slice sizes (``sched.quantize`` keeps its own copy in the
#: JAX package; slice snapping itself is a later slice of the port).
DEFAULT_SLICES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


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
def finish_alloc(theta, p, *, n_alloc, n_chips: int | None, min_chips: int = 1, dtype):
    """The one ``theta -> (alloc, rate)`` tail the rules share: continuous
    (``n_chips`` None, rate ``s(theta n_alloc)``) or whole chips (rate
    ``s(chips)``)."""
    theta = theta.to(dtype)
    if n_chips is None:
        return theta, speedup(theta * n_alloc, p)
    chips = quantize_allocation(theta, n_chips, min_chips=min_chips)
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
    policy: Policy, n_chips: int, *, min_chips: int = 1, dtype=torch.float64
) -> AllocRule:
    """Whole chips: largest-remainder rounding of ``theta * n_chips``.

    Over heSRPT the rule carries a ``fused_variant``: the
    ``kernels/alloc.py`` rank -> theta -> chips pass, chip-exact vs this
    rule, one kernel launch per event on the card.
    """

    def rule(x_act, p):
        return finish_alloc(
            policy(x_act, p), p, n_alloc=n_chips, n_chips=n_chips,
            min_chips=min_chips, dtype=dtype,
        )

    if policy is hesrpt:

        def fused(x_act, p):
            _theta, chips = hesrpt_alloc_fused(x_act, p, n_chips, min_chips=min_chips)
            return chips, speedup(chips.to(dtype), p)

        rule.fused_variant = fused
    return rule


def knee_rule(
    n_servers, *, n_chips: int | None = None, min_chips: int = 1, dtype=torch.float64
) -> StatefulRule:
    """KNEE with its per-epoch ``alpha`` refit, as an engine rule.

    At every event ``alpha = median(active remaining sizes) * p / N``, the
    masked median being ``np.median``'s over the active subset (the mean of
    the two middle order statistics), so the state stays empty.
    Continuous when ``n_chips`` is None, else whole chips with a min-chips
    floor, as :func:`continuous_rule` / :func:`quantized_rule`.
    """
    n_alloc = float(n_chips) if n_chips is not None else float(n_servers)

    def rule(x_act, p):
        active = x_act > 0
        m = active.sum(-1, keepdim=True).clamp(min=1)
        v = torch.sort(torch.where(active, x_act, torch.inf), dim=-1, stable=True).values
        med = 0.5 * (v.gather(-1, (m - 1) // 2) + v.gather(-1, m // 2))
        theta = knee(x_act, p, n_alloc, med * p / n_alloc)
        return finish_alloc(
            theta, p, n_alloc=n_alloc, n_chips=n_chips, min_chips=min_chips, dtype=dtype
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


def _resolve_superstep(rule, *, fused: bool, record: bool, p):
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


def _not_ported(name: str):
    raise NotImplementedError(
        f"engine.run({name}=...) is not ported yet (see ROADMAP.md Queue A)"
    )


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
    ``E = 2M`` steps (``M`` with ``pre_arrived=True``, or ``horizon``).
    Each step advances every cell to its next event (the ``min`` of next
    departure and next arrival) and re-queries ``rule`` on the active set;
    steps after a cell's last event are no-ops.  ``p`` is a scalar.

    ``record=True`` also returns the per-event trajectory; ``fused=True``
    swaps in the rule's ``fused_variant``.  ``superstep=True`` hands the
    run to ``core/superstep.py::run_superstep`` for the rules that carry a
    ``superstep_spec`` (``rel_tol`` is not read there) and raises
    ``ValueError`` for the rest.  Jobs that never depart within the horizon
    report ``inf``.
    """
    if p_drift is not None:
        _not_ported("p_drift")
    if telemetry is not None:
        _not_ported("telemetry")
    if superstep:
        pol_name, n_srv = _resolve_superstep(rule, fused=fused, record=record, p=p)
        from repro_torch.core.superstep import run_superstep

        return run_superstep(
            x0, arrival_times, p, n_srv, pol_name,
            pre_arrived=pre_arrived, horizon=horizon, t0=t0,
        )
    rule = _resolve_fused(rule, fused)
    x0, arr_in, lead, dtype = _cells(x0, arrival_times)
    C, M = x0.shape
    dev = x0.device
    E = (M if pre_arrived else 2 * M) if horizon is None else horizon
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
        alloc, rate = srule.allocate(st, x_act, p)
        tt = torch.where(active & (rate > 0), x / rate, inf)
        dt_dep = tt.amin(-1, keepdim=True)
        first = tt.argmin(-1, keepdim=True)  # first index on ties, as jnp.argmin
        t_next_arr = torch.where(i < M, arr.gather(-1, i.clamp(max=M - 1)), inf)
        dt_arr = torch.clamp(t_next_arr - t, min=0.0)
        dt = torch.minimum(dt_dep, dt_arr)
        any_event = torch.isfinite(dt)
        dt = torch.where(any_event, dt, 0.0)
        # Landing on an arrival pins t to the exact arrival time so the
        # searchsorted admission below cannot miss it to float rounding.
        admit = any_event & (dt_arr <= dt_dep)
        take_dep = any_event & (dt_dep <= dt_arr)
        t_new = torch.where(admit, t_next_arr, t + dt)
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


__all__ = [
    "DEFAULT_SLICES",
    "AllocRule",
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
]
