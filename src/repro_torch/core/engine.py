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
- per-job exponents (the multi-class runs, ``core/multiclass.py``): a
  ``p[..., M]`` and per-job drift rows travel with their jobs into the
  loop's arrival order, and the rule sees a ``[C, M]`` exponent.
- :func:`snap_to_slices` — whole chips snapped to power-of-two slices
  (``quantized_rule(snap_slices=True)``, ``knee_rule`` likewise).
- :func:`run_stream`, :func:`run_stream_ranked` and
  :func:`run_stream_source` — the bounded-slot streaming loop: ``[C, S]``
  recycled job slots instead of ``[C, M]`` job state, arrivals pulled from a
  :class:`StreamSource` (:func:`tape_source`, :func:`poisson_source`), a
  full pool deferring an arrival, and stationary-window aggregates
  (:class:`StreamResult`) as the read-out.
- ``telemetry=`` on :func:`run` and the stream loops — a probe
  (``core/telemetry.py``) that sees every epoch's :class:`ProbeEvent` and
  leaves the trajectory as it is; :func:`continuous_rule` and
  :func:`quantized_rule` take estimation noise (``size_factors``,
  ``p_hat``), and ``core/estimation.py`` builds the estimating
  :class:`StatefulRule`.
- the step after the allocate (``kernels/event_step.py``): one launch of
  its CUDA kernel a step on the card, its plain version on the CPU.
- program spans (``repro_torch/spans.py``, recorded only while a profiler
  runs): ``engine.loop`` around :func:`run`'s and :func:`run_ranked`'s loop,
  ``engine.allocate`` around each step's allocation, and the counters
  ``engine.steps`` and ``engine.step_kernel`` (the steps that launched the
  event-step kernel).
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.core.flowtime import speedup
from repro_torch.core import policies
from repro_torch.core.policies import Policy, hesrpt, knee
from repro_torch.kernels import event_step as kstep
from repro_torch.kernels.alloc import (
    hesrpt_alloc_fused,
    hesrpt_theta_fused,
    round_chips,
    stable_positions,
)
from repro_torch.spans import add, span

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
    ``values[r]``.  Per-job regime rows, ``values`` ``[..., D + 1, M]`` in
    input job order (one more dim than ``times``: the multi-class form),
    give every job its own exponent in each regime.
    """

    times: torch.Tensor  # [D] or [..., D] regime-change epochs, ascending
    values: torch.Tensor  # [D + 1], [..., D + 1] or per job [..., D + 1, M]


def _per_job_rows(p_drift: PDrift) -> bool:
    return torch.as_tensor(p_drift.values).ndim > torch.as_tensor(p_drift.times).ndim


class Observation(NamedTuple):
    """What an allocation rule sees after each epoch (per cell row)."""

    alloc: torch.Tensor  # [C, M] allocation held during the epoch
    rate: torch.Tensor  # [C, M] realized service rate
    dt: torch.Tensor  # [C, 1] epoch length (0 on no-op steps)
    active: torch.Tensor  # [C, M] bool, arrived & unfinished this epoch


class ProbeEvent(NamedTuple):
    """What a telemetry probe (``core/telemetry.py``) sees at each event, per
    cell row: :class:`Observation` plus the epoch-start clock, the remaining
    sizes, the true exponent in effect and the rule's epoch-start state
    (how the p-hat error probe reaches an estimating rule's state)."""

    t: torch.Tensor  # [C, 1] epoch-start time
    dt: torch.Tensor  # [C, 1] epoch length (0 on no-op steps)
    alloc: torch.Tensor  # [C, M] allocation held during the epoch
    rate: torch.Tensor  # [C, M] realized service rate
    active: torch.Tensor  # [C, M] bool, arrived & unfinished this epoch
    x: torch.Tensor  # [C, M] remaining sizes at epoch start
    p: Any  # float, [C, 1] under drift, or [C, M] per job: the true exponent
    rule_state: Any  # the rule's state at epoch start
    p_per_job: bool = False  # p is one exponent a job (even at M == 1)


class StatefulRule(NamedTuple):
    """An allocation rule with loop-carried state: ``(init, observe,
    allocate)``; see ``repro.core.engine.StatefulRule``."""

    init: Callable[[], Any]
    observe: Callable[[Any, Observation], Any]
    allocate: Callable[[Any, torch.Tensor, Any], tuple[torch.Tensor, torch.Tensor]]


def _keep_state(state, obs):
    """The trivial rule's ``observe``: the state as it was."""
    return state


def as_stateful(rule: AllocRule | StatefulRule) -> StatefulRule:
    """Wrap a plain ``(x_active, p) -> (alloc, rate)`` rule as the trivial
    :class:`StatefulRule` (empty state, identity ``observe``)."""
    if isinstance(rule, StatefulRule):
        return rule
    return StatefulRule(
        init=lambda: (),
        observe=_keep_state,
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
    telemetry: Any = None  # the probe's read-out under ``run(telemetry=)``


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


def _seen(x_act, p, size_factors, p_hat):
    """What the policy sees: the sizes times ``size_factors`` and ``p_hat``
    in place of ``p`` (each only where given)."""
    return (x_act if size_factors is None else x_act * size_factors,
            p if p_hat is None else p_hat)


def continuous_rule(
    policy: Policy, n_servers, *, dtype=torch.float64, size_factors=None, p_hat=None,
) -> AllocRule:
    """The paper's continuously-divisible allocation: ``rate = s(theta N)``.

    ``size_factors`` (``[C, M]`` or ``[M]``, in the loop's arrival-sorted
    job order) and ``p_hat`` (a float or a ``[C, 1]`` column) are
    estimation noise: the policy sees ``x * size_factors`` and ``p_hat``
    while the physics keep ``x`` and ``p``.

    Over :func:`~repro_torch.core.policies.hesrpt` the rule carries a
    ``fused_variant`` (``kernels/alloc.py::hesrpt_theta_fused``, on what the
    policy sees); over heSRPT, EQUI and SRPT without noise a
    ``superstep_spec`` ``(name, n_servers)``, which :func:`run` reads under
    ``superstep=True``.
    """

    def rule(x_act, p):
        x_seen, p_seen = _seen(x_act, p, size_factors, p_hat)
        return finish_alloc(policy(x_seen, p_seen), p, n_alloc=n_servers, n_chips=None,
                            dtype=dtype)

    from repro_torch.core.superstep import SUPERSTEP_RULE_POLICIES

    name = getattr(policy, "__name__", None)
    noisy = size_factors is not None or p_hat is not None
    if not noisy and name in SUPERSTEP_RULE_POLICIES and policy is getattr(policies, name):
        rule.superstep_spec = (name, n_servers)
    if policy is hesrpt:

        def fused(x_act, p):
            theta = hesrpt_theta_fused(*_seen(x_act, p, size_factors, p_hat)).to(dtype)
            return theta, speedup(theta * n_servers, p)

        rule.fused_variant = fused
    return rule


def quantized_rule(
    policy: Policy, n_chips: int, *, min_chips: int = 1, dtype=torch.float64,
    size_factors=None, p_hat=None, snap_slices: bool = False,
    slices: tuple[int, ...] = DEFAULT_SLICES,
) -> AllocRule:
    """Whole chips: largest-remainder rounding of ``theta * n_chips``,
    snapped to power-of-two ``slices`` under ``snap_slices=True``;
    ``size_factors`` / ``p_hat`` as in :func:`continuous_rule`.

    Over heSRPT the rule carries a ``fused_variant``: the
    ``kernels/alloc.py`` rank -> theta -> chips pass, chip-exact vs this
    rule, one kernel launch per event on the card (then the snap).
    """

    def rule(x_act, p):
        x_seen, p_seen = _seen(x_act, p, size_factors, p_hat)
        return finish_alloc(
            policy(x_seen, p_seen), p, n_alloc=n_chips, n_chips=n_chips,
            min_chips=min_chips, snap_slices=snap_slices, slices=slices, dtype=dtype,
        )

    if policy is hesrpt:

        def fused(x_act, p):
            x_seen, p_seen = _seen(x_act, p, size_factors, p_hat)
            _theta, chips = hesrpt_alloc_fused(x_seen, p_seen, n_chips, min_chips=min_chips)
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


def _resolve_superstep(rule, *, fused: bool, record: bool, telemetry, p, p_drift):
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
    if telemetry is not None:
        raise ValueError("telemetry probes ride the per-event scan" + fallback)
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


def loop_order(arr: torch.Tensor) -> torch.Tensor:
    """The order :func:`run` walks each cell row in: a stable argsort of its
    arrival times ``[C, M]``.  A rule's closure over per-job vectors takes
    them through :func:`to_loop_order` with this order."""
    return torch.argsort(arr, dim=-1, stable=True)


def to_loop_order(v: torch.Tensor, order: torch.Tensor, lead, mid=()) -> torch.Tensor:
    """Per-job values in input order, ``v`` ``[..., *mid, M]`` broadcasting
    over the cells' ``lead`` dims, as the loop's rows ``[C, *mid, M]`` in its
    arrival order ``order`` ``[C, M]`` (``mid`` is ``(D + 1,)`` for per-job
    drift regimes)."""
    C, M = order.shape
    v = v.expand(*lead, *mid, M).reshape(C, *mid, M)
    return v.gather(-1, order.view(C, *(1,) * len(mid), M).expand(C, *mid, M))


def is_per_job(v, M: int) -> bool:
    """Whether ``v`` holds one value a job (a ``[..., M]`` tensor) rather than
    one for every job (a float or a 0-d tensor) or one a cell row (a
    ``[..., 1]`` column); at ``M == 1`` a tensor with a dim is per job."""
    return isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[-1] == M


def _drift_rows(p_drift: PDrift, lead, dtype, device, order=None):
    """``(times, values)`` of every cell row: ``[C, D + 1]`` boundaries
    with a ``+inf`` past the last (so the next boundary is a gather even
    for ``D = 0``) and ``[C, D + 1]`` regimes, or per-job rows ``[C, D + 1,
    M]`` permuted by ``order`` (``[C, M]``, the loop's arrival order)."""
    times = torch.as_tensor(p_drift.times, device=device).to(dtype)
    values = torch.as_tensor(p_drift.values, device=device).to(dtype)
    per_job = _per_job_rows(p_drift)
    D = times.shape[-1]
    n_regimes = values.shape[-2] if per_job else values.shape[-1]
    if n_regimes != D + 1:
        raise ValueError(f"PDrift needs D + 1 regimes for D boundaries, got "
                         f"{n_regimes} for {D}")
    C = math.prod(lead)
    times = times.expand(*lead, D).reshape(C, D)
    inf = torch.full((C, 1), torch.inf, dtype=dtype, device=device)
    if per_job:
        values = to_loop_order(values, order, lead, (D + 1,))
    else:
        values = values.expand(*lead, D + 1).reshape(C, D + 1)
    return torch.cat([times, inf], -1), values


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
    cell's last event are no-ops.  ``p`` is a float, one exponent for every
    job and every cell, or a per-job tensor ``[..., M]`` in input order
    (:func:`is_per_job`: the multi-class runs), which travels with its
    jobs into the loop's arrival order; the rule then sees a ``[C, M]``
    exponent, and a closure over per-job vectors must be permuted the same
    way (:func:`loop_order`, :func:`to_loop_order`).

    ``p_drift`` (:class:`PDrift`) supersedes ``p`` with a piecewise-constant
    exponent: each row looks its regime up at its own clock, ``dt`` stops at
    the next boundary, the clock lands exactly on an arrival or a boundary,
    and ties go to the arrival, then the departure, then the boundary, as in
    the JAX scan.  The rule is shown each row's current ``p`` as a ``[C, 1]``
    column, or with per-job rows each job's as ``[C, M]``.

    ``record=True`` also returns the per-event trajectory; ``fused=True``
    swaps in the rule's ``fused_variant``.  ``superstep=True`` hands the
    run to ``core/superstep.py::run_superstep`` for the rules that carry a
    ``superstep_spec`` (``rel_tol`` is not read there) and raises
    ``ValueError`` for the rest, a probe included.  Jobs that never depart
    within the horizon report ``inf``.

    ``telemetry`` takes a probe (``core/telemetry.py::make_probe``): each
    step hands it the epoch's :class:`ProbeEvent` after the step's own ops,
    and its read-out comes back on ``EngineResult.telemetry``.  With
    ``telemetry=None`` the loop body is the probe-free one, op for op.

    Each step after the allocate is
    :func:`~repro_torch.kernels.event_step.event_step`, with the drift
    boundary as a third candidate event under ``p_drift``: one launch of its
    CUDA kernel on the card, its plain version on the CPU.  The kernel takes
    the sizes and the rule's rate in one dtype and raises otherwise (build
    the rule with the tapes' ``dtype``), where the CPU's plain version
    promotes a rate of another dtype.
    """
    if superstep:
        pol_name, n_srv = _resolve_superstep(
            rule, fused=fused, record=record, telemetry=telemetry, p=p, p_drift=p_drift
        )
        from repro_torch.core.superstep import run_superstep

        return run_superstep(
            x0, arrival_times, p, n_srv, pol_name,
            pre_arrived=pre_arrived, horizon=horizon, t0=t0, p_drift=p_drift,
        )
    rule = _resolve_fused(rule, fused)
    with span("engine.loop"):
        x0, arr_in, lead, dtype = _cells(x0, arrival_times)
        C, M = x0.shape
        dev = x0.device

        # Event logic walks arrivals in time order; un-sort at the end.
        order = loop_order(arr_in)
        arr = arr_in.gather(-1, order)
        x = x0.gather(-1, order)
        per_job = is_per_job(p, M)
        if per_job:  # per-job exponents travel with their jobs
            p = to_loop_order(p.to(device=dev, dtype=dtype), order, lead)
        drift = None if p_drift is None else _drift_rows(p_drift, lead, dtype, dev, order)
        drift_per_job = drift is not None and drift[1].ndim == 3
        n_drift = 0 if drift is None else drift[0].shape[-1] - 1
        E = ((M if pre_arrived else 2 * M) + n_drift) if horizon is None else horizon
        tol = rel_tol * x0.amax(-1, keepdim=True)
        i = torch.full((C, 1), M if pre_arrived else 0, dtype=torch.int64, device=dev)
        t = torch.full((C, 1), float(t0), dtype=dtype, device=dev)
        times = torch.zeros((C, M), dtype=dtype, device=dev)
        srule = as_stateful(rule)
        st = srule.init()
        # The epoch's active set is built only for a rule's observe or a probe.
        watched = telemetry is not None or srule.observe is not _keep_state
        trace = ([], [], []) if record else None
        tel = None if telemetry is None else telemetry.init(tuple(lead), dev)
        tel_outs = []
        add("engine.steps", E)
        if kstep.on_kernel(x):
            add("engine.step_kernel", E)

        x_act = torch.where((torch.arange(M, device=dev) < i) & (x > 0), x, 0.0)
        for _ in range(E):
            p_now = p
            if drift is not None:
                # The regime at each row's clock (right: a row landed on a
                # boundary already reads the new exponent) and its next boundary.
                r = torch.searchsorted(drift[0], t, right=True)
                if drift_per_job:  # each job's exponent in its row's regime
                    p_now = drift[1].gather(1, r.unsqueeze(-1).expand(C, 1, M)).squeeze(1)
                else:
                    p_now = drift[1].gather(-1, r)
            with span("engine.allocate"):
                alloc, rate = srule.allocate(st, x_act, p_now)
            step = kstep.event_step(x, rate, arr, t, i, tol, times,
                                    None if drift is None else drift[0].gather(-1, r))
            if watched:
                active = x_act > 0  # arrived and unfinished: x_act holds their sizes
                st_start = st
                st = srule.observe(st, Observation(alloc=alloc, rate=rate, dt=step.dt,
                                                   active=active))
                if tel is not None:
                    tel, out = telemetry.step(tel, ProbeEvent(
                        t=t, dt=step.dt, alloc=alloc, rate=rate, active=active, x=x, p=p_now,
                        rule_state=st_start,
                        p_per_job=per_job if drift is None else drift_per_job))
                    tel_outs.append(out)
            if record:
                trace[0].append(alloc)
                trace[1].append(t)
                trace[2].append(x)
            x, x_act, t, i, times = step.x, step.x_act, step.t, step.i, step.times

        # Safety: any job that never departed (pathological rule) -> inf.
        times = torch.where(x > 0, torch.inf, times)
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
        telemetry=None if tel is None else telemetry.finalize(tel, tel_outs, tuple(lead)),
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
    (``inf`` if never departed).  ``p`` is a scalar: with per-job exponents
    the rates are no longer monotone in size, so neither carried invariant
    holds (those runs take :func:`run`).
    """
    if isinstance(p, torch.Tensor) and p.ndim >= 1:
        raise ValueError(
            "run_ranked needs a scalar p — per-job exponents break the carried-rank "
            "invariants; multi-class runs take the generic run()"
        )
    with span("engine.loop"):
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
        add("engine.steps", E)

        for _ in range(E):
            with span("engine.allocate"):
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
        times_in = torch.zeros_like(times).scatter_(-1, order, times)
    return times_in.reshape(*lead, M)


# ----------------------------------------------------- bounded-slot streaming
class StreamSource(NamedTuple):
    """Pull-based arrival stream for the bounded-slot loop, one row a cell.

    ``init()`` builds the stream state, a tuple of ``[C, 1]`` tensors;
    ``peek(state)`` reads each row's next arrival ``(time, size)`` as two
    ``[C, 1]`` columns without consuming it (``time = inf`` once a row is
    exhausted); ``advance(state)`` consumes it, in every row (the loop keeps
    the advanced state only where a row admitted).  The peek/advance split lets a full
    pool defer an arrival and admit it later at its true arrival time.
    """

    init: Callable[[], Any]
    peek: Callable[[Any], tuple[torch.Tensor, torch.Tensor]]
    advance: Callable[[Any], Any]


def tape_source(x0_sorted: torch.Tensor, arrivals_sorted: torch.Tensor) -> StreamSource:
    """Finite arrival-sorted ``[..., T]`` tapes (flattened to ``[C, T]``
    rows) as a :class:`StreamSource`.  The state is each row's next tape
    index, ``([C, 1] int64,)``, so the loop's admission counter is the tape
    position (which is how ``record_times`` maps slots back to jobs)."""
    T = x0_sorted.shape[-1]
    xs = x0_sorted.reshape(-1, T)
    arr = arrivals_sorted.reshape(-1, T)
    inf = torch.tensor(torch.inf, dtype=arr.dtype, device=arr.device)

    def init():
        return (torch.zeros((xs.shape[0], 1), dtype=torch.int64, device=xs.device),)

    def peek(state):
        j = state[0].clamp(max=T - 1)
        return torch.where(state[0] < T, arr.gather(-1, j), inf), xs.gather(-1, j)

    def advance(state):
        return (state[0] + 1,)

    return StreamSource(init=init, peek=peek, advance=advance)


def poisson_source(
    gen: torch.Generator, rate, *, size_alpha: float = 1.5, dtype=torch.float64,
    device="cuda",
) -> StreamSource:
    """An unbounded Poisson/Pareto arrival stream in O(1) state a row.

    ``rate`` is a float (one row) or a ``[C, 1]`` column (one row a rate).
    The state is each row's peeked arrival ``(t_next, x_next)``; every
    ``advance`` draws one Exp(``rate``) gap and one Pareto(``size_alpha``,
    minimum 1) size a row from ``gen`` (``scenarios.pareto_sizes``' law),
    and the loop keeps them only where the row admitted.  Equal in
    distribution to the JAX package's ``poisson_source``, never sample for
    sample (its threefry streams are not drawn here).
    """
    from repro_torch.core.scenarios import pareto_sizes, unit_gaps
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator lies on {gen.device}, the stream on {dev}")
    rate = torch.as_tensor(rate, dtype=dtype, device=dev)
    C = rate.shape[0] if rate.ndim else 1
    rate = rate.reshape(C, 1) if rate.ndim else rate

    def draw():
        gap = unit_gaps(gen, C).reshape(C, 1).to(dtype) / rate
        return gap, pareto_sizes(gen, C, size_alpha).reshape(C, 1).to(dtype)

    def peek(state):
        return state

    def advance(state):
        gap, size = draw()
        return state[0] + gap, size

    return StreamSource(init=draw, peek=peek, advance=advance)


class StreamResult(NamedTuple):
    """Read-out of a bounded-slot streaming run, one value a cell.

    Flow and slowdown aggregates count the jobs that *arrived* inside the
    window ``[lo, hi)`` (``window=None``: the whole stream) and completed
    within the event budget, so long jobs near the window's trailing edge
    are right-censored as a finite-horizon measurement censors them.
    Slowdown compares against running alone on ``n_alone`` servers:
    ``flow / (size / s(n_alone))``.
    """

    mean_flow: torch.Tensor  # windowed mean flow time
    mean_slowdown: torch.Tensor  # windowed mean slowdown
    n_window: torch.Tensor  # completions counted into the window
    n_arrived_window: torch.Tensor  # admissions whose arrival fell in the window
    flow_sum: torch.Tensor  # windowed flow-time sum
    slow_sum: torch.Tensor  # windowed slowdown sum
    n_admitted: torch.Tensor  # arrivals admitted to a slot
    n_completed: torch.Tensor  # total departures
    blocked_steps: torch.Tensor  # events where a full pool deferred an arrival
    occupancy_max: torch.Tensor  # peak in-flight jobs (epoch-start census)
    t_final: torch.Tensor  # clock at the end of the loop
    x_final: torch.Tensor  # [..., n_slots] remaining sizes (0 = free slot)
    completion_times: torch.Tensor | None  # [..., n_jobs] input order (record_times)
    telemetry: Any  # the probe's TelemetryResult when one was attached


def _scalar_p(p, who: str) -> float:
    if torch.as_tensor(p).ndim != 0:
        raise ValueError(
            f"{who} needs a scalar p — per-job exponents do not ride in slots yet; "
            "multi-class streams take the finite-tape run()"
        )
    return float(p)


def _window_bounds(window, lead, dtype, device):
    """``(lo, hi)`` as 0-dim tensors, or as ``[C, 1]`` columns where a bound
    is a tensor that broadcasts over the cells' lead dims (a sweep's window
    differs by rate)."""
    if window is None:
        window = (-torch.inf, torch.inf)

    def bound(v):
        v = torch.as_tensor(v, dtype=dtype, device=device)
        return v if v.ndim == 0 else v.expand(lead).reshape(-1, 1)

    return bound(window[0]), bound(window[1])


def _acc_zeros(C: int, dtype, device) -> dict:
    z = torch.zeros((C, 1), dtype=torch.int64, device=device)
    zf = torch.zeros((C, 1), dtype=dtype, device=device)
    return {"n_admitted": z, "n_completed": z, "w_count": z, "w_arrived": z, "blocked": z,
            "occ_max": z, "w_flow": zf, "w_slow": zf}


def _finalize_stream(acc, t_fin, x_fin, comp, lead, tel=None) -> StreamResult:
    def cell(v):
        return v.reshape(lead)

    n_w = acc["w_count"].clamp(min=1).to(acc["w_flow"].dtype)
    S = x_fin.shape[-1]
    return StreamResult(
        mean_flow=cell(acc["w_flow"] / n_w),
        mean_slowdown=cell(acc["w_slow"] / n_w),
        n_window=cell(acc["w_count"]),
        n_arrived_window=cell(acc["w_arrived"]),
        flow_sum=cell(acc["w_flow"]),
        slow_sum=cell(acc["w_slow"]),
        n_admitted=cell(acc["n_admitted"]),
        n_completed=cell(acc["n_completed"]),
        blocked_steps=cell(acc["blocked"]),
        occupancy_max=cell(acc["occ_max"]),
        t_final=cell(t_fin),
        x_final=x_fin.reshape(*lead, S),
        completion_times=comp,
        telemetry=tel,
    )


def _claim(free, idx, ptr, S: int):
    """The free slot at the smallest cyclic offset after each row's ring
    pointer (``[C, 1]``; the first index on ties, as ``jnp.argmin``)."""
    offs = torch.remainder(idx - ptr, S)  # Python-style modulo
    return torch.where(free, offs, S).argmin(-1, keepdim=True)


def _stream_scan(
    source: StreamSource, p, srule: StatefulRule, *, n_slots: int, n_events: int,
    window, lead, n_alone, tol, t0: float, dtype, n_times: int, telemetry=None,
):
    """The bounded-slot event loop shared by the tape and source runners.

    Carries ``[C, S]`` slots (remaining size, original size, arrival time,
    job id) and ``[C, 1]`` scalars, so memory and per-event cost are flat
    in the number of jobs streamed.  A slot is free iff its remaining size
    is 0; an admitted arrival claims the free slot at the smallest cyclic
    offset after a rotating ring pointer (the epoch-start free mask: a slot
    freed by this step's departure is claimable from the next event), and a
    completion zeroes its slot.  With ``S >= n_jobs`` the pointer never
    wraps, slot ``i`` holds the ``i``-th arrival, and every step equals
    :func:`run`'s.  A full pool drops the arrival out of the event race; it
    is admitted on a later event, once a departure frees a slot, at the
    later clock, and its recorded arrival time stays the true one.

    ``record_times`` (``n_times > 0``) scatters completion times by job id
    into ``[C, n_times + 1]``, whose last column takes every slot that did
    not finish and is dropped.  ``lead`` is the cells' lead shape (None:
    one dim, the source's rows).  ``telemetry`` is a probe, stepped after
    the step's own ops.  Returns ``(x, t, acc, times, telemetry result)``.
    """
    S = int(n_slots)
    src = source.init()
    t_peek, _ = source.peek(src)
    C, dev = t_peek.shape[0], t_peek.device
    lead = (C,) if lead is None else tuple(lead)
    w_lo, w_hi = _window_bounds(window, lead, dtype, dev)
    alone_rate = speedup(torch.tensor(n_alone, dtype=dtype, device=dev), p)
    idx = torch.arange(S, device=dev)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    x = torch.zeros((C, S), dtype=dtype, device=dev)  # free slots hold 0
    sx0 = torch.ones((C, S), dtype=dtype, device=dev)  # 1.0: no 0/0 in idle slots
    sarr = torch.zeros((C, S), dtype=dtype, device=dev)
    sid = torch.full((C, S), n_times, dtype=torch.int64, device=dev)
    t = torch.full((C, 1), float(t0), dtype=dtype, device=dev)
    ptr = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    acc = _acc_zeros(C, dtype, dev)
    times = torch.full((C, n_times + 1), torch.inf, dtype=dtype, device=dev) if n_times else None
    st = srule.init()
    tel = None if telemetry is None else telemetry.init(lead, dev)
    tel_outs = []

    for _ in range(n_events):
        active = x > 0
        x_act = torch.where(active, x, 0.0)
        alloc, rate = srule.allocate(st, x_act, p)
        tt = torch.where(active & (rate > 0), x / rate, inf)
        dt_dep = tt.amin(-1, keepdim=True)
        first = tt.argmin(-1, keepdim=True)
        t_next, x_next = source.peek(src)
        dt_arr = torch.clamp(t_next - t, min=0.0)
        free = ~active
        has_free = free.any(-1, keepdim=True)
        eff_dt_arr = torch.where(has_free, dt_arr, inf)
        dt = torch.minimum(dt_dep, eff_dt_arr)
        any_event = torch.isfinite(dt)
        dt = torch.where(any_event, dt, 0.0)
        admit = any_event & has_free & (dt_arr <= dt_dep)
        take_dep = any_event & (dt_dep <= eff_dt_arr)
        blocked_now = torch.isfinite(dt_dep) & ~has_free & (dt_arr < dt_dep)
        # On time, t lands on the arrival exactly (as in run); a deferred
        # arrival is admitted at the later clock.
        t_new = torch.where(admit, torch.maximum(t_next, t), t + dt)
        x_new = torch.where(active, x - dt * rate, x)
        departing = (idx == first) & active & take_dep
        x_new = torch.where(departing | (active & (x_new <= tol)), 0.0, x_new)
        newly_done = active & (x_new == 0.0)
        # The tol clamp can finish several slots in one step.
        flow = t_new - sarr
        slow = flow * alone_rate / sx0
        done_w = newly_done & (sarr >= w_lo) & (sarr < w_hi)
        if times is not None:
            tix = torch.where(newly_done, sid, n_times)
            times.scatter_(-1, tix, t_new.to(dtype).expand(C, S))
        cand = _claim(free, idx, ptr, S)
        claimed = admit & (idx == cand)
        arr_id = acc["n_admitted"]
        acc = {
            "n_admitted": arr_id + admit,
            "n_completed": acc["n_completed"] + newly_done.sum(-1, keepdim=True),
            "w_count": acc["w_count"] + done_w.sum(-1, keepdim=True),
            "w_arrived": acc["w_arrived"] + (admit & (t_next >= w_lo) & (t_next < w_hi)),
            "blocked": acc["blocked"] + blocked_now,
            "occ_max": torch.maximum(acc["occ_max"], active.sum(-1, keepdim=True)),
            "w_flow": acc["w_flow"] + torch.where(done_w, flow, 0.0).sum(-1, keepdim=True),
            "w_slow": acc["w_slow"] + torch.where(done_w, slow, 0.0).sum(-1, keepdim=True),
        }
        x_old, x = x, torch.where(claimed, x_next, x_new)
        sx0 = torch.where(claimed, x_next, sx0)
        sarr = torch.where(claimed, t_next, sarr)
        sid = torch.where(claimed, arr_id, sid)
        ptr = torch.where(admit, torch.remainder(cand + 1, S), ptr)
        src = tuple(torch.where(admit, a, b) for a, b in zip(source.advance(src), src))
        st_start = st
        st = srule.observe(st, Observation(alloc=alloc, rate=rate, dt=dt, active=active))
        if tel is not None:
            tel, out = telemetry.step(tel, ProbeEvent(
                t=t, dt=dt, alloc=alloc, rate=rate, active=active, x=x_old, p=p,
                rule_state=st_start))
            tel_outs.append(out)
        t = t_new

    tel_result = None if tel is None else telemetry.finalize(tel, tel_outs, lead)
    return x, t, acc, None if times is None else times[:, :n_times], tel_result


def run_stream(
    x0: torch.Tensor,
    arrival_times: torch.Tensor,
    p,
    rule: AllocRule | StatefulRule,
    *,
    n_slots: int,
    window=None,
    n_alone=1.0,
    horizon: int | None = None,
    rel_tol: float = 1e-9,
    t0=0.0,
    record_times: bool = False,
    fused: bool = False,
    telemetry=None,
) -> StreamResult:
    """:func:`run` over a fixed pool of ``n_slots`` recycled job slots.

    ``x0``/``arrival_times`` are ``[..., T]`` tapes; the loop runs every
    cell together for ``2T`` steps (or ``horizon``) over ``[C, n_slots]``
    slots (see :func:`_stream_scan` for the slot lifecycle and the
    deferred admission).  Each field of the :class:`StreamResult` has the
    tapes' lead shape.  With ``n_slots >= T`` the trajectory is
    :func:`run`'s on the same tape, bit for bit, up to two measure-zero
    cases (exactly tied arrival times are admitted one an event here; a
    departure whose rounding overshoots the next arrival admits it one
    epoch later).

    ``window=(lo, hi)`` is the stationary window, each bound a float or a
    tensor broadcasting over the lead dims; ``record_times=True`` also
    scatters completion times (input order) through a ``[C, T + 1]`` carry,
    a parity tool, not the O(n_slots) path.  ``fused=True`` swaps in the
    rule's ``fused_variant`` (the alloc kernel at ``[C, n_slots]`` on the
    card).  ``telemetry`` takes a probe (``core/telemetry.py``), whose
    read-out comes back on ``StreamResult.telemetry``.  ``p`` must be a
    scalar.
    """
    p = _scalar_p(p, "run_stream")
    rule = _resolve_fused(rule, fused)
    x0, arr, lead, dtype = _cells(x0, arrival_times)
    T = x0.shape[-1]
    order = torch.argsort(arr, dim=-1, stable=True)
    x_fin, t_fin, acc, times, tel = _stream_scan(
        tape_source(x0.gather(-1, order), arr.gather(-1, order)), p, as_stateful(rule),
        n_slots=n_slots, n_events=2 * T if horizon is None else horizon, window=window,
        lead=lead, n_alone=n_alone, tol=rel_tol * x0.amax(-1, keepdim=True), t0=t0,
        dtype=dtype, n_times=T if record_times else 0, telemetry=telemetry,
    )
    comp = None
    if record_times:
        comp = torch.zeros_like(times).scatter_(-1, order, times).reshape(*lead, T)
    return _finalize_stream(acc, t_fin, x_fin, comp, lead, tel)


def run_stream_source(
    source: StreamSource,
    p,
    rule: AllocRule | StatefulRule,
    *,
    n_slots: int,
    n_events: int,
    window=None,
    n_alone=1.0,
    x_scale=1.0,
    rel_tol: float = 1e-9,
    t0=0.0,
    dtype=torch.float64,
    fused: bool = False,
    telemetry=None,
) -> StreamResult:
    """:func:`run_stream` for an unbounded :class:`StreamSource`: exactly
    ``n_events`` steps, nothing sized by a job count.  The completion
    tolerance is absolute, ``rel_tol * x_scale`` (there is no tape to take
    a max over), and no per-job times are recorded.  The result has one
    value a row of the source (``[C]``), the probe's read-out too."""
    p = _scalar_p(p, "run_stream_source")
    rule = _resolve_fused(rule, fused)
    x_fin, t_fin, acc, _, tel = _stream_scan(
        source, p, as_stateful(rule), n_slots=n_slots, n_events=n_events, window=window,
        lead=None, n_alone=n_alone, tol=rel_tol * x_scale, t0=t0, dtype=dtype, n_times=0,
        telemetry=telemetry,
    )
    return _finalize_stream(acc, t_fin, x_fin, None, x_fin.shape[:1], tel)


def run_stream_ranked(
    x0: torch.Tensor,
    arrival_times: torch.Tensor,
    p,
    n_servers,
    rank_policy,
    *,
    n_slots: int,
    window=None,
    n_alone=1.0,
    horizon: int | None = None,
    t0=0.0,
    record_times: bool = False,
) -> StreamResult:
    """:func:`run_ranked` over a fixed pool of recycled job slots.

    Ranks live on slots (0 = free); a departure drops rank ``m``, an arrival
    inserts one rank and claims a slot from the ring pointer, with no sort
    at all.  Admission, deferral and the window follow :func:`run_stream`.
    Every active job arrived earlier, so the arriving job loses every exact
    size tie (``x >= x_a``, the JAX package's predicate here, unlike
    :func:`run_ranked`'s index tie-break).  ``p`` must be a scalar.
    """
    p = _scalar_p(p, "run_stream_ranked")
    x0, arr_in, lead, dtype = _cells(x0, arrival_times)
    C, T = x0.shape
    S = int(n_slots)
    dev = x0.device
    order = torch.argsort(arr_in, dim=-1, stable=True)
    arr = arr_in.gather(-1, order)
    xs = x0.gather(-1, order)
    idx = torch.arange(S, device=dev)
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    w_lo, w_hi = _window_bounds(window, lead, dtype, dev)
    alone_rate = speedup(torch.tensor(n_alone, dtype=dtype, device=dev), p)
    n_times = T if record_times else 0
    x = torch.zeros((C, S), dtype=dtype, device=dev)
    sx0 = torch.ones((C, S), dtype=dtype, device=dev)
    sarr = torch.zeros((C, S), dtype=dtype, device=dev)
    sid = torch.full((C, S), n_times, dtype=torch.int64, device=dev)
    ranks = torch.zeros((C, S), dtype=torch.int64, device=dev)
    m = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    i = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    ptr = torch.zeros((C, 1), dtype=torch.int64, device=dev)
    t = torch.full((C, 1), float(t0), dtype=dtype, device=dev)
    acc = _acc_zeros(C, dtype, dev)
    times = torch.full((C, n_times + 1), torch.inf, dtype=dtype, device=dev) if n_times else None

    for _ in range(2 * T if horizon is None else horizon):
        theta = rank_policy(ranks, m, p, dtype=dtype)
        rate = speedup(theta * n_servers, p)
        small = ranks.argmax(-1, keepdim=True)  # rank m, the smallest active job
        has_active = m > 0
        x_s = x.gather(-1, small)
        r_s = rate.gather(-1, small)
        dt_dep = torch.where(has_active & (r_s > 0), x_s / r_s, inf)
        i_c = i.clamp(max=T - 1)
        t_next = torch.where(i < T, arr.gather(-1, i_c), inf)
        dt_arr = torch.clamp(t_next - t, min=0.0)
        has_free = m < S
        eff_dt_arr = torch.where(has_free, dt_arr, inf)
        dt = torch.minimum(dt_dep, eff_dt_arr)
        any_event = torch.isfinite(dt)
        dt = torch.where(any_event, dt, 0.0)
        admit = any_event & has_free & (dt_arr <= dt_dep)
        take_dep = any_event & (dt_dep <= eff_dt_arr)
        blocked_now = torch.isfinite(dt_dep) & ~has_free & (dt_arr < dt_dep)
        t_new = torch.where(admit, torch.maximum(t_next, t), t + dt)
        active = ranks > 0
        x_new = torch.where(active, torch.clamp(x - dt * rate, min=0.0), x)
        departing = (idx == small) & active & take_dep
        dep_real = take_dep & has_active
        x_new = torch.where(departing, 0.0, x_new)
        # Windowed accounting on the single departer (rank m).
        arr_s = sarr.gather(-1, small)
        flow = t_new - arr_s
        slow = flow * alone_rate / sx0.gather(-1, small)
        cw = dep_real & (arr_s >= w_lo) & (arr_s < w_hi)
        if times is not None:
            tj = torch.where(dep_real, sid.gather(-1, small), n_times)
            times.scatter_(-1, tj, t_new.to(dtype))
        ranks = torch.where(departing, 0, ranks)
        # Arrival: claim a slot (epoch-start free mask) and insert its rank
        # among the post-departure active set; it loses exact ties.
        cand = _claim(~active, idx, ptr, S)
        x_a = xs.gather(-1, i_c)
        still = ranks > 0
        r_a = 1 + (still & (x_new >= x_a)).sum(-1, keepdim=True)
        bumped = torch.where(still & (ranks >= r_a), ranks + 1, ranks)
        ranks = torch.where(admit, bumped.scatter(-1, cand, r_a), ranks)
        claimed = admit & (idx == cand)
        x = torch.where(claimed, x_a, x_new)
        sx0 = torch.where(claimed, x_a, sx0)
        sarr = torch.where(claimed, t_next, sarr)
        sid = torch.where(claimed, i, sid)
        acc = {
            "n_admitted": acc["n_admitted"] + admit,
            "n_completed": acc["n_completed"] + dep_real,
            "w_count": acc["w_count"] + cw,
            "w_arrived": acc["w_arrived"] + (admit & (t_next >= w_lo) & (t_next < w_hi)),
            "blocked": acc["blocked"] + blocked_now,
            "occ_max": torch.maximum(acc["occ_max"], m),
            "w_flow": acc["w_flow"] + torch.where(cw, flow, 0.0),
            "w_slow": acc["w_slow"] + torch.where(cw, slow, 0.0),
        }
        m = m - dep_real.to(m.dtype) + admit.to(m.dtype)
        i = i + admit.to(i.dtype)
        ptr = torch.where(admit, torch.remainder(cand + 1, S), ptr)
        t = t_new

    comp = None
    if record_times:
        times = times[:, :n_times]
        comp = torch.zeros_like(times).scatter_(-1, order, times).reshape(*lead, T)
    return _finalize_stream(acc, t, x, comp, lead)


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
    "ProbeEvent",
    "EngineResult",
    "EngineTrace",
    "Observation",
    "StatefulRule",
    "StreamResult",
    "StreamSource",
    "as_stateful",
    "continuous_rule",
    "finish_alloc",
    "knee_rule",
    "poisson_source",
    "quantize_allocation",
    "quantized_rule",
    "run",
    "run_ranked",
    "run_stream",
    "run_stream_ranked",
    "run_stream_source",
    "snap_to_slices",
    "tape_source",
]
