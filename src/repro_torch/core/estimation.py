"""Online speedup-exponent estimation as loop-carried rule state.

Port of ``repro.core.estimation``.  With
``s(k) = c k^p`` every observation satisfies ``log T = log c + p log k``, so
the discounted weighted least-squares slope needs only the running moments
``(sum w, sum w lk, sum w lt, sum w lk^2, sum w lk lt)`` a job, updated in
O(1) an event inside the engine's loop, ridge-blended toward a prior:

    p_hat = (cov + prior_weight * prior_p) / (var + prior_weight + 1e-12)

(the fixed NumPy estimator ``sched.estimator.SpeedupEstimator``'s fit).
Exponential ``discount`` applies to a job's past moments each time that job
observes, which lets p_hat track a drifting exponent.

Every state tensor is ``[M]`` at first and ``[C, M]`` once the loop's
first observation broadcasts it over the cell rows; :func:`blended_p_hat`
returns one ``[C, 1]`` value a row, the form the policies take for ``p``.

Jobs of one class share one exponent, so :func:`p_hat_classes` fits each
class from the sum of its jobs' statistics (:func:`pool_by_class`, ``[C,
K]``), and :func:`estimating_class_rule` shows the class-aware policies of
``core/multiclass.py`` each job's class estimate.  The pooling is a masked
sum over a one-hot ``[C, M, K]`` class mask (no atomic adds, so the order of
the sums is fixed on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.analysis import _class_mask
from repro_torch.core.policies import BisectGraph, Policy
from repro_torch.device import resolve_device
from repro_torch.spans import span

#: Clip bounds shared with the NumPy estimator (p = 0 and p = 1 are both
#: degenerate for the Thm-7 brackets).
P_CLIP = (0.01, 0.999)


class EstState(NamedTuple):
    """Per-job sufficient statistics of the discounted log-log WLS, in the
    loop's arrival-sorted job order; ``n`` counts raw observations (the fit
    falls back to the prior until a job has two)."""

    n: torch.Tensor  # [..., M] int32 observation counts
    s_w: torch.Tensor  # [..., M] sum w
    s_k: torch.Tensor  # [..., M] sum w log k
    s_t: torch.Tensor  # [..., M] sum w log T
    s_kk: torch.Tensor  # [..., M] sum w (log k)^2
    s_kt: torch.Tensor  # [..., M] sum w log k log T


def init_est_state(n_jobs: int, dtype=torch.float64, *, device="cuda") -> EstState:
    dev = resolve_device(device)
    z = torch.zeros(n_jobs, dtype=dtype, device=dev)
    return EstState(n=torch.zeros(n_jobs, dtype=torch.int32, device=dev),
                    s_w=z, s_k=z, s_t=z, s_kk=z, s_kt=z)


def est_state_from_history(histories, dtype=torch.float64, *, device="cuda") -> EstState:
    """Fold NumPy estimator histories (lists of ``(log k, log T, weight)`` a
    job) into an :class:`EstState` ``[M]``."""
    M = len(histories)
    n = np.zeros(M, np.int32)
    s = np.zeros((5, M), np.float64)
    for j, hist in enumerate(histories):
        for lk, lt, w in hist:
            n[j] += 1
            s[:, j] += (w, w * lk, w * lt, w * lk * lk, w * lk * lt)
    dev = resolve_device(device)
    return EstState(torch.as_tensor(n, device=dev),
                    *(torch.as_tensor(row, dtype=dtype, device=dev) for row in s))


def observe_throughput(state: EstState, obs: engine.Observation, *, discount=1.0) -> EstState:
    """Fold one epoch's ``(alloc, rate)`` into the running moments: a job
    observes only where it was active, held a positive allocation, made
    positive progress and the epoch had positive length; only the observing
    jobs' past moments are discounted."""
    dtype = state.s_w.dtype
    ok = obs.active & (obs.alloc > 0) & (obs.rate > 0) & (obs.dt > 0)
    lk = torch.where(obs.alloc > 0, obs.alloc, 1).to(dtype).log()
    lt = torch.where(obs.rate > 0, obs.rate, 1.0).to(dtype).log()
    d = torch.where(ok, torch.as_tensor(discount, dtype=dtype, device=ok.device), 1.0)
    okf = ok.to(dtype)
    return EstState(
        n=state.n + ok.to(torch.int32),
        s_w=state.s_w * d + okf,
        s_k=state.s_k * d + okf * lk,
        s_t=state.s_t * d + okf * lt,
        s_kk=state.s_kk * d + okf * lk * lk,
        s_kt=state.s_kt * d + okf * lk * lt,
    )


def _ridge_slope(n, s_w, s_k, s_t, s_kk, s_kt, prior_p, prior_weight):
    """The ridge fit on raw moments; the prior with fewer than 2 samples or
    an unidentifiable design (every sample at one allocation)."""
    s_w_safe = s_w.clamp(min=torch.finfo(s_w.dtype).tiny)
    var = s_kk - s_k * (s_k / s_w_safe)
    cov = s_kt - s_k * (s_t / s_w_safe)
    slope = (cov + prior_weight * prior_p) / (var + prior_weight + 1e-12)
    p = slope.clamp(*P_CLIP)
    return torch.where((n >= 2) & (var >= 1e-12), p, prior_p)


def _as_like(v, like: torch.Tensor):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def p_hat_jobs(state: EstState, prior_p, *, prior_weight=1.0) -> torch.Tensor:
    """Per-job p-hat (``SpeedupEstimator.p_hat``); ``prior_p`` and
    ``prior_weight`` broadcast (scalars or per-job tensors)."""
    return _ridge_slope(state.n, state.s_w, state.s_k, state.s_t, state.s_kk, state.s_kt,
                        _as_like(prior_p, state.s_w), _as_like(prior_weight, state.s_w))


def blended_p_hat(state: EstState, x_act: torch.Tensor, prior_p, *, prior_weight=1.0):
    """Work-weighted blend of the active jobs' p-hat (``x_act == 0`` drops a
    job), ``[..., 1]`` a row: what a single-exponent policy acts on
    (``sched.estimator.blended_p``).  A row with no active job reads 0."""
    ps = p_hat_jobs(state, prior_p, prior_weight=prior_weight)
    wsum = x_act.sum(-1, keepdim=True)
    return (ps * x_act).sum(-1, keepdim=True) / wsum.clamp(min=torch.finfo(x_act.dtype).tiny)


def pool_by_class(state: EstState, class_ids, n_classes: int) -> EstState:
    """Sum the per-job statistics ``[..., M]`` of each class into ``[..., K]``
    (``class_ids`` in the state's arrival-sorted job order); ``n`` comes
    back int64."""
    mask = _class_mask(torch.as_tensor(class_ids, device=state.s_w.device), n_classes)
    return EstState(*(torch.where(mask, f.unsqueeze(-1), 0).sum(-2) for f in state))


def p_hat_classes(state: EstState, class_ids, n_classes: int, prior_p, *, prior_weight=1.0,
                  base: EstState | None = None) -> torch.Tensor:
    """Per-class p-hat ``[..., K]`` from class-pooled statistics: the WLS on
    the concatenated histories of a class's jobs.  ``prior_p`` and
    ``prior_weight`` are scalars, per class ``[K]`` or per row ``[C, 1]``;
    ``base`` adds already-pooled ``[K]`` statistics of jobs outside the
    state (departed jobs keep informing their class)."""
    pooled = pool_by_class(state, class_ids, n_classes)
    if base is not None:
        pooled = EstState(*(a + torch.as_tensor(b, device=a.device)
                            for a, b in zip(pooled, base, strict=True)))
    return _ridge_slope(pooled.n, pooled.s_w, pooled.s_k, pooled.s_t, pooled.s_kk,
                        pooled.s_kt, _as_like(prior_p, state.s_w),
                        _as_like(prior_weight, state.s_w))


# ------------------------------------------------------ the stateful rules
def _rule_parts(n_alloc, n_chips, min_chips, snap_slices, dtype, discount):
    """The allocate tail (``engine.finish_alloc``, true-p rate) and the
    observe closure; continuous rules observe the chip count
    ``theta * n_alloc``."""

    def finish(theta, p):
        return engine.finish_alloc(theta, p, n_alloc=n_alloc, n_chips=n_chips,
                                   min_chips=min_chips, snap_slices=snap_slices, dtype=dtype)

    def observe(state, obs):
        alloc = obs.alloc if n_chips is not None else obs.alloc * n_alloc
        return observe_throughput(state, obs._replace(alloc=alloc), discount=discount)

    return finish, observe


def estimating_rule(
    policy: Policy, n_servers, *, prior_p, prior_weight=1.0, discount=1.0,
    dtype=torch.float64, n_jobs: int | None = None, n_chips: int | None = None,
    min_chips: int = 1, snap_slices: bool = False, init_state: EstState | None = None,
    device="cuda",
) -> engine.StatefulRule:
    """Single-class estimating rule: the policy sees the blended p-hat (a
    ``[C, 1]`` column), the physics keep the true, possibly drifting ``p``.

    Continuous when ``n_chips`` is None (the observed chips are ``theta *
    n_servers``), whole chips otherwise.  ``init_state`` seeds earlier
    observations; by default an empty state of ``n_jobs`` on ``device``.
    """
    if init_state is None:
        if n_jobs is None:
            raise ValueError("estimating_rule needs n_jobs or init_state")
        init_state = init_est_state(n_jobs, dtype, device=device)
    n_alloc = float(n_chips) if n_chips is not None else float(n_servers)
    finish, observe = _rule_parts(n_alloc, n_chips, min_chips, snap_slices, dtype, discount)

    def allocate(state, x_act, p):
        p_seen = blended_p_hat(state, x_act, prior_p, prior_weight=prior_weight)
        return finish(policy(x_act, p_seen), p)

    return engine.StatefulRule(init=lambda: init_state, observe=observe, allocate=allocate)


def estimating_class_rule(
    name: str, *, class_ids: torch.Tensor, n_classes: int, prior_p, prior_weight=1.0,
    discount=1.0, dtype=torch.float64, n_servers: float | None = None,
    n_chips: int | None = None, min_chips: int = 1, snap_slices: bool = False, w=None,
    init_state: EstState | None = None, base_class_state: EstState | None = None,
) -> engine.StatefulRule:
    """Class-aware estimating rule: the ``core/multiclass.py`` policy
    ``name`` sees each job's class p-hat (pooled statistics, read back
    through ``class_ids``), the physics keep each job's true exponent.

    ``class_ids`` and ``w`` are ``[C, M]`` (or ``[M]``) in the loop's
    arrival-sorted order; ``prior_p`` / ``prior_weight`` scalars, per class
    ``[K]`` or per row ``[C, 1]``.  ``base_class_state`` adds pooled ``[K]``
    statistics of jobs not in this run.
    """
    from repro_torch.core.multiclass import class_theta

    if init_state is None:
        init_state = init_est_state(class_ids.shape[-1], dtype, device=class_ids.device)
    n_alloc = float(n_chips) if n_chips is not None else float(n_servers)
    finish, observe = _rule_parts(n_alloc, n_chips, min_chips, snap_slices, dtype, discount)
    graph = BisectGraph()

    def allocate(state, x_act, p):
        p_k = p_hat_classes(state, class_ids, n_classes, prior_p,
                            prior_weight=prior_weight, base=base_class_state)
        ids = class_ids.expand(*p_k.shape[:-1], class_ids.shape[-1])
        p_seen = p_k.gather(-1, ids)
        with span("multiclass.theta"):
            theta = class_theta(name, x_act, p_seen, n_servers=n_alloc, w=w, graph=graph)
        return finish(theta, p)

    return engine.StatefulRule(init=lambda: init_state, observe=observe, allocate=allocate)


def simulate_scenario_estimated(
    scn, p, n_servers, policy: Policy, *, prior_p, prior_weight=1.0, discount=1.0,
    n_chips: int | None = None, min_chips: int = 1, rel_tol: float = 1e-9,
    horizon: int | None = None, telemetry=None, device="cuda",
):
    """Run drawn scenarios ``[..., M]`` with the estimator in the loop: the
    policy allocates with the blended p-hat fit online from observed
    throughput, the physics use the true exponent (``scn.p_job`` per job
    where set, and ``scn.p_drift`` where set).  The estimator-free arms are
    ``arrivals.simulate_scenario`` with and without a pinned ``p_hat``.

    ``telemetry`` takes a probe; the return is then ``(OnlineSimResult,
    TelemetryResult)`` (``p_hat_err`` reads the rule's state through
    ``telemetry.p_hat_error_metric(prior_p, prior_weight=...)``).
    """
    from repro_torch.core.arrivals import _finalize, _tapes

    x0, arr = _tapes(scn.x0, scn.arrival_times, device)
    if scn.p_job is not None:
        p = torch.as_tensor(scn.p_job, dtype=x0.dtype, device=x0.device).expand_as(x0)
    rule = estimating_rule(
        policy, n_servers, prior_p=prior_p, prior_weight=prior_weight, discount=discount,
        dtype=x0.dtype, n_jobs=x0.shape[-1], n_chips=n_chips, min_chips=min_chips,
        device=x0.device,
    )
    res = engine.run(x0, arr, p, rule, horizon=horizon, rel_tol=rel_tol,
                     p_drift=scn.p_drift, telemetry=telemetry)
    n_alone = n_chips if n_chips is not None else n_servers
    out = _finalize(x0, arr, res.completion_times, p, n_alone)
    return (out, res.telemetry) if telemetry is not None else out


__all__ = [
    "EstState",
    "P_CLIP",
    "blended_p_hat",
    "est_state_from_history",
    "estimating_class_rule",
    "estimating_rule",
    "init_est_state",
    "observe_throughput",
    "p_hat_classes",
    "p_hat_jobs",
    "pool_by_class",
    "simulate_scenario_estimated",
]
