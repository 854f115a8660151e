"""Multi-class workloads: per-class speedup exponents, sizes and arrivals.

Port of ``repro.core.multiclass``.  The paper proves heSRPT optimal for one
job class; the follow-up work (Berg, Moseley, Wang, Harchol-Balter 2024;
Berg, Vesilo, Harchol-Balter 2020 for mean slowdown) mixes classes that
differ in speedup exponent and size distribution.  Here:

- :class:`ClassSpec` — one job class: exponent ``p``, arrival share
  ``mix``, Pareto sizes (``size_alpha`` / ``size_scale``), policy
  ``weight`` and the bursty sampler's ``burst``.
- The samplers ``multiclass_poisson`` (a Poisson stream with i.i.d. class
  marks), ``multiclass_bursty`` (one MAP on-off stream a class, merged) and
  ``drift_multiclass`` (every class's exponent drifts to ``p1[k]``
  mid-stream, as per-job ``PDrift`` rows), registered in
  ``core/scenarios.SCENARIOS``.  Like the port's other samplers they take a
  ``torch.Generator`` and ``[R]`` rates: sizes, class marks and unit gaps
  are drawn once a seed and the gaps scaled by rate, so the class census is
  shared across the rate axis (JAX's paired keys share it the same way).
- :func:`class_theta` — the allocation of the four class-aware policies
  (``hesrpt_pc``, ``waterfill``, ``hesrpt_sd``, ``hesrpt_blind``) on
  ``[C, M]`` rows with a per-job ``[C, M]`` exponent; :func:`class_rule`
  makes it an engine rule, continuous or whole chips (optionally
  slice-snapped).
- :func:`simulate_multiclass` — a multi-class scenario through
  ``engine.run`` with per-job ``p``.  With one exponent in every class, no
  noise, no drift, no estimator and a heSRPT-family policy it dispatches to
  the single-class ``simulate_online`` / ``simulate_online_quantized``, as
  the reference does, so K equal-``p`` classes reproduce the single-class
  run bit for bit.  ``estimator_kw`` runs the class-pooled estimating rule
  (``core/estimation.py``).
- :func:`per_class_metrics` and :func:`multiclass_sweep` (a thin spec over
  ``core/sweeps.py``'s ``Sweep(classes=)``).

This path launches no kernel, as in the reference: ``class_theta`` is plain
tensor ops, and ``Sweep.create`` refuses ``fused`` with ``classes``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine
from repro_torch.core.analysis import per_class_mean
from repro_torch.core.arrivals import (
    OnlineSimResult,
    _finalize,
    _noise_rows,
    _tapes,
    simulate_online,
    simulate_online_quantized,
)
from repro_torch.core.engine import PDrift
from repro_torch.core.policies import hesrpt, hesrpt_per_class, waterfill, weighted_hesrpt
from repro_torch.core.scenarios import (
    SCENARIOS,
    Scenario,
    _rates,
    bursty_arrivals,
    unit_gaps,
)
from repro_torch.device import DTYPE, as_tensor

#: Class-aware policy names accepted by :func:`class_theta` and friends.
MULTICLASS_POLICY_NAMES = ("hesrpt_pc", "waterfill", "hesrpt_sd", "hesrpt_blind")


class ClassSpec(NamedTuple):
    """One job class: plain Python floats, hashable for sweep specs."""

    p: float = 0.5  # speedup exponent of the class
    mix: float = 1.0  # arrival-rate share (normalized over classes)
    size_alpha: float = 1.5  # Pareto tail of the class's size distribution
    size_scale: float = 1.0  # multiplicative size scale (the Pareto x_m)
    weight: float = 1.0  # class weight for weighted policies
    burst: float = 4.0  # MAP on/off rate ratio (multiclass_bursty only)


def as_specs(classes) -> tuple[ClassSpec, ...]:
    """Coerce a sequence of ClassSpec / tuples / dicts into ClassSpec."""
    out = []
    for c in classes:
        if isinstance(c, ClassSpec):
            out.append(c)
        elif isinstance(c, dict):
            out.append(ClassSpec(**c))
        else:
            out.append(ClassSpec(*c))
    if not out:
        raise ValueError("need at least one job class")
    return tuple(out)


def uniform_p(classes) -> float | None:
    """The shared exponent when every class has the same ``p``, else None."""
    ps = {float(c.p) for c in as_specs(classes)}
    return ps.pop() if len(ps) == 1 else None


# ----------------------------------------------------- multi-class sampling
def _class_fields(specs, field, device, dtype=DTYPE) -> torch.Tensor:
    return torch.tensor([getattr(c, field) for c in specs], dtype=dtype, device=device)


def _pareto_mixture_sizes(gen: torch.Generator, cls: torch.Tensor, specs) -> torch.Tensor:
    """Per-job Pareto sizes by inverse CDF, ``scale_k * u^(-1/alpha_k)`` for
    a job of class k, ``u`` uniform on ``[tiny, 1)``."""
    dev = cls.device
    alphas = _class_fields(specs, "size_alpha", dev)[cls]
    scales = _class_fields(specs, "size_scale", dev)[cls]
    u = torch.rand(cls.shape, dtype=DTYPE, device=dev, generator=gen)
    return scales * u.clamp(min=torch.finfo(DTYPE).tiny) ** (-1.0 / alphas)


def _expand_rates(scn: Scenario, lead) -> Scenario:
    """Broadcast a seed's per-job fields over the rate axis of the tape."""
    return scn._replace(**{
        f: getattr(scn, f).expand(*lead, scn.x0.shape[-1]).contiguous()
        for f in ("x0", "class_ids", "p_job")
    })


def _multiclass_poisson(gen, n_jobs, rates, *, classes, size_alpha=None, **_):
    """A Poisson(rate) stream with i.i.d. class marks drawn from the mix
    (the superposition of the per-class streams).  ``size_alpha`` is
    ignored: the classes carry their own size distributions."""
    del size_alpha
    specs = as_specs(classes)
    dev = gen.device
    mixes = _class_fields(specs, "mix", dev)
    cdf = torch.cumsum(mixes / mixes.sum(), 0)
    u = torch.rand(n_jobs, dtype=DTYPE, device=dev, generator=gen)
    cls = torch.searchsorted(cdf, u, right=True).clamp(max=len(specs) - 1)
    arr = torch.cumsum(unit_gaps(gen, n_jobs) / _rates(rates, dev), -1)
    x0 = _pareto_mixture_sizes(gen, cls, specs)
    scn = Scenario(x0=x0, arrival_times=arr, class_ids=cls,
                   p_job=_class_fields(specs, "p", dev)[cls])
    return _expand_rates(scn, arr.shape[:-1])


def _class_counts(specs, n_jobs: int) -> list[int]:
    """Largest-remainder split of ``n_jobs`` across the class mix (ties to
    the lower class index)."""
    total = sum(c.mix for c in specs)
    raw = [n_jobs * c.mix / total for c in specs]
    counts = [int(r) for r in raw]
    fracs = sorted(
        range(len(specs)), key=lambda k: (raw[k] - counts[k], -k), reverse=True
    )
    for k in fracs[: n_jobs - sum(counts)]:
        counts[k] += 1
    return counts


def _multiclass_bursty(gen, n_jobs, rates, *, classes, p_stay=0.95, size_alpha=None, **_):
    """One 2-state MAP on-off stream a class at long-run intensity
    ``rate * mix_k`` with the class's own ``burst``, concatenated (the
    engine's arrival sort merges them).  The class census is the
    largest-remainder split of the mix, so it is the same in every draw."""
    del size_alpha
    specs = as_specs(classes)
    dev = gen.device
    r = _rates(rates, dev)
    total_mix = sum(c.mix for c in specs)
    arrs, sizes, ids = [], [], []
    for k, (spec, n_k) in enumerate(zip(specs, _class_counts(specs, n_jobs), strict=True)):
        if n_k == 0:
            continue
        rate_k = r * spec.mix / total_mix
        norm = 0.5 * (spec.burst + 1.0 / spec.burst)
        arrs.append(bursty_arrivals(gen, n_k, rate_k * spec.burst * norm,
                                    rate_k / spec.burst * norm, p_stay=p_stay))
        cls_k = torch.full((n_k,), k, dtype=torch.int64, device=dev)
        sizes.append(_pareto_mixture_sizes(gen, cls_k, specs))
        ids.append(cls_k)
    cls = torch.cat(ids)
    arr = torch.cat(arrs, -1)
    scn = Scenario(x0=torch.cat(sizes), arrival_times=arr, class_ids=cls,
                   p_job=_class_fields(specs, "p", dev)[cls])
    return _expand_rates(scn, arr.shape[:-1])


def _drift_multiclass(gen, n_jobs, rates, *, classes, p1, drift_frac=0.5, size_alpha=None,
                      **_):
    """A ``multiclass_poisson`` draw whose true exponents drift: class k goes
    from its ``ClassSpec.p`` to ``p1[k]`` at ``drift_frac`` of the nominal
    span ``n_jobs / rate``.  The ``PDrift`` has per-job rows, values
    ``[..., 2, M]`` (the pre-drift ``p_job``, then ``p1`` of each job's
    class) over times ``[..., 1]``; ``p_job`` keeps the pre-drift exponents
    (what a stale scheduler believes)."""
    del size_alpha
    specs = as_specs(classes)
    if len(p1) != len(specs):
        raise ValueError(
            f"p1 needs one post-drift exponent per class ({len(p1)} != {len(specs)})"
        )
    scn = _multiclass_poisson(gen, n_jobs, rates, classes=specs)
    dev = scn.x0.device
    p1_job = torch.tensor(p1, dtype=DTYPE, device=dev)[scn.class_ids]
    t_d = drift_frac * n_jobs / _rates(rates, dev)
    drift = PDrift(
        times=t_d.reshape(-1, 1) if t_d.ndim else t_d.reshape(1),
        values=torch.stack([scn.p_job, p1_job], -2),
    )
    return scn._replace(p_drift=drift)


SCENARIOS.setdefault("multiclass_poisson", _multiclass_poisson)
SCENARIOS.setdefault("multiclass_bursty", _multiclass_bursty)
SCENARIOS.setdefault("drift_multiclass", _drift_multiclass)


# ------------------------------------------------- class-aware allocation
def class_theta(name: str, x: torch.Tensor, p, *, n_servers, w=None) -> torch.Tensor:
    """The class-aware allocation ``(x, p[, w]) -> theta`` row by row:
    ``x`` ``[..., M]``, ``p`` and ``w`` per job (``w`` from
    :func:`policy_weights`, ignored by the unweighted policies).
    ``hesrpt_blind`` takes each row's active-job mean exponent at every call
    (the class-blind scheduler's view)."""
    name = name.lower()
    if name == "hesrpt_pc":
        return hesrpt_per_class(x, p)
    if name == "waterfill":
        return waterfill(x, p, n_servers, w)
    if name == "hesrpt_sd":
        if w is None:
            raise ValueError("hesrpt_sd needs per-job weights (1/x0)")
        return weighted_hesrpt(x, p, w)
    if name == "hesrpt_blind":
        active = x > 0
        m = active.sum(-1, keepdim=True).clamp(min=1).to(x.dtype)
        p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
        p_blind = torch.where(active, p, 0.0).sum(-1, keepdim=True) / m
        return hesrpt(x, p_blind)
    raise ValueError(f"unknown multi-class policy {name!r}; known: {MULTICLASS_POLICY_NAMES}")


def policy_weights(name: str, *, x0=None, class_w=None):
    """The per-job weights ``name`` expects, or None: ``hesrpt_sd`` weights
    a job by ``class_weight / x0`` (the mean-slowdown objective),
    ``waterfill`` takes the bare class weights."""
    name = name.lower()
    if name == "hesrpt_sd":
        if x0 is None:
            raise ValueError("hesrpt_sd weights need the original sizes x0")
        return (1.0 if class_w is None else class_w) / x0
    if name == "waterfill":
        return class_w
    return None


def class_rule(
    name: str, *, n_servers: float | None = None, n_chips: int | None = None,
    min_chips: int = 1, snap_slices: bool = False, dtype=DTYPE, w=None, size_factors=None,
    p_hat=None,
) -> engine.AllocRule:
    """The engine rule of a class-aware policy: continuous when ``n_chips``
    is None, else whole chips (largest remainder with a min-chips floor,
    slice-snapped under ``snap_slices``).  ``w``, ``size_factors`` and a
    per-job ``p_hat`` are ``[C, M]`` in the loop's arrival-sorted order (a
    ``p_hat`` column ``[C, 1]`` is one belief a row)."""
    n_alloc = float(n_chips) if n_chips is not None else float(n_servers)

    def rule(x_act, p):
        x_seen, p_seen = engine._seen(x_act, p, size_factors, p_hat)
        theta = class_theta(name, x_seen, p_seen, n_servers=n_alloc, w=w)
        return engine.finish_alloc(theta, p, n_alloc=n_alloc, n_chips=n_chips,
                                   min_chips=min_chips, snap_slices=snap_slices, dtype=dtype)

    return rule


# ----------------------------------------------------- engine entry points
def simulate_multiclass(
    scn: Scenario, *, classes=None, policy: str = "hesrpt_pc", n_servers: float = 256.0,
    n_chips: int | None = None, min_chips: int = 1, snap_slices: bool = False,
    rel_tol: float = 1e-9, horizon: int | None = None, estimator_kw: dict | None = None,
    device="cuda",
) -> OnlineSimResult:
    """Run multi-class scenarios ``[..., M]`` through the engine.

    The physics use ``scn.p_job`` (and ``scn.p_drift`` where set); the
    policy sees the estimation noise (``scn.size_factors`` / ``scn.p_hat``)
    in their place.  ``n_chips`` switches to whole chips, ``snap_slices``
    further to power-of-two slices.  ``estimator_kw`` replaces the drawn
    truth in the policy's view by per-class estimates fit online from
    observed throughput (``estimation.estimating_class_rule``; ``prior_p``
    defaults to each cell's mean ``p_job``, a ``[C, 1]`` column).

    With ``classes`` of one shared exponent, no noise, no drift, no
    estimator, a policy in ``hesrpt`` / ``hesrpt_pc`` / ``hesrpt_blind``
    and no snap with chips, the run is the single-class
    ``simulate_online`` (or ``simulate_online_quantized``), bit for bit.
    """
    specs = as_specs(classes) if classes is not None else None
    x0, arr = _tapes(scn.x0, scn.arrival_times, device)
    dev, dtype = x0.device, x0.dtype
    p_shared = uniform_p(specs) if specs is not None else None
    noiseless = scn.size_factors is None and scn.p_hat is None
    if (
        p_shared is not None and noiseless and scn.p_drift is None and estimator_kw is None
        and policy.lower() in ("hesrpt", "hesrpt_pc", "hesrpt_blind")
        and not (n_chips is not None and snap_slices)
    ):
        if n_chips is None:
            return simulate_online(x0, arr, p_shared, n_servers, hesrpt, rel_tol=rel_tol,
                                   horizon=horizon, device=dev)
        return simulate_online_quantized(x0, arr, p_shared, n_chips, hesrpt,
                                         min_chips=min_chips, rel_tol=rel_tol,
                                         horizon=horizon, device=dev)

    p_job = scn.p_job
    if p_job is None:
        if p_shared is None:
            raise ValueError(
                "scenario has no p_job; draw it with a multi-class sampler or pass "
                "uniform classes"
            )
        p_job = torch.full_like(x0, p_shared)
    p_job = as_tensor(p_job, dev).expand_as(x0)
    M, lead = x0.shape[-1], x0.shape[:-1]
    # The loop walks each row in arrival order; every per-job vector the
    # rule closes over is permuted the same way.
    order = engine.loop_order(arr.expand_as(x0).reshape(-1, M))

    def rows(v, dt=dtype):
        return engine.to_loop_order(torch.as_tensor(v, dtype=dt, device=dev), order, lead)

    factors, p_hat = _noise_rows(scn, x0, order)
    class_w = None
    if specs is not None and scn.class_ids is not None:
        ids = torch.as_tensor(scn.class_ids, device=dev)
        class_w = _class_fields(specs, "weight", dev, dtype)[ids]
    x0_seen = x0 if scn.size_factors is None else x0 * as_tensor(scn.size_factors, dev)
    w = policy_weights(policy, x0=x0_seen, class_w=class_w)
    if w is not None:
        w = rows(w)

    if estimator_kw is not None:
        from repro_torch.core import estimation

        if scn.class_ids is None:
            raise ValueError("estimator_kw needs a multi-class scenario")
        ids = torch.as_tensor(scn.class_ids, device=dev)
        kw = dict(estimator_kw)
        kw.setdefault("prior_p", p_job.reshape(-1, M).mean(-1, keepdim=True))
        rule = estimation.estimating_class_rule(
            policy, class_ids=rows(ids, torch.int64),
            n_classes=len(specs) if specs is not None else int(ids.max()) + 1,
            dtype=dtype, n_servers=float(n_servers), n_chips=n_chips, min_chips=min_chips,
            snap_slices=snap_slices, w=w, **kw,
        )
    else:
        rule = class_rule(policy, n_servers=float(n_servers), n_chips=n_chips,
                          min_chips=min_chips, snap_slices=snap_slices, dtype=dtype, w=w,
                          size_factors=factors, p_hat=p_hat)
    res = engine.run(x0, arr, p_job, rule, horizon=horizon, rel_tol=rel_tol,
                     p_drift=scn.p_drift)
    n_alone = n_chips if n_chips is not None else n_servers
    return _finalize(x0, arr, res.completion_times, p_job, n_alone)


def per_class_metrics(res: OnlineSimResult, class_ids, n_classes: int) -> dict:
    """Per-class mean flow time and mean slowdown, ``[..., K]`` each."""
    return {
        "mean_flowtime": per_class_mean(res.flow_times, class_ids, n_classes),
        "mean_slowdown": per_class_mean(res.slowdowns, class_ids, n_classes),
    }


def multiclass_sweep(
    policies, rates, *, classes, n_jobs: int = 1000, n_seeds: int = 10,
    n_servers: float = 256.0, seed: int = 0, scenario: str = "multiclass_poisson",
    scenario_kw: dict | None = None, n_chips: int | None = None, min_chips: int = 1,
    snap_slices: bool = False, chunk_seeds: int | None = None,
    max_jobs_in_flight: int | None = None, device="cuda",
) -> dict:
    """Seeds x loads x class-aware policies, one batch run a policy (per seed
    chunk), seeds shared across rates and policies.  Returns ``{policy:
    {"mean_flowtime": [R, S], "mean_slowdown": [R, S], "class_flowtime":
    [R, S, K], "class_slowdown": [R, S, K]}}``: ``Sweep(classes=)``
    through ``sweeps.run_sweep``."""
    from repro_torch.core.sweeps import Sweep, run_sweep

    spec = Sweep.create(
        policies, rates, scenario=scenario, scenario_kw=scenario_kw, n_jobs=n_jobs,
        n_seeds=n_seeds, seed=seed, n_servers=n_servers, n_chips=n_chips,
        min_chips=min_chips, snap_slices=snap_slices, classes=as_specs(classes),
        metrics=("mean_flowtime", "mean_slowdown", "class_flowtime", "class_slowdown"),
    )
    res = run_sweep(spec, chunk_seeds=chunk_seeds, max_jobs_in_flight=max_jobs_in_flight,
                    device=device)
    return {name: dict(res.stats[name]) for name in spec.policies}


__all__ = [
    "MULTICLASS_POLICY_NAMES",
    "ClassSpec",
    "as_specs",
    "class_rule",
    "class_theta",
    "multiclass_sweep",
    "per_class_metrics",
    "policy_weights",
    "simulate_multiclass",
    "uniform_p",
]
