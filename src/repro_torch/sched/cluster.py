"""ClusterScheduler: the paper's policies driving a chip pool.

Port of ``repro.sched.cluster``.  The scheduler owns the job table
(remaining work, fitted p-hat) and, at every *decision epoch* (a departure,
an arrival, a resize; Thm 3 says allocations need to change only at
departures, arrivals are the paper's §4.3 heuristic), recomputes:

    theta = policy(remaining_sizes, p)        # heSRPT / heLRPT / SRPT / ...
    chips = quantize(theta, N)                # largest remainder (+ slices)

The policy and the rounding run on ``device`` (``core/policies.py``,
``core/multiclass.py`` and ``sched/quantize.py``, which is the event
loop's own batched quantizer on one row); the job table, the fluid
advance and the estimators stay host-side NumPy, as in the reference.

``run_fluid_to_completion`` hands the whole fluid trajectory to
``core/engine.py::run`` whenever the instance fits the engine's model, one
loop on the device instead of one Python epoch at a time, with the same
rules: ``quantized_rule`` / ``continuous_rule``, ``knee_rule`` (KNEE's
per-epoch alpha refit), ``estimation.estimating_rule`` (``use_estimator``:
the blended p-hat carried through the loop) and ``multiclass.class_rule``
/ ``estimation.estimating_class_rule`` (``class_aware``).  The per-event
path (``allocations`` / ``advance_fluid``) is the oracle the delegated one
is held against, and the fallback for heterogeneous p without
``class_aware`` and for KNEE under the estimator.  Neither path launches
a kernel: the rules run without ``fused=``, as the reference's do.

The reference delegates only under ``jax_enable_x64``; the port always runs
float64 (``device.DTYPE``), so that clause is gone (ROADMAP.md Queue C).
``sched/elastic.py`` drives training jobs through ``allocations`` and
``report_progress``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import estimation as est
from repro_torch.core import multiclass as mc
from repro_torch.core.policies import make_policy
from repro_torch.device import DTYPE, resolve_device
from repro_torch.sched.estimator import SpeedupEstimator, blended_p, pooled_p_hat
from repro_torch.sched.quantize import quantize_allocation, snap_to_slices


@dataclass
class Job:
    job_id: str
    size: float  # total work units (e.g. training steps x step cost)
    p: float = 0.7  # true speedup exponent (the fluid physics)
    remaining: float = -1.0
    arrival_time: float = 0.0
    chips: float = 0  # whole chips normally; fractional when quantize=False
    completion_time: float | None = None
    class_id: int = 0  # job class (multi-class workloads; 0 = default class)
    # What the estimator believes before any observation: None = the true
    # p; set it away from ``p`` to simulate a stale or wrong prior.
    prior_p: float | None = None
    estimator: SpeedupEstimator = field(default_factory=SpeedupEstimator)

    def __post_init__(self):
        if self.remaining < 0:
            self.remaining = self.size
        self.estimator.prior_p = self.p if self.prior_p is None else self.prior_p


class ClusterScheduler:
    def __init__(
        self,
        n_chips: int,
        *,
        policy: str = "hesrpt",
        min_chips: int = 1,
        snap_slices: bool = False,
        use_estimator: bool = False,
        quantize: bool = True,
        rel_tol: float = 1e-9,
        class_aware: bool = False,
        class_weights: dict[int, float] | None = None,
        est_discount: float = 1.0,
        est_prior_weight: float = 1.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_chips = n_chips
        self.policy_name = policy
        self.min_chips = min_chips
        self.snap_slices = snap_slices
        self.use_estimator = use_estimator
        # quantize=False keeps the paper's continuously divisible allocation
        # (fractional chips): the fluid reference of core/arrivals.py.
        self.quantize = quantize
        # The engine's rel_tol: a departure must not be kept alive by float
        # residue (~eps * size) from the linear advance.
        self.rel_tol = rel_tol
        # class_aware=True: ``policy`` is a core.multiclass name, allocations
        # see the per-job exponent vector, the physics each job's own p.
        self.class_aware = class_aware
        self.class_weights = class_weights or {}
        # Estimation knobs (use_estimator=True), applied to every job's
        # estimator on admission (per-job priors come from Job.prior_p).
        self.est_discount = est_discount
        self.est_prior_weight = est_prior_weight
        self.jobs: dict[str, Job] = {}
        self.time = 0.0
        self.events: list[dict] = []

    def _tensor(self, values, dtype=DTYPE) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=self.device)

    # ------------------------------------------------------------- job table
    def add_job(self, job: Job) -> None:
        job.arrival_time = self.time
        if self.use_estimator:
            job.estimator.discount = self.est_discount
            job.estimator.prior_weight = self.est_prior_weight
        self.jobs[job.job_id] = job
        self.events.append({"t": self.time, "event": "arrival", "job": job.job_id})

    def active_jobs(self) -> list[Job]:
        return [j for j in self.jobs.values() if j.remaining > 0]

    def effective_p(self) -> float:
        act = self.active_jobs()
        if not act:
            return 0.7
        if self.use_estimator:
            return blended_p([j.estimator for j in act], [j.remaining for j in act])
        return float(np.mean([j.p for j in act]))

    def _class_inputs(self, act: list[Job]):
        """Per-job exponent vector and policy weight vector of an active set:
        one construction for the per-event path and the delegation, so
        their chips cannot drift apart."""
        p_vec = self._tensor([j.p for j in act])
        class_w = self._tensor([self.class_weights.get(j.class_id, 1.0) for j in act])
        w = mc.policy_weights(self.policy_name, x0=self._tensor([j.size for j in act]),
                              class_w=class_w)
        return p_vec, w

    def _class_priors(self):
        """Per-class ridge prior (mean ``prior_p`` over the class's jobs) and
        prior weight for classes ``0..K-1`` over the whole job table."""
        K = max(j.class_id for j in self.jobs.values()) + 1
        prior_p, prior_w = [], []
        for k in range(K):
            ests = [j.estimator for j in self.jobs.values() if j.class_id == k]
            prior_p.append(float(np.mean([e.prior_p for e in ests])) if ests else 0.7)
            prior_w.append(float(np.mean([e.prior_weight for e in ests])) if ests else 1.0)
        return K, prior_p, prior_w

    def _class_p_hat(self, act: list[Job]) -> np.ndarray:
        """Each active job's class's pooled p-hat (``pooled_p_hat`` over every
        job of the class, departed ones included)."""
        K, prior_p, prior_w = self._class_priors()
        p_k = np.empty(K)
        for k in range(K):
            ests = [j.estimator for j in self.jobs.values() if j.class_id == k]
            p_k[k] = pooled_p_hat(ests, prior_p[k], prior_w[k])
        return p_k[[j.class_id for j in act]]

    def _class_theta(self, act: list[Job]) -> torch.Tensor:
        """Class-aware theta: ``core.multiclass.class_theta``, the function the
        engine's class rule calls, on the per-job exponent vector (the
        per-class pooled p-hat under ``use_estimator``; the physics in
        ``job_rates`` keep each job's true exponent)."""
        x = self._tensor([j.remaining for j in act])
        p_vec, w = self._class_inputs(act)
        if self.use_estimator:
            p_vec = self._tensor(self._class_p_hat(act).tolist())
        return mc.class_theta(self.policy_name, x, p_vec, n_servers=float(self.n_chips), w=w)

    # ------------------------------------------------------ decision epochs
    def allocations(self) -> dict[str, float]:
        """Recompute theta -> chips for the current active set (int-valued
        when quantizing, fractional chips when ``quantize=False``)."""
        act = self.active_jobs()
        if not act:
            return {}
        p = self.effective_p()
        if self.class_aware:
            theta = self._class_theta(act)
        else:
            rem = [j.remaining for j in act]
            pol = make_policy(self.policy_name, n_servers=float(self.n_chips),
                              alpha=float(np.median(rem) * p / self.n_chips))
            theta = pol(self._tensor(rem), p)
        if self.quantize:
            chips = quantize_allocation(theta, self.n_chips, min_chips=self.min_chips)
            if self.snap_slices:
                chips = snap_to_slices(chips, self.n_chips)
            chips = chips.tolist()
        else:
            chips = (theta * self.n_chips).tolist()
        out = {}
        for j, c in zip(act, chips, strict=True):
            j.chips = c
            out[j.job_id] = c
        self.events.append({"t": self.time, "event": "allocate", "chips": dict(out), "p": p})
        return out

    # --------------------------------------------------------- progress I/O
    def report_progress(self, job_id: str, work_done: float, wall_dt: float = 0.0) -> None:
        job = self.jobs[job_id]
        job.remaining = max(job.remaining - work_done, 0.0)
        if wall_dt > 0:  # the caller keeps the wall clock
            job.estimator.observe(job.chips, work_done / wall_dt)
        if job.remaining == 0 and job.completion_time is None:
            job.completion_time = self.time
            self.events.append({"t": self.time, "event": "depart", "job": job_id})

    # --------------------------------------------------------- fluid model
    def job_rates(self, act: list[Job]) -> np.ndarray:
        """Per-job fluid service rates s(chips_j).  Class-aware and estimator
        modes use each job's own true exponent; the plain single-class mode
        keeps the reference's blended p."""
        if self.class_aware or self.use_estimator:
            return np.array([max(j.chips, 0) ** j.p for j in act])
        p = self.effective_p()
        return np.array([max(j.chips, 0) ** p for j in act])

    def advance_fluid(self, *, until_departure: bool = True, dt: float = 0.0):
        """Advance the fluid simulation: each job progresses at s(chips) =
        chips^p, to the next departure or by ``dt``."""
        act = self.active_jobs()
        if not act:
            return 0.0
        rates = self.job_rates(act)
        if until_departure:
            with np.errstate(divide="ignore"):
                tt = np.where(rates > 0, [j.remaining for j in act] / rates, np.inf)
            step = float(np.min(tt))
        else:
            step = dt
        if not np.isfinite(step):
            raise RuntimeError("no job can make progress (all rates zero)")
        # Float residue must not keep a departing job alive for a
        # micro-epoch: the engine's relative-tolerance clamp.
        tol = self.rel_tol * max(j.size for j in self.jobs.values())
        self.time += step
        for j, r in zip(act, rates, strict=True):
            j.remaining = max(j.remaining - step * r, 0.0)
            if j.remaining <= tol:
                j.remaining = 0.0
            if j.remaining == 0 and j.completion_time is None:
                j.completion_time = self.time
                self.events.append({"t": self.time, "event": "depart", "job": j.job_id})
        if self.use_estimator and step > 0:
            # The observation schedule the engine's stateful rule mirrors:
            # after each epoch every job that held chips observes its fluid
            # throughput (work / dt == rate).
            for j, r in zip(act, rates, strict=True):
                j.estimator.observe(j.chips, r)
        return step

    def _engine_eligible(self) -> bool:
        """Whether ``engine.run`` takes this instance: class-aware instances
        with a ``core.multiclass`` policy (any p mix), estimator instances
        with any policy but KNEE (``estimating_rule`` wraps a static
        policy), and plain single-class instances whose jobs share one p
        (their blended-p physics are not a per-job rule).  No float64
        clause: the port always runs float64."""
        act = self.active_jobs()
        if self.class_aware:
            return self.policy_name.lower() in mc.MULTICLASS_POLICY_NAMES
        if self.use_estimator:
            return self.policy_name.lower() != "knee"
        return len({j.p for j in act}) <= 1

    def _rule(self, act: list[Job]):
        """``(rule, p_arg, p)``: the engine rule of this instance, the
        exponent the loop's physics take and the event log's ``p``.  Every
        job is pre-arrived, so the loop's arrival order is ``act``'s and the
        per-job vectors go in as they are."""
        dtype, n_chips = DTYPE, self.n_chips if self.quantize else None
        tail = dict(n_chips=n_chips, min_chips=self.min_chips, snap_slices=self.snap_slices)
        if self.use_estimator:
            est_kw = dict(
                prior_weight=self._tensor([j.estimator.prior_weight for j in act]),
                discount=self._tensor([j.estimator.discount for j in act]),
                init_state=est.est_state_from_history(
                    [j.estimator.history for j in act], dtype, device=self.device),
            )
        if self.class_aware:
            p_arg, w = self._class_inputs(act)
            p = float(np.mean([j.p for j in act]))
            if not self.use_estimator:
                return mc.class_rule(self.policy_name, n_servers=float(self.n_chips),
                                     dtype=dtype, w=w, **tail), p_arg, p
            K, prior_p_k, prior_w_k = self._class_priors()
            # Departed jobs' observations still inform their class's pooled
            # p-hat, as the per-event path pools the whole table.
            inact = [j for j in self.jobs.values() if j.remaining <= 0]
            base = None
            if inact:
                base = est.pool_by_class(
                    est.est_state_from_history([j.estimator.history for j in inact], dtype,
                                               device=self.device),
                    self._tensor([j.class_id for j in inact], torch.int64), K)
            rule = est.estimating_class_rule(
                self.policy_name, class_ids=self._tensor([j.class_id for j in act], torch.int64),
                n_classes=K, prior_p=self._tensor(prior_p_k),
                prior_weight=self._tensor(prior_w_k), discount=est_kw["discount"],
                dtype=dtype, n_servers=float(self.n_chips), w=w,
                init_state=est_kw["init_state"], base_class_state=base, **tail)
            return rule, p_arg, p
        pol = make_policy(self.policy_name, n_servers=float(self.n_chips))
        if self.use_estimator:
            # Physics: each job's true exponent; the rule allocates with the
            # blended p-hat it carries through the loop.
            rule = est.estimating_rule(
                pol, float(self.n_chips), prior_p=self._tensor([j.estimator.prior_p for j in act]),
                dtype=dtype, **tail, **est_kw)
            return rule, self._tensor([j.p for j in act]), self.effective_p()
        p = self.effective_p()
        if self.policy_name.lower() == "knee":
            # KNEE refits alpha from the active set at every event, inside
            # the loop (the masked median).
            return engine.knee_rule(float(self.n_chips), dtype=dtype, **tail), p, p
        if self.quantize:
            return engine.quantized_rule(pol, self.n_chips, min_chips=self.min_chips,
                                         dtype=dtype, snap_slices=self.snap_slices), p, p
        return engine.continuous_rule(pol, float(self.n_chips), dtype=dtype), p, p

    def _run_fluid_engine(self) -> dict:
        """One ``engine.run`` for the whole trajectory (allocate -> advance ->
        repeat), replayed into the event log and the job table the per-event
        path would have produced."""
        act = self.active_jobs()
        ids = [j.job_id for j in act]
        M = len(act)
        rule, p_arg, p = self._rule(act)
        res = engine.run(
            self._tensor([j.remaining for j in act]), self._tensor([0.0] * M), p_arg, rule,
            pre_arrived=True, horizon=M, rel_tol=self.rel_tol, t0=self.time, record=True,
        )
        # One copy of the trajectory to the host.
        order, times, alloc, sizes, t_ev = (
            v.cpu() for v in (res.order, res.completion_times, res.trace.alloc,
                              res.trace.sizes, res.trace.times))
        # The replay reads the trace in ``act`` order: every job arrived at
        # t0, so the loop's stable arrival sort is the identity.
        if not torch.equal(order, torch.arange(M)):
            raise RuntimeError("engine trace order differs from the job table's")
        times = times.tolist()
        if not all(np.isfinite(times)):
            raise RuntimeError("scheduler failed to converge (engine)")
        last_chips: dict[str, float] = {}
        for e in range(alloc.shape[0]):
            live = (sizes[e] > 0).tolist()
            if not any(live):
                break
            row = alloc[e].tolist()
            # Continuous rules record theta; the log keeps the per-event
            # path's unit (fractional chips, theta * N).
            chips = {ids[i]: (row[i] if self.quantize else row[i] * self.n_chips)
                     for i in range(M) if live[i]}
            last_chips.update(chips)
            self.events.append({"t": float(t_ev[e]), "event": "allocate", "chips": chips, "p": p})
        for i, j in enumerate(act):
            j.remaining = 0.0
            j.chips = last_chips.get(j.job_id, 0)
            j.completion_time = times[i]
        for t, jid in sorted(zip(times, ids, strict=True)):
            self.events.append({"t": t, "event": "depart", "job": jid})
        self.time = max(times)
        return self._summary()

    def _summary(self) -> dict:
        times = {j.job_id: j.completion_time for j in self.jobs.values()}
        flows = {jid: t - self.jobs[jid].arrival_time for jid, t in times.items()}
        return {
            "completion_times": times,
            "total_flow_time": float(sum(flows.values())),
            "mean_flow_time": float(np.mean(list(flows.values()))),
            "makespan": float(max(times.values())),
        }

    def run_fluid_to_completion(self, *, use_engine: bool = True) -> dict:
        """Run the current job table to completion in the fluid model: one
        ``engine.run`` when eligible; ``use_engine=False`` forces the
        per-event epoch loop (allocate -> advance to the next departure ->
        repeat), the oracle the delegation is held against."""
        if use_engine and self.active_jobs() and self._engine_eligible():
            return self._run_fluid_engine()
        guard = 0
        while self.active_jobs():
            self.allocations()
            self.advance_fluid(until_departure=True)
            guard += 1
            if guard > 10 * len(self.jobs) + 100:
                raise RuntimeError("scheduler failed to converge")
        return self._summary()


__all__ = ["ClusterScheduler", "Job"]
