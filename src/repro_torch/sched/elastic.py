"""Elastic training jobs under the heSRPT cluster scheduler.  Port of
``repro.sched.elastic``.

Each ``ElasticJob`` is a training job (model, AdamW, the synthetic stream)
that the scheduler RESIZES between its epochs.  Its devices are a tuple of
ranks of the default process group.  A resize writes the job's state to
disk from the job's first rank (``train/checkpoint.py``), builds the job's
mesh over its new ranks (``launch/mesh.py::make_job_mesh``) and restores
the state on every new member after a barrier, so no rank reads a
checkpoint before it is complete.  Data parallelism inside a job is
explicit: parameters and optimizer state are plain tensors, replicated on
every member; each member takes its rows of the global batch, and the
gradient all-reduce over the mesh's ``"data"`` group is where gradient
compression (int8 / top-k with error feedback, ``train/compression.py``)
intercepts the collective.  Every member applies the same update, so the
replicas stay bit for bit equal; each member keeps its own error state, as
each device of the reference does, and a resize hands every new member the
first rank's (ROADMAP.md Queue C).

``ElasticClusterDriver`` couples the jobs to ``ClusterScheduler``: at every
departure epoch it asks the policy (heSRPT by default) for chip counts,
assigns ranks, resizes jobs, and advances the fluid clock while the jobs do
real training work.  Every rank of the world runs the driver's loop over an
identical copy of the scheduler's bookkeeping, calls ``ensure_devices`` for
every job in the same order (a mesh's subgroups are made collectively),
runs only the steps of the job that holds it, and reports the same progress
to the scheduler.  A run with no process group is a run on one device.
Flow time accounting matches the paper's model: job i on k chips
progresses at rate s(k) = k^p work units per unit time, and allocations
change only at departures (Thm 3).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data.pipeline import DataConfig, ShardedSyntheticStream
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.common import ModelOptions
from repro_torch.models.model import build_model
from repro_torch.sched.cluster import ClusterScheduler, Job
from repro_torch.sched.stragglers import StragglerDetector
from repro_torch.spans import span
from repro_torch.train import checkpoint
from repro_torch.train.compression import init_error_state, make_grad_reducer, recip32
from repro_torch.train.optimizer import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.train.tree import leaves, tree_map


@dataclass
class ElasticJobConfig:
    job_id: str
    model_cfg: object  # ModelConfig (smoke-scale)
    total_steps: int
    seq_len: int = 32
    batch_per_chip: int = 2
    p: float = 0.7  # speedup exponent handed to the scheduler
    lr: float = 1e-3
    compression: str | None = None  # None | int8 | topk
    seed: int = 0


#: The reference's job model: float32, no remat, and the mixers on their
#: ``chunked`` paths, which have a backward (the kernels have none).
JOB_OPTIONS = ModelOptions(attn_impl="chunked", mixer_impl="chunked",
                           activation_dtype="float32", remat="none")


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_elastic_step(model, opt_cfg: OptimizerConfig, reducer, group=None):
    """The reference's data-parallel ``local_step``: ``(params, opt, err,
    batch) -> (params, opt, err, loss)``.  The gradient of ``loss_fn`` on
    this rank's rows, ``reducer`` over ``group`` (``None``: one device),
    AdamW, and the loss averaged over the group.  The step owns its inputs:
    the reducer updates the gradients and ``err`` in place, and AdamW
    ``params`` and ``opt`` (``apply_updates(inplace=True)``).  Its three
    parts run under program spans (``repro_torch/spans.py``) a profiler
    trace reads."""
    inv_n = recip32(1 if group is None else dist.get_world_size(group))

    def step(params, opt, err, batch):
        with span("elastic.loss_and_grad"):
            alias = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss, _ = model.loss_fn(alias, batch)
            flat = leaves(alias)
            grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                             materialize_grads=True))
            grads = tree_map(lambda _: next(grads), alias)
            del alias, flat
        with span("elastic.reduce"):
            grads, err = reducer(grads, err)
        with span("elastic.apply_updates"):
            params, opt, _ = apply_updates(params, grads, opt, opt_cfg, inplace=True)
        loss = loss.detach()
        if group is not None:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            loss = loss * inv_n  # the reference's pmean, as jitted XLA computes it
        return params, opt, err, loss

    return step


class ElasticJob:
    """One resizable job.  Its first parameters are ``params`` (the job
    takes the tree over and updates it in place), else the model's ``init``
    on a ``torch.Generator`` seeded with ``cfg.seed``."""

    def __init__(self, cfg: ElasticJobConfig, ckpt_root: str, *, params=None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ckpt_dir = os.path.join(ckpt_root, cfg.job_id)
        self.model = build_model(cfg.model_cfg, JOB_OPTIONS, device=self.device)
        self.opt_cfg = OptimizerConfig(lr=cfg.lr, warmup_steps=5, total_steps=cfg.total_steps,
                                       clip_norm=1.0)
        if params is None:
            params = self.model.init(torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.state = {"params": params, "opt": init_opt_state(params),
                      "err": init_error_state(params)}
        self.steps_done = 0
        self.losses: dict[int, float] = {}  # step -> loss, the steps this rank ran
        self.resizes = 0
        self.mesh = None
        self.devices: tuple = ()
        self._step_fn = None

    # ------------------------------------------------------------- resizing
    def ensure_devices(self, devices) -> None:
        """Hold the job on ``devices`` (ranks).  Every rank of the world
        calls it, for every job, in the same order."""
        devices = tuple(int(d) for d in devices)
        if devices == self.devices:
            return
        grouped, me = dist.is_initialized(), _rank()
        if not grouped and devices != (0,):
            raise ValueError(f"ranks {devices} without a process group: start one first")
        if self.devices:
            # A resize: state -> disk from the first rank -> every new member.
            if me == self.devices[0]:
                checkpoint.save(self.ckpt_dir, self.state, step=self.steps_done)
            self.resizes += 1
        self.devices = devices
        group = None
        if grouped:
            self.mesh = mesh_lib.make_job_mesh(devices, device_type=self.device.type)
            if me in devices:
                group = self.mesh.get_group("data")
        if self.resizes:
            if grouped:
                dist.barrier()
            if me in devices:
                checkpoint.restore(self.ckpt_dir, self.state)
        self._step_fn = None
        if me in devices:
            reducer = make_grad_reducer(self.cfg.compression, group)
            self._step_fn = make_elastic_step(self.model, self.opt_cfg, reducer, group)

    # ------------------------------------------------------------- training
    def run_steps(self, n: int) -> int:
        """Advance the job by up to ``n`` steps; returns how many.  Only its
        members compute them; every rank counts them."""
        n = min(n, self.cfg.total_steps - self.steps_done)
        if n <= 0 or not self.devices:
            return 0
        if self._step_fn is not None:
            # The global batch drawn whole, as the reference draws it; this
            # rank takes its rows.
            bpc, r = self.cfg.batch_per_chip, self.devices.index(_rank())
            mc = self.cfg.model_cfg
            stream = ShardedSyntheticStream(
                DataConfig(mc.vocab_size, self.cfg.seq_len, len(self.devices) * bpc,
                           seed=self.cfg.seed),
                family=mc.family, model_cfg=mc)
            for step in range(self.steps_done, self.steps_done + n):
                batch = {k: torch.as_tensor(v[r * bpc:(r + 1) * bpc], device=self.device)
                         for k, v in stream.batch(step).items()}
                s = self.state
                p, o, e, loss = self._step_fn(s["params"], s["opt"], s["err"], batch)
                self.state = {"params": p, "opt": o, "err": e}
                self.losses[step] = loss.item()
        self.steps_done += n
        return n

    @property
    def done(self) -> bool:
        return self.steps_done >= self.cfg.total_steps


class ElasticClusterDriver:
    """Couples ClusterScheduler epochs to real elastic training jobs.

    ``devices`` are the chip pool's ranks (every rank of the started group,
    or ``[0]`` without one); ``params`` maps a job id to its first
    parameters.  ``straggler_detector`` is kept, unused, as the reference
    keeps it."""

    def __init__(self, job_cfgs: list[ElasticJobConfig], devices=None, *,
                 policy: str = "hesrpt", ckpt_root: str | None = None,
                 straggler_detector: StragglerDetector | None = None,
                 params: dict | None = None, device="cuda"):
        self.device = resolve_device(device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.devices = list(range(world) if devices is None else devices)
        if not self.devices or any(not 0 <= d < world for d in self.devices):
            raise ValueError(f"devices {self.devices} are not ranks of a world of {world}")
        ckpt_root = ckpt_root or os.path.join(tempfile.gettempdir(), "repro_torch_elastic")
        params = params or {}
        self.scheduler = ClusterScheduler(len(self.devices), policy=policy, device=self.device)
        self.jobs: dict[str, ElasticJob] = {}
        for jc in job_cfgs:
            self.jobs[jc.job_id] = ElasticJob(jc, ckpt_root, params=params.get(jc.job_id),
                                              device=self.device)
            self.scheduler.add_job(Job(jc.job_id, size=float(jc.total_steps), p=jc.p))
        self.detector = straggler_detector
        self.allocation_log: list[dict] = []

    def run(self, max_epochs: int = 100) -> dict:
        sched = self.scheduler
        for _ in range(max_epochs):
            act = sched.active_jobs()
            if not act:
                break
            alloc = sched.allocations()
            # contiguous rank assignment, largest allocation first (stable)
            cursor, ranks = 0, {}
            for jid in sorted(alloc, key=lambda j: -alloc[j]):
                k = int(alloc[jid])
                if k <= 0:
                    continue
                ranks[jid] = tuple(self.devices[cursor:cursor + k])
                cursor += k
                self.jobs[jid].ensure_devices(ranks[jid])
            self.allocation_log.append({"t": sched.time, "alloc": dict(alloc), "ranks": ranks})

            # fluid epoch: until the fastest-finishing job departs
            p = sched.effective_p()
            rates = {j.job_id: max(j.chips, 0) ** p for j in act}
            dt = min(j.remaining / rates[j.job_id] for j in act if rates[j.job_id] > 0)
            for j in act:
                steps = int(round(rates[j.job_id] * dt))
                steps = min(steps, int(round(j.remaining)))
                if j.remaining - steps < 0.5:  # finish the departing job exactly
                    steps = int(round(j.remaining))
                done = self.jobs[j.job_id].run_steps(steps)
                sched.report_progress(j.job_id, float(done))
            sched.time += dt
            for j in act:
                if j.remaining <= 0 and j.completion_time is None:
                    j.completion_time = sched.time
        # The reference's accounting, kept (ROADMAP.md Queue C): a departure
        # is stamped at the start of its epoch, and a stamp of 0.0 reads as
        # not departed (the makespan).
        flows = {jid: (j.completion_time or sched.time) - j.arrival_time
                 for jid, j in sched.jobs.items()}
        return {
            "total_flow_time": float(sum(flows.values())),
            "mean_flow_time": float(np.mean(list(flows.values()))),
            "makespan": float(max(flows.values())),
            "losses": self._gather_losses(),
            "resizes": {jid: job.resizes for jid, job in self.jobs.items()},
            "allocations": self.allocation_log,
        }

    def _gather_losses(self) -> dict:
        """Each job's loss at every step, from the ranks that computed it (its
        members agree bit for bit: the loss is all-reduced)."""
        mine = {jid: job.losses for jid, job in self.jobs.items()}
        parts = [mine]
        if dist.is_initialized():
            parts = [None] * dist.get_world_size()
            dist.all_gather_object(parts, mine)
        out = {}
        for jid, job in self.jobs.items():
            merged: dict[int, float] = {}
            for part in parts:
                for step, loss in part[jid].items():
                    merged.setdefault(step, loss)
            out[jid] = [merged[s] for s in range(job.steps_done)]
        return out


__all__ = ["ElasticClusterDriver", "ElasticJob", "ElasticJobConfig", "JOB_OPTIONS",
           "make_elastic_step"]
