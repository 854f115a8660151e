"""Cluster scheduler built on the paper's policies: the job table and its
decision epochs, whole-chip quantization and slice snapping, online
p-estimation and straggler detection.  Port of ``repro.sched``;
``sched/elastic.py``, which drives training jobs, waits for ROADMAP.md
Queue A item 10c."""

from repro_torch.sched.cluster import ClusterScheduler, Job
from repro_torch.sched.estimator import SpeedupEstimator, blended_p, pooled_p_hat
from repro_torch.sched.quantize import quantize_allocation, snap_to_slices
from repro_torch.sched.stragglers import StragglerDetector

__all__ = [
    "ClusterScheduler",
    "Job",
    "SpeedupEstimator",
    "StragglerDetector",
    "blended_p",
    "pooled_p_hat",
    "quantize_allocation",
    "snap_to_slices",
]
