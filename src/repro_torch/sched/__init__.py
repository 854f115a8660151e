"""Cluster scheduler built on the paper's policies: the job table and its
decision epochs, whole-chip quantization and slice snapping, online
p-estimation, elastic resizing of training jobs (``sched/elastic.py``) and
straggler detection.  Port of ``repro.sched``."""

from repro_torch.sched.cluster import ClusterScheduler, Job
from repro_torch.sched.elastic import ElasticClusterDriver, ElasticJob, ElasticJobConfig
from repro_torch.sched.estimator import SpeedupEstimator, blended_p, pooled_p_hat
from repro_torch.sched.quantize import quantize_allocation, snap_to_slices
from repro_torch.sched.stragglers import StragglerDetector

__all__ = [
    "ClusterScheduler",
    "ElasticClusterDriver",
    "ElasticJob",
    "ElasticJobConfig",
    "Job",
    "SpeedupEstimator",
    "StragglerDetector",
    "blended_p",
    "pooled_p_hat",
    "quantize_allocation",
    "snap_to_slices",
]
