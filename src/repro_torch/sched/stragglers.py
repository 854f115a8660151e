"""Straggler mitigation: expected-vs-observed throughput per job/worker.

Port of ``repro.sched.stragglers`` (plain Python).  The speedup model gives
an expectation: a healthy job on k chips should run at ~``rate_at(k)``.  A
job persistently below ``threshold`` of that (default 70%) for
``patience`` consecutive reports is flagged; the cluster controller
responds by evicting the slow worker (shrinking the job by one chip, after
which the scheduler re-quantizes) or restarting the job from checkpoint on
fresh chips.  Detection reads the model residual, so it needs no extra
communication.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StragglerDetector:
    threshold: float = 0.7
    patience: int = 3
    slow_counts: dict[str, int] = field(default_factory=dict)
    events: list[dict] = field(default_factory=list)

    def report(self, job_id: str, observed_rate: float, expected_rate: float,
               step: int = -1) -> bool:
        """Returns True when the job crosses the straggler threshold."""
        if expected_rate <= 0:
            return False
        ratio = observed_rate / expected_rate
        if ratio < self.threshold:
            self.slow_counts[job_id] = self.slow_counts.get(job_id, 0) + 1
        else:
            self.slow_counts[job_id] = 0
        if self.slow_counts.get(job_id, 0) >= self.patience:
            self.events.append(
                {"job": job_id, "step": step, "ratio": ratio, "action": "evict"}
            )
            self.slow_counts[job_id] = 0
            return True
        return False


__all__ = ["StragglerDetector"]
