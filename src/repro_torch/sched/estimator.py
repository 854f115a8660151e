"""Online estimation of the speedup exponent p from observed step throughput.

Port of ``repro.sched.estimator``, kept in NumPy as the reference is: it is
per-job bookkeeping of a few floats on the host.  With ``s(k) = c * k^p``,
observed throughput T(k) at allocation k satisfies ``log T = log c + p log
k``: weighted least squares over the (k, T) history, ridge-blended toward
a prior and optionally exponentially discounted so p tracks a regime
change.

``blended_p`` work-weights the per-job estimates into the single p heSRPT
uses; ``pooled_p_hat`` is the per-class fit over the concatenated
histories of a class's jobs.  This is the per-event oracle; the recursive
form that runs inside the event loop is ``core/estimation.py`` (the same
ridge formula over sufficient statistics), which the engine path seeds
from these histories through ``est_state_from_history``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# One source of the clip bounds for both forms (p = 0 and p = 1 are both
# degenerate for the Thm-7 brackets).
from repro_torch.core.estimation import P_CLIP


def _ridge_p_hat(lk, lt, w, prior_p: float, prior_weight: float) -> float:
    """Ridge-regularized WLS slope of ``lt`` on ``lk``, pulled toward
    ``prior_p`` with strength ``prior_weight``; the prior when the design
    is unidentifiable (all samples at one allocation)."""
    wsum = w.sum()
    mk, mt = (w * lk).sum() / wsum, (w * lt).sum() / wsum
    var = (w * (lk - mk) ** 2).sum()
    cov = (w * (lk - mk) * (lt - mt)).sum()
    if var < 1e-12:
        return prior_p
    slope = (cov + prior_weight * prior_p) / (var + prior_weight + 1e-12)
    return float(np.clip(slope, *P_CLIP))


def _columns(history):
    """``(log k, log T, weight)`` of a history as three arrays."""
    return (np.array([h[0] for h in history]), np.array([h[1] for h in history]),
            np.array([h[2] for h in history]))


@dataclass
class SpeedupEstimator:
    """Per-job (or per-job-class) p-hat from (chips, throughput) samples."""

    prior_p: float = 0.7
    prior_weight: float = 1.0
    discount: float = 1.0  # 1.0 = no forgetting
    history: list[tuple[float, float, float]] = field(default_factory=list)
    # entries: (log k, log T, weight)

    def observe(self, chips: float, throughput: float) -> None:
        if chips <= 0 or throughput <= 0:
            return
        for i, (lk, lt, w) in enumerate(self.history):
            self.history[i] = (lk, lt, w * self.discount)
        self.history.append((np.log(chips), np.log(throughput), 1.0))

    def p_hat(self) -> float:
        """Ridge-blended WLS slope (see :func:`_ridge_p_hat`)."""
        if len(self.history) < 2:
            return self.prior_p
        return _ridge_p_hat(*_columns(self.history), self.prior_p, self.prior_weight)

    def rate_at(self, chips: float) -> float:
        """Predicted throughput c * k^p (c fit given p_hat)."""
        if not self.history:
            return chips ** self.p_hat()
        p = self.p_hat()
        lk, lt, w = _columns(self.history)
        logc = ((lt - p * lk) * w).sum() / w.sum()
        return float(np.exp(logc) * chips ** p)


def blended_p(estimators, remaining_work) -> float:
    """Work-weighted mean p-hat across jobs (heSRPT needs one p)."""
    ps = np.array([e.p_hat() for e in estimators])
    w = np.asarray(remaining_work, dtype=np.float64)
    if w.sum() <= 0:
        return float(ps.mean()) if len(ps) else 0.7
    return float((ps * w).sum() / w.sum())


def pooled_p_hat(estimators, prior_p: float, prior_weight: float = 1.0) -> float:
    """One p-hat from the pooled histories of several estimators (the
    per-class fit; ``core.estimation.p_hat_classes`` sums the same
    statistics); ``prior_p`` below 2 pooled samples."""
    hist = [h for e in estimators for h in e.history]
    if len(hist) < 2:
        return prior_p
    return _ridge_p_hat(*_columns(hist), prior_p, prior_weight)


__all__ = ["SpeedupEstimator", "blended_p", "pooled_p_hat"]
