"""Server-allocation policies: heSRPT and the competitors on the sweep path.

Port of ``repro.core.policies`` for ``hesrpt``, ``helrpt``, ``srpt``,
``equi`` and the rank-space forms.  Every policy maps remaining sizes
``x[..., M]`` (entries ``<= 0`` are departed jobs) and the speedup exponent
``p`` to shares ``theta[..., M]`` row by row, so a ``[cells, M]`` batch is
one call.

Paper: Berg, Vesilo, Harchol-Balter, "heSRPT: Optimal Parallel Scheduling of
Jobs With Known Sizes", 2019.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.core.ranking import ranks_from_order, size_order_desc

Policy = Callable[..., torch.Tensor]  # (x, p) -> theta


def _m_safe(m: torch.Tensor, dtype) -> torch.Tensor:
    return torch.clamp(m, min=1).to(dtype)


def bracket_pow(b: torch.Tensor, c) -> torch.Tensor:
    """``b ** c`` as the fused-allocate CUDA kernel computes it.

    For the exponents ``c = 1/(1-p)`` that are small integers (``p = 0`` ->
    1, ``p = 1/2`` -> 2, ``p = 2/3`` -> 3 when exact) both sides multiply;
    otherwise both call the device ``pow``.  Spelling the cases out keeps
    the kernel and this plain version on one op sequence without relying on
    how ``torch.pow`` special-cases a scalar exponent.
    """
    if not isinstance(c, torch.Tensor):
        if c == 1.0:
            return b
        if c == 2.0:
            return b * b
        if c == 3.0:
            return b * b * b
    return b.pow(c)


# Rank-space forms (Thm 6 size-invariance): ranks are 1-based descending-size
# ranks, 0 == inactive; ``m`` the active count, shaped to broadcast per row.
def hesrpt_theta_from_ranks(ranks, m, p, *, dtype=torch.float64) -> torch.Tensor:
    """Theorem 7 in rank space: theta = (r/m)^(1/(1-p)) - ((r-1)/m)^(1/(1-p))."""
    active = ranks > 0
    rf = ranks.to(dtype)
    c = 1.0 / (1.0 - p)
    m_safe = _m_safe(m, dtype)
    hi = bracket_pow(rf / m_safe, c)
    lo = bracket_pow((rf - 1.0) / m_safe, c)
    return torch.where(active, hi - lo, torch.zeros((), dtype=dtype, device=rf.device))


def equi_theta_from_ranks(ranks, m, p=None, *, dtype=torch.float64) -> torch.Tensor:
    active = ranks > 0
    share = 1.0 / _m_safe(m, dtype)
    return torch.where(active, share, torch.zeros((), dtype=dtype, device=ranks.device))


def srpt_theta_from_ranks(ranks, m, p=None, *, dtype=torch.float64) -> torch.Tensor:
    """The whole system to the smallest active job — rank m by definition."""
    return ((ranks == m) & (m > 0)).to(dtype)


def hesrpt(x: torch.Tensor, p) -> torch.Tensor:
    """heSRPT (Theorem 7): the optimal allocation for total flow time."""
    active = x > 0
    m = active.sum(-1, keepdim=True)
    ranks = ranks_from_order(size_order_desc(x), active)
    return hesrpt_theta_from_ranks(ranks, m, p, dtype=x.dtype)


def helrpt(x: torch.Tensor, p) -> torch.Tensor:
    """heLRPT (Theorem 2): the optimal allocation for makespan,
    ``x_i^(1/p) / sum_j x_j^(1/p)`` over active jobs."""
    active = x > 0
    tiny = torch.finfo(x.dtype).tiny
    xs = torch.where(active, x, 1.0)
    xmax = torch.where(active, x, 0.0).amax(-1, keepdim=True).clamp(min=tiny)
    w = torch.where(active, (xs / xmax).pow(1.0 / p), 0.0)
    return w / w.sum(-1, keepdim=True).clamp(min=tiny)


def srpt(x: torch.Tensor, p=None) -> torch.Tensor:
    """SRPT: the whole system to the job with the shortest remaining size
    (the first such job on a tie)."""
    active = x > 0
    key = torch.where(active, x, torch.inf)
    shortest = key.argmin(-1, keepdim=True)
    theta = torch.zeros_like(x).scatter_(-1, shortest, 1.0)
    return torch.where(active.any(-1, keepdim=True), theta, 0.0)


def equi(x: torch.Tensor, p=None) -> torch.Tensor:
    """EQUI: equal split between active jobs."""
    active = x > 0
    share = 1.0 / _m_safe(active.sum(-1, keepdim=True), x.dtype)
    return torch.where(active, share, 0.0)


#: Policies whose allocation is a pure function of the descending-size ranks;
#: the carried-rank event loop (``engine.run_ranked``) runs these.
RANK_POLICIES = {
    "hesrpt": hesrpt_theta_from_ranks,
    "equi": equi_theta_from_ranks,
    "srpt": srpt_theta_from_ranks,
}

_POLICIES = {"hesrpt": hesrpt, "helrpt": helrpt, "srpt": srpt, "equi": equi}
_NOT_PORTED = ("hell", "knee", "waterfill")


def make_rank_policy(name: str):
    """Rank-space form ``(ranks, m, p) -> theta`` or None if unavailable."""
    return RANK_POLICIES.get(name.lower())


def make_policy(name: str, *, n_servers: float = 1.0, alpha: float = 1.0) -> Policy:
    """The policy function by name.  Returns the module's function itself,
    so the engine can attach the fused allocate by an identity check."""
    del n_servers, alpha  # only the unported hell/knee/waterfill read them
    name = name.lower()
    if name in _POLICIES:
        return _POLICIES[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is not ported yet (ROADMAP.md Queue A, item 10: "
            "estimation and multi-class)"
        )
    raise ValueError(f"unknown policy {name!r}")
