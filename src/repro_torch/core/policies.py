"""Server-allocation policies: heSRPT and its competitors.

Port of ``repro.core.policies``: ``hesrpt``, ``helrpt``, ``srpt``,
``equi``, the rank-space forms, the paper's Fig-4 competitors ``hell`` and
``knee``, and the class-aware ``hesrpt_per_class``, ``weighted_hesrpt`` and
``waterfill``.  Every policy maps remaining sizes ``x[..., M]`` (entries
``<= 0`` are departed jobs) and the speedup exponent ``p`` to shares
``theta[..., M]`` row by row, so a ``[cells, M]`` batch is one call.  The
class-aware three also take a per-job ``p[..., M]`` (one exponent a job,
the multi-class runs of ``core/multiclass.py``).  The JAX package's ``lax.cond`` branches
become ``torch.where`` over both branches, decided per row.

Paper: Berg, Vesilo, Harchol-Balter, "heSRPT: Optimal Parallel Scheduling of
Jobs With Known Sizes", 2019.
"""

from __future__ import annotations

import functools
from collections.abc import Callable

import torch

from repro_torch.core.ranking import inv_rank, ranks_from_order, size_order_desc

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

    ``c`` is a float or a float64 tensor broadcasting per row (``[C, 1]``:
    a drifting ``p``), whose modes are chosen element by element from the
    float64 ``c`` before it is cast to ``b``'s type, as the kernel chooses
    them per cell.  Either exponent reaches ``pow`` as a tensor laid out
    like ``b`` (a 0-dim one for a float), so on the CPU, whose vectorized
    ``pow`` differs from its scalar loop in the last ulp, a row's result
    does not depend on whether the other rows share its exponent.
    """
    if not isinstance(c, torch.Tensor):
        if c == 1.0:
            return b
        if c == 2.0:
            return b * b
        if c == 3.0:
            return b * b * b
        return b.pow(torch.tensor(c, dtype=b.dtype))
    powered = b.pow(c.to(b.dtype).expand_as(b).contiguous())
    return torch.where(
        c == 1.0, b, torch.where(c == 2.0, b * b, torch.where(c == 3.0, b * b * b, powered))
    )


# Rank-space forms (Thm 6 size-invariance): ranks are 1-based descending-size
# ranks, 0 == inactive; ``m`` the active count, shaped to broadcast per row.
def hesrpt_theta_from_ranks(ranks, m, p, *, dtype=torch.float64) -> torch.Tensor:
    """Theorem 7 in rank space: theta = (r/m)^(1/(1-p)) - ((r-1)/m)^(1/(1-p))."""
    active = ranks > 0
    rf = ranks.to(dtype)
    # A tensor p (one exponent a row) takes its c in float64, as the kernel.
    c = 1.0 / (1.0 - (p.to(torch.float64) if isinstance(p, torch.Tensor) else p))
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


def _tiny(x: torch.Tensor) -> float:
    return torch.finfo(x.dtype).tiny


def hell(x: torch.Tensor, p, n_servers=None) -> torch.Tensor:
    """HELL: the greedy efficiency-to-remaining-time heuristic in its
    continuous limit.  For ``p >= 1/2`` the greedy pick is SRPT; below it
    water-fills to ``k_i ~ x_i^(-1/(1-2p))``.  ``p`` may be a scalar or a
    tensor broadcasting per row; both branches are computed, so the
    water-fill's exponent keeps the reference's ``1e-12`` guard.
    """
    del n_servers  # the continuous fixed point does not depend on N
    active = x > 0
    p = torch.as_tensor(p, dtype=x.dtype, device=x.device)
    xs = torch.where(active, x, 1.0)
    xmin = torch.where(active, x, torch.inf).amin(-1, keepdim=True)
    expo = -1.0 / torch.clamp(1.0 - 2.0 * p, min=1e-12)
    w = torch.where(active, (xs / xmin).pow(expo), 0.0)
    fill = w / w.sum(-1, keepdim=True).clamp(min=_tiny(x))
    return torch.where(p < 0.5, fill, srpt(x))


def knee(x: torch.Tensor, p, n_servers, alpha) -> torch.Tensor:
    """KNEE: each job its knee ``(p x_i / alpha)^(1/(1+p))`` of servers.

    Rows whose knees undersubscribe ``n_servers`` split the whole system in
    proportion to the knees; oversubscribed rows serve the smallest knees
    first (stable on ties) until the servers run out.  ``alpha`` may be a
    scalar or a ``[C, 1]`` column, one value per row (an alpha grid).
    """
    active = x > 0
    xs = torch.where(active, x, 0.0)
    kn = torch.where(active, (p * xs / alpha).pow(1.0 / (1.0 + p)), 0.0)
    total = kn.sum(-1, keepdim=True)
    under = kn / total.clamp(min=_tiny(x))
    order = torch.argsort(torch.where(active, kn, torch.inf), dim=-1, stable=True)
    kn_sorted = kn.gather(-1, order)
    prev = kn_sorted.cumsum(-1) - kn_sorted
    grant_sorted = torch.minimum(torch.clamp(n_servers - prev, min=0.0), kn_sorted)
    grant = torch.zeros_like(kn).scatter_(-1, order, grant_sorted)
    over = torch.where(active, grant / n_servers, 0.0)
    return torch.where(total <= n_servers, under, over)


def hesrpt_per_class(x: torch.Tensor, p) -> torch.Tensor:
    """Class-aware heSRPT: each job's Thm-7 bracket at its own exponent,
    ``(r/m)^c_i - ((r-1)/m)^c_i`` with ``c_i = 1/(1-p_i)`` and ``r`` its
    global descending-size rank (ties by index), renormalized to sum to 1.
    ``p`` is per job (``[..., M]``) or broadcasts.  The index tie-break is
    the reference's: ``x = [1, 1]`` at ``p = 0.5`` gives ``[0.25, 0.75]``."""
    active = x > 0
    m = active.sum(-1, keepdim=True)
    rf = ranks_from_order(size_order_desc(x), active).to(x.dtype)
    c = 1.0 / (1.0 - torch.as_tensor(p, dtype=x.dtype, device=x.device))
    m_safe = _m_safe(m, x.dtype)
    th = torch.where(active, (rf / m_safe).pow(c) - ((rf - 1.0) / m_safe).pow(c), 0.0)
    return th / th.sum(-1, keepdim=True).clamp(min=_tiny(x))


def weighted_hesrpt(x: torch.Tensor, p, w: torch.Tensor) -> torch.Tensor:
    """Weighted heSRPT: Thm-7 brackets over cumulative *weight* fractions
    ``W_r / W`` of the jobs ranked largest to smallest, renormalized.
    Uniform weights give :func:`hesrpt` up to the last ulp; ``p`` may be per
    job, as in :func:`hesrpt_per_class`."""
    active = x > 0
    order = size_order_desc(x)
    w_act = torch.where(active, w, 0.0)
    csum_sorted = w_act.gather(-1, order).cumsum(-1)
    w_hi = csum_sorted.gather(-1, inv_rank(order))
    w_lo = w_hi - w_act
    w_tot = csum_sorted[..., -1:].clamp(min=_tiny(x))
    c = 1.0 / (1.0 - p)
    th = torch.where(active, (w_hi / w_tot).pow(c) - (w_lo / w_tot).pow(c), 0.0)
    return th / th.sum(-1, keepdim=True).clamp(min=_tiny(x))


def waterfill(x: torch.Tensor, p, n_servers, w=None, *, n_iter: int = 64) -> torch.Tensor:
    """Class-weighted water-filling: ``theta`` maximizing ``sum_i w_i / x_i
    s(theta_i N)`` subject to ``sum theta = 1``, by ``n_iter`` bisection
    steps on the log water level (a fixed number of batched steps, each row
    its own bracket), then renormalized.  ``p`` and ``w`` may be per job."""
    active = x > 0
    dtype = x.dtype
    p = torch.as_tensor(p, dtype=dtype, device=x.device).expand_as(x)
    xs = torch.where(active, x, 1.0)
    wv = torch.ones_like(x) if w is None else torch.as_tensor(w, dtype=dtype, device=x.device)
    wv = torch.where(active, wv.clamp(min=_tiny(x)), 1.0)
    n = torch.as_tensor(n_servers, dtype=dtype, device=x.device)
    log_g = torch.log(wv) - torch.log(xs) + torch.log(p) + p * torch.log(n)
    m = active.sum(-1, keepdim=True).clamp(min=1).to(dtype)
    one_minus_p = 1.0 - p
    lo = torch.where(active, log_g, -torch.inf).amax(-1, keepdim=True)
    hi = torch.where(active, log_g + one_minus_p * torch.log(m), -torch.inf).amax(-1, keepdim=True)

    def theta_of(log_lam):
        return torch.where(active, torch.exp((log_g - log_lam) / one_minus_p), 0.0)

    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_big = theta_of(mid).sum(-1, keepdim=True) > 1.0
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    th = theta_of(0.5 * (lo + hi))
    th = th / th.sum(-1, keepdim=True).clamp(min=_tiny(x))
    return torch.where(active.any(-1, keepdim=True), th, 0.0)


#: Policies whose allocation is a pure function of the descending-size ranks;
#: the carried-rank event loop (``engine.run_ranked``) runs these.
RANK_POLICIES = {
    "hesrpt": hesrpt_theta_from_ranks,
    "equi": equi_theta_from_ranks,
    "srpt": srpt_theta_from_ranks,
}

_POLICIES = {"hesrpt": hesrpt, "helrpt": helrpt, "srpt": srpt, "equi": equi}

POLICY_NAMES = ("hesrpt", "helrpt", "srpt", "equi", "hell", "knee", "waterfill")


def make_rank_policy(name: str):
    """Rank-space form ``(ranks, m, p) -> theta`` or None if unavailable."""
    return RANK_POLICIES.get(name.lower())


def make_policy(name: str, *, n_servers: float = 1.0, alpha: float = 1.0) -> Policy:
    """The policy function by name.  heSRPT, heLRPT, SRPT and EQUI come
    back as the module's functions themselves, so the engine attaches the
    fused allocate and the superstep path by an identity check; HELL, KNEE
    and water-filling close over ``n_servers`` (and KNEE over ``alpha``,
    a scalar or a ``[C, 1]`` column)."""
    name = name.lower()
    if name in _POLICIES:
        return _POLICIES[name]
    if name == "hell":
        return functools.partial(hell, n_servers=n_servers)
    if name == "knee":
        return functools.partial(knee, n_servers=n_servers, alpha=alpha)
    if name == "waterfill":
        return functools.partial(waterfill, n_servers=n_servers)
    raise ValueError(f"unknown policy {name!r}")
