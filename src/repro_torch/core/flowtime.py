"""Closed forms: the speedup curve, Theorem 2 (makespan), Theorem 8 (flow
time), its weighted analogue, and the rank-space bracket geometry.

Port of ``repro.core.flowtime``: the ground truth the event-driven
simulator is checked against, and the epoch geometry the superstep path
(``core/superstep.py``) scans.  Every function reduces over the last dim,
so a ``[C, M]`` batch of tapes is one call.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def speedup(k: torch.Tensor, p) -> torch.Tensor:
    """s(k) = k^p, the paper's sublinear concave speedup family."""
    return torch.where(k > 0, k.pow(p), torch.zeros_like(k))


def omega_star(m: int, p, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """Scale-free constants of the optimal policy (Thm 5/8), shape ``[m]``.

    ``omega*_1 = 0`` and ``omega*_k = 1 / ((k/(k-1))^(1/(1-p)) - 1)``.
    """
    k = torch.arange(1, m + 1, dtype=dtype, device=resolve_device(device))
    c = 1.0 / (1.0 - p)
    ratio = torch.where(k > 1, k / torch.clamp(k - 1.0, min=1e-300), torch.inf)
    return torch.where(k > 1, 1.0 / (ratio.pow(c) - 1.0), 0.0)


def hesrpt_total_flowtime(x_desc: torch.Tensor, p, n_servers) -> torch.Tensor:
    """Theorem 8: optimal total flow time for sizes ``x_desc`` (descending).

    ``T* = (1/s(N)) * sum_k x_k [k s(1+w_k) - (k-1) s(w_k)]``; reduces the
    last dim, so a ``[..., m]`` batch of descending tapes gives ``[...]``.
    """
    m = x_desc.shape[-1]
    dt, dev = x_desc.dtype, x_desc.device
    k = torch.arange(1, m + 1, dtype=dt, device=dev)
    om = omega_star(m, p, dtype=dt, device=dev)
    coeff = k * speedup(1.0 + om, p) - (k - 1.0) * speedup(om, p)
    s_n = speedup(torch.as_tensor(n_servers, dtype=dt, device=dev), p)
    return (x_desc * coeff).sum(-1) / s_n


def hesrpt_mean_flowtime(x_desc: torch.Tensor, p, n_servers) -> torch.Tensor:
    return hesrpt_total_flowtime(x_desc, p, n_servers) / x_desc.shape[-1]


def omega_weighted(w: torch.Tensor, p) -> torch.Tensor:
    """Scale-free constants of the weighted bracket policy:
    ``omega_k = W_{k-1}^c / (W_k^c - W_{k-1}^c)``, ``c = 1/(1-p)``, with
    ``W_k`` the cumulative weight down the ranking.  Uniform weights give
    :func:`omega_star`."""
    c = 1.0 / (1.0 - p)
    W = w.cumsum(-1)
    W_lo = W - w
    gap = torch.clamp(W.pow(c) - W_lo.pow(c), min=torch.finfo(W.dtype).tiny)
    return W_lo.pow(c) / gap


def weighted_total_flowtime(x_desc: torch.Tensor, w, p, n_servers) -> torch.Tensor:
    """``sum_k w_k T_k`` under ``policies.weighted_hesrpt`` in closed form:
    ``(1/s(N)) sum_k x_k (W_k^c - W_{k-1}^c)^(1-p)``, jobs ranked largest to
    smallest.  Valid when weights do not increase with size (departures
    then follow the size ranking)."""
    w = torch.as_tensor(w, dtype=x_desc.dtype, device=x_desc.device)
    c = 1.0 / (1.0 - p)
    W = w.cumsum(-1)
    W_lo = W - w
    s_n = speedup(torch.as_tensor(n_servers, dtype=x_desc.dtype, device=x_desc.device), p)
    return (x_desc * (W.pow(c) - W_lo.pow(c)).pow(1.0 - p)).sum(-1) / s_n


def hesrpt_sd_mean_slowdown(x_desc: torch.Tensor, p, n_servers) -> torch.Tensor:
    """Mean slowdown of the slowdown-weighted policy (weights ``1/x``):
    :func:`weighted_total_flowtime` rescaled by ``s(N)/M``."""
    M = x_desc.shape[-1]
    total = weighted_total_flowtime(x_desc, 1.0 / x_desc, p, n_servers)
    s_n = speedup(torch.as_tensor(n_servers, dtype=x_desc.dtype, device=x_desc.device), p)
    return total * s_n / M


def optimal_makespan(x: torch.Tensor, p, n_servers) -> torch.Tensor:
    """Theorem 2: ``||X||_{1/p} / s(N)`` over the active jobs of each row."""
    active = x > 0
    xmax = torch.where(active, x, 0.0).amax(-1).clamp(min=torch.finfo(x.dtype).tiny)
    ratio = torch.where(active, (x / xmax[..., None]).pow(1.0 / p), 0.0)
    norm = ratio.sum(-1).pow(p) * xmax
    return norm / speedup(torch.as_tensor(n_servers, dtype=x.dtype, device=x.device), p)


# Rank-space bracket geometry.  With c = 1/(1-p) and per-rank bracket
# numerators a_r (heSRPT r^c - (r-1)^c, EQUI 1, weighted W_r^c - W_{r-1}^c),
# m active jobs get theta_r = a_r / A_m, A_m = sum_{j<=m} a_j.  Since c p =
# c - 1, in the virtual time tau with dtau/dt = s(N) / A_m^p every rank
# shrinks linearly, x_r(tau) = x_r - a_r^p tau, for its whole life: rank r
# departs at tau = v_r = x_r / a_r^p, and the epoch with m jobs active lasts
# (v_m - v_{m+1}) A_m^p / s(N) of wall time.  Completion offsets are suffix
# sums of those durations.  SRPT is the degenerate bracket: x_r / s(N) each.
def rank_bracket_powers(
    M: int, p, policy: str = "hesrpt", *, weights_rank=None, dtype=torch.float64,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a_r^p, A_r^p)`` for descending-size ranks ``r = 1..M``: ``[M]``
    for ``"hesrpt"`` and ``"equi"`` (``[K, M]`` for a ``[K, 1]`` tensor
    ``p``, one exponent a row), ``[..., M]`` for ``"weighted_hesrpt"``
    (``weights_rank`` per rank, cumulated here, on its own device)."""
    c = 1.0 / (1.0 - p)
    if policy == "weighted_hesrpt":
        if weights_rank is None:
            raise ValueError("weighted_hesrpt bracket powers need weights_rank")
        W = torch.as_tensor(weights_rank, dtype=dtype).cumsum(-1)
        Wc = W.pow(c)
        gap = Wc - torch.nn.functional.pad(Wc[..., :-1], (1, 0))
        # Ranks past the active set may carry zero weight; keep their a^p
        # finite (every caller masks them out).
        return torch.clamp(gap, min=0.0).pow(p), torch.clamp(W, min=0.0).pow(c - 1.0)
    dev = resolve_device(device)
    if policy == "equi":
        r = torch.arange(1, M + 1, dtype=dtype, device=dev)
        Ap = r.pow(p)
        return torch.ones_like(Ap), Ap
    if policy == "hesrpt":
        r = torch.arange(0, M + 1, dtype=dtype, device=dev)
        rc = r.pow(c)
        return (rc[..., 1:] - rc[..., :-1]).pow(p), r[1:].pow(c - 1.0)
    raise ValueError(f"no bracket form for policy {policy!r}")


def epoch_schedule(x_rank, ap, Ap, rank_active, p, n_servers, *, srpt: bool = False):
    """Virtual departure thresholds ``v`` and completion offsets ``T``.

    ``x_rank[..., r-1]`` is the rank-``r`` job's remaining size (descending,
    ``rank_active`` masking ranks ``1..m``); ``(ap, Ap)`` from
    :func:`rank_bracket_powers`.  ``T[..., r-1]`` is the wall-clock offset
    at which rank ``r`` departs; ``v`` is zero for SRPT, whose epochs run
    one job at a time.
    """
    sN = speedup(torch.as_tensor(n_servers, dtype=x_rank.dtype, device=x_rank.device), p)
    if srpt:
        v = torch.zeros_like(x_rank)
        delta = torch.where(rank_active, x_rank, 0.0) / sN
    else:
        v = torch.where(rank_active, x_rank / ap, 0.0)
        v_next = torch.nn.functional.pad(v[..., 1:], (0, 1))
        # Rounding can leave v_r - v_{r+1} at -eps on exact size ties.
        delta = torch.clamp(v - v_next, min=0.0) * torch.where(rank_active, Ap, 0.0)
        delta = delta / sN
    return v, delta.flip(-1).cumsum(-1).flip(-1)


def hesrpt_completion_times(x_desc: torch.Tensor, p, n_servers) -> torch.Tensor:
    """Per-job completion times under heSRPT, jobs ranked largest to
    smallest along the last dim: the Thm-3 epochs in one suffix-sum pass."""
    M = x_desc.shape[-1]
    ap, Ap = rank_bracket_powers(M, p, "hesrpt", dtype=x_desc.dtype, device=x_desc.device)
    _, T = epoch_schedule(x_desc, ap, Ap, torch.ones_like(x_desc, dtype=torch.bool), p, n_servers)
    return T
