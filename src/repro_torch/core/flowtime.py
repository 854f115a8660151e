"""Closed forms: the speedup curve and Theorem 8 (optimal flow time).

Port of ``repro.core.flowtime`` (``speedup``, ``omega_star``,
``hesrpt_total_flowtime``, ``hesrpt_mean_flowtime``): the ground truth the
event-driven simulator is checked against.
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
