"""The benchmark's own frozen copy of the job tapes' draws.

Online grids: one generator a seed, from numpy's ``SeedSequence`` spawn tree
of the grid's seed, on the device the grid runs on; it draws ``M`` Exp(1)
gaps, then ``M`` Exp(1) variates for the sizes.  Each rate ``r`` scales the
same gaps: arrivals are ``cumsum(gaps / r)`` over an ``[R, M]`` block, and
the sizes ``exp(e / alpha)`` (Pareto(alpha), minimum 1) are shared by every
rate.
"""

from __future__ import annotations

import numpy as np
import torch


def seed_generator(seed: int, index: int, device) -> torch.Generator:
    child = np.random.SeedSequence(seed).spawn(index + 1)[index]
    return torch.Generator(device=device).manual_seed(int(child.generate_state(1)[0]))


def poisson_pareto(seed: int, index: int, rates, n_jobs: int, alpha: float, device):
    """Sizes and arrival times ``[R, M]`` of seed ``index`` of a grid, float64."""
    gen = seed_generator(seed, index, device)
    gaps = torch.empty(n_jobs, dtype=torch.float64, device=device).exponential_(generator=gen)
    rate = torch.as_tensor(rates, dtype=torch.float64, device=device).reshape(-1, 1)
    arrivals = torch.cumsum(gaps / rate, -1)
    e = torch.empty(n_jobs, dtype=torch.float64, device=device).exponential_(generator=gen)
    sizes = torch.exp(e / alpha).expand_as(arrivals)
    return sizes, arrivals
