"""Inverse permutations and descending-size ranks over the last dim.

Port of ``repro.core.ranking``.  Every function takes ``[..., M]`` tensors
and works row by row, so a ``[cells, M]`` batch needs no loop.  Ties break
by index (stable argsort), which is part of the contract: heSRPT on
``x = [1, 1]`` gives the second job the larger share.
"""

from __future__ import annotations

import torch


def inv_rank(order: torch.Tensor) -> torch.Tensor:
    """Position of each element in its own argsort (the inverse permutation).

    ``inv_rank(argsort(key))[..., i]`` is the 0-based position job ``i``
    takes when its row is sorted by ``key``.
    """
    M = order.shape[-1]
    pos = torch.arange(M, device=order.device).expand_as(order)
    return torch.zeros_like(order).scatter_(-1, order, pos)


def size_order_desc(x: torch.Tensor) -> torch.Tensor:
    """Stable argsort of each row by remaining size, descending.

    Active (``x > 0``) jobs come first, largest first; inactive jobs sort
    last (key ``+inf``).  Ties break by index.
    """
    key = torch.where(x > 0, -x, torch.full_like(x, torch.inf))
    return torch.argsort(key, dim=-1, stable=True)


def ranks_from_order(order: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """1-based ranks from a :func:`size_order_desc` order (0 = inactive)."""
    return torch.where(active, inv_rank(order) + 1, 0)
