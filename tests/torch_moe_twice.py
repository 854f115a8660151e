"""The ``ragged_local`` MoE dispatch's backward run twice on the same
inputs, shared by the CPU test (``tests/test_torch_family_train.py``) and
the card's (``tests/test_torch_kernels_cuda.py``).  Imports no JAX."""

import torch

from repro_torch.models import moe


def ragged_local_twice(cfg, device) -> list:
    """The ``ragged_local`` dispatch's loss (the output against a seeded
    cotangent, plus ``aux``) and every gradient (x, router, gate, up, down),
    two backward passes of the same inputs; the top-k repeats every token
    ``top_k`` times in the gather."""
    gen = torch.Generator(device=device).manual_seed(3)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((3, 40, cfg.d_model), generator=gen, device=device)
    cot = torch.randn((3, 40, cfg.d_model), generator=gen, device=device)
    runs = []
    for _ in range(2):
        leaf = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xs = x.detach().requires_grad_(True)
        out, aux = moe.moe_apply(leaf, xs, cfg, impl="ragged_local")
        loss = (out * cot).sum() + aux
        loss.backward()
        runs.append([loss.detach(), xs.grad] + [leaf[k].grad for k in sorted(leaf)])
    return runs
