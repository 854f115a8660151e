"""The port's CUDA kernel on a card: bit for bit against its plain version.

Needs an NVIDIA card and nvcc (the kernel has no CPU mode), so every test
is marked ``cuda`` and skips where ``torch.cuda.is_available()`` is False.
The file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

(``--noconftest``: the shared ``tests/conftest.py`` configures jax.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine, policies  # noqa: E402
from repro_torch.kernels import alloc  # noqa: E402

# (M, n_chips, min_chips): plenty of chips, floored (trims), oversubscribed,
# the lane shape, and the largest M one CTA takes.
COMBOS = ((6, 16, 1), (16, 32, 3), (16, 8, 1), (9, 8, 2), (300, 256, 1), (1000, 256, 1),
          (1024, 16, 2))
PS = (0.2, 0.5, 0.8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _sizes(rng, shape, zero_frac=0.3):
    x = rng.pareto(1.5, shape) + 0.01
    x[rng.random(shape) < zero_frac] = 0.0
    k = shape[-1] // 4
    x[..., :k] = x[..., k : 2 * k]  # exact ties
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_equals_plain_version_on_card(cuda_device, dtype):
    rng = np.random.default_rng(0)
    for m, n_chips, min_chips in COMBOS:
        x = torch.tensor(_sizes(rng, (4, m)), device=cuda_device).to(dtype)
        for p in PS:
            before = alloc.LAUNCHES
            theta, chips = alloc.hesrpt_alloc_fused(x, p, n_chips, min_chips=min_chips)
            assert alloc.LAUNCHES == before + 1
            theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p, n_chips, min_chips=min_chips)
            assert torch.equal(theta, theta0)
            assert torch.equal(chips, chips0)
            assert torch.equal(alloc.hesrpt_theta_fused(x, p), theta0)


@pytest.mark.cuda
def test_fused_run_on_card_equals_cpu_run(cuda_device):
    """The fused engine on the card (kernel) and on the CPU (plain
    version): the same chips at every event; completion times within
    1e-12 relative (the engine's elementwise ops, e.g. ``chips ** p``,
    round differently in the last ulp on CPU and CUDA)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.pareto(1.5, (6, 50)) + 0.5)
    arr = torch.tensor(np.cumsum(rng.exponential(0.25, (6, 50)), -1))
    rule = engine.quantized_rule(policies.hesrpt, 32)
    cpu = engine.run(x, arr, 0.5, rule, record=True, fused=True)
    gpu = engine.run(x.to(cuda_device), arr.to(cuda_device), 0.5, rule, record=True, fused=True)
    assert torch.equal(gpu.trace.alloc.cpu(), cpu.trace.alloc)
    np.testing.assert_allclose(
        gpu.completion_times.cpu().numpy(), cpu.completion_times.numpy(), rtol=1e-12, atol=0
    )


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.ones((2, 1025), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        alloc.hesrpt_alloc_fused(x, 0.5, 16)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.ones((8, 4), device=cuda_device, dtype=torch.float64).t()
        alloc.hesrpt_alloc_fused(strided, 0.5, 16)
    with pytest.raises(TypeError):
        half = torch.ones(4, device=cuda_device, dtype=torch.float16)
        alloc.hesrpt_alloc_fused(half, 0.5, 16)
