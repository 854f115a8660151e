"""The port's cluster scheduler on a card against the same run on the CPU.

A 64-job backlog on 256 chips, heSRPT on whole chips and the class-aware
``hesrpt_pc``, delegated to ``engine.run`` and per event: chips equal at
every allocate event and completion times within 1e-12 relative between
the card and the CPU.  Marked ``cuda``: it skips where
``torch.cuda.is_available()`` is False.  The file imports neither jax nor
the JAX package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_sched_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.sched import ClusterScheduler, Job  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(device, use_engine, **kw):
    rng = np.random.default_rng(0)
    sizes, cls = rng.pareto(1.5, 64) + 1.0, rng.integers(0, 2, 64)
    s = ClusterScheduler(256, device=device, **kw)
    for i, (size, k) in enumerate(zip(sizes, cls, strict=True)):
        s.add_job(Job(f"j{i}", size=float(size), p=(0.35, 0.75)[k] if kw.get("class_aware")
                      else 0.5, class_id=int(k)))
    res = s.run_fluid_to_completion(use_engine=use_engine)
    return [e["chips"] for e in s.events if e["event"] == "allocate"], res["completion_times"]


@pytest.mark.cuda
@pytest.mark.parametrize("use_engine", [True, False], ids=["delegated", "per-event"])
@pytest.mark.parametrize("kw", [dict(policy="hesrpt"),
                                dict(policy="hesrpt_pc", class_aware=True)],
                         ids=["hesrpt", "hesrpt_pc"])
def test_card_equals_cpu(cuda_device, use_engine, kw):
    chips_gpu, times_gpu = _run(cuda_device, use_engine, **kw)
    chips_cpu, times_cpu = _run("cpu", use_engine, **kw)
    assert chips_gpu == chips_cpu
    np.testing.assert_allclose([times_gpu[k] for k in times_cpu], list(times_cpu.values()),
                               rtol=1e-12, atol=0.0)
