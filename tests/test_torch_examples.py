"""The port's four examples (``examples/*_torch.py``) on the CPU.

- ``quickstart_torch``: every number it prints equals ``repro.core`` /
  ``repro.sched`` on the same inputs at 1e-12 relative, chips equal;
- ``serve_batch_torch``: the smoke mixtral through ``generate``, its ring
  cache's capacity the window;
- ``train_100m_torch``: its loop at the smoke phi4-mini config, 4 steps with
  a failure injected, gives the losses of an uninterrupted run; its config
  is the JAX example's;
- ``train_cluster_elastic_torch``: 4 spawned ``gloo`` ranks with sizes 8
  and 4 (a timeout a spawn) stay within ``tests/test_torch_elastic.py``'s
  bar against the closed form.

No test imports a JAX example (``examples/quickstart.py`` flips
``jax_enable_x64`` at import for the whole worker): the port's examples
are held against calls into the JAX package itself.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import (  # noqa: E402
    helrpt,
    hesrpt,
    hesrpt_total_flowtime,
    optimal_makespan,
    simulate,
)
from repro.sched import ClusterScheduler, Job  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
REL = 1e-12
SPAWN_TIMEOUT = 120
ELASTIC_BAR = 0.35  # tests/test_torch_elastic.py: achieved / closed - 1


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=REL, atol=0)


def test_quickstart_prints_the_reference_numbers(capsys):
    qs = _example("quickstart_torch")
    got = qs.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    x = jnp.asarray(qs.SIZES)
    p, n = qs.P, qs.N_SERVERS
    _close(got["theta_two"], hesrpt(jnp.asarray(qs.TWO_JOBS), 0.5))
    _close(got["theta"], hesrpt(x, p))
    res, mk = simulate(x, p, n, hesrpt), simulate(x, p, n, helrpt)
    _close(got["total_flowtime"], res.total_flowtime)
    _close(got["total_flowtime_closed"], hesrpt_total_flowtime(x, p, n))
    _close(got["gamma"], helrpt(x, p))
    _close(got["makespan"], mk.makespan)
    _close(got["makespan_closed"], optimal_makespan(x, p, n))
    _close(got["completion_times"], mk.completion_times)
    sched = ClusterScheduler(qs.N_CHIPS, policy="hesrpt")
    for i, s in enumerate(qs.SIZES):
        sched.add_job(Job(f"job{i}", size=float(s), p=p))
    assert got["alloc"] == sched.allocations()  # chips equal
    _close(got["cluster_total_flow_time"], sched.run_fluid_to_completion()["total_flow_time"])
    _close(got["fluid_optimum"], hesrpt_total_flowtime(x, p, float(qs.N_CHIPS)))
    assert "theta* = [0.25 0.75]" in printed
    assert f"closed-form={got['total_flowtime_closed']:.6f}" in printed
    assert f"quantized heSRPT allocation: {got['alloc']}" in printed


def test_serve_batch_ring_cache_holds_the_window(capsys):
    sb = _example("serve_batch_torch")
    out = sb.main(["--device", "cpu", "--batch", "2", "--prompt-len", "40", "--gen-len", "6"])
    printed = capsys.readouterr().out
    cfg = smoke_config("mixtral-8x7b")
    assert 0 < cfg.window < 40 + 6
    assert out["ids"].shape == (2, 6)
    assert out["ring_cache"] == (2, cfg.n_kv_heads, cfg.window, cfg.head_dim)
    assert f"(window={cfg.window}, not seq)" in printed
    assert sb.serve("mamba2-130m", 1, 8, 2, device="cpu")["ring_cache"] is None


def test_train_100m_recovers_to_the_uninterrupted_losses(tmp_path):
    tr = _example("train_100m_torch")
    cfg = smoke_config("phi4-mini-3.8b")
    kw = dict(steps=4, seq_len=16, global_batch=4, ckpt_every=2, device="cpu")
    plain = tr.train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    failed = tr.train(cfg, ckpt_dir=str(tmp_path / "b"), fail_at=(3,), **kw)
    assert failed["recoveries"] == [{"failed_at": 3, "resumed_from": 2}]
    l0, l1, l2, l3 = plain["loss"]
    assert failed["loss"] == [l0, l1, l2, l2, l3]  # step 2 replayed bit for bit
    want = jget_config("phi4-mini-3.8b").scaled(
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64, d_ff=1536,
        vocab_size=32768)
    assert tr.config_100m().param_count() == want.param_count()


def test_elastic_example_on_four_spawned_ranks(tmp_path, capsys):
    el = _example("train_cluster_elastic_torch")
    el.main(["--device", "cpu", "--devices", "4", "--sizes", "8", "4", "--ckpt-root",
             str(tmp_path), "--timeout", str(SPAWN_TIMEOUT)])
    printed = capsys.readouterr().out
    achieved = float(re.search(r"achieved total flow time : (\S+)", printed).group(1))
    closed = float(re.search(r"heSRPT fluid optimum     : (\S+)", printed).group(1))
    want = float(hesrpt_total_flowtime(jnp.asarray([8.0, 4.0]), 0.5, 4.0))
    assert closed == float(f"{want:.3f}")
    assert achieved / want - 1 < ELASTIC_BAR
    assert "policy=hesrpt  p=0.5  devices=4" in printed
    assert "allocation trace:" in printed and "  t=  0.00  " in printed
