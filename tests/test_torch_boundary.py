"""The port's package boundary and its no-fallback device rule.

- No module of ``src/repro_torch`` (nor ``chip_smoke.py``) imports ``jax``
  or anything of the JAX package ``repro``: a fresh interpreter imports
  them all and inspects ``sys.modules``.
- Entry points called without ``device=`` run on CUDA; where there is no
  card they raise instead of falling back to the CPU.
- ``chip_smoke.py`` exits non-zero and prints no result without a card,
  and in a directory that holds nothing else of the repo.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC)}


def test_port_imports_nothing_of_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(ROOT)], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=300, check=True,
    )
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("kernels.alloc", "core.sweeps", "kernels.flash_attention", "kernels.ops",
                 "kernels.ssd_scan", "kernels.chunked", "models.model", "models.ssm",
                 "models.convert", "launch.serve", "train.serve_step", "core.superstep",
                 "configs.paper", "figures", "core.telemetry", "core.estimation",
                 "launch.trace_export", "core.multiclass", "sched.cluster",
                 "sched.estimator", "sched.quantize", "sched.stragglers", "lanes"):
        assert f"repro_torch.{name}" in got["modules"]
    assert got["bad"] == []


def _entry_points():
    from repro_torch import figures, lanes
    from repro_torch.core import arrivals, engine, flowtime, scenarios, simulator, sweeps
    from repro_torch.configs import smoke_config
    from repro_torch.core.policies import hesrpt
    from repro_torch.core.estimation import simulate_scenario_estimated
    from repro_torch.core.multiclass import multiclass_sweep, simulate_multiclass
    from repro_torch.launch import serve, trace_export
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model import build_model
    from repro_torch.sched import ClusterScheduler

    spec = sweeps.Sweep.create(("hesrpt",), (1.0,), n_jobs=4, n_seeds=1)
    stream_spec = sweeps.Sweep.create(("hesrpt",), (1.0,), n_jobs=4, n_seeds=1,
                                      stream={"n_slots": 2})
    tel_spec = sweeps.Sweep.create(("hesrpt",), (1.0,), n_jobs=4, n_seeds=1, telemetry=True)
    x, a = [2.0, 1.0], [0.0, 0.5]
    mc_spec = sweeps.Sweep.create(("hesrpt_pc",), (1.0,), scenario="multiclass_poisson",
                                  n_jobs=4, n_seeds=1, classes=((0.3, 1.0), (0.7, 1.0)))
    return {
        "ClusterScheduler": lambda: ClusterScheduler(16),
        "sched_scale": lambda: lanes.sched_scale(ms=(10,), repeats=1),
        "simulate_multiclass": lambda: simulate_multiclass(
            scenarios.Scenario(torch.tensor(x), torch.tensor(a), class_ids=torch.tensor([0, 1]),
                               p_job=torch.tensor([0.3, 0.7])), classes=mc_spec.classes
        ),
        "multiclass_sweep": lambda: multiclass_sweep(("hesrpt_pc",), (1.0,),
                                                     classes=mc_spec.classes, n_jobs=4,
                                                     n_seeds=1),
        "run_sweep_classes": lambda: sweeps.run_sweep(mc_spec),
        "run_sweep_telemetry": lambda: sweeps.run_sweep(tel_spec),
        "simulate_scenario_estimated": lambda: simulate_scenario_estimated(
            scenarios.Scenario(torch.tensor(x), torch.tensor(a)), 0.5, 4.0, hesrpt, prior_p=0.5
        ),
        "export_sample": lambda: trace_export.export_sample(),
        "run_sweep": lambda: sweeps.run_sweep(spec),
        "run_sweep_stream": lambda: sweeps.run_sweep(stream_spec),
        "simulate_stream": lambda: arrivals.simulate_stream(
            scenarios.Scenario(torch.tensor(x), torch.tensor(a)), 0.5, 4.0, hesrpt, n_slots=2
        ),
        "poisson_source": lambda: engine.poisson_source(torch.Generator(), 1.0),
        "simulate_cells": lambda: sweeps.simulate_cells(spec, [[x]], [[a]]),
        "run_lanes": lambda: lanes.run_lanes(smoke=True),
        "simulate_online": lambda: arrivals.simulate_online(x, a, 0.5, 4.0, hesrpt),
        "simulate_online_quantized": lambda: arrivals.simulate_online_quantized(
            x, a, 0.5, 4, hesrpt
        ),
        "simulate_online_superstep": lambda: arrivals.simulate_online_superstep(
            x, a, 0.5, 4.0, "hesrpt"
        ),
        "simulate": lambda: simulator.simulate(x, 0.5, 4.0, hesrpt),
        "total_flowtime": lambda: simulator.total_flowtime(x, 0.5, 4.0, hesrpt),
        "rank_bracket_powers": lambda: flowtime.rank_bracket_powers(4, 0.5),
        "fig3_trace": lambda: figures.fig3_trace(),
        "fig4_policies": lambda: figures.fig4_policies(quick=True),
        "tape_from_numpy": lambda: scenarios.tape_from_numpy(x, a),
        "seed_generator": lambda: scenarios.seed_generator(0, 0),
        "omega_star": lambda: flowtime.omega_star(4, 0.5),
        "build_model": lambda: build_model(smoke_config("phi4-mini-3.8b")),
        "build_model_ssm": lambda: build_model(smoke_config("mamba2-130m")),
        "params_from_jax": lambda: params_from_jax({}, smoke_config("phi4-mini-3.8b")),
        "serve_main": lambda: serve.main(["--arch", "phi4-mini-3.8b", "--smoke"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_do_not_fall_back(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def _smoke(cwd):
    return subprocess.run(
        [sys.executable, str(Path(cwd) / "chip_smoke.py")], cwd=cwd, env=_env(),
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for cwd in (ROOT, lone):
        out = _smoke(cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
