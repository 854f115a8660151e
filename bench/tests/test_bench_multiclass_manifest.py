"""The water-filling cell's files and entries: the configuration is the
source's K = 4 grid as the port's ``lanes`` holds it, the cell, its limits
and its two metrics are declared as the harness reads them, and its
reference, driver and readers load nothing they must not."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = "multiclass-k4-n256"
CELL = "multiclass-k4.waterfill"
READERS = ("class_theta_us", "waterfill_iters_per_step")


def _entry(section, name):
    (e,) = [e for e in MANIFEST[section] if e["name"] == name]
    return e


def test_the_configuration_is_the_sources_grid():
    pytest.importorskip("torch")
    from repro_torch.lanes import MC_RATES, class_grid

    entry = _entry("configs", CONFIG)
    assert entry["file"] == f"bench/configs/{CONFIG}.json" and entry["reduced"] == []
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert "2404.00346" in cfg["source"] and "benchmarks/multiclass.py" in cfg["source"]
    assert cfg["classes"] == [
        {"p": c.p, "mix": c.mix, "size_alpha": c.size_alpha, "size_scale": c.size_scale,
         "weight": 1.0} for c in class_grid(4)]
    assert cfg["rates"] == list(MC_RATES)
    assert (cfg["n_servers"], cfg["n_jobs"], cfg["scenario"], cfg["dtype"]) == (
        256.0, 1000, "multiclass_poisson", "float64")
    assert cfg["reduced"] == [] and cfg["assumed"] == {}
    assert cfg["deployment"] and cfg["guarantees"]


def test_the_cell_and_its_limits():
    entry = _entry("workloads", CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (CONFIG, "waterfill", 1)
    spec = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    assert spec["driver"] == "class_sweep" and spec["why"] == entry["why"]
    assert spec["traffic"] == {"policy": "waterfill", "n_seeds": 1024, "check_seeds": 8}
    assert spec["limits"] == {name: 1e-9 for name in
                              ("flow_gap", "slowdown_gap", "makespan_gap", "class_flow_gap")}
    assert "1e-14" in spec["limits_why"] and "float32" in spec["limits_why"]


@pytest.mark.parametrize("name", READERS)
def test_the_metrics_of_the_class_aware_allocate(name):
    m = _entry("per_layer", name)
    assert (m["layer"], m["moves"], m["better"]) == ("class-aware allocate", "jobs_per_s",
                                                     "lower")
    assert CELL in m["workloads"]
    assert m["source"] == ("program_span" if name == "class_theta_us" else "program_counter")
    assert (BENCH / "metrics" / f"{name}.py").is_file()


def test_the_reference_loads_nothing_of_the_program():
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
             "import bench.reference.multiclass\n"
             "from bench import harness\n"
             + "".join(f"harness.load_reader({n!r})\n" for n in READERS)
             + "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
