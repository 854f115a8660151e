"""What the benchmark may load and read: no module of the JAX stack or of the
JAX package in any driver's import graph, a reference that takes nothing
from the program, and no run without a card or without the program."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRIVERS = sorted(p.stem for p in (BENCH / "drivers").glob("*.py") if p.stem != "__init__")


def _loaded_after(code: str) -> set:
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("driver", DRIVERS)
def test_a_drivers_import_graph_leaves_out_jax(driver):
    # The port loads its modules at a unit's first call: load them as a run does.
    loaded = _loaded_after(
        f"import bench.run, bench.control\nfrom bench import harness\n"
        f"harness.load_driver({driver!r})\n"
        "import repro_torch.core.sweeps, repro_torch.core.simulator, repro_torch.core.policies\n"
        "for m in harness.load_manifest()['per_layer']:\n"
        "    harness.load_reader(m['name'])")
    assert "repro_torch" in loaded and not loaded & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import bench.reference.scheduler, bench.reference.tapes")
    assert not loaded & {*FORBIDDEN, "repro_torch"}
    for path in (BENCH / "reference").glob("*.py"):
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"__future__", "numpy", "torch"}, (path.name, n)
        assert "kernels/ref" not in text and "tests/" not in text


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "online-n256.fused", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    if out.returncode == 2 and "found 0" in out.stderr:
        assert out.stdout.strip() == ""
    else:
        pytest.skip("a card is present: the no-card path is not reachable here")


def test_without_the_program_a_run_fails(tmp_path):
    # A checkout of only BENCHMARK.json and the benchmark's paths: the run
    # stops where it loads the port, before any result.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch; sys.path.insert(0, '.')\n"
            "from bench import harness\n"
            "cell = harness.load_cell('online-n256.fused', config={'n_jobs': 8, 'rates': [1.0]},"
            " traffic={'n_seeds': 1, 'check_seeds': 1})\n"
            "print(harness.run_cell(cell, 1, 0.01, False, torch.device('cpu'), time.perf_counter()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and "repro_torch" in out.stderr and out.stdout.strip() == ""
