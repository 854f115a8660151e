"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
FILE = re.compile(r"[A-Za-z0-9_./-]{1,200}")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion"
                   r"|experts_per_tok")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _one_line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text \
        and "\t" not in text


def test_keys_paths_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert FILE.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_one_line(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if (ROOT / word).exists():
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST).encode()) <= 64 * 1024


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MANIFEST[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    for w in MANIFEST["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert _one_line(w["why"])
    for c in MANIFEST["configs"]:
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in MANIFEST["per_layer"]:
        assert _one_line(m["layer"])


def test_entry_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        for e in MANIFEST[section]:
            assert set(e) - {"workloads"} == want, (section, e["name"])
            if "workloads" in e:
                assert section in ("end_to_end", "per_layer")


def test_configs():
    assert 1 <= len(MANIFEST["configs"]) <= 24
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg and not WIDTH.search(key)


def test_workloads_and_chips():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))


def test_metrics_and_what_they_move():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}

    def reports(cell, metric):
        return cell in e2e[metric].get("workloads", cells)

    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells and reports(cell, m["moves"])
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        got = [n for n in e2e if reports(cell, n)]
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in MANIFEST["per_layer"]
                   if reports(cell, m["moves"]))


def test_files_found_by_name():
    from bench import harness

    for w in MANIFEST["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (BENCH / "drivers" / f"{cell.driver}.py").is_file()
        assert harness.load_driver(cell.driver)
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        spec = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert spec["why"] == w["why"]
    for m in MANIFEST["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)
    for name in harness.END_TO_END:
        assert name in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in BENCH.rglob("*") if p.is_file()
                                        and "__pycache__" not in p.parts))
def test_file_names(path):
    assert FILE.fullmatch(path)
