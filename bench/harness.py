"""The benchmark's general part: a cell by its name, the measured window, the
reduction of a profiler trace, the per-layer readers and the result line.

A cell is ``BENCHMARK.json``'s workload entry, its file
``bench/workloads/<cell>.json`` (driver, traffic, limits) and its
configuration ``bench/configs/<config>.json``.  A driver
(``bench/drivers/<driver>.py``) turns them into a :class:`Work`: one unit of
the program's work at a time, and the check of every unit's answers against
the plain reference (``bench/reference/``).  A per-layer metric is a reader
``bench/metrics/<metric>.py`` with ``read(ctx) -> float | None``.  Adding a
cell, a configuration or a metric adds files and manifest entries; nothing
here names one.
"""

from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

#: Top-level module names that must not be loaded in a run: the JAX stack
#: and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: The span around each unit of work in a traced window.
UNIT_SPAN = "bench.unit"


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    driver: str
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, *, config: dict | None = None, traffic: dict | None = None) -> Cell:
    """The cell ``name``; ``config`` / ``traffic`` override entries of its
    files (the CPU tests run a cell at a size a test can hold)."""
    manifest = load_manifest()
    spec = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"{name}: no workload of that name in BENCHMARK.json")
    for key in ("config", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} differs between BENCHMARK.json and its file")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, config={**cfg, **(config or {})},
                traffic={**spec["traffic"], **(traffic or {})}, driver=spec["driver"],
                chips=entry["chips"], limits=spec["limits"], end_to_end=e2e,
                per_layer=per_layer)


def load_driver(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


def load_reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Verdict:
    checks: list
    attempted: int
    failed: int

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


class Work:
    """One cell's program work, a unit at a time.  A driver fills in the
    counts (from shapes) and the two methods."""

    jobs_per_unit: int = 0
    steps_per_unit: int = 0  # event steps of the loop in one unit
    loop_bytes_per_unit: int = 0  # yardstick.event_step_bytes over those steps
    alloc_launch_bytes: int | None = None  # one alloc-kernel launch, None: no kernel

    def unit(self, k: int):
        """Run unit ``k`` of the window and return its answers on the host."""
        raise NotImplementedError

    def check(self, outputs: list) -> Verdict:
        """Hold every unit's answers against the plain reference."""
        raise NotImplementedError


@dataclass
class Window:
    jobs: int
    wall_s: float
    setup_s: float
    outputs: list
    peak_bytes: int
    build_s: float = 0.0  # the part of setup_s that built kernels
    unit_s: list = field(default_factory=list)  # each unit's wall, in order
    ctx: dict = field(default_factory=dict)  # what the per-layer readers read


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_build_seconds() -> float:
    """Seconds this process spent building the program's CUDA kernels (nvcc,
    on a checkout's first run; 0.0 once the build directory holds them): the
    ``BUILD_SECONDS`` of every loaded ``repro_torch.kernels`` module."""
    mods = [m for n, m in list(sys.modules.items()) if n.startswith("repro_torch.kernels.")]
    return float(sum(getattr(m, "BUILD_SECONDS", 0.0) for m in mods))


def measure(work: Work, seconds: float, trace: bool, device: torch.device,
            t_start: float) -> Window:
    """Warm-up (one whole unit, counted as set-up), then units back to back
    until ``seconds`` have passed; the unit in progress is finished."""
    work.unit(0)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    outputs, ends = [], []
    while True:
        with torch.profiler.record_function(UNIT_SPAN):
            outputs.append(work.unit(len(outputs)))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    _sync(device)
    t1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    n = len(outputs)
    win = Window(jobs=n * work.jobs_per_unit, wall_s=t1 - t0, setup_s=t0 - t_start,
                 outputs=outputs, peak_bytes=peak, build_s=kernel_build_seconds(),
                 unit_s=[b - a for a, b in zip([0.0] + ends, ends)])
    win.ctx = {"steps": n * work.steps_per_unit, "loop_bytes": n * work.loop_bytes_per_unit,
               "alloc_launch_bytes": work.alloc_launch_bytes, "peak_bytes": peak}
    if prof is not None:
        win.ctx["trace"] = summarize(prof.profiler.kineto_results.events(), win.wall_s)
    return win


# ------------------------------------------------------------ the trace
def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_transfer(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def summarize(events, window_s: float) -> dict:
    """The traced window's device and host timelines, reduced: device busy
    seconds (the union of every device operation's interval), kernels and
    their time by name, top-level aten ops the host dispatched (an aten op
    not inside another on its thread), and the idle gaps of the device
    labelled by the host op under way at their middle."""
    host, spans, device = [], [], []
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # A span's shadow on the device timeline is no device work.
            if not e.is_user_annotation() and name != UNIT_SPAN:
                device.append((start, start + dur, name))
        elif name.startswith("aten::"):
            host.append((e.start_thread_id(), start, start + dur, name))
        elif name == UNIT_SPAN:
            spans.append((start, start + dur))
    top = []
    for tid in {h[0] for h in host}:
        end = -1
        for _, s, e, name in sorted((h for h in host if h[0] == tid),
                                    key=lambda h: (h[1], -h[2])):
            if s >= end:
                top.append((s, e, name))
                end = e
    top.sort()
    busy = _merge([(s, e) for s, e, _ in device])
    by_name: dict[str, list] = {}
    for s, e, name in device:
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (e - s) * 1e-9
    gaps: dict[str, float] = {}
    if spans:
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        starts = [s for s, _, _ in top]
        prev = lo
        for s, e in [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi] + [(hi, hi)]:
            if s > prev:
                mid = (prev + s) / 2
                j = bisect.bisect_right(starts, mid) - 1
                label = top[j][2] if j >= 0 and top[j][1] >= mid else "host outside aten ops"
                gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-9
            prev = max(prev, e)
    return {
        "window_s": window_s,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernels": sum(1 for _, _, n in device if not _is_transfer(n)),
        "device_ops": sorted(([n, r[1]] for n, r in by_name.items()), key=lambda r: -r[1]),
        "kernel_rows": {n: r for n, r in by_name.items()},
        "host_ops": len(top),
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda r: -r[1]),
    }


def read_per_layer(cell: Cell, ctx: dict) -> dict:
    """Each per-layer metric of ``cell`` from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ------------------------------------------------------------ the result
END_TO_END = {
    "jobs_per_s": lambda w: w.jobs / w.wall_s,
    "setup_s": lambda w: w.setup_s,
}


def device_info(device: torch.device, count: int, peak: int) -> dict:
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": count, "memory_peak_bytes": int(peak)}


def result(cell: Cell, win: Window, verdict: Verdict, device: torch.device,
           trace: bool) -> dict:
    """The run's last line.  ``build_s`` (the kernel build inside set-up)
    and ``unit_s`` ride along; the numbers compared come last."""
    dev = device_info(device, 1, win.peak_bytes)
    out = {"correct": verdict.correct, "attempted": verdict.attempted,
           "failed": verdict.failed}
    if trace:
        t = win.ctx["trace"]
        out["metrics"] = read_per_layer(cell, win.ctx)
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        out["device"] = dev
        out["breakdown"] = {"device_ops": t["device_ops"][:10], "idle_gaps": t["idle_gaps"][:10]}
    else:
        out["metrics"] = {m["name"]: {"value": END_TO_END[m["name"]](win), "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = dev
    out["build_s"] = win.build_s
    out["unit_s"] = win.unit_s
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in verdict.checks}
    return out


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN_MODULES`."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """One single-process run of ``cell``: its result line as a dict."""
    work = load_driver(cell.driver).prepare(cell, seed, device)
    win = measure(work, seconds, trace, device, t_start)
    verdict = work.check(win.outputs)
    return result(cell, win, verdict, device, trace)
