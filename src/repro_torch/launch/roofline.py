"""Three-term roofline analysis from the dry-run artifacts, at H100 figures.
Port of ``repro.launch.roofline``, whose hardware model is a TPU v5e.

Hardware model (one NVIDIA H100 SXM, published dense peaks at 700 W):
  peak bf16:   989 TFLOP/s (tensor cores; float16 the same)
  peak fp32:    67 TFLOP/s (outside the tensor cores)
  HBM:        3.35 TB/s, 80 GB
  NVLink:      450 GB/s a card each way (900 GB/s all to all in one host)

Terms (seconds per step, per card: the trace is rank 0's local program, so
per-device totals divide by per-card rates):
  compute    = sum over dtypes of trace_flops(dev, dtype) / peak(dtype)
               (products in any other dtype at the float32 rate)
  memory     = trace_bytes(dev)      / 3.35e12
  collective = collective_bytes(dev) / 450e9

The collective term is a lower bound: a host holds 8 cards, so a 16-wide
model axis (and every data axis) spans two hosts, whose link is slower than
NVLink; it takes NVLink's rate for every byte.  trace_* come from the
trace analyzer (``launch/trace_analysis.py``); its bytes count every eager
op's operands and outputs, with no fusion.  MODEL_FLOPS uses the
paper-standard 6·N·D (train) / 2·N·D (inference) with N = active params for
MoE.  roofline_fraction = useful_compute_time / dominant_term, the useful
time at the bf16 peak: the score a real profile would report as "fraction
of roofline".
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass

PEAK_FLOPS = 989e12  # bf16, the card's best: the useful time's rate
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_GB = 80.0  # H100 80GB HBM3 (decimal gigabytes)


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs per step (global, forward+backward for train)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def compute_seconds(h: dict) -> float:
    """The products' time at the card's peak for each dtype."""
    by_dtype = h.get("flops_by_dtype") or {"bfloat16": h["flops"]}
    return sum(f / PEAK_FLOPS_BY_DTYPE.get(dt, PEAK_FLOPS_BY_DTYPE["float32"])
               for dt, f in by_dtype.items())


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    tag: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    trace_flops_global: float
    useful_ratio: float
    roofline_fraction: float
    temp_gb: float | None
    arg_gb: float | None = None
    trace_s: float | None = None
    note: str = ""


def analyze_record(rec: dict) -> CellRoofline | None:
    if rec.get("status") != "ok" or "trace_analysis" not in rec:
        return None
    from repro_torch.configs import SHAPE_BY_NAME, get_config

    cfg = get_config(rec["arch"])
    shape = SHAPE_BY_NAME[rec["shape"]]
    chips = rec["n_devices"]
    h = rec["trace_analysis"]
    if "error" in h:
        return None
    compute_s = compute_seconds(h)
    memory_s = h["bytes"] / HBM_BW
    coll_bytes = sum(h["collective_bytes"].values())
    collective_s = coll_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    trace_global = h["flops"] * chips
    useful_ratio = mf / trace_global if trace_global else 0.0
    useful_time = mf / (chips * PEAK_FLOPS)
    frac = useful_time / max(terms.values()) if max(terms.values()) > 0 else 0.0
    temp = rec.get("memory", {}).get("temp_size_in_bytes")
    arg = rec.get("memory", {}).get("argument_size_in_bytes")
    return CellRoofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        tag=rec.get("tag", "baseline"), chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, trace_flops_global=trace_global,
        useful_ratio=useful_ratio, roofline_fraction=frac,
        temp_gb=(temp / 1e9 if temp is not None else None),
        arg_gb=(arg / 1e9 if arg is not None else None),
        trace_s=rec.get("trace_s"),
        note=suggest(dominant, rec, useful_ratio),
    )


def suggest(dominant: str, rec: dict, useful_ratio: float) -> str:
    shape = rec["shape"]
    if dominant == "collective":
        return ("cast FSDP weight gathers to bf16 / reduce-scatter grads "
                "instead of all-reduce")
    if dominant == "memory":
        if "decode" in shape or "500k" in shape:
            return "KV/state cache streaming dominates: shard cache wider or quantize KV to int8"
        return "weight/activation traffic dominates: bf16 gathers, remat policy 'dots', fuse more"
    if useful_ratio < 0.5:
        return ("compute-bound but >2x waste vs model FLOPs: cut remat "
                "recompute or MoE dense dispatch")
    return "near compute roofline: overlap remaining collectives with compute"


def load_cells(results_dir: str, tag: str | None = None):
    cells, skips, errors = [], [], []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if tag is not None and rec.get("tag") != tag:
            continue
        if rec.get("status") == "skipped":
            skips.append(rec)
        elif rec.get("status") == "error":
            errors.append(rec)
        else:
            c = analyze_record(rec)
            if c:
                cells.append(c)
    return cells, skips, errors


def fits(c: CellRoofline) -> str:
    """Whether a card holds the step's arguments (parameters, optimizer
    state, batch, caches) and its peak temporaries at once."""
    if c.temp_gb is None or c.arg_gb is None:
        return "?"
    need = c.temp_gb + c.arg_gb
    return "y" if need < HBM_GB else f"n ({need:.0f}G)"


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:7.2f}s"
    return f"{x*1e3:6.1f}ms"


def table(cells, *, mesh_filter: str | None = None) -> str:
    rows = [
        "| arch | shape | mesh | compute | memory | collective | bottleneck "
        "| MODEL/TRACE | roofline frac | fits 80G | trace s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in sorted(cells, key=lambda c: (c.arch, c.shape, c.mesh)):
        if mesh_filter and c.mesh != mesh_filter:
            continue
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {fmt_s(c.compute_s)} "
            f"| {fmt_s(c.memory_s)} | {fmt_s(c.collective_s)} | {c.dominant} "
            f"| {c.useful_ratio:.3f} | {c.roofline_fraction:.3f} | {fits(c)} | {c.trace_s} |"
        )
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    cells, skips, errors = load_cells(args.results, args.tag)
    print(table(cells, mesh_filter=args.mesh))
    if skips:
        print("\nSkipped cells:")
        for s in skips:
            print(f"- {s['arch']} x {s['shape']} x {s['mesh']}: {s['reason']}")
    if errors:
        print("\nERRORED cells:")
        for e in errors:
            print(f"- {e['arch']} x {e['shape']} x {e['mesh']}: {e['error'][:100]}")
    print(f"\n{len(cells)} ok, {len(skips)} skipped, {len(errors)} errors")


if __name__ == "__main__":
    main()
