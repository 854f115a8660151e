"""Fill a markdown file's table markers from a dry-run results directory.
Port of ``repro.launch.report``, which writes the reference's
``EXPERIMENTS.md``; here the file is an argument:

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun NOTES.md

``<!-- BASELINE_TABLES -->`` becomes the roofline tables of the ``baseline``
tag on each mesh, ``<!-- OPT_TABLES -->`` the ``opt`` tag against it.
"""

from __future__ import annotations

import sys

from repro_torch.launch.roofline import fits, load_cells, table


def opt_comparison(results_dir: str) -> str:
    base, _, _ = load_cells(results_dir, "baseline")
    opt, _, _ = load_cells(results_dir, "opt")
    base_by = {(c.arch, c.shape, c.mesh): c for c in base}
    rows = [
        "| arch | shape | mesh | dominant term (base→opt) | base s | opt s "
        "| win | frac base→opt | fits base→opt |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in sorted(opt, key=lambda c: (c.arch, c.shape, c.mesh)):
        b = base_by.get((c.arch, c.shape, c.mesh))
        if b is None:
            continue
        b_dom = max(b.compute_s, b.memory_s, b.collective_s)
        o_dom = max(c.compute_s, c.memory_s, c.collective_s)
        win = b_dom / o_dom if o_dom > 0 else float("inf")
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {b.dominant}→{c.dominant} "
            f"| {b_dom:.2f} | {o_dom:.2f} | {win:.1f}x "
            f"| {b.roofline_fraction:.3f}→{c.roofline_fraction:.3f} "
            f"| {fits(b)}→{fits(c)} |"
        )
    return "\n".join(rows)


def main(results_dir: str, md_path: str):
    base_cells, skips, errors = load_cells(results_dir, "baseline")
    baseline_md = (
        "### Single-pod (16x16 = 256 cards)\n\n"
        + table(base_cells, mesh_filter="pod16x16")
        + "\n\n### Multi-pod (2x16x16 = 512 cards)\n\n"
        + table(base_cells, mesh_filter="pod2x16x16")
        + "\n\nSkipped cells (recorded): "
        + "; ".join(sorted({f"{s['arch']} x {s['shape']}" for s in skips}))
        + f"\n\n{len(base_cells)} baseline cells ok, {len(errors)} errors.\n"
    )
    opt_md = opt_comparison(results_dir)

    with open(md_path) as f:
        text = f.read()
    text = text.replace("<!-- BASELINE_TABLES -->", baseline_md)
    text = text.replace("<!-- OPT_TABLES -->", opt_md)
    with open(md_path, "w") as f:
        f.write(text)
    print(f"wrote tables into {md_path}: {len(base_cells)} baseline cells")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit("usage: python -m repro_torch.launch.report RESULTS_DIR MARKDOWN_PATH")
    main(*sys.argv[1:])
