"""Reckon the memory of ``chip_smoke.py`` phase 35's full-width train steps.

``PYTHONPATH=src python3 tools/family_train_reckon.py`` from the repo root,
on the CPU: no card and no data, every tensor a fake one (meta storage).
For each config of ``chip_smoke.FAMILY_TRAIN`` (arch, depth, batch,
sequence) it builds the model as ``launch/train.py`` builds a full config
(``train_options(smoke=False)``: bf16 activations, remat, the chunked
attention, the ``dense`` MoE dispatch; ``make_step``: AdamW, the step
donated), draws the parameters and the optimizer state, and runs one train
step under ``launch/trace_analysis.py``'s trace mode, as the dry run does
for a mesh.  It prints, a config a line:

- the parameters the model holds, and 16 B each (float32 masters,
  gradients and two moments: the state phase 35 keeps on the card);
- the step's arguments (parameters, moments and batch: the local bytes of
  their storages) and the peak of the bytes the step itself allocates and
  holds at once (gradients, activations, the per-use bf16 casts, AdamW's
  temporaries), and their sum against the card's 80 GB;
- the step's flops (the trace's count).

The peak is a count of tensor storages, not an allocator's figure: the
allocator's ``max_memory_allocated`` on the card can differ either way
(phase 34 (b) prints both for a phi4-mini step).
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def reckon(row) -> dict:
    """Figures of one ``(arch, layers, batch, seq)`` row."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import make_stream_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import make_step, train_options
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.tree import leaves

    sys.path.insert(0, str(ROOT))
    from chip_smoke import FAMILY_TRAIN_STEPS, _family_cfg

    arch, layers, batch, seq = row
    cfg = _family_cfg(arch, layers)[1]
    model = build_model(cfg, train_options(smoke=False), device="cpu")
    host = make_stream_for(cfg, seq, batch).batch(0)
    out = {"arch": arch, "layers": cfg.n_layers, "batch": batch, "seq": seq, "cfg": cfg}
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
        out["params"] = sum(t.numel() for t in leaves(params))
        out["state_bytes"] = 16 * out["params"]
        opt_state = init_opt_state(params)
        data = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype)
                for k, v in host.items()}
        rec, _ = dryrun.trace_step(make_step(model, steps=FAMILY_TRAIN_STEPS),
                                  (params, opt_state, data))
    out.update(argument_bytes=rec["memory"]["argument_size_in_bytes"],
               temp_bytes=rec["memory"]["temp_size_in_bytes"],
               trace_flops=rec["cost"]["flops"])
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for row in chip_smoke.FAMILY_TRAIN:
        r = reckon(row)
        total = r["argument_bytes"] + r["temp_bytes"]
        print(f"{r['arch']}: {r['layers']} layers, batch {r['batch']} x {r['seq']}: "
              f"{r['params']} parameters, state (16 B each) {r['state_bytes'] / 1e9:.2f} GB; "
              f"step arguments {r['argument_bytes'] / 1e9:.2f} GB + its own peak "
              f"{r['temp_bytes'] / 1e9:.2f} GB = {total / 1e9:.2f} GB "
              f"({'fits' if total < 80e9 else 'does not fit'} 80 GB); "
              f"{r['trace_flops']:.4e} flops", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
