"""The first training step's gradient of a smoke model against a float64 evaluation.

``PYTHONPATH=src python3 tools/grad_float64_check.py`` from the repo root
(``--arch whisper-base --seeds 29 30 31`` by default).  For each seed it
builds ``chip_smoke.py`` phase 31 (e)'s model (the smoke config, chunked
attention, float32, no remat, parameters drawn on the CPU from the seed) and
takes the gradient of ``loss_fn`` on the first batch of
``make_stream_for(cfg, 64, 4)``, as that phase does, three ways: float32 on
the CPU, float32 on the card (when there is one), and float64 on the CPU
with the parameters and every activation in float64 (``Tensor.float()``
leaves float64 tensors as they are while it runs, so the norms, the GeLU
and the loss's logits stay in float64 too).  For every gradient leaf it
prints the relative gap (norm of the difference over the norm) of each
float32 side to float64 and of the card to the CPU.

For each attention projection weight it also prints the cancellation in its
gradient ``dW = dY^T X`` (``X`` the projection's input, ``dY`` the gradient
of its output, summed over the batch's rows): ``kappa = || |dY|^T |X| || /
|| dY^T X ||``.  Errors of relative size ``e`` in the entries of ``dY`` or
``X`` (each is float32 arithmetic's result) can reach ``e kappa`` in ``dW``;
``kappa`` near 1 means no cancellation.  A key projection cancels by
construction: softmax rows sum to one, so the key gradients of one query
row sum to zero over the keys, and the part of ``X`` common to every key
position drops out of the exact ``dW`` but not out of its rounding.
``common`` is the norm of that part (``X``'s mean over the positions of one
sequence) over the norm of the rest.

Prints the card's name and power limit first when there is a card, and
writes ``chiprun_out/grad_float64_check.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _float64_kept():
    """``Tensor.float()`` returns a float64 tensor unchanged while inside."""
    import torch

    orig = torch.Tensor.float

    def keep(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else orig(self, *args, **kwargs)

    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = orig


@contextlib.contextmanager
def _recorded_projections(record: list):
    """Every attention projection's ``(weight, input, output)`` while inside."""
    from repro_torch.models import attention

    orig = attention._project

    def rec(p, x, name, heads, hd):
        out = orig(p, x, name, heads, hd)
        record.append((p["w" + name], x, out))
        return out

    attention._project = rec
    try:
        yield
    finally:
        attention._project = orig


def first_grads(cfg, init, device, dtype, projections: list | None = None):
    """``{path: gradient}`` of the first batch's loss at ``init`` moved to
    ``device`` and ``dtype``; with ``projections``, each attention weight's
    ``kappa`` and ``common`` (see the module docstring) into it."""
    import torch

    from repro_torch.data.pipeline import make_stream_for
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model
    from repro_torch.train.tree import leaves_with_paths, tree_map

    opts = ModelOptions(attn_impl="chunked", mixer_impl="chunked",
                        activation_dtype=str(dtype).removeprefix("torch."), remat="none")
    model = build_model(cfg, opts, device=device)
    params = tree_map(lambda t: t.to(device=device, dtype=dtype).requires_grad_(True), init)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in make_stream_for(cfg, 64, 4).batch(0).items()}
    named = leaves_with_paths(params)
    record: list = []
    ctx = _float64_kept() if dtype == torch.float64 else contextlib.nullcontext()
    with ctx, _recorded_projections(record):
        loss, _ = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in named] + [o for _, _, o in record])
    out = {k: g.detach().cpu() for (k, _), g in zip(named, grads)}
    if projections is not None:
        path_of = {id(t): k for k, t in named}
        for (w, x, o), dy in zip(record, grads[len(named):]):
            x2, dy2 = x.detach().flatten(0, 1), dy.flatten(2).flatten(0, 1)
            mean = x.detach().mean(dim=1, keepdim=True)
            projections.append({
                "leaf": path_of[id(w)],
                "kappa": ((dy2.abs().T @ x2.abs()).norm() / (dy2.T @ x2).norm()).item(),
                "common": (mean.expand_as(x).norm() / (x.detach() - mean).norm()).item(),
            })
    return out


def _gap(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="whisper-base")
    ap.add_argument("--seeds", type=int, nargs="+", default=[29, 30, 31])
    ap.add_argument("--show", type=int, default=6, help="leaves printed a seed, worst first")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import smoke_config
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.layers import sinusoidal_positions
    from repro_torch.models.model import build_model

    card = None
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(card, flush=True)
    cfg = smoke_config(args.arch)
    report = {"card": card, "arch": cfg.name, "seeds": {}}
    if card is not None and cfg.is_encdec:
        s_cpu = sinusoidal_positions(cfg.encoder_seq, cfg.d_model)
        s_card = sinusoidal_positions(cfg.encoder_seq, cfg.d_model, device="cuda").cpu()
        report["sinusoid_max_abs_diff"] = (s_card - s_cpu).abs().max().item()
        print(f"encoder sinusoids, card vs CPU: max |diff| "
              f"{report['sinusoid_max_abs_diff']:.3e}", flush=True)
    for seed in args.seeds:
        init = build_model(cfg, ModelOptions(activation_dtype="float32"),
                           device="cpu").init(torch.Generator().manual_seed(seed))
        proj: list = []
        exact = first_grads(cfg, init, "cpu", torch.float64, proj)
        cpu = first_grads(cfg, init, "cpu", torch.float32)
        gpu = first_grads(cfg, init, "cuda", torch.float32) if card is not None else None
        rows = {}
        for k in exact:
            rows[k] = {"cpu_vs_f64": _gap(cpu[k], exact[k])}
            if gpu is not None:
                rows[k]["card_vs_f64"] = _gap(gpu[k], exact[k])
                rows[k]["card_vs_cpu"] = _gap(gpu[k], cpu[k])
        for p in proj:
            rows[p["leaf"]].update(kappa=p["kappa"], common=p["common"])
        report["seeds"][seed] = rows
        key = "card_vs_cpu" if gpu is not None else "cpu_vs_f64"
        print(f"seed {seed}: {len(rows)} leaves, worst {args.show} by {key}:", flush=True)
        for k in sorted(rows, key=lambda k: -rows[k][key])[:args.show]:
            print(f"  {k}: " + ", ".join(f"{n} {v:.3e}" if isinstance(v, float) else f"{n} {v}"
                                         for n, v in rows[k].items()), flush=True)
        print("  attention weights' cancellation:", flush=True)
        for p in proj:
            r = rows[p["leaf"]]
            print(f"    {p['leaf']}: kappa {r['kappa']:.1f}, common {r['common']:.2f}, "
                  f"cpu_vs_f64 {r['cpu_vs_f64']:.3e}"
                  + (f", card_vs_f64 {r['card_vs_f64']:.3e}" if gpu is not None else ""),
                  flush=True)
    out = ROOT / "chiprun_out" / "grad_float64_check.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
