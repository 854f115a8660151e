"""Time the MoE dispatches on the card: a prefill at published widths under
``moe_impl="dense"`` and ``"ragged_local"`` (what ``chip_smoke.py`` phase 31
(c) runs), and one MoE layer's ``ragged_local`` forward and backward (phase
35 (c)'s shapes).

    PYTHONPATH=src python tools/moe_prefill_time.py --layers 1

times the ``repro_torch`` on ``PYTHONPATH``, so two checkouts compare on one
card when each is run in turn (``PYTHONPATH=<checkout>/src``).  Prints one
JSON line a config: the card's name and power limit, the depth, each
prefill's seconds (every repetition, warm) and the layer's forward and
backward seconds (every repetition).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import make_batch
from repro_torch.models import moe
from repro_torch.models.common import ModelOptions
from repro_torch.models.model import build_model

# (arch, batch, prompt): chip_smoke.py's FAMILY_SERVE rows for the MoE.
PREFILLS = (("mixtral-8x7b", 4, 4352), ("qwen3-moe-235b-a22b", 4, 1000))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def time_prefill(arch, batch_size, prompt, layers, reps, device) -> dict:
    cfg = get_config(arch).scaled(n_layers=layers)
    models = {impl: build_model(cfg, ModelOptions(activation_dtype="float32", moe_impl=impl),
                                device=device) for impl in ("dense", "ragged_local")}
    params = models["dense"].init(torch.Generator(device=device).manual_seed(0))
    batch = make_batch(cfg, batch_size, prompt, device)
    out = {}
    for impl, model in models.items():
        model.prefill_fn(params, batch)  # warm
        out[impl] = [_timed(lambda: model.prefill_fn(params, batch))[1] for _ in range(reps)]
    del params
    torch.cuda.empty_cache()
    return out


def time_layer_grad(arch, tokens, reps, device) -> dict:
    cfg = get_config(arch)
    gen = torch.Generator(device=device).manual_seed(35)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((1, tokens, cfg.d_model), generator=gen, device=device)
    cot = torch.randn((1, tokens, cfg.d_model), generator=gen, device=device)
    fwd, bwd = [], []
    for _ in range(reps + 1):  # the first warms
        leaf = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xs = x.detach().requires_grad_(True)
        (y, aux), f = _timed(lambda: moe.moe_apply(leaf, xs, cfg, impl="ragged_local"))
        loss = (y * cot).sum() + aux
        _, b = _timed(lambda: torch.autograd.grad(loss, [xs] + list(leaf.values())))
        fwd.append(f)
        bwd.append(b)
        del y, aux, loss, leaf, xs
    del p
    torch.cuda.empty_cache()
    return {"fwd_s": fwd[1:], "bwd_s": bwd[1:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--grad-tokens", type=int, default=512)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = _card()
    for arch, batch_size, prompt in PREFILLS:
        rec = {"tag": args.tag, "card": card, "arch": arch, "layers": args.layers,
               "batch": batch_size, "prompt": prompt,
               "prefill_s": time_prefill(arch, batch_size, prompt, args.layers, args.reps,
                                         device),
               "grad_tokens": args.grad_tokens,
               "ragged_layer": time_layer_grad(arch, args.grad_tokens, args.reps, device)}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
