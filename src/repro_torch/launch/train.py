"""Single-job training entry point.  Port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --steps 200 --seq-len 512 --global-batch 8 --smoke --device cpu

``--smoke`` trains the reduced config with float32 activations and no
remat; without it the published config is built, with bf16 activations and
activation checkpointing per block (``remat="full"``), on the card (a full
phi4-mini state, 71 GB of float32 masters, gradients and moments, does not
fit one 80 GB card: ``chip_smoke.py`` phase 29 trains it at full width with
its depth cut).  The loop wires together every piece of the training path:
the synthetic stream, the train step (the mixers on their ``chunked``
paths, which have a backward), AdamW, checkpoints and the fault-tolerant
restart (``--fail-at``).  Parameters come from the port's ``init`` on a
seeded ``torch.Generator`` on the device.  The port runs on one device: with
more than one card visible it refuses (the mesh and its shardings are
ROADMAP.md Queue A item 10).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import make_stream_for
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelOptions
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.ft import FailureInjector, run_with_recovery
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT exercise)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} cards are visible; the port trains on one "
            "(the mesh and its shardings are ROADMAP.md Queue A item 10): set "
            "CUDA_VISIBLE_DEVICES to one card")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opts = ModelOptions(attn_impl="chunked", mixer_impl="chunked",
                        activation_dtype="float32" if args.smoke else "bfloat16",
                        remat="none" if args.smoke else "full")
    model = build_model(cfg, opts, device=device)
    tc = TrainConfig(microbatches=args.microbatches,
                     optimizer=OptimizerConfig(lr=args.lr, warmup_steps=10,
                                               total_steps=args.steps))
    # The loop never reads a state it passed to the step again: donated.
    step_fn = make_train_step(model, tc, donate=True)
    stream = make_stream_for(cfg, args.seq_len, args.global_batch)

    def batches(step):
        return {k: torch.as_tensor(v, device=device) for k, v in stream.batch(step).items()}

    t0 = time.time()

    def on_metrics(step, metrics):
        if step % args.log_every == 0:
            tps = args.global_batch * args.seq_len * (step + 1) / (time.time() - t0)
            print(
                f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} tok/s {tps:,.0f}",
                flush=True,
            )

    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = init_opt_state(params)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    _, _, history = run_with_recovery(
        step_fn, batches, params, opt_state,
        n_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, injector=injector, on_metrics=on_metrics,
    )
    print(f"done: {len(history['loss'])} steps, final loss "
          f"{history['loss'][-1]:.4f}, recoveries {len(history['recoveries'])}")
    return history


if __name__ == "__main__":
    main()
