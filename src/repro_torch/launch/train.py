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
seeded ``torch.Generator`` on the device.

Under ``torchrun`` (``WORLD_SIZE`` > 1) each rank starts the default process
group (``nccl`` on ``cuda``, ``gloo`` on ``cpu``; ``--init-method`` names
another rendezvous than ``env://``) and builds the ``(n, 1)`` ``("data",
"model")`` mesh, as the reference does; the parameters and optimizer state
are distributed by ``launch/sharding.py``'s ``param_specs`` and each batch
by ``batch_specs``, ``ModelOptions.parallel`` is set, and rank 0 prints.
Every rank draws the same initial parameters from the seed.  With one rank
it runs as on one device, with no group and no mesh:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch phi4-mini-3.8b
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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.models.common import ModelOptions, ParallelConfig
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
    ap.add_argument("--init-method", default=None,
                    help="rendezvous of a multi-rank run (default env://, as torchrun sets)")
    args = ap.parse_args(argv)

    n = int(os.environ.get("WORLD_SIZE", "1"))
    device = resolve_device(args.device)
    mesh = None
    if n > 1:
        mesh_lib.start_group(device.type, init_method=args.init_method)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = mesh_lib.make_mesh((n, 1), ("data", "model"), device_type=device.type)
    try:
        return _train(args, device, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def train_options(smoke: bool, mesh=None) -> ModelOptions:
    """The loop's model options: the mixers on their ``chunked`` paths;
    float32 and no remat for ``--smoke``, else bf16 with remat; under a mesh
    of more than one rank, its ``ParallelConfig``."""
    parallel = None
    if mesh is not None and mesh.size() > 1:
        parallel = ParallelConfig(mesh, mesh_lib.data_axes_of(mesh), mesh_lib.model_axis_of(mesh))
    return ModelOptions(attn_impl="chunked", mixer_impl="chunked",
                        activation_dtype="float32" if smoke else "bfloat16",
                        remat="none" if smoke else "full", parallel=parallel)


def make_step(model, *, microbatches: int = 1, lr: float = 1e-3, steps: int = 100):
    """The loop's train step: AdamW with 10 warmup steps over ``steps``,
    donated (the loop never reads a state it passed to the step again)."""
    tc = TrainConfig(microbatches=microbatches,
                     optimizer=OptimizerConfig(lr=lr, warmup_steps=10, total_steps=steps))
    return make_train_step(model, tc, donate=True)


def shard_state(params, opt_state, cfg, mesh):
    """The parameters and optimizer state as DTensors on ``mesh``, placed by
    ``param_specs`` / ``opt_state_specs``."""
    params = sh.distribute(params, sh.param_specs(params, mesh, cfg), mesh)
    ospecs = sh.opt_state_specs(opt_state["m"], mesh, cfg, keep_master="master" in opt_state)
    return params, sh.distribute(opt_state, ospecs, mesh)


def shard_batch(batch, mesh):
    """A batch of tensors as DTensors on ``mesh``, placed by ``batch_specs``."""
    return sh.distribute(batch, sh.batch_specs(batch, mesh), mesh)


def _train(args, device, mesh):
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, train_options(args.smoke, mesh), device=device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    step_fn = make_step(model, microbatches=args.microbatches, lr=args.lr, steps=args.steps)
    stream = make_stream_for(cfg, args.seq_len, args.global_batch)

    def batches(step):
        batch = {k: torch.as_tensor(v, device=device) for k, v in stream.batch(step).items()}
        return batch if mesh is None else shard_batch(batch, mesh)

    t0 = time.time()

    def on_metrics(step, metrics):
        if lead and step % args.log_every == 0:
            tps = args.global_batch * args.seq_len * (step + 1) / (time.time() - t0)
            print(
                f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} tok/s {tps:,.0f}",
                flush=True,
            )

    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_state = init_opt_state(params)
    if mesh is not None:
        params, opt_state = shard_state(params, opt_state, cfg, mesh)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    _, _, history = run_with_recovery(
        step_fn, batches, params, opt_state,
        n_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, injector=injector, on_metrics=on_metrics,
    )
    if lead:
        print(f"done: {len(history['loss'])} steps, final loss "
              f"{history['loss'][-1]:.4f}, recoveries {len(history['recoveries'])}")
    return history


if __name__ == "__main__":
    main()
