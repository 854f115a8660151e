"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu --steps 20

Builds a 12-layer, d_model=512 phi4-family decoder with a 32k vocab,
streams the deterministic synthetic pipeline, runs the microbatched AdamW
train step (the attention on its ``chunked`` path, which has a backward)
through ``train/ft.py::run_with_recovery`` with a checkpoint every 100
steps, and reports the loss curve.  The lines printed are those of
``examples/train_100m.py``.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import make_stream_for  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.train.ft import FailureInjector, run_with_recovery  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402


def config_100m():
    """~100M params: the phi4 family scaled to 12 x 512 with a 32k vocab."""
    return get_config("phi4-mini-3.8b").scaled(
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=32768,
    )


def train(cfg, *, steps: int, seq_len: int, global_batch: int, ckpt_dir: str,
          ckpt_every: int = 100, fail_at=(), log_every: int = 20, device="cuda") -> dict:
    """Train ``cfg`` from seed 0 for ``steps`` steps (2 microbatches, AdamW
    at lr 6e-4 with 20 warmup steps), a failure injected at each step of
    ``fail_at``; returns ``run_with_recovery``'s history."""
    dev = resolve_device(device)
    model = build_model(cfg, ModelOptions(attn_impl="chunked", mixer_impl="chunked",
                                          activation_dtype="float32", remat="none"),
                        device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in leaves(params))
    print(f"model: {cfg.name} scaled -> {n_params / 1e6:.1f}M params", flush=True)

    tc = TrainConfig(
        microbatches=2,
        optimizer=OptimizerConfig(lr=6e-4, warmup_steps=20, total_steps=steps),
    )
    step = make_train_step(model, tc, donate=True)
    opt = init_opt_state(params)
    stream = make_stream_for(cfg, seq_len, global_batch)

    t0 = time.time()

    def on_metrics(s, m):
        if s % log_every == 0:
            tps = global_batch * seq_len * (s + 1) / (time.time() - t0)
            print(f"step {s:4d} loss {float(m['loss']):.4f} tok/s {tps:,.0f}", flush=True)

    _, _, hist = run_with_recovery(
        step, lambda s: {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(s).items()},
        params, opt, n_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        injector=FailureInjector(fail_at) if fail_at else None, on_metrics=on_metrics,
    )
    hist["seconds"] = time.time() - t0
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    hist = train(config_100m(), steps=args.steps, seq_len=args.seq_len,
                 global_batch=args.global_batch, ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"\nloss: {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f} "
          f"over {len(hist['loss'])} steps ({hist['seconds']:.0f}s)")
    return hist


if __name__ == "__main__":
    main()
