"""Batched serving with KV caches on the PyTorch port: prefill a batch of
prompts, then decode.

    PYTHONPATH=src python examples/serve_batch_torch.py --arch mixtral-8x7b
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

Uses the smoke-scale config of the chosen architecture (any of the 10
assigned archs works; the SSM and hybrid archs carry state caches instead
of KV) through ``launch/serve.py::generate``, with random weights from a
seeded ``torch.Generator``.  Demonstrates the ring-buffer sliding-window
cache: for mixtral the cache capacity is the window, not the sequence
length.  The lines printed are those of ``examples/serve_batch.py``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import generate, make_batch  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402


def serve(arch: str, batch: int, prompt_len: int, gen_len: int, device="cuda") -> dict:
    """The smoke ``arch`` through ``generate``: the ids ``[batch, gen_len]``,
    the wall seconds, and for a windowed config the shape of its first ring
    cache (``[B, Hkv, capacity, head_dim]``)."""
    dev = resolve_device(device)
    cfg = smoke_config(arch)
    model = build_model(cfg, ModelOptions(activation_dtype="float32", remat="none"),
                        device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    inputs = make_batch(cfg, batch, prompt_len, dev)

    t0 = time.time()
    ids = generate(model, params, inputs, gen_len=gen_len)
    ids = ids.cpu()  # waits for the device
    out = {"cfg": cfg, "ids": ids, "seconds": time.time() - t0, "ring_cache": None}
    if cfg.window:
        _, caches = model.prefill_fn(params, inputs, max_len=prompt_len + gen_len)
        out["ring_cache"] = tuple(leaves(caches)[0].shape)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = serve(args.arch, args.batch, args.prompt_len, args.gen_len, args.device)
    cfg, dt = out["cfg"], out["seconds"]
    where = torch.cuda.get_device_name() if args.device.startswith("cuda") else "CPU"
    print(f"arch={args.arch} ({cfg.family})  batch={args.batch}")
    print(f"prefill {args.prompt_len} + decode {args.gen_len}: {dt:.2f}s "
          f"({args.batch * args.gen_len / dt:.1f} tok/s on {where})")
    if cfg.window:
        print(f"sliding-window ring cache: capacity {out['ring_cache']} "
              f"(window={cfg.window}, not seq)")
    print("first sequence:", out["ids"][0, :16].numpy(), "...")
    return out


if __name__ == "__main__":
    main()
