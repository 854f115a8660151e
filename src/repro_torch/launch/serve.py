"""Serving entry point: batched prefill, then a greedy decode loop over the
caches (KV caches for attention, a ring of ``window`` slots for local and
sliding-window attention, conv and state caches for mamba2 and the RG-LRU,
cross-attention K/V of the encoder states for whisper).  Port of
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --batch 4 --prompt-len 1000 --gen-len 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --batch 4 --prompt-len 30000 --gen-len 32         # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --batch 4 --prompt-len 4096 --gen-len 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --smoke --device cpu                               # the MoE path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \
        --batch 4 --prompt-len 1024 --gen-len 32          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --batch 4 --prompt-len 416 --gen-len 32           # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --smoke --device cpu                               # plain PyTorch on the CPU

Parameters are random, drawn by the port's own ``init`` on the device from a
seeded ``torch.Generator`` (the JAX package's threefry streams cannot be
reproduced, and the repo has no published weights).  Activations are
float32, as in the JAX entry point.  A vlm's patch embeddings and an audio
model's frames are drawn after the prompt from the same NumPy generator,
standard normals times 0.02, as the JAX entry point draws them.  A MoE
config's full depth does not fit one card (mixtral is 187 GB in float32).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelOptions
from repro_torch.models.model import build_model
from repro_torch.train.serve_step import make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, params, batch, *, gen_len: int, timings: dict | None = None):
    """Prefill on the prompt, then decode ``gen_len`` tokens greedily.
    Returns ``[B, gen_len]`` generated ids.

    With ``timings`` (a dict), the device is synchronised at the end of the
    prefill and of the decode loop and the two wall times are stored under
    ``"prefill_s"`` and ``"decode_s"``; without it nothing waits for the
    device until the caller reads the ids.
    """
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    prompt_len = batch["tokens"].shape[1]
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch, max_len=prompt_len + gen_len)
    tok = logits.argmax(-1, keepdim=True)
    if timings is not None:
        _sync(model.device)
        t1 = time.perf_counter()
        timings["prefill_s"] = t1 - t0
    out = []
    for i in range(gen_len):
        out.append(tok)
        logits, caches = decode(params, tok, caches, prompt_len + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    if timings is not None:
        _sync(model.device)
        timings["decode_s"] = time.perf_counter() - t1
    return torch.cat(out, dim=1)


def make_batch(cfg, batch: int, prompt_len: int, device, seed: int = 0) -> dict:
    """The prompt ``tokens`` ``[batch, prompt_len]`` from a NumPy seed, and
    after them a vlm's ``patch_embeds`` or an audio model's ``frames``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                                     device=device)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.n_patches, cfg.d_model)).astype(np.float32),
            device=device) * 0.02
    if cfg.family == "audio":
        out["frames"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32),
            device=device) * 0.02
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, ModelOptions(activation_dtype="float32"), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    batch = make_batch(cfg, args.batch, args.prompt_len, device)

    timings = {}
    ids = generate(model, params, batch, gen_len=args.gen_len, timings=timings)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{cfg.name} on {where}: generated {tuple(ids.shape)}; prefill "
          f"{timings['prefill_s']:.3f} s, decode {timings['decode_s']:.3f} s "
          f"({args.batch * args.gen_len / timings['decode_s']:.1f} tok/s)")
    print("sample:", ids[0, :16].tolist())
    return ids


if __name__ == "__main__":
    main()
