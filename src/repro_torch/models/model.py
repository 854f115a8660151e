"""``build_model(cfg, opts)``: the port's entry point to a model.  Port of
``repro.models.model`` for the decoder-only dense, ssm and hybrid families.
Returns a ``Model`` of plain functions:

  init(generator)                                  -> params (float32 masters)
  prefill_fn(params, batch, max_len=None)          -> (last_logits [B, V], caches)
  decode_fn(params, tokens, caches, cache_length)  -> (logits [B, 1, V], caches)

``params`` is a dict of tensors laid out as ``models/convert.py`` documents.
The training loss comes with the training slice; the other families raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelOptions
from repro_torch.models.layers import embed_init, embed_lookup, logits_from_embed, rms_norm
from repro_torch.models.layers import uniform_scale_init
from repro_torch.models.transformer import stack_apply, stack_init

#: Where each family that is not ported yet stands in ROADMAP.md Queue A.
UNPORTED_FAMILIES = {
    "moe": "ROADMAP.md Queue A item 16 (the other model families)",
    "vlm": "ROADMAP.md Queue A item 16 (the other model families)",
    "audio": "ROADMAP.md Queue A item 16 (the other model families)",
}


class Model(NamedTuple):
    cfg: ModelConfig
    opts: ModelOptions
    device: torch.device
    init: Callable
    prefill_fn: Callable
    decode_fn: Callable


def _lm_head(cfg, params, x):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return logits_from_embed(table, x)


def build_model(cfg: ModelConfig, opts: ModelOptions = ModelOptions(), *,
                device: str | torch.device = "cuda") -> Model:
    """The model's functions on ``device`` (CUDA unless the caller asks for
    the CPU; without a card the default raises)."""
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet: {UNPORTED_FAMILIES[cfg.family]}"
        )
    return _build_decoder_only(cfg, opts, resolve_device(device))


def _build_decoder_only(cfg: ModelConfig, opts: ModelOptions, device: torch.device) -> Model:
    adt = opts.dtype
    pdt = getattr(torch, cfg.param_dtype)

    def init(generator: torch.Generator):
        """Random parameters from ``generator``, which must lie on the
        model's device (the tensors are drawn there)."""
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, model on {device}")
        params = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, pdt),
            "stack": stack_init(generator, cfg, pdt),
            "final_norm": torch.ones(cfg.d_model, dtype=pdt, device=generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = uniform_scale_init(
                generator, (cfg.vocab_size, cfg.d_model), pdt, scale=0.02
            )
        return params

    def forward(params, tokens, *, mode, caches=None, cache_length=None, max_len=None):
        tokens = torch.as_tensor(tokens, device=device)
        x = embed_lookup(params["embed"], tokens, adt)
        if mode == "decode":  # filled on the device: no host-to-device copy, no sync
            positions = torch.full((1,), cache_length, dtype=torch.int32, device=device)
        else:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=device)
        x, new_caches = stack_apply(
            params["stack"], x, cfg=cfg, opts=opts, mode=mode, positions=positions,
            caches=caches, cache_length=cache_length, prefill_capacity=max_len,
        )
        return rms_norm(x, params["final_norm"], cfg.norm_eps), new_caches

    def prefill_fn(params, batch, max_len=None):
        x, caches = forward(params, batch["tokens"], mode="prefill", max_len=max_len)
        return _lm_head(cfg, params, x[:, -1:, :])[:, 0, :], caches

    def decode_fn(params, tokens, caches, cache_length: int):
        """One token per row against caches that hold ``cache_length``
        tokens; the caches are updated in place and returned."""
        x, caches = forward(params, tokens, mode="decode", caches=caches,
                            cache_length=int(cache_length))
        return _lm_head(cfg, params, x), caches

    return Model(cfg, opts, device, init, prefill_fn, decode_fn)
