"""``build_model(cfg, opts)``: the port's entry point to a model, for every
family of the registry.  Port of ``repro.models.model``.  Returns a
``Model`` of plain functions:

  init(generator)                                  -> params (float32 masters)
  loss_fn(params, batch)                           -> (loss, {"ce", "aux_loss"})
  prefill_fn(params, batch, max_len=None)          -> (last_logits [B, V], caches)
  decode_fn(params, tokens, caches, cache_length)  -> (logits [B, 1, V], caches)
  input_specs(shape)                               -> {name: meta tensor}
  cache_specs(shape)                               -> caches of meta tensors

``input_specs`` / ``cache_specs`` are the dry-run contract: stand-ins for
every input of a cell of the shape grid (``configs/shapes.py``), tensors on
the meta device (a shape and a dtype, no storage) that ``launch/dryrun.py``
turns into fake tensors.  The caches are in the port's own layout, the one
``prefill_fn`` returns and ``decode_fn`` takes.

``params`` is a dict of tensors laid out as ``models/convert.py`` documents.
A batch holds ``tokens`` (and ``labels`` for the loss), plus, for a vlm,
``patch_embeds`` ``[B, n_patches, d_model]`` (spliced over the first token
embeddings at training and prefill) and, for audio, ``frames`` ``[B,
encoder_seq, d_model]`` (the encoder's input).  The loss is the cross
entropy plus 0.01 times the MoE layers' load-balance loss (zero for the
other families); a vlm's cross entropy leaves out the patch positions.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.common import ModelOptions, constrain_batch
from repro_torch.models.layers import embed_init, embed_lookup, logits_from_embed, rms_norm
from repro_torch.models.layers import uniform_scale_init
from repro_torch.models.transformer import stack_apply, stack_cache_specs, stack_init
from repro_torch.models.vlm import patch_embed_spec, splice_patches, vlm_loss_mask


class Model(NamedTuple):
    cfg: ModelConfig
    opts: ModelOptions
    device: torch.device
    init: Callable
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    input_specs: Callable
    cache_specs: Callable


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _decode_inputs(shape: ShapeConfig) -> dict:
    """One new token a row against a cache of ``shape.seq_len``."""
    return {"tokens": _meta((shape.global_batch, 1), torch.int32),
            "cache_length": _meta((), torch.int32)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor):
    """Mean masked cross entropy.  logits ``[B, S, V]`` (any dtype, reduced
    in float32), labels ``[B, S]``, mask ``[B, S]`` float32; the sum over
    ``max(sum(mask), 1)``."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    ce = (lse - gold) * mask
    return ce.sum() / torch.clamp_min(mask.sum(), 1.0)


def _lm_head(cfg, params, x):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return logits_from_embed(table, x)


def build_model(cfg: ModelConfig, opts: ModelOptions = ModelOptions(), *,
                device: str | torch.device = "cuda") -> Model:
    """The model's functions on ``device`` (CUDA unless the caller asks for
    the CPU; without a card the default raises)."""
    if cfg.family == "audio":
        return _build_encdec(cfg, opts, resolve_device(device))
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

    def forward(params, tokens, *, mode, caches=None, cache_length=None, patch_embeds=None,
                max_len=None):
        tokens = torch.as_tensor(tokens, device=device)
        x = embed_lookup(params["embed"], tokens, adt)
        if patch_embeds is not None:
            x = splice_patches(x, torch.as_tensor(patch_embeds, device=device))
        x = constrain_batch(x, opts.parallel)
        if mode == "decode":  # filled on the device: no host-to-device copy, no sync
            positions = torch.full((1,), cache_length, dtype=torch.int32, device=device)
        else:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=device)
        x, new_caches, aux = stack_apply(
            params["stack"], x, cfg=cfg, opts=opts, mode=mode, positions=positions,
            caches=caches, cache_length=cache_length, prefill_capacity=max_len,
        )
        return rms_norm(x, params["final_norm"], cfg.norm_eps), new_caches, aux

    def loss_fn(params, batch):
        """``(loss, {"ce", "aux_loss"})`` of a batch of ``tokens`` and
        ``labels`` ``[B, S]``: the cross entropy (for a vlm masked over the
        patch positions) plus 0.01 times the layers' load-balance loss."""
        x, _, aux = forward(params, batch["tokens"], mode="train",
                            patch_embeds=batch.get("patch_embeds"))
        logits = _lm_head(cfg, params, x)
        labels = torch.as_tensor(batch["labels"], device=device)
        if cfg.family == "vlm":
            mask = vlm_loss_mask(cfg, labels)
        else:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=device)
        ce = cross_entropy(logits, labels, mask)
        return ce + 0.01 * aux, {"ce": ce, "aux_loss": aux}

    def prefill_fn(params, batch, max_len=None):
        x, caches, _ = forward(params, batch["tokens"], mode="prefill",
                               patch_embeds=batch.get("patch_embeds"), max_len=max_len)
        return _lm_head(cfg, params, x[:, -1:, :])[:, 0, :], caches

    def decode_fn(params, tokens, caches, cache_length: int):
        """One token per row against caches that hold ``cache_length``
        tokens; the caches are updated in place and returned."""
        x, caches, _ = forward(params, tokens, mode="decode", caches=caches,
                               cache_length=int(cache_length))
        return _lm_head(cfg, params, x), caches

    def input_specs(shape: ShapeConfig) -> dict:
        if shape.kind == "decode":
            return _decode_inputs(shape)
        b = shape.global_batch
        specs = {"tokens": _meta((b, shape.seq_len), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, shape.seq_len), torch.int32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = patch_embed_spec(cfg, b, adt)
        return specs

    def cache_specs(shape: ShapeConfig) -> dict:
        return stack_cache_specs(cfg, shape.global_batch, shape.seq_len, adt)

    return Model(cfg, opts, device, init, loss_fn, prefill_fn, decode_fn, input_specs,
                 cache_specs)


def _build_encdec(cfg: ModelConfig, opts: ModelOptions, device: torch.device) -> Model:
    adt = opts.dtype
    pdt = getattr(torch, cfg.param_dtype)

    def init(generator: torch.Generator):
        """Random parameters from ``generator``, which must lie on the
        model's device (the tensors are drawn there)."""
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, model on {device}")
        return encdec.encdec_init(generator, cfg, pdt)

    def encode(params, batch):
        frames = torch.as_tensor(batch["frames"], device=device).to(adt)
        return encdec.encode(params, frames, cfg=cfg, opts=opts)

    def loss_fn(params, batch):
        """``(loss, {"ce", "aux_loss"})``: the cross entropy over every
        position of ``tokens`` given ``frames``; ``aux_loss`` is zero."""
        x, _ = encdec.decode_stack(params, torch.as_tensor(batch["tokens"], device=device),
                                   cfg=cfg, opts=opts, mode="train",
                                   enc_out=encode(params, batch))
        logits = logits_from_embed(params["embed"], x)
        labels = torch.as_tensor(batch["labels"], device=device)
        ce = cross_entropy(logits, labels,
                           torch.ones(labels.shape, dtype=torch.float32, device=device))
        return ce, {"ce": ce, "aux_loss": torch.zeros((), dtype=torch.float32, device=device)}

    def prefill_fn(params, batch, max_len=None):
        x, caches = encdec.decode_stack(
            params, torch.as_tensor(batch["tokens"], device=device), cfg=cfg, opts=opts,
            mode="prefill", enc_out=encode(params, batch), prefill_capacity=max_len,
        )
        return logits_from_embed(params["embed"], x[:, -1:, :])[:, 0, :], caches

    def decode_fn(params, tokens, caches, cache_length: int):
        """One token per row against caches that hold ``cache_length``
        tokens; the self-attention caches are updated in place."""
        x, caches = encdec.decode_stack(
            params, torch.as_tensor(tokens, device=device), cfg=cfg, opts=opts, mode="decode",
            caches=caches, cache_length=int(cache_length),
        )
        return logits_from_embed(params["embed"], x), caches

    def input_specs(shape: ShapeConfig) -> dict:
        if shape.kind == "decode":
            return _decode_inputs(shape)
        b = shape.global_batch
        specs = {"frames": _meta((b, cfg.encoder_seq, cfg.d_model), adt),
                 "tokens": _meta((b, shape.seq_len), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, shape.seq_len), torch.int32)
        return specs

    def cache_specs(shape: ShapeConfig) -> dict:
        return encdec.encdec_cache_specs(cfg, shape.global_batch, shape.seq_len, adt)

    return Model(cfg, opts, device, init, loss_fn, prefill_fn, decode_fn, input_specs,
                 cache_specs)
