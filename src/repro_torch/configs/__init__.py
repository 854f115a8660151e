"""Architecture and shape registry of the port, a copy of ``repro.configs``.

``get_config(arch_id)`` returns the published full-size config;
``smoke_config(arch_id)`` a reduced config of the same family that runs a
prefill, decode and train step on the CPU in a test.  The registry holds the
reference's ten configs: the dense decoders, mamba2 (``ssm``),
recurrentgemma (``hybrid``), mixtral and qwen3-moe (``moe``), internvl2
(``vlm``) and whisper (``audio``).
"""

from __future__ import annotations

from repro_torch.configs import (
    internvl2_1b,
    mamba2_130m,
    mixtral_8x7b,
    phi4_mini,
    qwen3_moe_235b,
    qwen15_110b,
    qwen25_14b,
    recurrentgemma_9b,
    stablelm_12b,
    whisper_base,
)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPE_BY_NAME, SHAPES, ShapeConfig, cell_applicable

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen25_14b, phi4_mini, stablelm_12b, qwen15_110b, mamba2_130m, internvl2_1b,
              recurrentgemma_9b, mixtral_8x7b, qwen3_moe_235b, whisper_base)
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}") from None


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced config of the same family, by the conditionals of
    ``repro.configs.smoke_config``: 2 layers, width 64, vocab 256; an MLP of
    128 only where the full config has one; 4 query heads of dim 16 (at most
    2 KV heads) only where it has attention; 4 experts, top-k at most 2,
    where it has experts; SSM state 16 and SSM head dim 16 for ``ssm``; 3
    layers, LRU width 64 and window 16 for ``hybrid``, window 16 for any
    other windowed config; 2 encoder layers over 8 frames for an
    encoder-decoder; 4 patches for a vlm."""
    cfg = get_config(arch_id)
    small = dict(
        n_layers=2,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        rope_theta=10000.0,
    )
    if cfg.n_heads:
        small.update(n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16)
    if cfg.n_experts:
        small.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.family == "ssm":
        small.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        small.update(n_layers=3, lru_width=64, window=16)
    elif cfg.window:
        small.update(window=16)
    if cfg.is_encdec:
        small.update(encoder_layers=2, encoder_seq=8)
    if cfg.n_patches:
        small.update(n_patches=4)
    return cfg.scaled(**small)


__all__ = ["ARCH_IDS", "SHAPES", "SHAPE_BY_NAME", "ModelConfig", "ShapeConfig",
           "cell_applicable", "get_config", "smoke_config"]
