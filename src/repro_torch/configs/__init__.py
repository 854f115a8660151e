"""Architecture registry of the port, a copy of ``repro.configs``' registry
for the families the port serves.

``get_config(arch_id)`` returns the published full-size config;
``smoke_config(arch_id)`` a reduced config of the same family that runs a
prefill and decode on the CPU in a test.  The registry holds the dense
decoder family, mamba2 (``ssm``) and recurrentgemma (``hybrid``); the other
families' configs come with their slices (ROADMAP.md Queue A).
"""

from __future__ import annotations

from repro_torch.configs import (
    mamba2_130m,
    phi4_mini,
    qwen15_110b,
    qwen25_14b,
    recurrentgemma_9b,
    stablelm_12b,
)
from repro_torch.configs.base import ModelConfig

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen25_14b, phi4_mini, stablelm_12b, qwen15_110b, mamba2_130m, recurrentgemma_9b)
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}") from None


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced config of the same family, by the conditionals of
    ``repro.configs.smoke_config`` that the registry's families reach: 2
    layers, width 64, vocab 256; an MLP of 128 only where the full config
    has one; 4 query heads of dim 16 (at most 2 KV heads) only where it has
    attention; SSM state 16 and SSM head dim 16 for ``ssm``; 3 layers, LRU
    width 64 and window 16 for ``hybrid``, window 16 for any other windowed
    config.  The other families' conditionals (experts, encoders, patches)
    come with their slices."""
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
    if cfg.family == "ssm":
        small.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        small.update(n_layers=3, lru_width=64, window=16)
    elif cfg.window:
        small.update(window=16)
    return cfg.scaled(**small)


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "smoke_config"]
