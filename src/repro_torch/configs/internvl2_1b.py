"""internvl2-1b — VLM: InternViT frontend (stub) + InternLM2 backbone,
GQA(14q/2kv). [arXiv:2404.16821; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,  # d_model / n_heads
    d_ff=4864,
    vocab_size=151655,
    n_patches=256,  # precomputed patch embeddings from the stubbed ViT
    source="[arXiv:2404.16821; hf]",
)
