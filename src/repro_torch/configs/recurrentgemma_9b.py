"""recurrentgemma-9b — hybrid: RG-LRU + local attention 1:2 (two recurrent
blocks per local-attention block), MQA(16q/1kv). [arXiv:2402.19427; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,  # 38 = 12 patterns of (rglru, rglru, attn) + 2 extra rglru
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,  # d_model / n_heads
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
    window=2048,  # local attention window
    tie_embeddings=True,
    source="[arXiv:2402.19427; unverified]",
)
