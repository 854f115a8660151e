"""mixtral-8x7b — MoE 8 experts top-2, GQA(32q/8kv), SWA. [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    window=4096,  # sliding-window attention
    source="[arXiv:2401.04088; hf]",
)
