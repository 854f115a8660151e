"""qwen3-moe-235b-a22b — MoE 128 experts top-8, GQA(64q/4kv).
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,  # decoupled from d_model/n_heads, per the hf config family
    d_ff=1536,  # per-expert hidden
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
