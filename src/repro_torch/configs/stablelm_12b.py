"""stablelm-12b — dense, GQA(32q/8kv). [hf:stabilityai/stablelm-2-1_6b; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,  # d_model / n_heads
    d_ff=13824,
    vocab_size=100352,
    source="[hf:stabilityai/stablelm-2-1_6b; hf]",
)
