"""mamba2-130m — attention-free SSM, SSD dual form. [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,  # attn-free, MLP-free mamba2 block
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)
