"""whisper-base — encoder-decoder; conv/audio frontend is a STUB
(``input_specs`` hands the encoder precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq=1500,  # 30 s of audio after the (stubbed) conv frontend
    tie_embeddings=True,
    source="[arXiv:2212.04356; unverified]",
)
