"""The input-shape grid, a copy of the reference's (``repro.configs.base``,
re-exported by ``repro.configs.shapes``): one ``ShapeConfig`` a cell of the
(architecture x input shape) grid, and which cells run."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell.  ``kind`` picks the step: train -> the train
    step; prefill -> the prefill step; decode -> one new token against a KV
    cache of ``seq_len``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    def __post_init__(self):
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"bad shape kind {self.kind}")


SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason).  long_500k needs sub-quadratic attention; every arch
    has a decoder, so the decode shapes always run (whisper's 32k KV is far
    beyond its 448 positions, exercised mechanically as the grid asks)."""
    if shape.name == "long_500k" and not cfg.attention_is_subquadratic:
        return False, "pure full-attention stack: 500k decode needs sub-quadratic attention"
    return True, ""
