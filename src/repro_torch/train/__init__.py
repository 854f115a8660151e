"""Training substrate of the port: the optimizer, the train and serve steps
(on one device or a mesh), checkpoints across mesh shapes, fault-tolerant
recovery and gradient compression with error feedback
(``train/compression.py``).  Port of ``repro.train``."""

from repro_torch.train.optimizer import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.train.train_step import (
    TrainConfig,
    make_decode_step,
    make_init_fn,
    make_prefill_step,
    make_train_step,
)

__all__ = [
    "OptimizerConfig",
    "TrainConfig",
    "apply_updates",
    "init_opt_state",
    "make_decode_step",
    "make_init_fn",
    "make_prefill_step",
    "make_train_step",
]
