"""Training substrate of the port: the optimizer, the train and serve steps
(on one device or a mesh), checkpoints across mesh shapes and fault-tolerant
recovery.  Port of ``repro.train`` (gradient compression comes with
ROADMAP.md Queue A item 10c)."""

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
