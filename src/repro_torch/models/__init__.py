"""The model stack of the port: the decoder-only dense, moe, ssm, hybrid and
vlm families and the audio encoder-decoder (``model.build_model``: init,
training loss, prefill and decode), their layers, mixers and MoE layer, and
``convert.params_from_jax`` / ``opt_state_from_jax`` for the JAX package's
parameter and optimizer trees."""

from repro_torch.models.common import ModelOptions, ParallelConfig
from repro_torch.models.model import Model, build_model, cross_entropy

__all__ = ["Model", "ModelOptions", "ParallelConfig", "build_model", "cross_entropy"]
