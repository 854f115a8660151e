"""The model stack of the port: the decoder-only dense, ssm and hybrid
families (``model.build_model``: init, training loss, prefill and decode),
their layers and mixers, and ``convert.params_from_jax`` /
``opt_state_from_jax`` for the JAX package's parameter and optimizer
trees."""
