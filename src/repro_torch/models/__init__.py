"""The model stack of the port: the dense decoder-only family so far
(``model.build_model``), its layers, attention with KV caches, and
``convert.params_from_jax`` for the JAX package's parameter trees."""
