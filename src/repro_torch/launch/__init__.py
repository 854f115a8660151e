"""Entry points of the port: ``serve.py`` (batched prefill + greedy decode),
``train.py`` (training on one device or a ``torchrun`` mesh, with
checkpoints and fault-tolerant restart) and ``trace_export.py`` (a recorded,
probed schedule as Perfetto JSON); ``mesh.py`` and ``sharding.py`` build the
device meshes and the logical-axis shardings the mesh paths take."""
