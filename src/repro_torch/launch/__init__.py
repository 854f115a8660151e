"""Entry points of the port: ``serve.py`` (batched prefill + greedy decode),
``train.py`` (single-device training with checkpoints and fault-tolerant
restart) and ``trace_export.py`` (a recorded, probed schedule as Perfetto
JSON)."""
