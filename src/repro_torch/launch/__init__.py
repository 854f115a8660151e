"""Entry points of the port: ``serve.py`` (batched prefill + greedy decode)
and ``trace_export.py`` (a recorded, probed schedule as Perfetto JSON)."""
