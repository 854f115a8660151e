"""Entry points of the port: ``serve.py`` (batched prefill + greedy decode)."""
