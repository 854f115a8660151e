"""Data of the port's training path: the synthetic stream (``pipeline.py``)."""
