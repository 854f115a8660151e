"""Step factories of the port: serving so far (``serve_step.py``)."""
