"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``alloc.py``: the fused heSRPT allocate, source in ``csrc/``)."""
