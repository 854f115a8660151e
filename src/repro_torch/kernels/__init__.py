"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``alloc.py`` (the fused heSRPT allocate) and ``flash_attention.py``
(attention forward, plain version in ``ref.py``, dispatch in ``ops.py``).
Sources in ``csrc/``, built at first use by ``build.py``."""
