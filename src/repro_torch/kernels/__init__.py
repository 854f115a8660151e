"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``alloc.py`` (the fused heSRPT allocate), ``flash_attention.py``
(attention forward, plain version in ``ref.py``) and ``ssd_scan.py``
(Mamba2's SSD chunked scan, plain version in ``chunked.py``, oracle in
``ref.py``); dispatch in ``ops.py``.  Sources in ``csrc/``, built at first
use by ``build.py``."""
