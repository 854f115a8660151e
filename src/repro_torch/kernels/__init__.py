"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``alloc.py`` (the fused heSRPT allocate), ``flash_attention.py``
(attention forward, plain version in ``ref.py``), ``ssd_scan.py``
(Mamba2's SSD chunked scan, plain version in ``chunked.py``, oracle in
``ref.py``) and ``rglru_scan.py`` (the RG-LRU's linear recurrence, plain
version and oracle in ``ref.py``, log-depth form in ``chunked.py``);
dispatch in ``ops.py``.  Sources in ``csrc/``, built at first use by
``build.py``."""
