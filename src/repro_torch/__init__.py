"""heSRPT scheduling and the model stack in PyTorch, with CUDA kernels.

The PyTorch/CUDA port of the JAX package ``repro``.  Its paths so far:

- the heSRPT sweep path (scenario tape -> Thm-3 event loop -> Thm-7 shares
  -> whole chips -> mean flow time) over a leading ``[cells, M]`` batch,
  in float64: ``core/``, ``lanes.py``, the fused allocate ``kernels/alloc.py``;
- the paper's figures, Fig 3's trace and Fig 4's policy comparison
  (``figures.py``, ``core/policies.py``);
- the closed-form arrival superstep (``core/superstep.py``);
- a drifting speedup exponent and slice snapping (``engine.run(p_drift=)``,
  ``engine.snap_to_slices``);
- the bounded-slot streaming loop (``engine.run_stream``,
  ``run_stream_source``, ``Sweep(stream=)``);
- in-loop telemetry and single-class online estimation: probes and the
  ``tel_*`` sweep columns (``core/telemetry.py``), the Perfetto export
  (``launch/trace_export.py``), the estimating rule, estimation noise and
  the estimation arms (``core/estimation.py``, ``Sweep(arm=)``);
- multi-class workloads: per-job exponents and per-job drift rows through
  the event loop, the class-aware policies and samplers, class-pooled
  estimation and ``Sweep(classes=)`` (``core/multiclass.py``);
- the cluster scheduler: ``ClusterScheduler``'s job table and decision
  epochs, per event or delegated to the event loop, the speedup
  estimator, whole-chip quantization and straggler detection (``sched/``),
  with the benchmarks' cross-checks against it and the decision-epoch
  benchmark (``lanes.py``);
- serving every family of the registry, dense, moe, ssm, hybrid, vlm and
  audio (batched prefill, greedy decode over KV, conv, state and
  cross-attention caches): ``configs/``, ``models/``,
  ``train/serve_step.py``, ``launch/serve.py``, with the flash, SSD and
  RG-LRU kernels (``kernels/``);
- training them on one device: the loss, the chunked attention's
  hand-written backward (``kernels/chunked.py``; the kernels have no
  backward), remat, AdamW, the train step, checkpoints and fault-tolerant
  restart (``train/``), the synthetic stream (``data/``) and
  ``launch/train.py``;
- the mesh: device meshes, the logical-axis shardings, the sharded train
  step and checkpoints across mesh shapes (``launch/mesh.py``,
  ``launch/sharding.py``);
- the paper end to end: training jobs with gradient compression
  (``train/compression.py``) resized by the heSRPT ``ClusterScheduler`` at
  every departure (``sched/elastic.py``, ``launch/cluster_train.py``).

Layout mirrors ``src/repro/``.  Every entry point takes ``device=`` and
defaults to ``"cuda"``; without a card it raises instead of falling back
(pass ``device="cpu"`` for the plain-PyTorch path).
"""

from repro_torch.device import DTYPE, resolve_device

__all__ = ["DTYPE", "resolve_device"]
