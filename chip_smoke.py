#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

``python3 chip_smoke.py`` from the repo root, on a machine with one NVIDIA
card (sm_90a, nvcc under ``CUDA_HOME``).  It builds the port's four
kernels, ``src/repro_torch/kernels/csrc/alloc.cu`` (the fused allocate),
``csrc/flash_attention.cu``, ``csrc/ssd_scan.cu`` and ``csrc/rglru_scan.cu``,
with one nvcc each, started together, and runs, in order (any failure
raises, and the exit code is not 0):

1. environment: the card's name and power limit, torch and CUDA versions,
   the allocate kernel's build time;
2. the kernel against its plain PyTorch version on the card, bit for bit
   (theta bitwise, chips equal) over sizes with zeros and exact ties, f64
   and f32, M from 1 to ``MAX_JOBS`` (4096), rows of sizes in {1, 2, 3},
   rows with no active job, and 1, 6 and 300 cells, plus the reference
   behaviours ROADMAP.md's Queue C records; then with one p a cell read from
   device memory (the drifting p), every mode of the power (c = 1, 2, 3 and
   two of pow) mixed in one launch, f64 and f32, in 1, 6 and 192 cells,
   also against each cell's scalar-p launch;
3. the three canonical sweep lanes at full size (24 rates x 8 seeds x 1000
   jobs, 256 chips, p = 0.5); the launch count is zeroed just before and
   read just after, and the fused lane must launch the kernel once per
   event step (2M = 2000);
4. one smoke-size lane on the same tapes on the CPU and on the card: flows
   within 1e-12 relative, chips equal at every event;
5. Thm 8: a batch heSRPT tape simulated on the card against the closed form;
6. kernel timing at the lane shape [192, 1000] in f64 and f32 and at
   [192, 4096] in f64, each beside the plain version's time and the bound,
   with the instance's registers a thread and resident CTAs an SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) (every time in
   phases 6, 10, 14 and 18 is device ms a call:
   CUDA events around calls queued behind a sleep kernel, so the host's
   launch rate is not what is timed);
7. the flash-attention kernel's build time, and the kernel against its plain
   version on the card, float32 within 2e-5 and bfloat16 within 5e-2 (the
   tolerances of ``tests/test_kernels.py``): the shapes of that file, non-
   causal, windows 16 and 100, head dims 16, 128, 160 and 256 and the padded
   80 and 200, the model's transposed views, and the phi4-mini prefill shape
   [4, 24, 1000, 128]; float32 runs the CUDA-core design, bfloat16 the
   tensor-core one, and neither may copy any of these inputs (no alignment
   copy).  float32 also runs its design's edges at each of the six head
   dims (``FLASH_F32_EDGES``: q_offset, lengths off its 64-row and 64-key
   tiles, a window narrower than a tile, one query row, MQA, non-causal,
   transposed views, and an unaligned q, which must be copied once).  5e-2
   is about a typical |out| at ~1000 keys, so bf16 is also held within
   1e-2 + 1e-2 |want| at every element and within ``FLASH_BF16_REL`` in
   relative norm; at the serve shapes (phi4-mini's and stablelm's) two
   faulty outputs made with the plain arithmetic (a middle K/V tile
   dropped; the causal edge 3 keys early for the later rows) must lie
   beyond that limit in bf16 and beyond 2e-5 in float32, and the float32
   kernel's output rounded to bf16 within the bf16 limit;
8. the serving path at full width: phi4-mini-3.8b (32 layers, d_model 3072,
   vocab 200064, 4.45e9 float32 parameters drawn on the card from a seed)
   serves batch 4 x 1000 prompt tokens + 32 greedy tokens through
   ``launch/serve.py::generate``; the flash count is zeroed just before and
   read just after and must be 32 (one per layer of the one prefill), with
   no input copied for alignment; the
   prefill's last logits match the same prefill with ``attn_impl="ref"``;
   then phase 20, on the same weights;
9. the smoke-size phi4-mini on the same weights on the CPU and on the card:
   prefill and teacher-forced decode logits within 2e-4;
10. flash timing, float32 and bfloat16, at phi4-mini's prefill shape
    [4, 24, 1000, 128] / [4, 8, 1000, 128] causal and recurrentgemma's
    [4, 16, 4096, 256] / [4, 1, 4096, 256] causal with window 2048: the
    kernel, its plain version and PyTorch's ``scaled_dot_product_attention``
    (the band as a boolean mask where there is a window; timed as a
    yardstick only, the port never calls it), beside the kernel's bound,
    and the float32 instance's registers and resident CTAs an SM;
11. the SSD kernel's build time, and the kernel against its plain version
    (``kernels/chunked.py`` at the kernel's chunk length) and, up to 1000
    steps, the recurrence (``kernels/ref.py``) on the card, float32 and
    bfloat16: y within 2e-5 / 5e-2 and the final state within 1e-3 (the
    tolerances of ``tests/test_kernels.py``), on that file's SSD shapes
    (ragged, a chunk longer than the sequence), fewer steps than the conv
    width, one step, 65 chunks (4096 + 17 steps), x, b and c as strided
    slices of one projection, and the mamba2-130m prefill shape
    x [4, 30000, 24, 64], b/c [4, 30000, 128] (``tools/ssd_float64_check.py``
    holds both against a float64 evaluation there);
12. mamba2-130m at full width (24 layers, d_model 768, d_inner 1536, state
    128, vocab 50280, 128,983,488 float32 parameters drawn on the card from a
    seed) serves batch 4 x 30000 prompt tokens + 32 greedy tokens through
    ``generate``; the SSD count is zeroed just before and read just after and
    must be 24 (one per layer of the one prefill), the flash count 0; the
    prefill's last logits match the same prefill with ``mixer_impl="chunked"``;
13. the smoke-size mamba2-130m on the same weights on the CPU and on the
    card: prefill and teacher-forced decode logits within 2e-4;
14. SSD timing at the prefill shape of one layer, float32: the kernel and
    its plain version beside the kernel's bound (no single PyTorch call
    computes SSD, so there is no library yardstick);
15. the RG-LRU kernel's build time, and the kernel against its plain version
    (the recurrence ``kernels/ref.py::linear_recurrence`` on the same a and
    g) and, through ``ops.rglru``, against the log-depth
    ``kernels/chunked.py::rglru`` on the card, float32 and bfloat16: y within
    2e-5 / 5e-2 and the float32 state within 1e-3 (the tolerances of
    ``tests/test_kernels.py``), on that file's RG-LRU shapes, one step, a
    width not a multiple of the kernel's 128-channel block, decay near 1
    over 8192 steps, and the recurrentgemma-9b prefill shape [4, 4096, 4096];
16. recurrentgemma-9b at full width (38 layers: 12 x (rglru, rglru, attn) + 2
    rglru, d_model 4096, LRU width 4096, 16 query / 1 KV head of dim 256,
    window 2048, d_ff 12288, vocab 256000, 8,524,206,080 float32 parameters
    drawn on the card from a seed) serves batch 4 x 4096 prompt tokens + 32
    greedy tokens through ``generate``; the counts are zeroed just before
    and read just after, and the one prefill must launch the RG-LRU kernel 26
    times, flash 12 times (no input copied) and SSD not at all; the prefill's
    last logits
    match the same prefill with ``mixer_impl="chunked"``;
17. the smoke-size recurrentgemma on the same weights on the CPU and on the
    card: prefill and teacher-forced decode past the window within 2e-4;
18. RG-LRU timing at [4, 4096, 4096] float32: the kernel and its plain
    version beside the kernel's bound (no single PyTorch call computes a
    first-order linear recurrence, so there is no library yardstick);
19. stablelm-12b at its published widths (d_model 5120, 32 query / 8 KV
    heads of dim 160, d_ff 13824, vocab 100352, untied) with the depth cut
    from 40 to 2 layers (1.6e9 float32 parameters drawn on the card from a
    seed) prefills batch 4 x 1000 tokens through ``generate``; the flash
    count is zeroed just before and read just after and must be 2 (one per
    layer, at the kernel's D = 160 instance, no input copied); the prefill's
    last logits
    match the same prefill with ``attn_impl="ref"``;
20. (run right after phase 8, on its weights) phi4-mini-3.8b at full width
    and depth with bf16 activations (``ModelOptions()``, the models'
    default) prefills batch 4 x 1000 through ``prefill_fn``: exactly 32
    launches of the bf16 flash kernel and no alignment copy; the last
    logits lie within twice the distance from phase 8's float32 logits
    that the same bf16 prefill with ``attn_impl="ref"`` has (over 32
    layers any bf16-sized change of one layer's output grows to ~6e-2 at
    |logit| ~3, so the kernel's rounding of P is held to the spread of
    bf16 itself; a wrong mask or scale moves them by O(1)); prefill time
    and peak memory;
21. the paper's figures on the card (``repro_torch/figures.py``): Fig 3's
    trace (epoch-0 shares (1/9, 3/9, 5/9) within 1e-12, SJF completion
    order), then Fig 4 at ``FIG4``'s full size (N = 1e6, M = 500,
    Pareto(1.5), 10 seeds, p in {.05, .3, .5, .9, .99}, KNEE's best of 12
    alphas: each policy one batch run a p, 10 rows or 120 for KNEE); the
    alloc count is zeroed just before and read just after, and the heSRPT
    column must launch the kernel once per event step, 5 x 500 times.  Its
    flows equal the unfused heSRPT run bit for bit and lie within 1e-9
    relative of Theorem 8 and of the batch closed form; heSRPT's median is
    at most every competitor's x (1 + 1e-9) at every p; Fig 4 at its quick
    size on the card equals the CPU run within 1e-12 relative.  Prints the
    medians, heSRPT's advantage, the figure's wall time, and the kernel's
    theta pass at Fig 4's shape [10, 500] beside its plain version and bound;
22. the closed-form superstep path at the lanes' size (24 rates x 8 seeds x
    1000 jobs, 256 servers, p = 0.5, the lanes' tapes): heSRPT, EQUI and
    SRPT through ``Sweep(superstep=True)`` (M + 1 steps) against the
    carried-rank sweep (2M steps), every cell's mean flow within 1e-9
    relative; the pre-arrived [192, 1000] batch by ``batch_result_closed_form``
    equal bit for bit to ``flowtime.hesrpt_completion_times`` and within
    1e-9 relative of ``simulator.simulate``, job by job; both paths' wall
    times;
23. the drift lanes at full size (the lanes' grid under ``drift_poisson``:
    p 0.8 -> 0.3 at half of each rate's nominal span, 256 chips): the alloc
    count is zeroed just before and read just after, and the fused lane
    must launch the kernel 2M + D = 2001 times, each cell reading its own p;
    its flows equal the unfused lane's bit for bit; continuous heSRPT on
    the generic loop and ``Sweep(superstep=True)`` for heSRPT, EQUI and SRPT
    within 1e-9 relative of the generic loop per cell; the ``drift_bursty``
    fused lane (2001 launches) bit for bit with its unfused lane; the smoke
    drift lanes on the same tapes on the CPU and the card: flows within
    1e-12 relative, chips equal at every event; every lane's wall;
24. slice snapping on the lanes' tapes through ``engine.run``
    (``quantized_rule(snap_slices=True)``), fused against unfused: chips
    equal at every event, every count a slice size, at most 256 chips a
    cell; seed chunking of the fused drift lane (chunks of 1 and 3 seeds)
    bit for bit with the unchunked run; and the kernel with one p a cell at
    [192, 1000] f64 timed beside the scalar path, its plain version and its
    bound;
25. the bounded-slot streaming loop at ``benchmarks/streaming.py``'s full
    sizes and the lanes' grid, every tape drawn on the card from a seed:
    (a) on the fused lane's tapes, ``run_stream(fused=True)`` over 1000 slots
    (no recycling) gives ``engine.run(fused=True)``'s completion times bit
    for bit and the same chips at every event step; (b) the three stream
    lanes (``lanes.stream_lane_specs``: the lanes through 64 slots a cell,
    every stream metric): the alloc count is zeroed just before and read
    just after, and the fused lane must launch the kernel once an event
    step (2M = 2000) at [192, 64], equal the unfused lane bit for bit in
    every metric, and hold at most 64 jobs a cell; (c) the load ladder
    (rates 1, 2, 4, 8, 1000 jobs, 10 seeds, 64 slots; heSRPT, SRPT, EQUI on
    the carried-rank stream): wall and windowed mean flows; (d) horizon
    scaling: ``run_stream_source(poisson_source)`` at 32 slots (rate 4, 4
    servers, p 0.5) over ``STREAM_HORIZONS`` events (64,000 is cut for the
    time limit): us an event and peak device bytes above the baseline,
    which must not grow with the horizon, beside ``engine.run`` on E/2 jobs;
    (e) the long horizon: at least 50 x 32 jobs through 32 slots, never
    more than 32 in flight, deferrals printed; (f) the smoke stream lanes on
    the same tapes on the CPU and the card: flows within 1e-12 relative,
    counts equal; (g) the kernel at the pool's widths (M = 1, 12, 24, 64,
    256; rows half, 90% and all free) bit for bit with its plain version,
    f64 and f32, and its time at [192, 64] f64 beside the plain version and
    the bound;
26. in-loop telemetry and single-class online estimation: (a) the fused
    lane's tapes through ``run_sweep`` with and without a stream probe of
    ``telemetry.DEFAULT_METRICS`` (``alloc_unit`` 256): the alloc count is
    zeroed just before the probed run and read just after, 2M = 2000
    launches, mean flows equal, and through ``engine.run`` the chips of all
    2000 event steps and the completion times bit for bit, and the probe's
    aggregates (histograms included) bit for bit the unfused lane's; the fused stream
    lane under each rate's windowed probe, 2000 launches at [192, 64],
    every stream metric bit for bit; both walls of each; (b) one
    full-width row: the stream aggregates within 1e-9 of
    ``analysis.time_weighted_stats`` of the series (``benchmarks/
    telemetry.py``'s bar), histogram mass == span; (c) that file's online
    half at its full size (heSRPT and EQUI, rates 0.5, 2, 8, 500 jobs x 20
    seeds, ``telemetry=True``): its table and wall; (d) ``benchmarks/
    estimation.py``'s sweep at its full size (oracle, stale, estimator x
    the same grid, ``drift_poisson`` and ``drift_bursty``): estimator <=
    stale x 1.02 at every load and scenario, the forgetting rows, and the
    estimator arm of ``benchmarks/telemetry.py`` with ``p_hat_err``
    (``estimation.cross_check`` runs in phase 28); (e) smoke
    telemetry and estimator sweeps on the same tapes, CPU against card,
    every column within 1e-12 relative, the smoke fused lane's histograms
    within 1e-12; (f) ``trace_export.export_sample(n_chips=16)`` on the
    card (heSRPT through the fused allocate) passes
    ``validate_trace_events`` (24 alloc launches);
27. multi-class workloads (``core/multiclass.py``), which launch no kernel,
    as in the reference (the alloc count is zeroed before (a) and must read
    0 after it): (a) ``lanes.multiclass_specs``, ``benchmarks/
    multiclass.py``'s grid: K = 4 at its full size (1000 jobs x 10 seeds x
    rates 0.5, 2, 8, 256 servers, continuous), K = 2 and 3 at its quick size
    (300 x 8; cut for the time budget), each of the four class-aware
    policies one ``run_sweep`` of one ``[R * S, M]`` batch: each policy's
    wall, the overall and per-class mean flow and slowdown, and the
    class-aware / class-blind ratios of ``gap_rows``; (b) the K = 2 snap
    pair (``hesrpt_pc`` on 256 chips, 300 jobs x 8 seeds, slices off and
    on): walls and the snapped / whole-chips ratio; (c) K = 3 classes at
    p = 0.5 through ``simulate_multiclass`` bit for bit with the
    single-class run on the same tapes, continuous and whole chips; (d) K =
    4's ``hesrpt_pc`` column run twice, every column bit for bit (the
    per-class sums are fixed-order masked sums, no atomics); (e) smoke
    ``Sweep(classes=)``, its snapped twin, a ``drift_multiclass`` sweep and
    ``simulate_multiclass(estimator_kw=)``, CPU against card within 1e-12
    relative;
28. the cluster scheduler (``sched/``), which launches no kernel, as in the
    reference (the alloc count is zeroed before (a) and must read 0 after
    (e)): (a) ``examples/quickstart.py``'s cluster step (64 chips, sizes 8,
    5, 3, 2, 1, heSRPT on whole chips): the allocation, and the total flow
    beside Thm 8's fluid optimum; (b) a backlog of 1000 Pareto(1.5) + 1 jobs
    (``default_rng(0)``) on 4096 chips, heSRPT and the class-aware
    ``hesrpt_pc`` over ``lanes.class_grid(4)``'s exponents, each delegated
    to ``engine.run`` and per event: chips equal at every allocate event,
    completion times within 1e-9 relative, both walls; the delegated heSRPT
    run on the CPU within 1e-12 of the card's; (c) the estimator at 64 jobs
    on 256 chips (true p in [0.3, 0.8], priors 0.5, discount 0.9),
    continuous and whole chips, and the class-aware estimator on a table
    reused after a first run: delegated against per event within 1e-8;
    (d) the five cross-checks of ``lanes`` at their benchmarks' sizes and
    bars (quantized: chips exact, epoch times and flows 1e-9; arrivals
    1e-6; estimation 1e-8; multi-class: chips exact, continuous 1e-10,
    whole chips 1e-9; the stream oracle 1e-6); (e) ``lanes.sched_scale``
    at M = 100 .. 1e5 on 4096 chips: theta us (median of 5), quantize us,
    4096 chips at every M, and the card's chips at 1e5 equal to the CPU's.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without CUDA, or without the repo's
sources beside it, it exits with 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Exponents p of every mode of the allocate's power c = 1/(1-p): products for
# c = 1, 2, 3 (p = 0, 1/2, 2/3), device pow for c = 5 and 1/0.7.
PER_CELL_P = (0.0, 0.5, 2.0 / 3.0, 0.8, 0.3)

# H100 SXM, from NVIDIA's data sheet:
# HBM rate, and the float32 rate outside the tensor cores (the table has no
# float64 row; the f64 rate is lower, so this understates no bound).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Dense bf16 tensor-core rate: the least time for attention's products on
# bf16 inputs, whatever unit a kernel uses.
PEAK_BF16_OPS_PER_S = 989e12

SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "phi4-mini-3.8b", 4, 1000, 32
# 30000 is near the repo's prefill_32k length and a multiple of neither 64
# nor 128, so the SSD kernel's masked last chunk runs at full width.
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_GEN = "mamba2-130m", 4, 30000, 32
# 4096 is twice the local-attention window: the flash kernel's band skipping
# and the ring fold of the KV cache both run at full width.
HYBRID_ARCH, HYBRID_BATCH, HYBRID_PROMPT, HYBRID_GEN = "recurrentgemma-9b", 4, 4096, 32
# Head dim 160, the flash kernel's one instance that is not a power of two;
# the depth is cut to 2 of its 40 layers (the widths are the published ones).
WIDE_ARCH, WIDE_LAYERS, WIDE_BATCH, WIDE_PROMPT, WIDE_GEN = "stablelm-12b", 2, 4, 1000, 32
# Logits of two float32 runs that differ only in summation order (kernel vs
# plain attention; CPU vs card): the bar of tests/test_models.py.  Computing
# any part in bf16 moves them by ~1e-2.
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# The bf16 flash kernel is held closer than FLASH_TOL, whose 5e-2 is about a
# typical |out| at ~1000 keys: every element within 1e-2 + 1e-2 |want| (one
# bf16 ulp is at most 7.8e-3 |want|), and ||got - want|| / ||want|| within
# FLASH_BF16_REL on every shape.  The limit lies between the readings of
# sound outputs and those of faulty ones, which phase 7 takes anew in every
# run: on an H100 the kernel's worst was 2.3e-3 (the float32 kernel rounded
# to bf16 3.4e-5), a dropped middle K/V tile 0.116 and the causal edge 3
# keys early 2.3e-2; 7e-3 is 3x from each side (PERF.md section 6).
FLASH_BF16_TIGHT = dict(rtol=1e-2, atol=1e-2)
FLASH_BF16_REL = 7e-3
# The SSD kernel's y at the same tolerances (summation order; bf16 rounds the
# float32 result), its float32 final state within 1e-3: tests/test_kernels.py.
SSD_TOL = FLASH_TOL
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# The RG-LRU kernel's y at the same tolerances (another order of the same
# steps in the log-depth scan), its state (y[:, -1] in float32, as the TPU
# kernel's) within 1e-3.  In bf16 both sides take the same bf16 a and g.
RGLRU_TOL = FLASH_TOL
# Phase 25's horizon scaling. benchmarks/streaming.py's full tier also runs
# 64,000 events: cut here for the script's time limit (on an H100 at 700 W
# that horizon alone took 107 s, 1.67 ms an event step of host launches,
# with the same peak device bytes as the three below). The finite-tape
# comparator runs at every horizon kept.
STREAM_HORIZONS = (1_000, 4_000, 16_000)
STREAM_HORIZONS_CUT = (64_000,)
# The widths the alloc kernel takes in the streaming loop: a pool of slots,
# padded to at least 32 entries.
POOL_WIDTHS = (1, 12, 24, 64, 256)
# Phase 28: a cluster's backlog (jobs, chips; sched_scale's pool) and the
# estimator tables (benchmarks/estimation.py's regime at 64 jobs).
SCHED_JOBS, SCHED_CHIPS = 1000, 4096
SCHED_EST_JOBS, SCHED_EST_CHIPS = 64, 256


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _sizes(gen, shape, device, dtype, kind="pareto"):
    """Job sizes: "pareto", Pareto-like with ~20% zeros (departed jobs) and
    exact ties; "ties", 1, 2 or 3 with ~20% zeros (ties in the ranks and in
    the fractional parts of the shares); "inactive", zeros and negatives."""
    import torch

    if kind == "ties":
        x = torch.randint(1, 4, shape, generator=gen, device=device).to(torch.float64)
    elif kind == "inactive":
        x = torch.full(shape, -1.0, dtype=torch.float64, device=device)
    else:
        x = torch.exp(torch.empty(shape, dtype=torch.float64, device=device)
                      .exponential_(generator=gen) / 1.5)
    drop = torch.rand(shape, generator=gen, device=device, dtype=torch.float64) < 0.2
    x = torch.where(drop, 0.0, x)
    if kind != "pareto":
        return x.to(dtype).contiguous()
    k = shape[-1] // 4
    x[..., :k] = x[..., k:2 * k]
    return x.to(dtype).contiguous()


def _time_ms(fn, iters: int) -> float:
    """Device ms per call (CUDA events): the calls are queued behind a ~50 ms
    sleep kernel, so the events bracket back-to-back device work even where
    the host takes longer to launch a call than the device to run it."""
    import torch

    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_kernel_vs_plain(alloc, engine, device) -> float:
    """Phase 2: bitwise equality on the card; returns the max |theta| error."""
    import torch

    gen = torch.Generator(device=device).manual_seed(2)
    worst, checked = 0.0, 0
    # (cells, M, sizes): one to sixteen jobs a thread (1024 and 1025 on
    # either side of four, MAX_JOBS the most one CTA takes), tie-heavy rows,
    # rows with no active job, and 1 and 300 cells (more than two CTAs an
    # SM).
    cases = [(6, M, "pareto") for M in (1, 7, 60, 257, 1000, 1024, 1025, 2048, alloc.MAX_JOBS)]
    cases += [(6, 1000, "ties"), (6, alloc.MAX_JOBS, "ties"), (6, 1000, "inactive"),
              (6, alloc.MAX_JOBS, "inactive"), (1, 1000, "pareto"), (300, 1000, "pareto"),
              (300, alloc.MAX_JOBS, "ties")]
    for dtype in (torch.float64, torch.float32):
        for cells, M, kind in cases:
            x = _sizes(gen, (cells, M), device, dtype, kind)
            for n_chips in (0, 16, 256):
                for min_chips in (1, 2, 4):
                    for p in (0.5, 0.3, 0.99):  # c = 2 (products), pow, subnormal brackets
                        kw = dict(min_chips=min_chips)
                        theta, chips = alloc.hesrpt_alloc_fused(x, p, n_chips, **kw)
                        theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p, n_chips, **kw)
                        err = (theta - theta0).abs().max().item()
                        worst = max(worst, err)
                        if not (torch.equal(theta, theta0) and torch.equal(chips, chips0)):
                            raise AssertionError(
                                f"kernel != plain: {dtype} [{cells}, {M}] {kind} n_chips={n_chips} "
                                f"min_chips={min_chips} p={p} max|dtheta|={err} "
                                f"chip diffs={(chips != chips0).sum().item()}"
                            )
                        checked += 1
    # Queue C: ties break by index (through the kernel) ...
    theta, chips = alloc.hesrpt_alloc_fused(torch.tensor([1.0, 1.0], device=device), 0.5, 4)
    assert theta.tolist() == [0.25, 0.75] and chips.tolist() == [1, 3], (theta, chips)
    # ... f64 on the card keeps a subnormal share (the NumPy oracle's answer),
    # and a leftover chip may go to a job at the min-chips floor.
    sub = torch.tensor([0.0] * 13 + [1.0, 1.11253693e-308], dtype=torch.float64, device=device)
    assert engine.quantize_allocation(sub, 2)[-2:].tolist() == [1, 1]
    floor_case = torch.tensor([0, 0, 0.04142012, 0.9112426, 0.04733728, 0], device=device,
                              dtype=torch.float64)
    assert engine.quantize_allocation(floor_case, 24).tolist() == [0, 0, 2, 21, 1, 0]
    print(f"phase 2: kernel == plain version bit for bit on {checked} cases "
          f"(max |dtheta| = {worst}); Queue C inputs as recorded", flush=True)
    return worst


def phase_per_cell_p(alloc, device) -> int:
    """Phase 2, second part: one p a cell read from device memory, every
    power mode in one launch; returns the number of cases checked."""
    import torch

    gen = torch.Generator(device=device).manual_seed(22)
    mixed = torch.tensor(PER_CELL_P, dtype=torch.float64, device=device)
    checked = 0
    for dtype in (torch.float64, torch.float32):
        for cells in (1, 6, 192):
            p_col = mixed.repeat(-(-cells // len(PER_CELL_P)))[:cells, None]
            for M, kind in ((1000, "pareto"), (37, "ties"), (alloc.MAX_JOBS, "pareto")):
                x = _sizes(gen, (cells, M), device, dtype, kind)
                for n_chips, min_chips in ((0, 1), (256, 1), (16, 2)):
                    kw = dict(min_chips=min_chips)
                    theta, chips = alloc.hesrpt_alloc_fused(x, p_col, n_chips, **kw)
                    theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p_col, n_chips, **kw)
                    same = torch.equal(theta, theta0) and torch.equal(chips, chips0)
                    for p in PER_CELL_P:  # each cell as its scalar-p launch
                        rows = (p_col[:, 0] == p).nonzero()[:, 0]
                        theta_s, chips_s = alloc.hesrpt_alloc_fused(x, p, n_chips, **kw)
                        same = same and torch.equal(theta[rows], theta_s[rows]) and \
                            torch.equal(chips[rows], chips_s[rows])
                    if not same:
                        raise AssertionError(
                            f"per-cell p: kernel != plain: {dtype} [{cells}, {M}] {kind} "
                            f"n_chips={n_chips} min_chips={min_chips} "
                            f"max|dtheta|={(theta - theta0).abs().max().item()}")
                    checked += 1
    print(f"phase 2: one p a cell from device memory (c = 1, 2, 3, 5, 1/0.7 in one launch): "
          f"kernel == plain version and == each cell's scalar-p launch bit for bit on "
          f"{checked} cases (f64, f32; 1, 6, 192 cells)", flush=True)
    return checked


def phase_lanes(alloc, lanes, device):
    """Phase 3: the three lanes at full size; returns (results, launches)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    alloc.LAUNCHES = 0
    results = lanes.run_lanes(device=device)
    torch.cuda.synchronize()
    launches = alloc.LAUNCHES
    by_label = dict(results)
    M = by_label["quantized-fused"].spec.n_jobs
    assert launches == 2 * M, f"fused lane launched the kernel {launches} times, not {2 * M}"
    assert lanes.fused_equals_unfused(results), "fused lane != unfused lane"
    for label, res in results:
        a = res.stats["hesrpt"]["mean_flowtime"]
        assert a.shape == (len(res.spec.rates), res.spec.n_seeds) and np.all(np.isfinite(a))
        jobs = res.spec.total_jobs()
        means = [round(v["hesrpt"], 6) for v in res.cell_means().values()]
        print(f"phase 3: {label:>15s} wall {res.wall_s:.3f} s, {jobs / res.wall_s:.0f} jobs/s, "
              f"per-rate mean flow {means}", flush=True)
    print(f"phase 3: kernel launches during the lanes: {launches} (2M = {2 * M}); "
          "fused == unfused bit for bit", flush=True)
    return results, launches


def phase_cpu_vs_cuda(lanes, sweeps, engine, policies, device):
    """Phase 4: one smoke-size lane, same tapes, CPU vs card."""
    import numpy as np
    import torch

    worst = 0.0
    for label, spec in lanes.lane_specs(smoke=True):
        scn = sweeps.draw_scenario(spec, device="cpu")
        x0, arr = scn.x0, scn.arrival_times
        cpu = sweeps.simulate_cells(spec, x0, arr, device="cpu")["hesrpt"]["mean_flowtime"]
        gpu = sweeps.simulate_cells(spec, x0, arr, device=device)["hesrpt"]["mean_flowtime"]
        rel = float(np.max(np.abs(gpu - cpu) / np.abs(cpu)))
        assert rel <= 1e-12, f"{label}: CPU vs CUDA mean flow differ by {rel} relative"
        worst = max(worst, rel)
    spec = dict(lanes.lane_specs(smoke=True))["quantized-fused"]
    scn = sweeps.draw_scenario(spec, device="cpu")
    x0, arr = scn.x0, scn.arrival_times
    x0, arr = x0.reshape(-1, spec.n_jobs), arr.reshape(-1, spec.n_jobs)
    rule = engine.quantized_rule(policies.hesrpt, spec.n_chips)
    cpu = engine.run(x0, arr, spec.p, rule, record=True, fused=True)
    gpu = engine.run(x0.to(device), arr.to(device), spec.p, rule, record=True, fused=True)
    assert torch.equal(cpu.trace.alloc, gpu.trace.alloc.cpu()), "chips differ CPU vs CUDA"
    print(f"phase 4: smoke lanes CPU vs CUDA on the same tapes: max rel mean-flow gap "
          f"{worst}; chips equal at every event", flush=True)
    return worst


def phase_theorem8(simulator, flowtime, policies, device) -> float:
    """Phase 5: batch heSRPT on the card against the Thm-8 closed form."""
    import torch

    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.exp(torch.empty((4, 1000), dtype=torch.float64, device=device)
                  .exponential_(generator=gen) / 1.5)
    sim = simulator.simulate(x, 0.5, 256.0, policies.hesrpt, device=device)
    closed = flowtime.hesrpt_total_flowtime(torch.sort(x, -1, descending=True).values, 0.5, 256.0)
    rel = ((sim.total_flowtime - closed).abs() / closed).max().item()
    assert math.isfinite(rel) and rel <= 1e-9, f"Thm 8 gap {rel}"
    print(f"phase 5: Thm 8 closed form vs simulator on the card, 4 x 1000 jobs: "
          f"max rel gap {rel}", flush=True)
    return rel


def phase_timing(alloc, device) -> dict:
    """Phase 6: per-launch time at the lane shape [192, 1000] in f64 (the
    record's ``ms``), in f32, and at [192, MAX_JOBS] in f64, each beside the
    plain version's time, the bound, and the instance's registers and
    resident CTAs an SM."""
    import torch

    cells, n_chips = 192, 256
    gen = torch.Generator(device=device).manual_seed(6)
    out = {}
    for name, M, dtype in (("f64", 1000, torch.float64), ("f32", 1000, torch.float32),
                           (f"f64_{alloc.MAX_JOBS}", alloc.MAX_JOBS, torch.float64)):
        x = _sizes(gen, (cells, M), device, dtype)
        before = alloc.LAUNCHES
        ms = _time_ms(lambda: alloc.hesrpt_alloc_fused(x, 0.5, n_chips), 200)
        plain_ms = _time_ms(lambda: alloc.hesrpt_alloc_fused_ref(x, 0.5, n_chips), 50)
        alloc.LAUNCHES = before  # timing launches are not the main path's
        registers, ctas = alloc.occupancy(M, dtype)
        # Least time for the same function: read x once, write theta and
        # chips once; the operations of a comparison sort (2 M log2 M per
        # cell) and ~40 scalar ops per job are far below the bytes' time.
        n_bytes = cells * M * (2 * x.element_size() + 4)
        n_ops = cells * (2 * M * math.ceil(math.log2(M)) + 40 * M)
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / PEAK_OPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"phase 6: kernel {ms:.4f} ms/launch at [{cells}, {M}] {name[:3]}, plain version "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({n_bytes} bytes); "
              f"{registers} registers a thread, {ctas} resident CTAs an SM", flush=True)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": n_bytes, "ops": n_ops, "registers": registers,
                     "ctas_per_sm": ctas, "shape": [cells, M]}
    print("phase 6: no single PyTorch call computes this function, so there is no "
          "library yardstick", flush=True)
    return out


def _rel(got, want) -> float:
    """||got - want|| / ||want||, in float32."""
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _tol_used(got, want, rtol, atol) -> float:
    """The largest |got - want| / (atol + rtol |want|): at most 1 within."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def _faulty_attention(ref, q, k, v, fault, *, causal, window, q_offset):
    """``ref.attention``'s arithmetic with a fault put into its mask: what a
    kernel with that fault would return.  "tile" drops a middle 64-key tile
    from every row; "edge" drops the 3 latest keys of each row in the later
    half (its causal edge 3 keys early)."""
    import torch

    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    mask = ref.attention_mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                              device=q.device)
    if fault == "tile":
        mid = skv // 64 // 2
        mask[:, 64 * mid:64 * (mid + 1)] = False
    else:
        latest = mask & (mask.flip(-1).cumsum(-1).flip(-1) <= 3)
        mask[sq // 2:] &= ~latest[sq // 2:]
    group = q.shape[1] // k.shape[1]
    kf, vf = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * d ** -0.5, kf)
    probs = torch.softmax(torch.where(mask, logits, ref.NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def phase_flash_vs_plain(flash, ref, device) -> tuple:
    """Phase 7: the flash kernel against its plain version on the card;
    returns the max |error| per dtype, the bf16 readings and the float32
    ones (edge cases, fault controls)."""
    import torch

    cases = [  # (b, hq, hkv, sq, skv, d, causal, window, transposed views)
        (1, 4, 4, 128, 128, 64, True, 0, False), (2, 4, 2, 256, 256, 64, True, 0, False),
        (1, 8, 1, 128, 128, 32, True, 0, False), (2, 4, 2, 130, 190, 64, True, 0, False),
        (1, 2, 2, 64, 64, 128, True, 0, False), (2, 2, 2, 128, 192, 64, False, 0, False),
        (1, 4, 2, 256, 256, 64, True, 16, False), (1, 4, 2, 256, 256, 64, True, 100, False),
        (1, 4, 2, 300, 300, 16, False, 100, False), (2, 4, 2, 190, 190, 16, True, 0, True),
        (2, 6, 3, 200, 260, 256, True, 0, False), (1, 8, 1, 333, 333, 256, True, 100, True),
        (2, 4, 2, 190, 190, 160, True, 0, False), (1, 8, 2, 130, 330, 160, True, 100, True),
        (2, 4, 2, 190, 190, 80, True, 100, True), (1, 4, 2, 200, 260, 200, True, 0, False),
        (1, 4, 2, 150, 150, 200, True, 64, True),
    ]
    serve_cases = [  # the serve shapes: phi4-mini's (phases 8, 20) and stablelm's (phase 19)
        (4, 24, 8, 1000, 1000, 128, True, 0, True), (4, 32, 8, 1000, 1000, 160, True, 0, True),
    ]
    gen = torch.Generator(device=device).manual_seed(7)
    worst = {}
    bf16 = {"rel": 0.0, "tight_used": 0.0, "rounded_f32_rel": 0.0, "tile_rel": math.inf,
            "edge_rel": math.inf, "tile_tight_used": math.inf, "edge_tight_used": math.inf}
    # float32's fault controls: the share of FLASH_TOL["float32"] each uses
    f32_faults = {"tile": math.inf, "edge": math.inf}
    copies = flash.ALIGN_COPIES
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        worst[dtype] = 0.0
        for case in cases + serve_cases:
            b, hq, hkv, sq, skv, d, causal, window, views = case

            def make(h, s):
                if views:  # [B, S, H, D] memory, as the model's projections
                    x = torch.randn((b, s, h, d), generator=gen, device=device)
                    return x.to(dt).transpose(1, 2)
                return torch.randn((b, h, s, d), generator=gen, device=device).to(dt)
            q, k, v = make(hq, sq), make(hkv, skv), make(hkv, skv)
            kw = dict(causal=causal, window=window, q_offset=max(skv - sq, 0))
            got = flash.flash_attention(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            worst[dtype] = max(worst[dtype], err)
            if dtype == "float32" and case in serve_cases:
                for fault in f32_faults:
                    bad = _faulty_attention(ref, q, k, v, fault, **kw)
                    f32_faults[fault] = min(f32_faults[fault],
                                            _tol_used(bad, want, **FLASH_TOL[dtype]))
            if dtype == "bfloat16":
                bf16["rel"] = max(bf16["rel"], _rel(got, want))
                bf16["tight_used"] = max(bf16["tight_used"],
                                         _tol_used(got, want, **FLASH_BF16_TIGHT))
                if case in serve_cases:
                    rounded = flash.flash_attention(q.float(), k.float(), v.float(), **kw).to(dt)
                    bf16["rounded_f32_rel"] = max(bf16["rounded_f32_rel"], _rel(rounded, want))
                    for fault in ("tile", "edge"):
                        bad = _faulty_attention(ref, q, k, v, fault, **kw)
                        bf16[f"{fault}_rel"] = min(bf16[f"{fault}_rel"], _rel(bad, want))
                        bf16[f"{fault}_tight_used"] = min(
                            bf16[f"{fault}_tight_used"],
                            _tol_used(bad, want, **FLASH_BF16_TIGHT))
            torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    n = len(cases + serve_cases)
    assert flash.ALIGN_COPIES == copies, "an aligned input was copied"
    f32_edge = _flash_f32_edges(flash, ref, gen, device)
    worst["float32"] = max(worst["float32"], f32_edge["max_abs_err"])
    print(f"phase 7: float32 design's edges at head dims {list(flash.HEAD_DIMS)}: "
          f"{f32_edge['cases']} cases (q_offset, ragged tiles, a window of 20, one query "
          f"row, MQA, non-causal, transposed views, an unaligned q copied once), max |err| "
          f"{f32_edge['max_abs_err']:.3e}, alignment copies {f32_edge['copies']}; float32 "
          f"faulty outputs at the serve shapes use FLASH_TOL's limit {f32_faults['tile']:.1f}x "
          f"(a middle tile dropped) and {f32_faults['edge']:.1f}x (the causal edge 3 keys "
          f"early)", flush=True)
    print(f"phase 7: flash kernel == plain version on {n} shapes x 2 dtypes: "
          f"max |err| float32 {worst['float32']:.3e}, bfloat16 {worst['bfloat16']:.3e}; bf16 "
          f"max ||err|| / ||want|| {bf16['rel']:.3e} (limit {FLASH_BF16_REL}), max share of "
          f"1e-2 + 1e-2 |want| used {bf16['tight_used']:.3f}; at the serve shapes the float32 "
          f"kernel rounded to bf16 {bf16['rounded_f32_rel']:.3e}, faulty outputs: a middle "
          f"tile dropped {bf16['tile_rel']:.3e} (share used {bf16['tile_tight_used']:.3f}), "
          f"the causal edge 3 keys early {bf16['edge_rel']:.3e} (share used "
          f"{bf16['edge_tight_used']:.3f})", flush=True)
    assert min(f32_faults.values()) > 1, "FLASH_TOL['float32'] would pass a faulty output"
    assert bf16["tight_used"] <= 1, "bf16 flash beyond 1e-2 + 1e-2 |want|"
    assert bf16["rel"] <= FLASH_BF16_REL, "bf16 flash beyond FLASH_BF16_REL"
    assert bf16["rounded_f32_rel"] <= FLASH_BF16_REL, "the limit is below bf16 rounding"
    assert min(bf16["tile_rel"], bf16["edge_rel"]) > FLASH_BF16_REL, (
        "FLASH_BF16_REL would pass a faulty output")
    return worst, bf16, {"fault_tol_used": f32_faults, "edges": f32_edge}


# (b, hq, hkv, sq, skv, causal, window, layout): the float32 design's edges,
# as tests/test_torch_kernels_cuda.py holds them: q_offset = skv - sq > 0,
# lengths that are not multiples of its 64-row and 64-key tiles, a window
# narrower than a tile, a single query row, MQA, non-causal, the model's
# transposed views, and a q that is not 16-byte aligned (copied once).
FLASH_F32_EDGES = (
    (1, 4, 2, 77, 300, True, 0, "dense"), (2, 4, 2, 130, 190, True, 0, "dense"),
    (1, 4, 2, 200, 200, True, 20, "dense"), (1, 4, 1, 1, 333, True, 0, "dense"),
    (1, 2, 1, 1, 1, True, 0, "dense"), (1, 8, 1, 150, 150, True, 0, "dense"),
    (2, 2, 2, 70, 129, False, 0, "dense"), (2, 6, 2, 150, 150, True, 48, "view"),
    (1, 4, 2, 90, 90, True, 40, "unaligned"),
)


def _flash_f32_edges(flash, ref, gen, device) -> dict:
    """Phase 7's float32 edge cases at each of the kernel's head dims, held
    at FLASH_TOL["float32"]; each launches the kernel once, and only the
    unaligned q is copied."""
    import torch

    worst, n = 0.0, 0
    copies = flash.ALIGN_COPIES
    for d in flash.HEAD_DIMS:
        for b, hq, hkv, sq, skv, causal, window, layout in FLASH_F32_EDGES:
            def make(h, s):
                if layout == "view":
                    return torch.randn((b, s, h, d), generator=gen, device=device).transpose(1, 2)
                return torch.randn((b, h, s, d), generator=gen, device=device)
            q, k, v = make(hq, sq), make(hkv, skv), make(hkv, skv)
            if layout == "unaligned":
                q = torch.randn((b, hq, sq, d + 1), generator=gen, device=device)[..., 1:]
            kw = dict(causal=causal, window=window, q_offset=skv - sq)
            launches = flash.LAUNCHES
            got = flash.flash_attention(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            assert flash.LAUNCHES == launches + 1 and got.shape == q.shape
            worst = max(worst, (got - want).abs().max().item())
            torch.testing.assert_close(got, want, **FLASH_TOL["float32"])
            n += 1
    copies = flash.ALIGN_COPIES - copies
    assert copies == len(flash.HEAD_DIMS), f"{copies} alignment copies, not one a head dim"
    return {"cases": n, "max_abs_err": worst, "copies": copies}


def phase_serve(flash, device) -> dict:
    """Phase 8: phi4-mini-3.8b at full width through ``generate``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model

    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg, ModelOptions(activation_dtype="float32"), device=device)
    plain = build_model(cfg, ModelOptions(attn_impl="ref", activation_dtype="float32"),
                        device=device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)),
                             device=device)
    batch = {"tokens": tokens}

    timings = {}
    torch.cuda.synchronize()
    flash.LAUNCHES = flash.ALIGN_COPIES = 0
    ids = generate(model, params, batch, gen_len=SERVE_GEN, timings=timings)
    torch.cuda.synchronize()
    launches = flash.LAUNCHES
    assert launches == cfg.n_layers, f"{launches} flash launches in one prefill, not {cfg.n_layers}"
    assert flash.ALIGN_COPIES == 0, "the model's float32 views were copied"
    assert ids.shape == (SERVE_BATCH, SERVE_GEN) and int(ids.min()) >= 0
    assert int(ids.max()) < cfg.vocab_size
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    got, _ = model.prefill_fn(params, batch)
    want, _ = plain.prefill_fn(params, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and got.shape == (SERVE_BATCH, cfg.vocab_size)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    decode_tps = SERVE_BATCH * SERVE_GEN / timings["decode_s"]
    print(f"phase 8: {cfg.name} full width ({n_params} parameters, init {init_s:.2f} s): "
          f"batch {SERVE_BATCH} x prompt {SERVE_PROMPT} + {SERVE_GEN} tokens; prefill "
          f"{timings['prefill_s']:.4f} s, decode {timings['decode_s']:.4f} s "
          f"({decode_tps:.1f} tok/s), peak memory {peak_gb:.2f} GB; flash launches {launches}; "
          f"last logits kernel vs plain attention max |err| {err:.3e} "
          f"(max |logit| {want.abs().max().item():.3f})", flush=True)
    record = {"arch": cfg.name, "params": n_params, "batch": SERVE_BATCH,
              "prompt_len": SERVE_PROMPT, "gen_len": SERVE_GEN, "init_s": init_s,
              "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
              "decode_tok_s": decode_tps, "peak_mem_gb": peak_gb, "flash_launches": launches,
              "logits_max_abs_err_vs_plain": err, "sample_ids": ids[0, :16].tolist()}
    return record, params, got


def phase_serve_bf16(flash, params, logits_f32, card, device) -> dict:
    """Phase 20: phase 8's model and weights with bf16 activations through
    ``prefill_fn``: the bf16 flash kernel on the main path."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model

    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg, ModelOptions(), device=device)  # the default: bf16 activations
    plain = build_model(cfg, ModelOptions(attn_impl="ref"), device=device)
    assert model.opts.dtype == torch.bfloat16
    rng = np.random.default_rng(0)  # phase 8's prompt
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=device)}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    flash.LAUNCHES, flash.ALIGN_COPIES = 0, 0
    t0 = time.perf_counter()
    got, _ = model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches, copies = flash.LAUNCHES, flash.ALIGN_COPIES
    assert launches == cfg.n_layers, f"{launches} flash launches in one bf16 prefill"
    assert copies == 0, f"{copies} alignment copies on the model's path"
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    want, _ = plain.prefill_fn(params, batch)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all()) and got.shape == (SERVE_BATCH, cfg.vocab_size)
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    kernel_to_f32 = (got - logits_f32).abs().max().item()
    plain_to_f32 = (want - logits_f32).abs().max().item()
    print(f"phase 20: {cfg.name} full width and depth, bf16 activations, batch {SERVE_BATCH} x "
          f"prompt {SERVE_PROMPT} through prefill_fn on {card}: prefill {cold_s:.4f} s cold, "
          f"{warm_s:.4f} s warm, peak memory {peak_gb:.2f} GB (phase 8's weights included); "
          f"bf16 flash launches {launches}, alignment copies {copies}; last logits max |err| "
          f"kernel vs plain bf16 attention {err:.3e}, to phase 8's float32 logits: kernel "
          f"{kernel_to_f32:.3e}, plain {plain_to_f32:.3e} (max |logit| "
          f"{want.abs().max().item():.3f})", flush=True)
    assert kernel_to_f32 <= 2 * plain_to_f32, "the kernel's logits left bf16's spread"
    return {"arch": cfg.name, "activation_dtype": "bfloat16", "batch": SERVE_BATCH,
            "prompt_len": SERVE_PROMPT, "prefill_s_cold": cold_s, "prefill_s_warm": warm_s,
            "peak_mem_gb": peak_gb, "flash_launches": launches, "align_copies": copies,
            "logits_max_abs_err_vs_plain": err, "kernel_to_f32_logits": kernel_to_f32,
            "plain_to_f32_logits": plain_to_f32}


def phase_serve_cpu_vs_cuda(device, arch=SERVE_ARCH, phase=9) -> float:
    """Phases 9, 13 and 17: a smoke-size model, same weights, CPU vs card."""
    import numpy as np
    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model

    cfg = smoke_config(arch)
    opts = ModelOptions(activation_dtype="float32")
    cpu, gpu = build_model(cfg, opts, device="cpu"), build_model(cfg, opts, device=device)
    params = cpu.init(torch.Generator().manual_seed(phase))
    params_gpu = _tree_to(params, device)
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 80)))
    p0, end = 70, 80
    lc, cc = cpu.prefill_fn(params, {"tokens": toks[:, :p0]}, max_len=end)
    lg, cg = gpu.prefill_fn(params_gpu, {"tokens": toks[:, :p0].to(device)}, max_len=end)
    pairs = [(lc, lg)]
    for t in range(p0, end):
        lc, cc = cpu.decode_fn(params, toks[:, t:t + 1], cc, t)
        lg, cg = gpu.decode_fn(params_gpu, toks[:, t:t + 1].to(device), cg, t)
        pairs.append((lc, lg))
    worst = 0.0
    for a, b in pairs:
        torch.testing.assert_close(b.cpu(), a, **LOGIT_TOL)
        worst = max(worst, (b.cpu() - a).abs().max().item())
    print(f"phase {phase}: smoke {cfg.name} CPU vs card on the same weights: prefill + "
          f"{end - p0} teacher-forced decode steps, max |logit gap| {worst:.3e}", flush=True)
    return worst


def _leaves(tree):
    """The tensors of a parameter tree (dicts and lists of tensors)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


# (b, hq, hkv, s, d, window) of the flash timing, causal: the phi4-mini
# prefill (phases 8 and 20) and the recurrentgemma prefill (phase 16).
FLASH_TIMING_SHAPES = {
    "phi4-mini": (SERVE_BATCH, 24, 8, SERVE_PROMPT, 128, 0),
    "recurrentgemma": (HYBRID_BATCH, 16, 1, HYBRID_PROMPT, 256, 2048),
}


def phase_flash_timing(flash, ref, device) -> dict:
    """Phase 10: the kernel, its plain version and SDPA at the prefill shapes."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(10)
    out = {}
    before = flash.LAUNCHES, flash.ALIGN_COPIES
    for name, (b, hq, hkv, s, d, window) in FLASH_TIMING_SHAPES.items():
        out[name] = {}
        mask = ref.attention_mask(s, s, causal=True, window=window, device=device)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = torch.randn((b, hq, s, d), generator=gen, device=device).to(dt)
            k = torch.randn((b, hkv, s, d), generator=gen, device=device).to(dt)
            v = torch.randn((b, hkv, s, d), generator=gen, device=device).to(dt)
            kw = dict(causal=True, window=window)
            ms = _time_ms(lambda: flash.flash_attention(q, k, v, **kw), 20)
            plain_ms = _time_ms(lambda: ref.attention(q, k, v, **kw), 3)
            sdpa_kw = dict(attn_mask=mask) if window else dict(is_causal=True)
            sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **sdpa_kw), 20)
            # Least time: two products of 2 * D flops for each allowed (query,
            # key) pair (S (S + 1) / 2 a head when causal, fewer in a window)
            # at the peak rate of the input type; or q, k, v read once and o
            # written once.
            w = window or s
            pairs = w * (w + 1) // 2 + (s - w) * w
            n_ops = 4 * d * pairs * b * hq
            n_bytes = (2 * b * hq + 2 * b * hkv) * s * d * q.element_size()
            peak = PEAK_OPS_PER_S if dtype == "float32" else PEAK_BF16_OPS_PER_S
            t_ops, t_bytes = n_ops / peak * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
            occupancy = flash.occupancy(d) if dtype == "float32" else None
            out[name][dtype] = {"shape": [b, hq, hkv, s, d], "window": window, "ms": ms,
                                "plain_ms": plain_ms, "library_ms": sdpa_ms,
                                "bound_ms": max(t_ops, t_bytes),
                                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                                "ops": n_ops, "bytes": n_bytes, "tflops": n_ops / ms / 1e9,
                                "registers": occupancy and occupancy[0],
                                "ctas_per_sm": occupancy and occupancy[1]}
            print(f"phase 10: flash {dtype} {name} [{b}, {hq}, {s}, {d}] / [{b}, {hkv}, {s}, "
                  f"{d}] causal{f' window {window}' if window else ''}: kernel {ms:.4f} ms "
                  f"({n_ops / ms / 1e9:.2f} TFLOP/s), plain version {plain_ms:.4f} ms, SDPA "
                  f"{sdpa_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
                  f"({out[name][dtype]['bound_by']}: {n_ops:.4e} flop, {n_bytes} bytes)"
                  + (f"; {occupancy[0]} registers a thread, {occupancy[1]} CTAs an SM"
                     if occupancy else ""), flush=True)
            del q, k, v
    flash.LAUNCHES, flash.ALIGN_COPIES = before  # timing launches are not the main path's
    return out


def _ssd_inputs(gen, device, dtype, b, s, h, p, n):
    """x, dt, a, b, c, d as ``tests/test_kernels.py`` draws them: x, b, c
    standard normal in ``dtype``; dt in U(0.01, 0.2), a in -U(0.5, 2.0), d
    standard normal, all float32."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = randn(b, s, h, p).to(dtype)
    dt = torch.rand((b, s, h), generator=gen, device=device) * 0.19 + 0.01
    a = -(torch.rand((h,), generator=gen, device=device) * 1.5 + 0.5)
    return x, dt, a, randn(b, s, n).to(dtype), randn(b, s, n).to(dtype), randn(h)


def _ssd_strided_inputs(gen, device, dtype, b, s, h, p, n):
    """As :func:`_ssd_inputs`, with x, b and c slices of one projection at an
    odd offset, as the model hands them (unit-stride last dims, row stride
    h p + 2 n + 1, no 16-byte alignment)."""
    import torch

    x, dt, a, bm, cm, d = _ssd_inputs(gen, device, dtype, b, s, h, p, n)
    xbc = torch.empty((b, s, h * p + 2 * n + 1), device=device, dtype=dtype)[..., 1:]
    xbc[..., :h * p] = x.reshape(b, s, h * p)
    xbc[..., h * p:h * p + n], xbc[..., h * p + n:] = bm, cm
    return (xbc[..., :h * p].reshape(b, s, h, p), dt, a, xbc[..., h * p:h * p + n],
            xbc[..., h * p + n:], d)


def _ssd_shape(cfg) -> tuple:
    """(b, s, h, p, n) of one prefill layer of the mamba2 serve phase."""
    return SSM_BATCH, SSM_PROMPT, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state


def phase_ssd_vs_plain(ssd_kernel, chunked, ref, device) -> dict:
    """Phase 11: the SSD kernel against its plain version at the kernel's
    chunk length (and the recurrence up to 1000 steps) on the card; returns
    the max |error| of y and of the state per dtype."""
    import torch

    from repro_torch.configs import get_config

    serve_shape = _ssd_shape(get_config(SSM_ARCH))
    cases = [  # (b, s, h, p, n, strided)
        (1, 128, 2, 32, 16, False), (2, 200, 3, 32, 16, False), (1, 64, 1, 64, 128, False),
        (2, 96, 4, 16, 8, False), (2, 2, 3, 16, 16, False), (1, 1, 2, 64, 128, False),
        (2, 4096 + 17, 24, 64, 128, False), (2, 513, 24, 64, 128, True),
        (2, 300, 3, 80, 64, False), (1, 200, 5, 128, 128, True),
        (*serve_shape, False),
    ]
    gen = torch.Generator(device=device).manual_seed(11)
    worst = {}
    for dtype in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype)
        worst[dtype] = {"y": 0.0, "state": 0.0, "y_max_abs": 0.0}
        for *case, strided in cases:
            args = (_ssd_strided_inputs if strided else _ssd_inputs)(gen, device, dt_, *case)
            y, st = ssd_kernel.ssd_scan(*args, return_state=True)
            plains = [lambda *a, **k: chunked.ssd(*a, block=ssd_kernel.CHUNK, **k)]
            plains += [ref.ssd] if case[1] <= 1000 else []
            for plain in plains:
                y0, st0 = plain(*args, return_state=True)
                torch.cuda.synchronize()
                assert bool(torch.isfinite(y).all()) and y.shape == y0.shape
                torch.testing.assert_close(y.float(), y0.float(), **SSD_TOL[dtype])
                torch.testing.assert_close(st, st0, **STATE_TOL)
                w = worst[dtype]
                w["y"] = max(w["y"], (y.float() - y0.float()).abs().max().item())
                w["state"] = max(w["state"], (st - st0).abs().max().item())
                w["y_max_abs"] = max(w["y_max_abs"], y0.float().abs().max().item())
                del y0, st0
            del args, y, st
    torch.cuda.empty_cache()
    print(f"phase 11: SSD kernel == plain version (chunked at Q = {ssd_kernel.CHUNK}; recurrence "
          f"up to 1000 steps) on {len(cases)} shapes x 2 dtypes: max |err| y float32 "
          f"{worst['float32']['y']:.3e}, bfloat16 {worst['bfloat16']['y']:.3e} (max |y| "
          f"{worst['float32']['y_max_abs']:.2f}, {worst['bfloat16']['y_max_abs']:.2f}); "
          f"state float32 "
          f"{worst['float32']['state']:.3e}, bfloat16 {worst['bfloat16']['state']:.3e}",
          flush=True)
    return worst


def phase_serve_ssm(ssd_kernel, flash, card, device) -> dict:
    """Phase 12: mamba2-130m at full width through ``generate``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import uncounted_params
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model

    cfg = get_config(SSM_ARCH)
    model = build_model(cfg, ModelOptions(activation_dtype="float32"), device=device)
    plain = build_model(cfg, ModelOptions(mixer_impl="chunked", activation_dtype="float32"),
                        device=device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    # param_count() is the JAX package's formula, which leaves out each
    # layer's conv_b and dt_bias (ROADMAP.md Queue C); the model holds them.
    exact = cfg.param_count() + uncounted_params(cfg)
    assert n_params == exact == 128_983_488, (n_params, exact)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT)),
                             device=device)
    batch = {"tokens": tokens}

    timings = {}
    torch.cuda.synchronize()
    ssd_kernel.LAUNCHES = 0
    flash.LAUNCHES = 0
    ids = generate(model, params, batch, gen_len=SSM_GEN, timings=timings)
    torch.cuda.synchronize()
    launches, flash_launches = ssd_kernel.LAUNCHES, flash.LAUNCHES
    assert launches == cfg.n_layers, f"{launches} SSD launches in one prefill, not {cfg.n_layers}"
    assert flash_launches == 0, f"{flash_launches} flash launches in an attention-free model"
    assert ids.shape == (SSM_BATCH, SSM_GEN) and int(ids.min()) >= 0
    assert int(ids.max()) < cfg.vocab_size
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    got, _ = model.prefill_fn(params, batch)
    want, _ = plain.prefill_fn(params, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and got.shape == (SSM_BATCH, cfg.vocab_size)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    decode_tps = SSM_BATCH * SSM_GEN / timings["decode_s"]
    print(f"phase 12: {cfg.name} full width ({n_params} parameters, init {init_s:.2f} s): "
          f"batch {SSM_BATCH} x prompt {SSM_PROMPT} + {SSM_GEN} tokens on {card}; prefill "
          f"{timings['prefill_s']:.4f} s, decode {timings['decode_s']:.4f} s "
          f"({decode_tps:.1f} tok/s), peak memory {peak_gb:.2f} GB; SSD launches {launches}, "
          f"flash launches {flash_launches}; last logits kernel vs chunked max |err| {err:.3e} "
          f"(max |logit| {want.abs().max().item():.3f})", flush=True)
    del params, got, want
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "params": n_params, "param_count": cfg.param_count(),
            "batch": SSM_BATCH, "prompt_len": SSM_PROMPT, "gen_len": SSM_GEN,
            "init_s": init_s, "prefill_s": timings["prefill_s"],
            "decode_s": timings["decode_s"], "decode_tok_s": decode_tps,
            "peak_mem_gb": peak_gb, "ssd_launches": launches, "flash_launches": flash_launches,
            "logits_max_abs_err_vs_chunked": err, "sample_ids": ids[0, :16].tolist()}


def phase_ssd_timing(ssd_kernel, chunked, card, device) -> dict:
    """Phase 14: the kernel and its plain version at one layer's prefill shape."""
    import torch

    from repro_torch.configs import get_config

    b, s, h, p, n = _ssd_shape(get_config(SSM_ARCH))
    args = _ssd_inputs(torch.Generator(device=device).manual_seed(14), device, torch.float32,
                       b, s, h, p, n)
    q = ssd_kernel.CHUNK
    before = ssd_kernel.LAUNCHES
    ms = _time_ms(lambda: ssd_kernel.ssd_scan(*args, return_state=True), 10)
    plain_ms = _time_ms(lambda: chunked.ssd(*args, block=q, return_state=True), 3)
    ssd_kernel.LAUNCHES = before  # timing launches are not the main path's
    # Least time: the work of the chunked form at the kernel's chunk length Q
    # on these S steps: per batch row C B^T over the (t, u <= t) pairs of
    # each chunk, once (every head sees the same b and c); per head those
    # pairs times x, and C h_prev and the state update, 2 N P flops per step
    # each.  Against x, b, c, dt read once and y, the state written once.
    lens = [min(q, s - t0) for t0 in range(0, s, q)]
    pairs = sum(L * (L + 1) // 2 for L in lens)
    n_ops = b * (pairs * 2 * n + h * (pairs * 2 * p + 2 * s * 2 * n * p))
    size = args[0].element_size()
    n_bytes = (2 * b * s * h * p + 2 * b * s * n) * size + b * s * h * 4 + b * h * p * n * 4
    t_ops, t_bytes = n_ops / PEAK_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ops": n_ops,
           "bytes": n_bytes, "gflops": n_ops / ms / 1e6, "chunk": q}
    print(f"phase 14: SSD float32 x [{b}, {s}, {h}, {p}], b/c [{b}, {s}, {n}] on {card}: "
          f"kernel {ms:.4f} ms ({n_ops / ms / 1e9:.2f} TFLOP/s), plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({out['bound_by']}: {n_ops:.4e} flop, "
          f"{n_bytes} bytes); no single PyTorch call computes SSD, so there is no library "
          "yardstick", flush=True)
    return out


def _rglru_inputs(gen, device, dtype, b, s, w, a_shift=0.0):
    """x, gate_x, gate_a standard normal in ``dtype`` and a_param standard
    normal float32 plus ``a_shift``, as ``tests/test_kernels.py`` draws them
    (a_shift = -9 puts the decay within ~1e-3 of 1)."""
    import torch

    x, gx, ga = (torch.randn((b, s, w), generator=gen, device=device).to(dtype)
                 for _ in range(3))
    return x, gx, ga, torch.randn((w,), generator=gen, device=device) + a_shift


def phase_rglru_vs_plain(rglru_kernel, chunked, ref, ops, device) -> dict:
    """Phase 15: the RG-LRU kernel against its plain version and the
    log-depth scan on the same a and g, and ``ops.rglru`` against
    ``chunked.rglru`` (float32: bf16 rounds a and g before the kernel) on
    the card; returns the max |error| of y and of the state per dtype."""
    import torch

    cases = [  # (b, s, w, a_shift)
        (2, 100, 48, 0.0), (1, 256, 64, 0.0), (2, 64, 128, 0.0), (3, 1, 40, 0.0),
        (2, 77, 200, 0.0), (1, 8192, 256, -9.0), (HYBRID_BATCH, HYBRID_PROMPT, 4096, 0.0),
    ]
    gen = torch.Generator(device=device).manual_seed(15)
    worst = {}
    for dtype in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype)
        w_ = worst[dtype] = {"y": 0.0, "state": 0.0, "y_vs_chunked": 0.0, "y_max_abs": 0.0}
        for b, s, w, shift in cases:
            x, gx, ga, ap = _rglru_inputs(gen, device, dt_, b, s, w, shift)
            a, g = (t.to(dt_) for t in ref.rglru_gates(x, gx, ga, ap))
            y, st = rglru_kernel.rglru_scan(a, g, return_state=True)
            y0 = ref.linear_recurrence(a, g)
            yc = chunked.linear_scan(a.float(), g.float()).to(dt_)
            yk, stk = ops.rglru(x, gx, ga, ap, impl="cuda", return_state=True)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y).all()) and y.shape == (b, s, w) and y.dtype == dt_
            assert torch.equal(yk, y) and torch.equal(stk, st), "ops.rglru != the kernel"
            torch.testing.assert_close(y.float(), y0.float(), **RGLRU_TOL[dtype])
            torch.testing.assert_close(st, y0[:, -1].float(), **STATE_TOL)
            torch.testing.assert_close(y.float(), yc.float(), **RGLRU_TOL[dtype])
            if dtype == "float32":  # the whole op, gates included (bf16 rounds a and g first)
                yr, str_ = chunked.rglru(x, gx, ga, ap, return_state=True)
                torch.testing.assert_close(yk, yr, **RGLRU_TOL[dtype])
                torch.testing.assert_close(stk, str_, **STATE_TOL)
                del yr
            w_["y"] = max(w_["y"], (y.float() - y0.float()).abs().max().item())
            w_["state"] = max(w_["state"], (st - y0[:, -1].float()).abs().max().item())
            w_["y_vs_chunked"] = max(w_["y_vs_chunked"],
                                     (y.float() - yc.float()).abs().max().item())
            w_["y_max_abs"] = max(w_["y_max_abs"], y0.float().abs().max().item())
            del x, gx, ga, a, g, y, y0, yk, yc
    torch.cuda.empty_cache()
    print(f"phase 15: RG-LRU kernel == plain version (the recurrence) and ~ log-depth scan "
          f"on the same a, g, {len(cases)} shapes x 2 dtypes: max |err| "
          f"vs recurrence y float32 {worst['float32']['y']:.3e}, bfloat16 "
          f"{worst['bfloat16']['y']:.3e}, state {worst['float32']['state']:.3e}; vs log-depth "
          f"scan y float32 {worst['float32']['y_vs_chunked']:.3e}, bfloat16 "
          f"{worst['bfloat16']['y_vs_chunked']:.3e} (max |y| {worst['float32']['y_max_abs']:.2f})",
          flush=True)
    return worst


def phase_serve_hybrid(rglru_kernel, flash, ssd_kernel, card, device) -> dict:
    """Phase 16: recurrentgemma-9b at full width through ``generate``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import uncounted_params
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model

    cfg = get_config(HYBRID_ARCH)
    model = build_model(cfg, ModelOptions(activation_dtype="float32"), device=device)
    plain = build_model(cfg, ModelOptions(mixer_impl="chunked", activation_dtype="float32"),
                        device=device)
    kinds = cfg.layer_kinds()
    n_rglru, n_attn = kinds.count("rglru"), kinds.count("attn")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    # param_count() is the JAX package's formula, which leaves out each
    # RG-LRU layer's conv_b (ROADMAP.md Queue C); the model holds them.
    exact = cfg.param_count() + uncounted_params(cfg)
    assert n_params == exact == 8_524_206_080, (n_params, exact)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT)),
                             device=device)
    batch = {"tokens": tokens}

    timings = {}
    torch.cuda.synchronize()
    rglru_kernel.LAUNCHES = flash.LAUNCHES = ssd_kernel.LAUNCHES = flash.ALIGN_COPIES = 0
    ids = generate(model, params, batch, gen_len=HYBRID_GEN, timings=timings)
    torch.cuda.synchronize()
    assert flash.ALIGN_COPIES == 0, "the model's float32 views were copied"
    launches = {"rglru": rglru_kernel.LAUNCHES, "flash": flash.LAUNCHES,
                "ssd": ssd_kernel.LAUNCHES}
    assert launches == {"rglru": n_rglru, "flash": n_attn, "ssd": 0} == {
        "rglru": 26, "flash": 12, "ssd": 0}, f"launches in one prefill: {launches}"
    assert ids.shape == (HYBRID_BATCH, HYBRID_GEN) and int(ids.min()) >= 0
    assert int(ids.max()) < cfg.vocab_size
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    got, _ = model.prefill_fn(params, batch)
    want, _ = plain.prefill_fn(params, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and got.shape == (HYBRID_BATCH, cfg.vocab_size)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    decode_tps = HYBRID_BATCH * HYBRID_GEN / timings["decode_s"]
    # Flash's least time at this prefill's shape, as phase 10 counts it: 4 D
    # flops per allowed (query, key) pair (causal, window) per query head.
    s_, w_ = HYBRID_PROMPT, cfg.window
    pairs = sum(min(q + 1, w_) for q in range(s_))
    flash_ops = 4 * cfg.head_dim * pairs * HYBRID_BATCH * cfg.n_heads
    flash_bound_ms = flash_ops / PEAK_OPS_PER_S * 1e3
    print(f"phase 16: {cfg.name} full width ({cfg.n_layers} layers, {n_params} parameters, "
          f"init {init_s:.2f} s): batch {HYBRID_BATCH} x prompt {HYBRID_PROMPT} + {HYBRID_GEN} "
          f"tokens on {card}; prefill {timings['prefill_s']:.4f} s, decode "
          f"{timings['decode_s']:.4f} s ({decode_tps:.1f} tok/s), peak memory {peak_gb:.2f} GB; "
          f"RG-LRU launches {launches['rglru']}, flash {launches['flash']}, SSD "
          f"{launches['ssd']}; last logits kernel vs chunked max |err| {err:.3e} (max |logit| "
          f"{want.abs().max().item():.3f}); flash bound at [{HYBRID_BATCH}, {cfg.n_heads}, "
          f"{s_}, {cfg.head_dim}], window {w_}: {pairs} pairs per head, {flash_ops:.4e} flop, "
          f"{flash_bound_ms:.4f} ms float32", flush=True)
    del params, got, want
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
            "param_count": cfg.param_count(), "batch": HYBRID_BATCH,
            "prompt_len": HYBRID_PROMPT, "gen_len": HYBRID_GEN, "init_s": init_s,
            "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
            "decode_tok_s": decode_tps, "peak_mem_gb": peak_gb,
            "rglru_launches": launches["rglru"], "flash_launches": launches["flash"],
            "ssd_launches": launches["ssd"], "logits_max_abs_err_vs_chunked": err,
            "flash_pairs_per_head": pairs, "flash_ops": flash_ops,
            "flash_bound_ms": flash_bound_ms,
            "sample_ids": ids[0, :16].tolist()}


def phase_rglru_timing(rglru_kernel, ref, card, device) -> dict:
    """Phase 18: the kernel and its plain version at one layer's prefill shape."""
    import torch

    from repro_torch.configs import get_config

    b, s, w = HYBRID_BATCH, HYBRID_PROMPT, get_config(HYBRID_ARCH).lru_width
    x, gx, ga, ap = _rglru_inputs(torch.Generator(device=device).manual_seed(18), device,
                                  torch.float32, b, s, w)
    a, g = ref.rglru_gates(x, gx, ga, ap)
    del x, gx, ga
    before = rglru_kernel.LAUNCHES
    ms = _time_ms(lambda: rglru_kernel.rglru_scan(a, g, return_state=True), 20)
    plain_ms = _time_ms(lambda: ref.linear_recurrence(a, g, return_state=True), 3)
    rglru_kernel.LAUNCHES = before  # timing launches are not the main path's
    # Least time: a and g read once and y written once, against one multiply
    # and one add per element.
    n_bytes = 3 * b * s * w * a.element_size()
    n_ops = 2 * b * s * w
    t_ops, t_bytes = n_ops / PEAK_OPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "ops": n_ops,
           "bytes": n_bytes, "gb_per_s": n_bytes / ms / 1e6}
    print(f"phase 18: RG-LRU float32 [{b}, {s}, {w}] on {card}: kernel {ms:.4f} ms "
          f"({n_bytes / ms / 1e6:.1f} GB/s, {bound_ms / ms:.1%} of the bound), plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({out['bound_by']}: {n_bytes} bytes, "
          f"{n_ops:.4e} flop); no single PyTorch call computes a first-order linear "
          "recurrence, so there is no library yardstick", flush=True)
    return out


def phase_serve_wide(flash, card, device) -> dict:
    """Phase 19: stablelm-12b at its published widths, depth cut, through
    ``generate``: the flash kernel at head dim 160."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model

    full = get_config(WIDE_ARCH)
    cfg = full.scaled(n_layers=WIDE_LAYERS)
    assert cfg.head_dim == 160  # an instance of its own, not a power of two
    model = build_model(cfg, ModelOptions(activation_dtype="float32"), device=device)
    plain = build_model(cfg, ModelOptions(attn_impl="ref", activation_dtype="float32"),
                        device=device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (WIDE_BATCH, WIDE_PROMPT)),
                             device=device)
    batch = {"tokens": tokens}

    timings = {}
    torch.cuda.synchronize()
    flash.LAUNCHES = flash.ALIGN_COPIES = 0
    ids = generate(model, params, batch, gen_len=WIDE_GEN, timings=timings)
    torch.cuda.synchronize()
    launches = flash.LAUNCHES
    assert launches == cfg.n_layers == WIDE_LAYERS, f"{launches} flash launches in one prefill"
    assert flash.ALIGN_COPIES == 0, "the model's float32 views were copied"
    assert ids.shape == (WIDE_BATCH, WIDE_GEN) and int(ids.min()) >= 0
    assert int(ids.max()) < cfg.vocab_size
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    got, _ = model.prefill_fn(params, batch)
    want, _ = plain.prefill_fn(params, batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and got.shape == (WIDE_BATCH, cfg.vocab_size)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **LOGIT_TOL)
    decode_tps = WIDE_BATCH * WIDE_GEN / timings["decode_s"]
    print(f"phase 19: {cfg.name} at published widths (head dim {cfg.head_dim}), depth cut from "
          f"{full.n_layers} to {cfg.n_layers} layers ({n_params} parameters, init "
          f"{init_s:.2f} s): batch {WIDE_BATCH} x prompt {WIDE_PROMPT} + {WIDE_GEN} tokens on "
          f"{card}; prefill {timings['prefill_s']:.4f} s, decode {timings['decode_s']:.4f} s "
          f"({decode_tps:.1f} tok/s), peak memory {peak_gb:.2f} GB; flash launches {launches}; "
          f"last logits kernel vs plain attention max |err| {err:.3e} (max |logit| "
          f"{want.abs().max().item():.3f})", flush=True)
    del params, got, want
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "full_layers": full.n_layers,
            "head_dim": cfg.head_dim, "params": n_params, "batch": WIDE_BATCH,
            "prompt_len": WIDE_PROMPT, "gen_len": WIDE_GEN, "init_s": init_s,
            "prefill_s": timings["prefill_s"], "decode_s": timings["decode_s"],
            "decode_tok_s": decode_tps, "peak_mem_gb": peak_gb, "flash_launches": launches,
            "logits_max_abs_err_vs_plain": err, "sample_ids": ids[0, :16].tolist()}


def phase_figures(alloc, figures, simulator, flowtime, superstep, policies, card,
                  device) -> dict:
    """Phase 21: Fig 3 and Fig 4 at the paper's size on the card."""
    import numpy as np
    import torch

    trace = figures.fig3_trace(device=device)
    fig3_err = float(np.max(np.abs(trace["theta_trace"][0] - np.array([1, 3, 5]) / 9)))
    ct = trace["completion_times"]
    assert fig3_err <= 1e-12, f"Fig 3 epoch-0 shares off by {fig3_err}"
    assert ct[2] <= ct[1] <= ct[0], f"Fig 3 completion order {ct}"

    exp = figures.FIG4
    torch.cuda.synchronize()
    alloc.LAUNCHES = 0
    t0 = time.perf_counter()
    res = figures.fig4_policies(device=device)  # its flows come back to the host
    wall_s = time.perf_counter() - t0
    launches = alloc.LAUNCHES
    want_launches = len(exp.p_values) * exp.n_jobs
    assert launches == want_launches, f"Fig 4 launched alloc {launches} times, not {want_launches}"

    x = torch.as_tensor(res.sizes, device=device)
    thm8_gap = closed_gap = 0.0
    for p in exp.p_values:
        fused = res.flows[p]["hesrpt"]
        plain = simulator.total_flowtime(x, p, exp.n_servers, policies.hesrpt, device=device)
        assert np.array_equal(fused, plain.cpu().numpy() / exp.n_jobs), f"fused != unfused, p={p}"
        thm8 = flowtime.hesrpt_total_flowtime(x, p, exp.n_servers).cpu().numpy() / exp.n_jobs
        closed = superstep.batch_result_closed_form(x, p, "hesrpt", n_servers=exp.n_servers)
        closed = closed.completion_times.sum(-1).cpu().numpy() / exp.n_jobs
        thm8_gap = max(thm8_gap, float(np.max(np.abs(fused - thm8) / thm8)))
        closed_gap = max(closed_gap, float(np.max(np.abs(fused - closed) / closed)))
        meds = res.medians[p]
        for name, med in meds.items():
            assert meds["hesrpt"] <= med * (1 + 1e-9), f"p={p}: {name} {med} beats heSRPT"
    assert thm8_gap <= 1e-9 and closed_gap <= 1e-9, (thm8_gap, closed_gap)

    # The heSRPT column's launch: theta alone over [seeds, M] (n_chips = 0),
    # timed beside its plain version, policies.hesrpt on the card.
    ms = _time_ms(lambda: alloc.hesrpt_theta_fused(x, 0.5), 200)
    plain_ms = _time_ms(lambda: policies.hesrpt(x, 0.5), 50)
    alloc.LAUNCHES = launches  # timing launches are not the figure's
    # Least time: x read once, theta written once; a sort's 2 M log2 M and
    # ~40 scalar ops a job are far below the bytes' time.
    cells, M = x.shape
    n_bytes, n_ops = 2 * x.numel() * x.element_size(), cells * (2 * M * math.ceil(math.log2(M))
                                                                 + 40 * M)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / PEAK_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    quick_card = figures.fig4_policies(quick=True, device=device).medians
    quick_cpu = figures.fig4_policies(quick=True, device="cpu").medians
    quick_gap = max(abs(quick_card[p][n] - v) / abs(v)
                    for p, meds in quick_cpu.items() for n, v in meds.items())
    assert quick_gap <= 1e-12, f"Fig 4 quick card vs CPU {quick_gap}"
    adv = figures.advantage(res.medians)
    print(f"phase 21: Fig 3 epoch-0 shares within {fig3_err:.1e} of (1/9, 3/9, 5/9), SJF "
          f"order; Fig 4 at N = {exp.n_servers:g}, M = {exp.n_jobs}, {exp.n_seeds} seeds on "
          f"{card}: wall {wall_s:.3f} s, alloc launches {launches} (5 x {exp.n_jobs}); heSRPT "
          f"fused == unfused bit for bit, vs Thm 8 {thm8_gap:.2e}, vs closed form "
          f"{closed_gap:.2e}; quick size card vs CPU {quick_gap:.2e}", flush=True)
    print(f"phase 21: alloc theta pass at [{cells}, {M}] f64: kernel {ms:.4f} ms/launch, plain "
          f"version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({n_bytes} bytes)", flush=True)
    for line in figures.fig4_table(res.medians).splitlines():
        print(f"phase 21: {line}", flush=True)
    return {"fig3_theta0_err": fig3_err, "fig3_completion_times": ct.tolist(),
            "wall_s": wall_s, "alloc_launches": launches, "alloc_shape": [cells, M],
            "alloc_ms": ms, "alloc_plain_ms": plain_ms, "alloc_bound_ms": bound_ms,
            "alloc_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "medians": {str(p): m for p, m in res.medians.items()},
            "advantage": {str(p): a for p, a in adv.items()}, "thm8_max_rel": thm8_gap,
            "closed_form_max_rel": closed_gap, "quick_card_vs_cpu_max_rel": quick_gap}


def phase_superstep(lanes, sweeps, superstep, flowtime, simulator, policies, card,
                    device) -> dict:
    """Phase 22: the superstep path against the carried-rank sweep at the
    lanes' size, and the closed-form batch."""
    import numpy as np
    import torch

    names = ("hesrpt", "equi", "srpt")
    ranked = dict(lanes.lane_specs())["continuous"]._replace(policies=names)
    fast = ranked._replace(superstep=True)
    scn = sweeps.draw_scenario(ranked, device=device)
    x0, arr = scn.x0, scn.arrival_times
    walls, stats = {}, {}
    for label, spec in (("ranked", ranked), ("superstep", fast), ("superstep_2", fast),
                        ("ranked_2", ranked)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats[label] = sweeps.simulate_cells(spec, x0, arr, device=device)  # ends on the host
        walls[label] = time.perf_counter() - t0
    M = ranked.n_jobs
    cells = len(ranked.rates) * ranked.n_seeds
    gap = 0.0
    for name in names:
        want = stats["ranked"][name]["mean_flowtime"]
        got = stats["superstep"][name]["mean_flowtime"]
        assert got.shape == (len(ranked.rates), ranked.n_seeds) and np.all(np.isfinite(got))
        gap = max(gap, float(np.max(np.abs(got - want) / want)))
    assert gap <= 1e-9, f"superstep vs ranked sweep {gap}"

    xb = torch.sort(x0.reshape(-1, M), dim=-1, descending=True, stable=True).values
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    closed = superstep.batch_result_closed_form(xb, ranked.p, "hesrpt",
                                                n_servers=ranked.n_servers).completion_times
    torch.cuda.synchronize()
    closed_s = time.perf_counter() - t0
    thm3 = flowtime.hesrpt_completion_times(xb, ranked.p, ranked.n_servers)
    assert torch.equal(closed, thm3), "batch closed form != Thm-3 completion times"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = simulator.simulate(xb, ranked.p, ranked.n_servers, policies.hesrpt, device=device)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    batch_gap = ((sim.completion_times - closed).abs() / closed).max().item()
    del sim
    torch.cuda.empty_cache()
    assert batch_gap <= 1e-9, f"batch closed form vs simulate {batch_gap}"
    print(f"phase 22: superstep sweep ({M + 1} steps) vs carried-rank sweep ({2 * M} steps), "
          f"{cells} cells x {len(names)} policies on {card}: max rel mean-flow gap {gap:.2e}; "
          f"wall ranked {walls['ranked']:.3f} / {walls['ranked_2']:.3f} s, superstep "
          f"{walls['superstep']:.3f} / {walls['superstep_2']:.3f} s; pre-arrived [{cells}, {M}] "
          f"batch: closed form == Thm-3 bit for bit, vs simulate (M = {M} steps) {batch_gap:.2e} "
          f"per job; closed form {closed_s:.4f} s, simulate {sim_s:.3f} s", flush=True)
    return {"cells": cells, "n_jobs": M, "policies": list(names),
            "steps": {"superstep": M + 1, "ranked": 2 * M}, "wall_s": walls,
            "max_rel_gap": gap, "batch_vs_simulate_max_rel": batch_gap,
            "batch_closed_form_s": closed_s, "batch_simulate_s": sim_s}


def _mean_flows(res, name="hesrpt"):
    return res.stats[name]["mean_flowtime"]


def phase_drift(alloc, lanes, sweeps, engine, policies, card, device) -> dict:
    """Phase 23: the drift lanes at full size, their superstep, the bursty
    drift lanes and the smoke drift lanes CPU vs card."""
    import numpy as np
    import torch

    specs = dict(lanes.drift_lane_specs())
    M = specs["drift-quantized"].n_jobs
    walls, launches, results = {}, {}, {}
    for label, spec in specs.items():
        torch.cuda.synchronize()
        alloc.LAUNCHES = 0
        results[label] = sweeps.run_sweep(spec, device=device)
        torch.cuda.synchronize()
        launches[label] = alloc.LAUNCHES
        walls[label] = results[label].wall_s
    D = 1
    assert launches["drift-quantized-fused"] == 2 * M + D, launches
    assert launches["drift-quantized"] == launches["drift-continuous"] == 0, launches
    lane_pairs = list(results.items())
    assert lanes.fused_equals_unfused(lane_pairs, "drift-"), "drift fused lane != unfused lane"
    for label, res in results.items():
        a = _mean_flows(res)
        assert a.shape == (len(res.spec.rates), res.spec.n_seeds) and np.all(np.isfinite(a))

    names = ("hesrpt", "equi", "srpt")
    generic = specs["drift-continuous"]._replace(policies=names)
    fast = generic._replace(superstep=True)
    ss_res = {}
    for label, spec in (("generic", generic), ("superstep", fast)):
        ss_res[label] = sweeps.run_sweep(spec, device=device)
        walls[f"drift-{label}-3-policies"] = ss_res[label].wall_s
    ss_gap = 0.0
    for name in names:
        want, got = _mean_flows(ss_res["generic"], name), _mean_flows(ss_res["superstep"], name)
        assert np.all(np.isfinite(got))
        ss_gap = max(ss_gap, float(np.max(np.abs(got - want) / want)))
    assert ss_gap <= 1e-9, f"drift superstep vs generic loop {ss_gap}"
    assert np.array_equal(_mean_flows(ss_res["generic"]), _mean_flows(results["drift-continuous"]))

    bursty = dict(lanes.drift_lane_specs(scenario="drift_bursty"))
    bursty_res = {}
    for label in ("drift-quantized", "drift-quantized-fused"):
        torch.cuda.synchronize()
        alloc.LAUNCHES = 0
        bursty_res[label] = sweeps.run_sweep(bursty[label], device=device)
        torch.cuda.synchronize()
        launches[f"bursty-{label}"] = alloc.LAUNCHES
        walls[f"bursty-{label}"] = bursty_res[label].wall_s
    assert launches["bursty-drift-quantized-fused"] == 2 * M + D, launches
    assert lanes.fused_equals_unfused(list(bursty_res.items()), "drift-"), \
        "drift_bursty fused lane != unfused lane"

    cpu_gap = 0.0
    for label, spec in lanes.drift_lane_specs(smoke=True):
        scn = sweeps.draw_scenario(spec, device="cpu")
        cpu = sweeps.simulate_cells(spec, scn.x0, scn.arrival_times, p_drift=scn.p_drift,
                                    device="cpu")["hesrpt"]["mean_flowtime"]
        gpu = sweeps.simulate_cells(spec, scn.x0, scn.arrival_times, p_drift=scn.p_drift,
                                    device=device)["hesrpt"]["mean_flowtime"]
        rel = float(np.max(np.abs(gpu - cpu) / np.abs(cpu)))
        assert rel <= 1e-12, f"{label}: CPU vs CUDA mean flow differ by {rel} relative"
        cpu_gap = max(cpu_gap, rel)
    spec = dict(lanes.drift_lane_specs(smoke=True))["drift-quantized-fused"]
    scn = sweeps.draw_scenario(spec, device="cpu")
    x0, arr = scn.x0.reshape(-1, spec.n_jobs), scn.arrival_times.reshape(-1, spec.n_jobs)
    drift = engine.PDrift(scn.p_drift.times.reshape(-1, 1), scn.p_drift.values)
    gdrift = engine.PDrift(drift.times.to(device), drift.values.to(device))
    rule = engine.quantized_rule(policies.hesrpt, spec.n_chips)
    cpu = engine.run(x0, arr, spec.p, rule, record=True, fused=True, p_drift=drift)
    gpu = engine.run(x0.to(device), arr.to(device), spec.p, rule, record=True, fused=True,
                     p_drift=gdrift)
    assert torch.equal(cpu.trace.alloc, gpu.trace.alloc.cpu()), "drift chips differ CPU vs CUDA"
    cells = len(specs["drift-quantized"].rates) * specs["drift-quantized"].n_seeds
    print(f"phase 23: drift lanes (drift_poisson, p 0.8 -> 0.3 at half the nominal span) "
          f"{cells} cells x {M} jobs on {card}: fused lane {launches['drift-quantized-fused']} "
          f"launches (2M + D = {2 * M + D}), fused == unfused bit for bit; superstep vs generic "
          f"loop (heSRPT, EQUI, SRPT) {ss_gap:.2e}; drift_bursty fused "
          f"{launches['bursty-drift-quantized-fused']} launches, == unfused; smoke CPU vs "
          f"card {cpu_gap:.2e}, chips equal at every event", flush=True)
    print("phase 23: walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()),
          flush=True)
    means = [round(v["hesrpt"], 6) for v in results["drift-quantized-fused"].cell_means().values()]
    print(f"phase 23: fused drift lane per-rate mean flow {means}", flush=True)
    return {"launches": launches, "walls_s": walls, "superstep_vs_generic_max_rel": ss_gap,
            "cpu_vs_cuda_max_rel": cpu_gap, "cells": cells, "n_jobs": M,
            "lanes": lanes.lane_records(lane_pairs),
            "fused_result": results["drift-quantized-fused"]}


def phase_snap_chunk_timing(alloc, lanes, sweeps, engine, policies, fused_drift, card,
                            device) -> dict:
    """Phase 24: slice snapping fused vs unfused on the lanes' tapes, seed
    chunking of the fused drift lane, and the per-cell-p kernel's time."""
    import numpy as np
    import torch

    spec = dict(lanes.lane_specs())["quantized-fused"]
    scn = sweeps.draw_scenario(spec, device=device)
    x0, arr = scn.x0, scn.arrival_times
    x0, arr = x0.reshape(-1, spec.n_jobs), arr.reshape(-1, spec.n_jobs)
    rule = engine.quantized_rule(policies.hesrpt, spec.n_chips, snap_slices=True)
    runs, walls = {}, {}
    for label, fused in (("unfused", False), ("fused", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label] = engine.run(x0, arr, spec.p, rule, record=True, fused=fused)
        torch.cuda.synchronize()
        walls[f"snap-{label}"] = time.perf_counter() - t0
    chips = runs["fused"].trace.alloc
    assert torch.equal(chips, runs["unfused"].trace.alloc), "snapped chips fused != unfused"
    assert torch.equal(runs["fused"].completion_times, runs["unfused"].completion_times)
    slices = torch.tensor((0, *engine.DEFAULT_SLICES), dtype=chips.dtype, device=device)
    assert bool(torch.isin(chips, slices).all()), "a snapped count is not a slice size"
    most = int(chips.sum(-1).max())
    assert most <= spec.n_chips, f"{most} chips in a cell"
    assert bool(torch.isfinite(runs["fused"].completion_times).all())
    del runs, chips
    torch.cuda.empty_cache()
    # What the snap costs a lane: the fused run with and without it, no record.
    plain_rule = engine.quantized_rule(policies.hesrpt, spec.n_chips)
    for label, r in (("fused-no-snap", plain_rule), ("fused-snap", rule),
                     ("fused-snap-2", rule), ("fused-no-snap-2", plain_rule)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(x0, arr, spec.p, r, fused=True)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0

    fspec = fused_drift.spec
    chunk_walls = {}
    for chunk in (1, 3):
        res = sweeps.run_sweep(fspec, chunk_seeds=chunk, device=device)
        chunk_walls[chunk] = res.wall_s
        assert res.chunk_seeds == (chunk if chunk < fspec.n_seeds else None)
        for m in fspec.metrics:
            assert np.array_equal(res.stats["hesrpt"][m], fused_drift.stats["hesrpt"][m]), \
                f"chunk {chunk}: {m} differs from the unchunked run"

    cells, M, n_chips = 192, 1000, 256
    gen = torch.Generator(device=device).manual_seed(24)
    x = _sizes(gen, (cells, M), device, torch.float64)
    p_col = torch.tensor((0.8, 0.3), dtype=torch.float64, device=device).repeat(cells // 2)[:, None]
    before = alloc.LAUNCHES
    timing = {
        "per_cell_p": _time_ms(lambda: alloc.hesrpt_alloc_fused(x, p_col, n_chips), 200),
        "scalar_p_0.8": _time_ms(lambda: alloc.hesrpt_alloc_fused(x, 0.8, n_chips), 200),
        "scalar_p_0.5": _time_ms(lambda: alloc.hesrpt_alloc_fused(x, 0.5, n_chips), 200),
        "exponent_rows": _time_ms(lambda: alloc.exponent_rows(p_col, cells, x.device), 200),
        "plain_per_cell_p": _time_ms(
            lambda: alloc.hesrpt_alloc_fused_ref(x, p_col, n_chips), 50),
    }
    alloc.LAUNCHES = before  # timing launches are not the main path's
    # Least time: x read once, theta and chips written once, and now one
    # float64 p (and c) a cell; the operations stay far below.
    n_bytes = cells * M * (2 * x.element_size() + 4) + cells * 8
    n_ops = cells * (2 * M * math.ceil(math.log2(M)) + 40 * M)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / PEAK_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"phase 24: slice snapping on the lanes' tapes ([{x0.shape[0]}, {spec.n_jobs}], "
          f"{spec.n_chips} chips): fused == unfused at every event, every count a slice size, "
          f"at most {most} chips a cell; wall unfused {walls['snap-unfused']:.3f} s, fused "
          f"{walls['snap-fused']:.3f} s (record=True); fused without the trace: snapped "
          f"{walls['fused-snap']:.3f} / {walls['fused-snap-2']:.3f} s, not snapped "
          f"{walls['fused-no-snap']:.3f} / {walls['fused-no-snap-2']:.3f} s", flush=True)
    print(f"phase 24: fused drift lane in chunks of 1 and 3 seeds == unchunked bit for bit; "
          f"walls {chunk_walls[1]:.3f} / {chunk_walls[3]:.3f} s (unchunked "
          f"{fused_drift.wall_s:.3f} s)", flush=True)
    print(f"phase 24: alloc at [{cells}, {M}] f64 on {card}: one p a cell "
          f"{timing['per_cell_p']:.4f} ms/call (of it building c {timing['exponent_rows']:.4f}), "
          f"scalar p 0.8 {timing['scalar_p_0.8']:.4f}, scalar p 0.5 {timing['scalar_p_0.5']:.4f}; "
          f"plain version (one p a cell) {timing['plain_per_cell_p']:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({n_bytes} bytes)", flush=True)
    return {"snap_walls_s": walls, "snap_most_chips": most, "chunk_walls_s": chunk_walls,
            "timing_ms": timing, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "shape": [cells, M]}


def _recording_rule(base, sink):
    """``base`` (a quantized rule over heSRPT) whose fused allocate also
    hands every event step's chips to ``sink``."""
    def rule(x, p):
        return base(x, p)

    def fused(x, p):
        chips, rate = base.fused_variant(x, p)
        sink(chips)
        return chips, rate

    rule.fused_variant = fused
    return rule


def _pool_rows(gen, cells, M, device, dtype, free_frac):
    """Slot-pool rows: Pareto-like sizes with ``free_frac`` of the slots free
    (exactly 0), as the streaming loop hands them to the allocate."""
    import torch

    x = _sizes(gen, (cells, M), device, torch.float64)
    free = torch.rand((cells, M), generator=gen, device=device, dtype=torch.float64) < free_frac
    return torch.where(free, 0.0, x).to(dtype).contiguous()


def phase_stream(alloc, lanes, sweeps, engine, scenarios, policies, card, device) -> dict:
    """Phase 25: the bounded-slot streaming loop on the card."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    # (a) Reduction: a pool as wide as the tape never recycles.
    spec = dict(lanes.lane_specs())["quantized-fused"]
    M = spec.n_jobs
    scn = sweeps.draw_scenario(spec, device=device)
    x0, arr = scn.x0, scn.arrival_times
    x0, arr = x0.reshape(-1, M), arr.reshape(-1, M)
    base = engine.quantized_rule(policies.hesrpt, spec.n_chips)
    chips_run = []
    ref = engine.run(x0, arr, spec.p, _recording_rule(base, chips_run.append), fused=True)
    step, mismatch = [0], torch.zeros((), dtype=torch.int64, device=device)

    def compare(chips):
        mismatch.add_((chips != chips_run[step[0]]).sum())
        step[0] += 1

    red = engine.run_stream(x0, arr, spec.p, _recording_rule(base, compare), n_slots=M,
                            record_times=True, fused=True)
    assert step[0] == len(chips_run) == 2 * M, (step[0], len(chips_run))
    assert int(mismatch) == 0, f"stream chips differ from run's at {int(mismatch)} entries"
    assert bool(torch.isfinite(ref.completion_times).all())
    assert torch.equal(red.completion_times, ref.completion_times), \
        "run_stream(n_slots = M) != run completion times"
    assert bool((red.blocked_steps == 0).all()) and bool((red.n_completed == M).all())
    del chips_run, ref, red
    torch.cuda.empty_cache()

    # (b) The stream lanes at full size: the main path of this phase.
    results, launches = {}, {}
    for label, lspec in lanes.stream_lane_specs():
        torch.cuda.synchronize()
        alloc.LAUNCHES = 0
        results[label] = sweeps.run_sweep(lspec, device=device)
        torch.cuda.synchronize()
        launches[label] = alloc.LAUNCHES
    fused_res = results["stream-quantized-fused"]
    slots = dict(fused_res.spec.stream)["n_slots"]
    assert launches["stream-quantized-fused"] == 2 * M, launches
    assert launches["stream-quantized"] == launches["stream-continuous"] == 0, launches
    assert lanes.fused_equals_unfused(list(results.items()), "stream-"), \
        "stream fused lane != unfused lane"
    for label, res in results.items():
        st = res.stats["hesrpt"]
        assert st["stream_flow"].shape == (len(res.spec.rates), res.spec.n_seeds)
        assert np.all(np.isfinite(st["stream_flow"])) and np.all(st["stream_completed"] > 0)
        assert st["stream_occupancy"].max() <= slots, f"{label}: occupancy above {slots}"
    cells = len(fused_res.spec.rates) * fused_res.spec.n_seeds

    # (c) The load ladder (benchmarks/streaming.py::load_ladder, full size).
    ladder = sweeps.Sweep.create(
        ("hesrpt", "srpt", "equi"), (1.0, 2.0, 4.0, 8.0), n_jobs=1000, n_seeds=10, p=0.5,
        stream={"n_slots": 64},
        metrics=("stream_flow", "stream_slowdown", "stream_blocked", "stream_occupancy"))
    lad = sweeps.run_sweep(ladder, device=device)
    lad_means = lad.cell_means("stream_flow")
    for name in ladder.policies:
        assert np.all(np.isfinite(lad.stats[name]["stream_flow"]))
        assert lad.stats[name]["stream_occupancy"].max() <= 64
    ahead = all(v["hesrpt"] <= min(v["srpt"], v["equi"]) for v in lad_means.values())

    # (d) Horizon scaling: the stream's memory is flat in the horizon.
    rate, n_servers, n_slots, p = 4.0, 4.0, 32, 0.5
    rule = engine.continuous_rule(policies.hesrpt, n_servers)
    horizon = []
    for hi, E in enumerate(STREAM_HORIZONS):
        src = engine.poisson_source(torch.Generator(device=device).manual_seed(hi), rate,
                                    device=device)
        torch.cuda.synchronize()
        floor = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = engine.run_stream_source(src, p, rule, n_slots=n_slots, n_events=E,
                                       n_alone=n_servers)
        done = int(res.n_completed[0])  # synchronizes
        row = {"events": E, "stream_us_per_event": (time.perf_counter() - t0) * 1e6 / E,
               "stream_peak_bytes": torch.cuda.max_memory_allocated() - floor,
               "stream_completed": done, "stream_occupancy": int(res.occupancy_max[0])}
        assert done > 0 and row["stream_occupancy"] <= n_slots
        del res, src
        # The finite-tape loop on the same workload: E/2 jobs, horizon E.
        gen = torch.Generator(device=device).manual_seed(100 + hi)
        t_arr = scenarios.poisson_arrivals(gen, E // 2, rate)
        t_x = scenarios.pareto_sizes(gen, E // 2, 1.5)
        torch.cuda.synchronize()
        floor = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tape = engine.run(t_x, t_arr, p, rule, horizon=E)
        n_tape = int(torch.isfinite(tape.completion_times).sum())  # synchronizes
        row.update(tape_us_per_event=(time.perf_counter() - t0) * 1e6 / E,
                   tape_peak_bytes=torch.cuda.max_memory_allocated() - floor,
                   tape_completed=n_tape)
        del tape, t_arr, t_x
        horizon.append(row)
    peaks = [r["stream_peak_bytes"] for r in horizon]
    assert max(peaks) == min(peaks), f"the stream's peak memory grows with the horizon: {peaks}"

    # (e) The long horizon: 50 x 32 jobs through 32 slots.
    jobs_factor = 50
    src = engine.poisson_source(torch.Generator(device=device).manual_seed(7), rate,
                                device=device)
    t0 = time.perf_counter()
    res = engine.run_stream_source(src, p, rule, n_slots=n_slots,
                                   n_events=int(2.4 * jobs_factor * n_slots), n_alone=n_servers)
    long_h = {"completed": int(res.n_completed[0]), "occupancy_max": int(res.occupancy_max[0]),
              "deferred": int(res.blocked_steps[0]), "events": int(2.4 * jobs_factor * n_slots),
              "wall_s": time.perf_counter() - t0}
    assert long_h["completed"] >= jobs_factor * n_slots, long_h
    assert long_h["occupancy_max"] <= n_slots, long_h

    # (f) The smoke stream lanes on the same tapes, CPU against card.
    cpu_gap = 0.0
    for label, sspec in lanes.stream_lane_specs(smoke=True):
        scn = sweeps.draw_scenario(sspec, device="cpu")
        sx, sa = scn.x0, scn.arrival_times
        cpu = sweeps.simulate_cells(sspec, sx, sa, device="cpu")["hesrpt"]
        gpu = sweeps.simulate_cells(sspec, sx, sa, device=device)["hesrpt"]
        for m in sspec.metrics:
            if m in ("stream_flow", "stream_slowdown"):
                rel = float(np.max(np.abs(gpu[m] - cpu[m]) / np.abs(cpu[m])))
                assert rel <= 1e-12, f"{label}: {m} CPU vs card differ by {rel} relative"
                cpu_gap = max(cpu_gap, rel)
            else:
                assert np.array_equal(gpu[m], cpu[m]), f"{label}: {m} CPU vs card"

    # (g) The kernel at the pool's widths, then its time at the lanes' [192, 64].
    gen = torch.Generator(device=device).manual_seed(25)
    checked = 0
    for dtype in (torch.float64, torch.float32):
        for width in POOL_WIDTHS:
            for free_frac in (0.5, 0.9, 1.0):
                x = _pool_rows(gen, cells, width, device, dtype, free_frac)
                for n_chips, min_chips in ((0, 1), (256, 1), (16, 2)):
                    for pp in (0.5, 0.3):
                        kw = dict(min_chips=min_chips)
                        theta, chips = alloc.hesrpt_alloc_fused(x, pp, n_chips, **kw)
                        theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, pp, n_chips, **kw)
                        if not (torch.equal(theta, theta0) and torch.equal(chips, chips0)):
                            raise AssertionError(
                                f"pool width: kernel != plain: {dtype} [{cells}, {width}] "
                                f"free {free_frac} n_chips={n_chips} p={pp}")
                        checked += 1
    x = _pool_rows(gen, cells, slots, device, torch.float64, 0.5)
    before = alloc.LAUNCHES
    ms = _time_ms(lambda: alloc.hesrpt_alloc_fused(x, 0.5, spec.n_chips), 500)
    plain_ms = _time_ms(lambda: alloc.hesrpt_alloc_fused_ref(x, 0.5, spec.n_chips), 100)
    alloc.LAUNCHES = before  # timing launches are not the main path's
    registers, ctas = alloc.occupancy(slots, torch.float64)
    n_bytes = cells * slots * (2 * x.element_size() + 4)
    n_ops = cells * (2 * slots * math.ceil(math.log2(slots)) + 40 * slots)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / PEAK_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    phase_s = time.perf_counter() - t_phase

    walls = {label: res.wall_s for label, res in results.items()}
    print(f"phase 25: run_stream(fused=True, n_slots={M}) on the fused lane's tapes "
          f"([{x0.shape[0]}, {M}]) == engine.run(fused=True): completion times bit for bit, "
          f"chips equal at all {2 * M} event steps", flush=True)
    print(f"phase 25: stream lanes ({cells} cells x {M} jobs through {slots} slots, "
          f"{spec.n_chips} chips) on {card}: fused lane "
          f"{launches['stream-quantized-fused']} launches at [{cells}, {slots}] (2M = {2 * M}), "
          f"fused == unfused bit for bit in every stream metric, occupancy <= {slots}; walls "
          + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()), flush=True)
    for label, res in results.items():
        st = res.stats["hesrpt"]
        flows = [round(v["hesrpt"], 6) for v in res.cell_means("stream_flow").values()]
        print(f"phase 25: {label} per-rate windowed mean flow {flows}; blocked steps "
              f"{int(st['stream_blocked'].sum())}, peak occupancy "
              f"{int(st['stream_occupancy'].max())}", flush=True)
    print(f"phase 25: load ladder (rates {list(ladder.rates)}, {ladder.n_jobs} jobs, "
          f"{ladder.n_seeds} seeds, 64 slots, carried-rank stream) wall {lad.wall_s:.3f} s; "
          "windowed mean flow " + "; ".join(
              f"rate {r}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              for r, row in lad_means.items())
          + f"; heSRPT <= SRPT and EQUI at every rate: {ahead}", flush=True)
    for row in horizon:
        print(f"phase 25: horizon {row['events']} events on {card}: stream "
              f"{row['stream_us_per_event']:.1f} us/event, peak {row['stream_peak_bytes']} B "
              f"above the baseline, {row['stream_completed']} completed; engine.run on "
              f"{row['events'] // 2} jobs {row['tape_us_per_event']:.1f} us/event, peak "
              f"{row['tape_peak_bytes']} B", flush=True)
    print(f"phase 25: horizons {list(STREAM_HORIZONS_CUT)} of benchmarks/streaming.py's full "
          "tier cut for the script's time limit", flush=True)
    print(f"phase 25: long horizon: {long_h['completed']} jobs through {n_slots} slots in "
          f"{long_h['events']} events ({long_h['wall_s']:.3f} s), peak occupancy "
          f"{long_h['occupancy_max']}, {long_h['deferred']} deferred admissions; smoke stream "
          f"lanes CPU vs card {cpu_gap:.2e}, counts equal", flush=True)
    print(f"phase 25: alloc at the pool's widths {list(POOL_WIDTHS)} == plain version bit for "
          f"bit on {checked} cases; at [{cells}, {slots}] f64 on {card}: kernel {ms:.4f} ms, "
          f"plain version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({n_bytes} bytes); "
          f"{registers} registers a thread, {ctas} CTAs an SM; phase 25 took {phase_s:.1f} s",
          flush=True)
    return {"launches": launches, "walls_s": walls, "cells": cells, "n_jobs": M,
            "n_slots": slots, "ladder_wall_s": lad.wall_s, "ladder_flow": lad_means,
            "hesrpt_ahead": ahead, "horizon": horizon,
            "horizons_cut": list(STREAM_HORIZONS_CUT), "long_horizon": long_h,
            "cpu_vs_cuda_max_rel": cpu_gap, "pool_cases": checked,
            "timing_ms": {"ms": ms, "plain_ms": plain_ms}, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "registers": registers, "ctas_per_sm": ctas, "shape": [cells, slots],
            "phase_s": phase_s,
            "lanes": lanes.lane_records(list(results.items()))}


# Phase 26's sizes: benchmarks/telemetry.py's and benchmarks/estimation.py's
# full tier (their main(): 500 jobs x 20 seeds at rates 0.5, 2 and 8; the
# forgetting rows at half of each), not cut.
TEL_RATES, TEL_JOBS, TEL_SEEDS = (0.5, 2.0, 8.0), 500, 20
EST_ARMS, EST_SCENARIOS = ("oracle", "stale", "estimator"), ("drift_poisson", "drift_bursty")


def _sweep_gap(cpu: dict, gpu: dict) -> float:
    """Largest relative CPU-vs-card gap over every column of two
    ``simulate_cells`` results (a 0 against a 0 is no gap)."""
    import numpy as np

    worst = 0.0
    for name, cols in cpu.items():
        for col, want in cols.items():
            got = gpu[name][col]
            den = np.where(want == 0, 1.0, np.abs(want))
            worst = max(worst, float(np.max(np.abs(got - want) / den)))
    return worst


def phase_telemetry(alloc, lanes, sweeps, engine, policies, telemetry, analysis, trace_export,
                    card, device) -> dict:
    """Phase 26: in-loop telemetry and single-class online estimation."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    # (a) Neutrality on the fused lane, through the sweep (the main path)
    # and event by event through engine.run.
    spec = dict(lanes.lane_specs())["quantized-fused"]
    M, n_chips = spec.n_jobs, spec.n_chips
    probed_spec = spec._replace(telemetry=telemetry.DEFAULT_METRICS)
    plain_res = sweeps.run_sweep(spec, device=device)
    torch.cuda.synchronize()
    alloc.LAUNCHES = 0
    probed_res = sweeps.run_sweep(probed_spec, device=device)
    torch.cuda.synchronize()
    launches = {"fused_probe": alloc.LAUNCHES}
    assert launches["fused_probe"] == 2 * M, launches
    assert np.array_equal(plain_res.stats["hesrpt"]["mean_flowtime"],
                          probed_res.stats["hesrpt"]["mean_flowtime"]), "a probe moved the lane"
    for col in telemetry.scalar_columns(telemetry.DEFAULT_METRICS):
        assert np.all(np.isfinite(probed_res.stats["hesrpt"][col])), col
    scn = sweeps.draw_scenario(spec, device=device)
    x0, arr = scn.x0.reshape(-1, M), scn.arrival_times.reshape(-1, M)
    base = engine.quantized_rule(policies.hesrpt, n_chips)
    chips_run = []
    ref = engine.run(x0, arr, spec.p, _recording_rule(base, chips_run.append), fused=True)
    step, mismatch = [0], torch.zeros((), dtype=torch.int64, device=device)

    def compare(chips):
        mismatch.add_((chips != chips_run[step[0]]).sum())
        step[0] += 1

    probe = telemetry.make_probe(telemetry.DEFAULT_METRICS, alloc_unit=n_chips, n_jobs=M)
    got = engine.run(x0, arr, spec.p, _recording_rule(base, compare), fused=True,
                     telemetry=probe)
    assert step[0] == len(chips_run) == 2 * M, (step[0], len(chips_run))
    assert int(mismatch) == 0, f"a probe changed the chips at {int(mismatch)} entries"
    assert torch.equal(got.completion_times, ref.completion_times), "a probe moved the flows"
    # Within the card the probe is deterministic (one bin a row an event):
    # the unfused lane's read-out equals the fused lane's bit for bit.
    unfused = engine.run(x0, arr, spec.p, base, telemetry=probe).telemetry
    for k, v in got.telemetry.aggregates.items():
        assert torch.equal(v, unfused.aggregates[k]), f"probe {k}: fused != unfused"
    del chips_run, ref, got, unfused
    torch.cuda.empty_cache()
    # The fused stream lane under its windowed probe (each rate's window).
    sspec = dict(lanes.stream_lane_specs())["stream-quantized-fused"]
    slots = dict(sspec.stream)["n_slots"]
    stream_plain = sweeps.run_sweep(sspec, device=device)
    torch.cuda.synchronize()
    alloc.LAUNCHES = 0
    stream_probed = sweeps.run_sweep(sspec._replace(telemetry=telemetry.DEFAULT_METRICS),
                                     device=device)
    torch.cuda.synchronize()
    launches["stream_fused_probe"] = alloc.LAUNCHES
    assert launches["stream_fused_probe"] == 2 * sspec.n_jobs, launches
    for m in sspec.metrics:
        assert np.array_equal(stream_plain.stats["hesrpt"][m], stream_probed.stats["hesrpt"][m]), \
            f"a probe moved the stream lane's {m}"
    walls = {"fused": plain_res.wall_s, "fused_probe": probed_res.wall_s,
             "stream_fused": stream_plain.wall_s, "stream_fused_probe": stream_probed.wall_s}

    # (b) One full-width row: the stream aggregates against the series.
    row = (x0[:1], arr[:1])
    tel = {mode: engine.run(*row, spec.p, base, fused=True, telemetry=telemetry.make_probe(
        telemetry.DEFAULT_METRICS, mode=mode, alloc_unit=n_chips, n_jobs=M)).telemetry
        for mode in ("series", "stream")}
    series = {k: v[0].cpu().numpy() for k, v in tel["series"].series.items()}
    agg = {k: v[0].cpu().numpy() for k, v in tel["stream"].aggregates.items()}
    series_gap = 0.0
    for m in telemetry.DEFAULT_METRICS:
        want = analysis.time_weighted_stats(series[m], series["dt"])
        series_gap = max(series_gap, abs(float(agg[f"{m}_mean"]) - want["mean"]),
                         abs(float(agg[f"{m}_max"]) - want["max"]))
        mass = float(agg[f"{m}_hist"].sum())
        assert abs(mass - float(agg["time"])) <= 1e-12 * float(agg["time"]), (m, mass)
    assert series_gap <= 1e-9, f"stream vs series {series_gap}"

    # (c) The online half of benchmarks/telemetry.py at its full size.
    online = sweeps.run_sweep(sweeps.Sweep.create(
        ("hesrpt", "equi"), TEL_RATES, scenario="poisson", n_jobs=TEL_JOBS, n_seeds=TEL_SEEDS,
        p=0.5, telemetry=True), device=device)
    cols = ("tel_efficiency_mean", "tel_utilization_mean", "tel_queue_mean", "tel_queue_max",
            "tel_entropy_mean")
    table = {name: {rate: {c: float(np.mean(online.stats[name][c][r])) for c in cols}
                    for r, rate in enumerate(TEL_RATES)} for name in ("hesrpt", "equi")}

    # (d) benchmarks/estimation.py's sweep, its forgetting rows and the
    # estimator arm of benchmarks/telemetry.py, full size.
    def arm_sweep(arm, scenario, rates, n_jobs, n_seeds, discount=0.9):
        return sweeps.run_sweep(sweeps.Sweep.create(
            ("hesrpt",), rates, scenario=scenario,
            scenario_kw={"p0": 0.8, "p1": 0.3, "drift_frac": 0.5}, n_jobs=n_jobs,
            n_seeds=n_seeds, seed=0, p=0.8, n_servers=256.0, arm=arm,
            arm_kw={"discount": discount, "prior_weight": 1.0}), device=device)

    t_est = time.perf_counter()
    est_tables, ok_order = {}, True
    for scenario in EST_SCENARIOS:
        est_tables[scenario] = {
            arm: arm_sweep(arm, scenario, TEL_RATES, TEL_JOBS, TEL_SEEDS).cell_means()
            for arm in EST_ARMS}
        for rate in TEL_RATES:
            ok_order &= (est_tables[scenario]["estimator"][rate]["hesrpt"]
                         <= est_tables[scenario]["stale"][rate]["hesrpt"] * 1.02)
    est_s = time.perf_counter() - t_est
    assert ok_order, f"estimator arm lost to stale-p: {est_tables}"
    forgetting = {f"discount={d}": arm_sweep("estimator", "drift_poisson", TEL_RATES,
                                             TEL_JOBS // 2, TEL_SEEDS // 2, d).cell_means()
                  for d in (1.0, 0.9)}
    tel_est = sweeps.run_sweep(sweeps.Sweep.create(
        ("hesrpt",), (2.0,), scenario="drift_poisson", scenario_kw={"p0": 0.7, "p1": 0.3},
        n_jobs=TEL_JOBS, n_seeds=TEL_SEEDS, seed=0, arm="estimator",
        telemetry=("efficiency", "utilization", "queue", "p_hat_err")), device=device)
    err = tel_est.stats["hesrpt"]
    p_hat_err = {"mean": float(np.mean(err["tel_p_hat_err_mean"])),
                 "max": float(np.max(err["tel_p_hat_err_max"]))}
    assert 0.0 < p_hat_err["mean"] < 1.0 and p_hat_err["max"] <= 1.0, p_hat_err

    # (e) The smoke telemetry and estimator sweeps on the same tapes, CPU
    # against card, and the smoke fused lane's histograms.
    smoke = [
        sweeps.Sweep.create(("hesrpt", "equi"), TEL_RATES, n_jobs=60, n_seeds=6, telemetry=True),
        sweeps.Sweep.create(("hesrpt",), TEL_RATES, n_jobs=60, n_seeds=6, n_chips=64,
                            fused=True, telemetry=True),
        sweeps.Sweep.create(("hesrpt",), (2.0,), scenario="drift_poisson",
                            scenario_kw={"p0": 0.7, "p1": 0.3}, n_jobs=60, n_seeds=6,
                            arm="estimator",
                            telemetry=("efficiency", "utilization", "queue", "p_hat_err")),
    ] + [sweeps.Sweep.create(("hesrpt",), TEL_RATES, scenario="drift_bursty",
                             scenario_kw={"p0": 0.8, "p1": 0.3}, n_jobs=60, n_seeds=4, p=0.8,
                             arm=arm, arm_kw={"discount": 0.9}) for arm in EST_ARMS]
    cpu_gap = 0.0
    for sm in smoke:
        s_scn = sweeps.draw_scenario(sm, device="cpu")
        kw = dict(p_drift=s_scn.p_drift)
        cpu_gap = max(cpu_gap, _sweep_gap(
            sweeps.simulate_cells(sm, s_scn.x0, s_scn.arrival_times, device="cpu", **kw),
            sweeps.simulate_cells(sm, s_scn.x0, s_scn.arrival_times, device=device, **kw)))
    assert cpu_gap <= 1e-12, f"telemetry / estimator sweeps CPU vs card {cpu_gap}"
    lspec = dict(lanes.lane_specs(smoke=True))["quantized-fused"]
    l_scn = sweeps.draw_scenario(lspec, device="cpu")
    lx, la = l_scn.x0.reshape(-1, lspec.n_jobs), l_scn.arrival_times.reshape(-1, lspec.n_jobs)
    lprobe = telemetry.make_probe(telemetry.DEFAULT_METRICS, alloc_unit=lspec.n_chips,
                                  n_jobs=lspec.n_jobs)
    lrule = engine.quantized_rule(policies.hesrpt, lspec.n_chips)
    h_cpu = engine.run(lx, la, lspec.p, lrule, fused=True, telemetry=lprobe).telemetry
    h_gpu = engine.run(lx.to(device), la.to(device), lspec.p, lrule, fused=True,
                       telemetry=lprobe).telemetry
    hist_gap = max(float((h_gpu.aggregates[f"{m}_hist"].cpu() - h_cpu.aggregates[f"{m}_hist"])
                         .abs().max()) for m in telemetry.DEFAULT_METRICS)
    assert hist_gap <= 1e-12, f"histograms CPU vs card {hist_gap}"

    # (f) The Perfetto export on the card, through the fused allocate.
    alloc.LAUNCHES = 0
    events = trace_export.export_sample(device=device, n_chips=16)
    launches["export_sample"] = alloc.LAUNCHES
    trace_export.validate_trace_events(events)
    assert launches["export_sample"] == 2 * 12, launches
    assert {"X", "i", "C", "M"} <= {e["ph"] for e in events}
    phase_s = time.perf_counter() - t_phase

    print(f"phase 26: fused lane ({x0.shape[0]} cells x {M} jobs, {n_chips} chips) on {card} "
          f"with a {len(telemetry.DEFAULT_METRICS)}-metric stream probe: "
          f"{launches['fused_probe']} launches (2M = {2 * M}), mean flows and the chips at all "
          f"{2 * M} event steps bit for bit the probe-free run's, every aggregate (histograms "
          f"included) bit for bit the unfused lane's; walls: no probe "
          f"{walls['fused']:.3f} s, probe {walls['fused_probe']:.3f} s", flush=True)
    print(f"phase 26: fused stream lane ({slots} slots) under each rate's windowed probe: "
          f"{launches['stream_fused_probe']} launches at [{x0.shape[0]}, {slots}], every stream "
          f"metric bit for bit; walls: no probe {walls['stream_fused']:.3f} s, probe "
          f"{walls['stream_fused_probe']:.3f} s", flush=True)
    print(f"phase 26: one full-width row ({M} jobs): stream aggregates vs time_weighted_stats "
          f"of the series {series_gap:.2e} (<= 1e-9), histogram mass == span", flush=True)
    print(f"phase 26: benchmarks/telemetry.py online half ({TEL_JOBS} jobs x {TEL_SEEDS} seeds x "
          f"{len(TEL_RATES)} loads) wall {online.wall_s:.3f} s", flush=True)
    print(f"phase 26: {'policy':>8s} {'rate':>6s} " + " ".join(f"{c[4:]:>16s}" for c in cols),
          flush=True)
    for name, by_rate in table.items():
        for rate, vals in by_rate.items():
            print(f"phase 26: {name:>8s} {rate:6.1f} "
                  + " ".join(f"{vals[c]:16.4f}" for c in cols), flush=True)
    for scenario, res in est_tables.items():
        print(f"phase 26: benchmarks/estimation.py {scenario} (mean flow time; {TEL_JOBS} jobs x "
              f"{TEL_SEEDS} seeds) " + "; ".join(
                  f"rate {r}: " + ", ".join(f"{a} {res[a][r]['hesrpt']:.4f}" for a in EST_ARMS)
                  for r in TEL_RATES), flush=True)
    print(f"phase 26: estimator <= stale x 1.02 at every load and scenario: {ok_order}; the "
          f"six arm sweeps {est_s:.3f} s", flush=True)
    for label, res in forgetting.items():
        print(f"phase 26: forgetting {label:>14s} "
              + " ".join(f"{v['hesrpt']:10.4f}" for v in res.values()), flush=True)
    print(f"phase 26: estimator arm (drift 0.7 -> 0.3) time-weighted |p_hat - p| mean "
          f"{p_hat_err['mean']:.4f}, max {p_hat_err['max']:.4f}, wall {tel_est.wall_s:.3f} s",
          flush=True)
    print(f"phase 26: smoke telemetry and estimator sweeps CPU vs card {cpu_gap:.2e} relative, "
          f"histograms {hist_gap:.2e}; export_sample(n_chips=16) {len(events)} valid "
          f"events, {launches['export_sample']} launches; phase 26 took {phase_s:.1f} s",
          flush=True)
    return {"launches": launches, "walls_s": walls, "series_vs_stream_max_abs": series_gap,
            "online_wall_s": online.wall_s, "online_table": table,
            "estimation": est_tables, "estimation_wall_s": est_s,
            "estimator_not_worse_than_stale": ok_order, "forgetting": forgetting,
            "p_hat_err": p_hat_err, "estimator_telemetry_wall_s": tel_est.wall_s,
            "cpu_vs_cuda_max_rel": cpu_gap, "hist_cpu_vs_cuda_max_abs": hist_gap,
            "export_events": len(events), "phase_s": phase_s}


def phase_multiclass(alloc, lanes, sweeps, multiclass, arrivals, policies, card,
                     device) -> dict:
    """Phase 27: multi-class workloads.  The path launches no kernel, as in
    the reference: the alloc count is zeroed before (a) and must read 0
    after it."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    alloc.LAUNCHES = 0
    # (a) The class-aware grid: one run_sweep a policy, each one [R * S, M]
    # batch through the generic loop.
    # K = 4 at benchmarks/multiclass.py's full grid; K = 2 and 3 at that
    # file's quick size (300 jobs x 8 seeds), cut for the script's time
    # budget: at full size the two columns add ~46 s on an H100 (PERF.md
    # section 5), which takes the phase past 90 s.
    quick = dict(lanes.multiclass_specs("quick"))
    grids = {"K=4": dict(lanes.multiclass_specs("full"))["K=4"],
             "K=3": quick["K=3"], "K=2": quick["K=2"]}
    walls, tables, gaps, results = {}, {}, {}, {}
    for label in sorted(grids, reverse=True):
        spec = grids[label]
        by_pol, stats = {}, {}
        for name in spec.policies:
            res = sweeps.run_sweep(spec._replace(policies=(name,)), device=device)
            by_pol[name] = res.wall_s
            stats[name] = res.stats[name]
            for m, a in stats[name].items():
                assert np.all(np.isfinite(a)), (label, name, m)
        res = sweeps.SweepResult(spec, stats, sum(by_pol.values()), device.type, 1, device)
        walls[label], results[label] = by_pol, res
        gaps[label] = lanes.gap_ratios(res)
        # Means over seeds: [R] overall, [R, K] per class.
        tables[label] = {name: {m: a.mean(axis=1).tolist() for m, a in stats[name].items()}
                         for name in spec.policies}

    alloc_launches = alloc.LAUNCHES
    assert alloc_launches == 0, f"the class-aware grid launched the alloc kernel {alloc_launches}x"

    # (b) The K = 2 snap pair on 256 whole chips.
    pair = {label: sweeps.run_sweep(spec, device=device)
            for label, spec in lanes.multiclass_specs("full") if label.startswith("snap")}
    off, on = (pair[k].stats["hesrpt_pc"]["mean_flowtime"] for k in ("snap-off", "snap-on"))
    snap_ratio = [float(on[r].mean() / off[r].mean()) for r in range(off.shape[0])]

    # (c) The equal-p reduction: K = 3 classes at p = 0.5 are the
    # single-class run bit for bit, continuous and whole chips.
    eq = tuple(multiclass.ClassSpec(p=0.5, mix=1.0 / 3, size_alpha=a, size_scale=s)
               for a, s in ((1.5, 1.0), (2.0, 2.0), (2.5, 4.0)))
    eq_spec = sweeps.Sweep.create(("hesrpt_pc",), lanes.MC_RATES, scenario="multiclass_poisson",
                                  n_jobs=300, n_seeds=8, n_servers=256.0, classes=eq)
    scn = sweeps.draw_scenario(eq_spec, device=device)
    equal = {}
    for regime, kw in (("continuous", {}), ("chips", {"n_chips": 256})):
        got = multiclass.simulate_multiclass(scn, classes=eq, policy="hesrpt_pc",
                                             n_servers=256.0, device=device, **kw)
        if kw:
            ref = arrivals.simulate_online_quantized(scn.x0, scn.arrival_times, 0.5, 256,
                                                     policies.hesrpt, device=device)
        else:
            ref = arrivals.simulate_online(scn.x0, scn.arrival_times, 0.5, 256.0,
                                           policies.hesrpt, device=device)
        equal[regime] = bool(torch.equal(got.completion_times, ref.completion_times))
        assert equal[regime], f"equal-p classes differ from the single-class run ({regime})"

    # (d) Determinism: K = 4's hesrpt_pc column again, every column bit for bit.
    k4 = grids["K=4"]
    again = sweeps.run_sweep(k4._replace(policies=("hesrpt_pc",)), device=device)
    deterministic = all(np.array_equal(again.stats["hesrpt_pc"][m],
                                       results["K=4"].stats["hesrpt_pc"][m])
                        for m in k4.metrics)
    assert deterministic, "two card runs of the K = 4 hesrpt_pc column differ"

    # (e) CPU against card at smoke size: Sweep(classes=), a drift_multiclass
    # sweep, and simulate_multiclass(estimator_kw=).
    smoke = dict(lanes.multiclass_specs("smoke"))
    drift_spec = smoke["K=2"]._replace(scenario="drift_multiclass",
                                       scenario_kw=(("p1", (0.15, 0.25)),))
    cpu_gap = 0.0
    for sm in (smoke["K=2"], smoke["snap-on"], drift_spec):
        s_scn = sweeps.draw_scenario(sm, device="cpu")
        kw = dict(p_drift=s_scn.p_drift, class_ids=s_scn.class_ids, p_job=s_scn.p_job)
        cpu_gap = max(cpu_gap, _sweep_gap(
            sweeps.simulate_cells(sm, s_scn.x0, s_scn.arrival_times, device="cpu", **kw),
            sweeps.simulate_cells(sm, s_scn.x0, s_scn.arrival_times, device=device, **kw)))
    est_scn = sweeps.draw_scenario(smoke["K=2"], device="cpu")
    est = {}
    for dev in ("cpu", device):
        moved = est_scn._replace(**{f: getattr(est_scn, f).to(dev)
                                    for f in ("x0", "arrival_times", "class_ids", "p_job")})
        est[str(dev)] = multiclass.simulate_multiclass(
            moved, classes=smoke["K=2"].classes, policy="hesrpt_pc", n_servers=256.0,
            estimator_kw={"discount": 0.95}, device=dev).completion_times.cpu()
    want = est["cpu"]
    est_gap = float(((est[str(device)] - want).abs() / want.abs()).max())
    cpu_gap = max(cpu_gap, est_gap)
    assert cpu_gap <= 1e-12, f"multi-class CPU vs card {cpu_gap}"
    phase_s = time.perf_counter() - t_phase

    for label in sorted(grids, reverse=True):
        spec = grids[label]
        print(f"phase 27: {label} ({spec.n_jobs} jobs x {spec.n_seeds} seeds x rates "
              f"{spec.rates}, {int(spec.n_servers)} servers, continuous, "
              f"{alloc_launches} alloc launches) on {card}: walls "
              + ", ".join(f"{n} {w:.3f} s" for n, w in walls[label].items()), flush=True)
        for name, t in tables[label].items():
            print(f"phase 27: {label} {name:>12s} mean flow | slowdown by rate: "
                  + "  ".join(f"{f:.4f} | {s:.3f}" for f, s in zip(
                      t["mean_flowtime"], t["mean_slowdown"], strict=True)), flush=True)
            print(f"phase 27: {label} {name:>12s} per class at rate {spec.rates[-1]:g}: "
                  + "  ".join(f"k={k}: flow {f:.4f} slow {s:.3f}" for k, (f, s) in enumerate(
                      zip(t["class_flowtime"][-1], t["class_slowdown"][-1], strict=True))),
                  flush=True)
        print(f"phase 27: {label} class-aware/class-blind mean flow "
              + "  ".join(f"{r:g}: {g:.3f}" for r, g in zip(spec.rates, gaps[label]["flow"],
                                                          strict=True))
              + "; mean slowdown "
              + "  ".join(f"{r:g}: {g:.3f}" for r, g in zip(spec.rates,
                                                          gaps[label]["slowdown"], strict=True)),
              flush=True)
    snap_spec = dict(lanes.multiclass_specs("full"))["snap-on"]
    print(f"phase 27: snap pair (K = 2, hesrpt_pc, {snap_spec.n_chips} chips, "
          f"{snap_spec.n_jobs} jobs x {snap_spec.n_seeds} seeds): walls off "
          f"{pair['snap-off'].wall_s:.3f} s, on {pair['snap-on'].wall_s:.3f} s; snapped / "
          "whole-chips mean flow " + "  ".join(
              f"{r:g}: {g:.3f}" for r, g in zip(snap_spec.rates, snap_ratio, strict=True)),
          flush=True)
    print(f"phase 27: equal-p reduction (K = 3 at p = 0.5, 300 jobs x 8 seeds x 3 rates) bit "
          f"for bit with the single-class run: continuous {equal['continuous']}, chips "
          f"{equal['chips']}; K = 4 hesrpt_pc twice on the card bit for bit: {deterministic} "
          f"(wall {again.wall_s:.3f} s)", flush=True)
    print(f"phase 27: smoke Sweep(classes=), snapped, drift_multiclass and the class "
          f"estimator CPU vs card {cpu_gap:.2e} relative (estimator {est_gap:.2e}); phase 27 "
          f"took {phase_s:.1f} s", flush=True)
    return {"walls_s": walls, "tables": tables, "gaps": gaps,
            "snap_walls_s": {k: v.wall_s for k, v in pair.items()}, "snap_ratio": snap_ratio,
            "equal_p_bit_for_bit": equal, "deterministic": deterministic,
            "repeat_wall_s": again.wall_s, "cpu_vs_cuda_max_rel": cpu_gap,
            "alloc_launches": alloc_launches,
            "jobs_seeds": {k: [s.n_jobs, s.n_seeds] for k, s in grids.items()},
            "phase_s": phase_s}


def _allocs(sched_obj) -> list[dict]:
    return [e["chips"] for e in sched_obj.events if e["event"] == "allocate"]


def _times_gap(got: dict, want: dict) -> float:
    """Largest relative gap between two ``completion_times`` dicts."""
    return max(abs(got[k] - w) / abs(w) for k, w in want.items())


def _both_ways(make, device) -> dict:
    """One job table run delegated (``run_fluid_to_completion()``) and per
    event (``use_engine=False``) on ``device``: walls, chips equal at every
    allocate event, the completion-time gap."""
    out = {}
    for label, use_engine in (("delegated", True), ("per_event", False)):
        s = make(device)
        assert s._engine_eligible(), "the instance must delegate"
        t0 = time.perf_counter()  # both paths end in a copy to the host
        res = s.run_fluid_to_completion(use_engine=use_engine)
        out[label] = (s, res, time.perf_counter() - t0)
    (a, ra, wall_a), (b, rb, wall_b) = out["delegated"], out["per_event"]
    ea, eb = _allocs(a), _allocs(b)
    # Fractional chips (quantize=False) differ in the last ulps.
    chips_rel = max((abs(e[k] - c) / max(abs(c), 1e-300) for e, f in zip(ea, eb, strict=True)
                     for k, c in f.items()), default=0.0) if len(ea) == len(eb) else math.inf
    return {"walls_s": {"delegated": wall_a, "per_event": wall_b},
            "chips_equal": ea == eb, "chips_max_rel": chips_rel, "n_events": len(eb),
            "max_rel": _times_gap(ra["completion_times"], rb["completion_times"]),
            "total_flow": ra["total_flow_time"], "result": ra}


def phase_sched(alloc, lanes, sched, flowtime, policies, card, device) -> dict:
    """Phase 28: the cluster scheduler (``sched/``) and the benchmarks that
    hold the engine against it.  It launches no kernel, as in the
    reference (``ClusterScheduler`` never passes ``fused=``): the alloc
    count is zeroed before (a) and must read 0 after (e)."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    alloc.LAUNCHES = 0
    # (a) examples/quickstart.py's cluster step: 64 chips, heSRPT on whole chips.
    sizes = [8.0, 5.0, 3.0, 2.0, 1.0]
    q = sched.ClusterScheduler(64, policy="hesrpt", device=device)
    for i, size in enumerate(sizes):
        q.add_job(sched.Job(f"job{i}", size=size, p=0.5))
    quick_alloc = q.allocations()
    quick = q.run_fluid_to_completion()
    fluid = float(flowtime.hesrpt_total_flowtime(
        torch.tensor(sizes, dtype=torch.float64, device=device), 0.5, 64.0))
    assert sum(quick_alloc.values()) == 64, quick_alloc
    assert fluid * (1 - 1e-12) <= quick["total_flow_time"] < math.inf, (quick, fluid)

    # (b) A backlog at a real cluster's size: 1000 Pareto(1.5) + 1 jobs on
    # 4096 chips, heSRPT and class-aware hesrpt_pc over class_grid(4).
    rng = np.random.default_rng(0)
    x = rng.pareto(1.5, SCHED_JOBS) + 1.0
    classes = lanes.class_grid(4)
    cls = rng.integers(0, len(classes), SCHED_JOBS)

    def backlog(dev, **kw):
        s = sched.ClusterScheduler(SCHED_CHIPS, device=dev, **kw)
        for i, size in enumerate(x):
            k = int(cls[i])
            s.add_job(sched.Job(f"j{i}", size=float(size),
                                p=classes[k].p if kw.get("class_aware") else 0.5, class_id=k))
        return s

    backlogs = {
        "hesrpt": _both_ways(lambda d: backlog(d, policy="hesrpt"), device),
        "hesrpt_pc": _both_ways(
            lambda d: backlog(d, policy="hesrpt_pc", class_aware=True), device),
    }
    for label, r in backlogs.items():
        assert r["chips_equal"], f"{label}: delegated chips differ from the per-event path"
        assert r["max_rel"] <= 1e-9, (label, r["max_rel"])
    t0 = time.perf_counter()
    cpu_run = backlog("cpu", policy="hesrpt").run_fluid_to_completion()
    cpu_wall = time.perf_counter() - t0
    cpu_gap = _times_gap(cpu_run["completion_times"],
                         backlogs["hesrpt"].pop("result")["completion_times"])
    backlogs["hesrpt_pc"].pop("result")
    assert cpu_gap <= 1e-12, f"backlog CPU vs card {cpu_gap}"

    # (c) The estimator modes at 64 jobs (true p in [0.3, 0.8], priors 0.5,
    # discount 0.9), and the class-aware estimator on a reused table.
    rng = np.random.default_rng(1)
    xe, pe = rng.pareto(1.5, SCHED_EST_JOBS) + 1.0, rng.uniform(0.3, 0.8, SCHED_EST_JOBS)
    ce = rng.integers(0, len(classes), 2 * SCHED_EST_JOBS)

    def est_table(dev, quantize):
        s = sched.ClusterScheduler(SCHED_EST_CHIPS, policy="hesrpt", use_estimator=True,
                                   quantize=quantize, est_discount=0.9, device=dev)
        for i in range(SCHED_EST_JOBS):
            s.add_job(sched.Job(f"j{i}", size=float(xe[i]), p=float(pe[i]), prior_p=0.5))
        return s

    def reused_table(dev):
        s = sched.ClusterScheduler(SCHED_EST_CHIPS, policy="hesrpt_pc", use_estimator=True,
                                   class_aware=True, device=dev)
        for batch in range(2):
            if batch:
                s.run_fluid_to_completion(use_engine=False)  # builds real histories
            for i in range(SCHED_EST_JOBS):
                k = int(ce[batch * SCHED_EST_JOBS + i])
                s.add_job(sched.Job(f"b{batch}j{i}", size=float(xe[i]), p=classes[k].p,
                                    class_id=k, prior_p=0.5))
        return s

    estimators = {
        "continuous": _both_ways(lambda d: est_table(d, False), device),
        "whole_chips": _both_ways(lambda d: est_table(d, True), device),
        "class_reused": _both_ways(reused_table, device),
    }
    for label, r in estimators.items():
        r.pop("result")
        assert r["max_rel"] <= 1e-8, (label, r["max_rel"])

    # (d) The five cross-checks at their benchmarks' own sizes and bars.
    t0 = time.perf_counter()
    checks = {
        "quantized": lanes.quantized_cross_check(device=device),
        "arrivals": lanes.arrivals_cross_check(device=device),
        "estimation": lanes.estimation_cross_check(device=device),
        "multiclass": lanes.multiclass_cross_check(device=device),
        "stream_oracle": lanes.stream_oracle_check(device=device),
    }
    checks_s = time.perf_counter() - t0
    qc, mcc = checks["quantized"], checks["multiclass"]
    assert qc["chips_exact"] and qc["worst_flow_rel"] < 1e-9, qc
    assert qc["worst_epoch_time_rel"] < 1e-9, qc
    assert checks["arrivals"] < 1e-6, checks["arrivals"]
    assert checks["estimation"]["worst_flow_rel"] < 1e-8, checks["estimation"]
    assert mcc["chips_exact"] and mcc["worst_continuous_flow_rel"] < 1e-10, mcc
    assert mcc["worst_quantized_flow_rel"] < 1e-9, mcc
    assert checks["stream_oracle"] < 1e-6, checks["stream_oracle"]

    # (e) One decision epoch at M = 100 .. 1e5 on 4096 chips; the card's
    # chips at the largest M against the CPU's.
    scale = lanes.sched_scale(device=device)
    st = scale.stats["hesrpt"]
    assert np.all(st["chips_sum"] == SCHED_CHIPS), st["chips_sum"]
    m_top = scale.spec["ms"][-1]
    xs = np.sort(np.random.default_rng(0).pareto(1.5, m_top) + 1.0)[::-1].copy()
    top = {dev: sched.quantize_allocation(
        policies.hesrpt(torch.tensor(xs, device=dev), scale.spec["p"]), SCHED_CHIPS).cpu()
        for dev in ("cpu", device)}
    scale_cpu_equal = bool(torch.equal(top["cpu"], top[device]))
    assert scale_cpu_equal, "sched_scale's chips at the largest M differ CPU vs card"
    launches = alloc.LAUNCHES
    assert launches == 0, f"the cluster scheduler launched the alloc kernel {launches}x"
    phase_s = time.perf_counter() - t_phase

    print(f"phase 28: quickstart on 64 chips (heSRPT, whole chips, p 0.5): allocation "
          f"{quick_alloc}; total flow {quick['total_flow_time']:.6f} against Thm 8's fluid "
          f"optimum {fluid:.6f}", flush=True)
    for label, r in backlogs.items():
        print(f"phase 28: backlog {label} ({SCHED_JOBS} jobs, {SCHED_CHIPS} chips) on {card}: "
              f"delegated {r['walls_s']['delegated']:.3f} s, per event "
              f"{r['walls_s']['per_event']:.3f} s, {r['n_events']} allocate events, chips "
              f"equal at every one {r['chips_equal']}, completion times {r['max_rel']:.2e} "
              f"relative; total flow {r['total_flow']:.4f}", flush=True)
    print(f"phase 28: backlog heSRPT delegated on the CPU {cpu_wall:.3f} s, completion times "
          f"{cpu_gap:.2e} relative to the card's", flush=True)
    for label, r in estimators.items():
        print(f"phase 28: estimator {label} ({SCHED_EST_JOBS} jobs, {SCHED_EST_CHIPS} chips): "
              f"delegated {r['walls_s']['delegated']:.3f} s, per event "
              f"{r['walls_s']['per_event']:.3f} s, completion times {r['max_rel']:.2e} "
              f"relative, chips equal {r['chips_equal']} (within {r['chips_max_rel']:.2e})",
              flush=True)
    print(f"phase 28: cross-checks ({checks_s:.3f} s): quantized chips exact "
          f"{qc['chips_exact']} over {qc['n_events']} events, epoch times "
          f"{qc['worst_epoch_time_rel']:.2e}, flows {qc['worst_flow_rel']:.2e}; arrivals "
          f"{checks['arrivals']:.2e}; estimation {checks['estimation']['worst_flow_rel']:.2e} "
          f"({checks['estimation']['n_cases']} cases); multiclass chips exact "
          f"{mcc['chips_exact']} over {mcc['n_events']} events, continuous "
          f"{mcc['worst_continuous_flow_rel']:.2e}, whole chips "
          f"{mcc['worst_quantized_flow_rel']:.2e}; stream oracle "
          f"{checks['stream_oracle']:.2e}", flush=True)
    for mi, m in enumerate(scale.spec["ms"]):
        print(f"phase 28: sched_scale M = {m} on {card}: theta {np.median(st['theta_us'][mi]):.1f} "
              f"us (median of {scale.spec['repeats']}), quantize {st['quantize_us'][mi, 0]:.1f} "
              f"us, chips {int(st['chips_sum'][mi, 0])}", flush=True)
    print(f"phase 28: chips at M = {m_top} card == CPU {scale_cpu_equal}; {launches} alloc "
          f"launches; phase 28 took {phase_s:.1f} s", flush=True)
    return {"quickstart": {"allocation": quick_alloc, "total_flow": quick["total_flow_time"],
                           "fluid_optimum": fluid},
            "backlog": backlogs, "backlog_cpu_wall_s": cpu_wall, "backlog_cpu_vs_cuda": cpu_gap,
            "estimators": estimators, "cross_checks": checks, "cross_checks_s": checks_s,
            "sched_scale": {"ms": scale.spec["ms"],
                            "theta_us_median": np.median(st["theta_us"], axis=1).tolist(),
                            "theta_us": st["theta_us"].tolist(),
                            "quantize_us": st["quantize_us"][:, 0].tolist(),
                            "chips_sum": st["chips_sum"][:, 0].tolist(),
                            "cpu_equal_at_top": scale_cpu_equal},
            "alloc_launches": launches, "phase_s": phase_s}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    if not all((csrc / f).is_file()
               for f in ("alloc.cu", "flash_attention.cu", "ssd_scan.cu", "rglru_scan.cu")):
        print("chip_smoke: run it from a checkout of the repo (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import figures, lanes, sched
    from repro_torch.core import (
        analysis, arrivals, engine, flowtime, multiclass, policies, scenarios, simulator,
        superstep, sweeps, telemetry,
    )
    from repro_torch.launch import trace_export
    from repro_torch.kernels import alloc, chunked, flash_attention, ops, ref, rglru_scan, ssd_scan

    # Float32 products in full float32 (these are PyTorch's defaults, stated).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = _card()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    kernel_modules = (alloc, flash_attention, ssd_scan, rglru_scan)
    with ThreadPoolExecutor(len(kernel_modules)) as pool:  # one nvcc per source, together
        builds = [pool.submit(k.load_library) for k in kernel_modules]
        for b in builds:
            b.result()
    print(f"phase 1: built {alloc._SRC.name} in {alloc.BUILD_SECONDS:.2f} s "
          f"(nvcc {' '.join(alloc.NVCC_FLAGS)})", flush=True)

    max_err = phase_kernel_vs_plain(alloc, engine, device)
    per_cell_cases = phase_per_cell_p(alloc, device)
    results, launches = phase_lanes(alloc, lanes, device)
    cpu_gap = phase_cpu_vs_cuda(lanes, sweeps, engine, policies, device)
    thm8_gap = phase_theorem8(simulator, flowtime, policies, device)
    timing = phase_timing(alloc, device)
    print(f"phase 7: built {flash_attention._SRC.name} in "
          f"{flash_attention.BUILD_SECONDS:.2f} s (in parallel with phase 1's build)",
          flush=True)
    flash_err, flash_bf16_check, flash_f32_check = phase_flash_vs_plain(flash_attention, ref,
                                                                        device)
    serve, params, logits_f32 = phase_serve(flash_attention, device)
    bf16_serve = phase_serve_bf16(flash_attention, params, logits_f32, card, device)
    del params, logits_f32
    torch.cuda.empty_cache()
    serve_cpu_gap = phase_serve_cpu_vs_cuda(device)
    flash_timing = phase_flash_timing(flash_attention, ref, device)
    f32, bf16 = flash_timing["phi4-mini"]["float32"], flash_timing["phi4-mini"]["bfloat16"]
    print(f"phase 11: built {ssd_scan._SRC.name} in {ssd_scan.BUILD_SECONDS:.2f} s "
          "(in parallel with phase 1's build)", flush=True)
    ssd_err = phase_ssd_vs_plain(ssd_scan, chunked, ref, device)
    ssm_serve = phase_serve_ssm(ssd_scan, flash_attention, card, device)
    ssm_cpu_gap = phase_serve_cpu_vs_cuda(device, SSM_ARCH, phase=13)
    ssd_timing = phase_ssd_timing(ssd_scan, chunked, card, device)
    print(f"phase 15: built {rglru_scan._SRC.name} in {rglru_scan.BUILD_SECONDS:.2f} s "
          "(in parallel with phase 1's build)", flush=True)
    rglru_err = phase_rglru_vs_plain(rglru_scan, chunked, ref, ops, device)
    hybrid_serve = phase_serve_hybrid(rglru_scan, flash_attention, ssd_scan, card, device)
    hybrid_cpu_gap = phase_serve_cpu_vs_cuda(device, HYBRID_ARCH, phase=17)
    rglru_timing = phase_rglru_timing(rglru_scan, ref, card, device)
    wide_serve = phase_serve_wide(flash_attention, card, device)
    fig = phase_figures(alloc, figures, simulator, flowtime, superstep, policies, card, device)
    ss = phase_superstep(lanes, sweeps, superstep, flowtime, simulator, policies, card, device)
    drift = phase_drift(alloc, lanes, sweeps, engine, policies, card, device)
    snap = phase_snap_chunk_timing(alloc, lanes, sweeps, engine, policies,
                                   drift.pop("fused_result"), card, device)
    stream = phase_stream(alloc, lanes, sweeps, engine, scenarios, policies, card, device)
    tel = phase_telemetry(alloc, lanes, sweeps, engine, policies, telemetry, analysis,
                          trace_export, card, device)
    mc = phase_multiclass(alloc, lanes, sweeps, multiclass, arrivals, policies, card, device)
    cluster = phase_sched(alloc, lanes, sched, flowtime, policies, card, device)

    kernels = [{
        "name": "hesrpt_alloc",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/alloc.cu",
        "replaces": "src/repro/kernels/alloc.py:160",
        "launches": launches,
        "launches_fig4": fig["alloc_launches"],
        "launches_drift": drift["launches"]["drift-quantized-fused"],
        "launches_drift_bursty": drift["launches"]["bursty-drift-quantized-fused"],
        "ms_per_cell_p": snap["timing_ms"]["per_cell_p"],
        "plain_ms_per_cell_p": snap["timing_ms"]["plain_per_cell_p"],
        "bound_ms_per_cell_p": snap["bound_ms"],
        "per_cell_p_cases": per_cell_cases,
        "launches_stream": stream["launches"]["stream-quantized-fused"],
        "ms_stream": stream["timing_ms"]["ms"],
        "plain_ms_stream": stream["timing_ms"]["plain_ms"],
        "bound_ms_stream": stream["bound_ms"],
        "shape_stream": stream["shape"],
        "pool_width_cases": stream["pool_cases"],
        "launches_probe": tel["launches"]["fused_probe"],
        "launches_stream_probe": tel["launches"]["stream_fused_probe"],
        "ms_fig4": fig["alloc_ms"],
        "plain_ms_fig4": fig["alloc_plain_ms"],
        "bound_ms_fig4": fig["alloc_bound_ms"],
        "max_abs_err": max_err,
        "ms": timing["f64"]["ms"],
        "plain_ms": timing["f64"]["plain_ms"],
        "bound_ms": timing["f64"]["bound_ms"],
        "bound_by": timing["f64"]["bound_by"],
        "library_ms": None,
        "registers": timing["f64"]["registers"],
        "ctas_per_sm": timing["f64"]["ctas_per_sm"],
        "ms_f32": timing["f32"]["ms"],
        f"ms_{alloc.MAX_JOBS}": timing[f"f64_{alloc.MAX_JOBS}"]["ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:33",
        "launches": serve["flash_launches"],
        "max_abs_err": flash_err["float32"],
        "max_abs_err_bf16": flash_err["bfloat16"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "registers": f32["registers"],
        "ctas_per_sm": f32["ctas_per_sm"],
        "ms_recurrentgemma": flash_timing["recurrentgemma"]["float32"]["ms"],
        "launches_bf16": bf16_serve["flash_launches"],
        "ms_bf16": bf16["ms"],
        "plain_ms_bf16": bf16["plain_ms"],
        "bound_ms_bf16": bf16["bound_ms"],
        "library_ms_bf16": bf16["library_ms"],
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:29",
        "launches": ssm_serve["ssd_launches"],
        "max_abs_err": ssd_err["float32"]["y"],
        "max_abs_err_bf16": ssd_err["bfloat16"]["y"],
        "max_abs_err_state": ssd_err["float32"]["state"],
        "ms": ssd_timing["ms"],
        "plain_ms": ssd_timing["plain_ms"],
        "bound_ms": ssd_timing["bound_ms"],
        "bound_by": ssd_timing["bound_by"],
        "library_ms": None,
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:32",
        "launches": hybrid_serve["rglru_launches"],
        "max_abs_err": rglru_err["float32"]["y"],
        "max_abs_err_bf16": rglru_err["bfloat16"]["y"],
        "max_abs_err_state": rglru_err["float32"]["state"],
        "ms": rglru_timing["ms"],
        "plain_ms": rglru_timing["plain_ms"],
        "bound_ms": rglru_timing["bound_ms"],
        "bound_by": rglru_timing["bound_by"],
        "library_ms": None,
    }]
    detail = {
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": alloc.BUILD_SECONDS,
        "flash_build_s": flash_attention.BUILD_SECONDS,
        "ssd_build_s": ssd_scan.BUILD_SECONDS,
        "kernels": kernels,
        "timing": timing,
        "lanes": lanes.lane_records(results),
        "cpu_vs_cuda_max_rel": cpu_gap,
        "thm8_max_rel": thm8_gap,
        "flash_max_abs_err": flash_err,
        "flash_bf16_check": flash_bf16_check,
        "flash_f32_check": flash_f32_check,
        "flash_timing": flash_timing,
        "serve": serve,
        "bf16_serve": bf16_serve,
        "serve_cpu_vs_cuda_max_abs": serve_cpu_gap,
        "ssd_max_abs_err": ssd_err,
        "ssm_serve": ssm_serve,
        "ssm_cpu_vs_cuda_max_abs": ssm_cpu_gap,
        "ssd_timing": ssd_timing,
        "rglru_build_s": rglru_scan.BUILD_SECONDS,
        "rglru_max_abs_err": rglru_err,
        "hybrid_serve": hybrid_serve,
        "hybrid_cpu_vs_cuda_max_abs": hybrid_cpu_gap,
        "rglru_timing": rglru_timing,
        "wide_serve": wide_serve,
        "figures": fig,
        "superstep": ss,
        "drift": drift,
        "snap_chunk_timing": snap,
        "stream": stream,
        "telemetry": tel,
        "multiclass": mc,
        "sched": cluster,
        "total_s": time.perf_counter() - t_start,
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"total {detail['total_s']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
