"""Multi-pod dry run: trace every (arch x shape x mesh) cell on rank 0 of a
fake world.  Port of ``repro.launch.dryrun``, by intent: the reference
lowers and compiles each cell's jitted step for 256 or 512 fake devices and
reads the compiled per-device program; PyTorch has no HLO, so the port runs
the step once on fake DTensors and records rank 0's local aten ops
(``launch/trace_analysis.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape decode_32k --mesh single --out results/dryrun

- The fake world.  The process starts a default process group of 256
  (``pod16x16``) or 512 (``pod2x16x16``) ranks on a fake backend, which
  makes no communication, and builds ``make_production_mesh`` on it with
  ``device_type="cpu"``: the dry run needs no card.  The world is
  process-global (the reference sets ``XLA_FLAGS`` before any import for the
  same reason), so it is started inside :func:`run_cell`, never at import.
  The backend is ``torch.testing._internal.distributed.fake_pg``'s.
- State.  Parameters (bf16 where ``--bf16-params``, with float32 masters
  in the optimizer), optimizer state, batch and caches are fake tensors,
  placed by ``sharding.param_specs``, ``opt_state_specs``, ``batch_specs``
  and ``cache_specs_tree``; the inputs come from ``Model.input_specs`` /
  ``cache_specs``.
- What is traced, in place of lowering and compiling: one step of
  ``make_train_step`` (microbatches reduced until they divide the global
  batch), or ``prefill_fn``, or ``decode_fn`` (one token a row against
  caches that hold ``seq_len - 1``).
- The record, as the reference's: ``cost`` (the analyzer's flops and bytes,
  and ``FlopCounterMode``'s flops beside them, both per device),
  ``memory`` (``argument_size_in_bytes`` and ``output_size_in_bytes``, the
  local bytes of the step's inputs and results, and
  ``temp_size_in_bytes``, the peak of the bytes the step allocated and held
  at once: a count of tensor storages from the trace, not an allocator's
  figure), ``collectives`` and ``trace_analysis``; the trace itself is
  written beside the ``.json`` as ``<cell>.trace.jsonl.gz`` (in place of
  ``.hlo.txt.gz``).  Cells that ``cell_applicable`` refuses are recorded as
  skipped, failures as errors with their traceback.
- What cannot be traced is refused, with the reason, as an error: the
  hand-written kernels (``--attn-impl cuda``, ``--mixer-impl cuda``) are
  bound through ``ctypes`` and take raw pointers, which a dispatch mode
  cannot see and a fake tensor cannot give (on the CPU their wrappers would
  run the plain path instead); the ``ragged`` / ``ragged_local`` MoE
  dispatches read the group sizes on the host (``.tolist()``), which a fake
  tensor does not hold.  ``dense`` (the reference's default) and ``dense_ep``
  are traced.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPE_BY_NAME, SHAPES, cell_applicable, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import trace_analysis as ta
from repro_torch.models.common import ModelOptions, ParallelConfig
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.tree import leaves, tree_map

MESHES = {False: ("pod16x16", 256), True: ("pod2x16x16", 512)}

#: Options a fake trace cannot run, and why.
UNTRACEABLE = {
    ("attn_impl", "cuda"): "the flash kernel is bound through ctypes and takes raw pointers: "
                           "a dispatch mode cannot see it and a fake tensor has no data",
    ("mixer_impl", "cuda"): "the SSD and RG-LRU kernels are bound through ctypes and take raw "
                            "pointers: a dispatch mode cannot see them and a fake tensor has "
                            "no data",
    ("moe_impl", "ragged"): "the ragged dispatch reads its group sizes on the host "
                            "(.tolist()), which a fake tensor does not hold",
    ("moe_impl", "ragged_local"): "the ragged_local dispatch reads its group sizes on the host "
                                  "(.tolist()), which a fake tensor does not hold",
}


def start_fake_world(world_size: int) -> None:
    """This process as rank 0 of a ``world_size``-rank fake world (a running
    default group of another size is ended first)."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world_size)


def _fake(meta: torch.Tensor) -> torch.Tensor:
    return torch.empty(meta.shape, dtype=meta.dtype)


def _place(tree, specs, mesh):
    """Each leaf as a DTensor placed by its spec, split locally (no data is
    sent: every rank holds the same fake tensor), each local shard in a
    storage of its own, as a rank's would be."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, spec):
        d = distribute_tensor(t, mesh, sh.to_placements(spec, mesh), src_data_rank=None)
        return DTensor.from_local(d.to_local().clone(), mesh, d.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())

    return tree_map(place, tree, specs)


def check_traceable(**options) -> None:
    """Raise ``ValueError`` with the reason if an option cannot be traced."""
    for key, value in options.items():
        if (key, value) in UNTRACEABLE:
            raise ValueError(f"{key}={value!r} cannot be traced: {UNTRACEABLE[key, value]}")


def build_cell(arch, shape_name, mesh, *, microbatches: int = 8, moe_impl: str = "dense",
               remat: str = "full", attn_impl: str = "ref", mixer_impl: str = "ref",
               cast_bf16: bool = False, seq_shard: bool = False, bf16_params: bool = False):
    """``(fn, args)`` for one cell: ``fn(*args)`` runs the step on fake
    DTensors.  ``arch`` and ``shape_name`` name a config and a grid shape,
    or are a ``ModelConfig`` and a ``ShapeConfig`` themselves (a smoke
    config, a small shape).  Call it under ``FakeTensorMode``."""
    check_traceable(attn_impl=attn_impl, mixer_impl=mixer_impl, moe_impl=moe_impl)
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPE_BY_NAME[shape_name] if isinstance(shape_name, str) else shape_name
    parallel = ParallelConfig(mesh, mesh_lib.data_axes_of(mesh), mesh_lib.model_axis_of(mesh))
    opts = ModelOptions(attn_impl=attn_impl, mixer_impl=mixer_impl, moe_impl=moe_impl,
                        remat=remat, activation_dtype="bfloat16", parallel=parallel,
                        seq_shard=seq_shard)
    model = build_model(cfg, opts, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    if bf16_params:
        # mixed-precision layout: bf16 stored params + fp32 masters in opt
        params = tree_map(lambda t: t.to(torch.bfloat16)
                          if t.dtype == torch.float32 and t.dim() >= 2 else t, params)
    inputs = tree_map(_fake, model.input_specs(shape))

    if shape.kind == "train":
        while shape.global_batch % microbatches:
            microbatches -= 1
        tc = TrainConfig(microbatches=microbatches, cast_params_bf16=cast_bf16)
        opt_state = init_opt_state(params, keep_master=bf16_params)
        opt_state = _place(opt_state, sh.opt_state_specs(opt_state["m"], mesh, cfg,
                                                         keep_master=bf16_params), mesh)
        params = _place(params, sh.param_specs(params, mesh, cfg), mesh)
        return make_train_step(model, tc), (params, opt_state,
                                            _place(inputs, sh.batch_specs(inputs, mesh), mesh))
    params = _place(params, sh.param_specs(params, mesh, cfg), mesh)
    if shape.kind == "prefill":
        return model.prefill_fn, (params, _place(inputs, sh.batch_specs(inputs, mesh), mesh))
    caches = tree_map(_fake, model.cache_specs(shape))
    caches = _place(caches, sh.cache_specs_tree(caches, mesh), mesh)
    tokens = inputs["tokens"]
    tokens = _place(tokens, sh.spec_for(tokens.shape, ("batch", "seq"), mesh), mesh)
    return model.decode_fn, (params, tokens, caches, shape.seq_len - 1)


def _local_bytes(tree) -> int:
    """Bytes of the distinct local storages under ``tree``'s tensors."""
    from torch.distributed.tensor import DTensor

    seen = {}
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            st = (t._local_tensor if isinstance(t, DTensor) else t).untyped_storage()
            seen[st._cdata] = st.nbytes()
    return int(sum(seen.values()))


def trace_step(fn, args) -> tuple[dict, list]:
    """Run ``fn(*args)`` once under the trace mode and ``FlopCounterMode``
    (the trace mode innermost, so both see the local ops).  Returns the
    record's cost, memory and collectives, and the trace."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    with implicit_replication(), FlopCounterMode(display=False) as counter:
        with ta.TraceMode() as mode:
            out = fn(*args)
    trace = mode.trace
    deep = ta.analyze_trace(trace)
    rec = {
        "cost": {"flops": deep["flops"], "bytes accessed": deep["bytes"],
                 "flop_counter_flops": float(counter.get_total_flops())},
        "memory": {"argument_size_in_bytes": _local_bytes(args),
                   "output_size_in_bytes": _local_bytes(out),
                   "temp_size_in_bytes": deep["peak_live_bytes"]},
        "collectives": {"bytes": deep["collective_bytes"], "counts": deep["collective_counts"]},
        "trace_analysis": deep,
        "trace_ops": sum(1 for r in trace if "op" in r),
    }
    return rec, trace


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             microbatches: int = 8, moe_impl: str = "dense", remat: str = "full",
             attn_impl: str = "ref", mixer_impl: str = "ref", cast_bf16: bool = False,
             seq_shard: bool = False, bf16_params: bool = False,
             tag: str = "baseline") -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh_name, world = MESHES[multi_pod]
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{tag}"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "microbatches": microbatches, "moe_impl": moe_impl, "remat": remat,
        "attn_impl": attn_impl, "mixer_impl": mixer_impl,
        "cast_bf16": cast_bf16, "seq_shard": seq_shard,
        "bf16_params": bf16_params,
    }
    if not ok:
        rec.update(status="skipped", reason=why)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    t0 = time.time()
    try:
        check_traceable(attn_impl=attn_impl, mixer_impl=mixer_impl, moe_impl=moe_impl)
        start_fake_world(world)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        with FakeTensorMode():
            fn, args = build_cell(
                cfg, shape, mesh, microbatches=microbatches, moe_impl=moe_impl, remat=remat,
                attn_impl=attn_impl, mixer_impl=mixer_impl, cast_bf16=cast_bf16,
                seq_shard=seq_shard, bf16_params=bf16_params,
            )
            t_build = time.time() - t0
            traced, trace = trace_step(fn, args)
            t_trace = time.time() - t0 - t_build
        ta.write_trace(out_path.replace(".json", ".trace.jsonl.gz"), trace)
        rec.update(status="ok", build_s=round(t_build, 1), trace_s=round(t_trace, 1),
                   n_devices=mesh.size(), torch=torch.__version__, **traced)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on a fake world")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--moe-impl", default="dense")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--attn-impl", default="ref")
    ap.add_argument("--mixer-impl", default="ref")
    ap.add_argument("--cast-bf16", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    try:
        for multi_pod in meshes:
            for arch in archs:
                for shape_name in shapes:
                    rec = run_cell(
                        arch, shape_name, multi_pod=multi_pod, out_dir=args.out,
                        microbatches=args.microbatches, moe_impl=args.moe_impl,
                        remat=args.remat, attn_impl=args.attn_impl,
                        mixer_impl=args.mixer_impl, cast_bf16=args.cast_bf16,
                        seq_shard=args.seq_shard, bf16_params=args.bf16_params,
                        tag=args.tag,
                    )
                    status = rec["status"]
                    extra = ""
                    if status == "ok":
                        extra = (f" flops/dev={rec['cost']['flops']:.3e}"
                                 f" trace={rec['trace_s']}s")
                    elif status == "error":
                        extra = " " + rec["error"][:120]
                    print(f"[{status:7s}] {arch} x {shape_name} x "
                          f"{'multi' if multi_pod else 'single'}{extra}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
