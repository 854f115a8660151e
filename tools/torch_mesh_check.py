"""The port's mesh paths on several cards (or CPU ranks), against one device.

    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \
        tools/torch_mesh_check.py [--device cpu] [--smoke]

from the repo root: one process a card (``LOCAL_RANK``'s), the group started
by ``launch.mesh.start_group`` (``nccl`` on CUDA, ``gloo`` with ``--device
cpu``), rendezvous on the local host.  Every rank checks, and rank 0 prints:

1. sweep sharding: ``lanes.py``'s fused lane (24 rates x 8 seeds x 1000
   jobs, 256 chips; ``--smoke``: the smoke lane) through ``run_sweep(shard=
   True)`` on the seed axis and on the rate axis against the unsharded run
   on the same rank, bit for bit, with each run's alloc launches and wall;
2. the mesh MoE dispatches: the smoke qwen3-moe on a ``(n / 2, 2)`` mesh,
   ``ragged``, ``dense_ep`` and ``dense`` against the plain ``dense`` on
   one device, x ``(8, 16, d)``, within 2e-4;
3. the train step: phi4-mini at its published widths with 2 of 32 layers
   (``--smoke``: the smoke config), float32 activations, remat, batch 4 x
   1024 (``--smoke``: 4 x 64) from the stream, 2 steps through
   ``launch/train.py``'s pieces on the ``(n, 1)`` and the ``(n / 2, 2)``
   mesh, each against the plain step on one device from the same init: the losses within 1e-5, the
   grad norms and every parameter within 1e-4 relative (the zero-started
   leaves as one vector); each step's ms each way and the peak GB.

Writes ``chiprun_out/mesh_check.json`` (rank 0).  Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

STEP_REL, GRAD_REL, MOE_TOL = 1e-5, 1e-4, 2e-4


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    den = want.norm().item()
    return (got - want).norm().item() / (den if den else 1.0)


def check_sweeps(dev, smoke: bool) -> dict:
    from repro_torch import lanes
    from repro_torch.core import sweeps
    from repro_torch.kernels import alloc

    spec = dict(lanes.lane_specs(smoke=smoke))["quantized-fused"]
    out = {}
    for shard, axis in ((False, "seeds"), (True, "seeds"), (True, "rates")):
        _sync(dev)
        alloc.LAUNCHES = 0
        res = sweeps.run_sweep(spec, shard=shard, shard_axis=axis, device=dev)
        out["plain" if not shard else axis] = {"stats": res.stats, "wall_s": res.wall_s,
                                               "launches": alloc.LAUNCHES}
    plain = out["plain"]["stats"]["hesrpt"]
    for axis in ("seeds", "rates"):
        got = out[axis]["stats"]["hesrpt"]
        out[axis]["equal"] = all(np.array_equal(got[m], plain[m]) for m in plain)
    return {k: {kk: vv for kk, vv in v.items() if kk != "stats"} for k, v in out.items()}


def check_moe(dev, mesh) -> dict:
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import smoke_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import moe
    from repro_torch.models.common import ParallelConfig

    cfg = smoke_config("qwen3-moe-235b-a22b")
    gen = torch.Generator(device=dev).manual_seed(1)
    p = moe.moe_init(gen, cfg)
    x = torch.randn(8, 16, cfg.d_model, generator=gen, device=dev)
    y, aux = moe.moe_apply(p, x, cfg, impl="dense")
    par = ParallelConfig(mesh, ("data",), "model")
    spec = sh.param_specs({"stack": {"blocks": [{"sub0": {"mlp": p}}]}}, mesh,
                          cfg)["stack"]["blocks"][0]["sub0"]["mlp"]
    dp = sh.distribute({k: v.clone() for k, v in p.items()}, spec, mesh)
    dx = distribute_tensor(x, mesh, par.placements(Shard(0)))
    out = {}
    for impl in ("ragged", "dense_ep", "dense"):
        with implicit_replication():
            y_m, aux_m = moe.moe_apply(dp, dx, cfg, impl=impl, parallel=par)
        y_m, aux_m = y_m.full_tensor(), aux_m.full_tensor()
        out[impl] = {"max_abs": (y_m - y).abs().max().item(),
                     "aux_gap": abs(aux_m.item() - aux.item())}
    return out


def check_train(dev, meshes: dict, smoke: bool) -> dict:
    """The plain step on rank 0, then the step on each of ``meshes`` (by
    name), every gap against the plain one (rank 0's)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import make_stream_for
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.tree import leaves_with_paths, tree_map

    cfg = smoke_config("phi4-mini-3.8b") if smoke else get_config("phi4-mini-3.8b").scaled(
        n_layers=2)
    stream = make_stream_for(cfg, 64 if smoke else 1024, 4)
    lead = dist.get_rank() == 0
    runs = {}
    for way, mesh in ([("plain", None)] if lead else []) + list(meshes.items()):
        opts = dataclasses.replace(tlaunch.train_options(False, mesh), activation_dtype="float32")
        model = build_model(cfg, opts, device=dev)
        step_fn = tlaunch.make_step(model, steps=2)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        start = dict(leaves_with_paths(tree_map(torch.clone, params))) if mesh is None else None
        opt = init_opt_state(params)
        if mesh is not None:
            params, opt = tlaunch.shard_state(params, opt, cfg, mesh)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        log, ms = [], []
        for step in range(2):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(step).items()}
            if mesh is not None:
                batch = tlaunch.shard_batch(batch, mesh)
            _sync(dev)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            log.append((m["loss"].item(), m["grad_norm"].item()))
        if mesh is not None:
            params = tree_map(lambda t: t.full_tensor(), params)
        runs[way] = {"log": log, "ms": ms, "params": dict(leaves_with_paths(params)),
                     "start": start,
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                     if dev.type == "cuda" else None}
        del model, step_fn, opt, params
    out = {w: {"log": r["log"], "ms": r["ms"], "peak_gb": r["peak_gb"]} for w, r in runs.items()}
    if lead:
        plain = runs["plain"]
        zero = sorted(k for k, v in plain["start"].items() if not v.any())
        for way in meshes:
            got = runs[way]
            gaps = [_rel(got["params"][k], w) for k, w in plain["params"].items() if k not in zero]
            if zero:
                gaps.append(_rel(torch.cat([got["params"][k].flatten() for k in zero]),
                                 torch.cat([plain["params"][k].flatten() for k in zero])))
            out[way].update(
                loss_gap=max(abs(a[0] - b[0]) / abs(b[0])
                             for a, b in zip(got["log"], plain["log"])),
                grad_norm_gap=max(abs(a[1] - b[1]) / abs(b[1])
                                  for a, b in zip(got["log"], plain["log"])),
                param_gap=max(gaps))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_lib

    dev = resolve_device(args.device)
    mesh_lib.start_group(dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    n, rank = dist.get_world_size(), dist.get_rank()
    lead = rank == 0
    if lead and dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip().splitlines()[0], f"x {n}", flush=True)
    if dev.type == "cuda":
        from repro_torch.kernels import alloc

        alloc.load_library()
    t0 = time.perf_counter()
    out = {"ranks": n, "device": str(dev),
           "sweeps": check_sweeps(dev, args.smoke),
           "moe": check_moe(dev, mesh_lib.make_mesh((n // 2, 2), ("data", "model"),
                                                    device_type=dev.type)),
           "train": check_train(dev, {
               f"({n}, 1)": mesh_lib.make_mesh((n, 1), ("data", "model"), device_type=dev.type),
               f"({n // 2}, 2)": mesh_lib.make_mesh((n // 2, 2), ("data", "model"),
                                                    device_type=dev.type)}, args.smoke)}
    out["seconds"] = time.perf_counter() - t0
    sw, moe, tr = out["sweeps"], out["moe"], out["train"]
    # ragged's aux is the mean of the shards' own (the reference's), not dense's
    ok = (all(sw[a]["equal"] for a in ("seeds", "rates"))
          and all(r["max_abs"] <= MOE_TOL and (impl == "ragged" or r["aux_gap"] <= 1e-6)
                  for impl, r in moe.items()))
    if lead:
        meshes = [w for w in tr if w != "plain"]
        ok = ok and all(tr[w]["loss_gap"] <= STEP_REL and tr[w]["grad_norm_gap"] <= GRAD_REL
                        and tr[w]["param_gap"] <= GRAD_REL for w in meshes)
        for k, v in sw.items():
            print(f"sweeps {k}: wall {v['wall_s']:.3f} s, alloc launches {v['launches']}"
                  + (f", == unsharded bit for bit: {v['equal']}" if "equal" in v else ""),
                  flush=True)
        for impl, r in moe.items():
            print(f"moe {impl} on ({n // 2}, 2): max |y - dense| {r['max_abs']:.3e}, "
                  f"|aux - dense's| {r['aux_gap']:.3e}", flush=True)
        for way, r in tr.items():
            print(f"train {way}: losses {[round(l, 6) for l, _ in r['log']]}, ms a step "
                  f"{[round(t, 1) for t in r['ms']]}, peak GB {r['peak_gb']}"
                  + ("" if way == "plain" else
                     f"; against one device: loss {r['loss_gap']:.3e}, grad norm "
                     f"{r['grad_norm_gap']:.3e}, parameters {r['param_gap']:.3e}"), flush=True)
        print(f"{out['seconds']:.1f} s; ok {ok}", flush=True)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "mesh_check.json").write_text(json.dumps(out, indent=1))
    flag = torch.tensor([int(ok)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    dist.destroy_process_group()
    return 0 if flag.item() else 1


if __name__ == "__main__":
    sys.exit(main())
