"""Multi-job heSRPT-scheduled elastic cluster driver (the paper, end to
end).  Port of ``repro.launch.cluster_train``.

    python -m repro_torch.launch.cluster_train --device cpu --devices 8
    python -m repro_torch.launch.cluster_train
    torchrun --nproc-per-node 4 -m repro_torch.launch.cluster_train

Builds a set of training jobs with known sizes (the smoke config of
``--arch``, job i seeded with i), lets the heSRPT scheduler allocate chips
and resize the jobs at every departure epoch (``sched/elastic.py``), and
compares the achieved flow time with the paper's closed form (Thm 8).

The chip pool is ``--devices`` ranks of a process group:

- under ``torchrun`` (``RANK`` set) the world is the pool, ``nccl`` on the
  card (``--device cpu``: ``gloo``); ``--devices`` defaults to the world
  size and may not exceed it, nor the visible cards;
- ``--device cpu`` without ``torchrun`` spawns ``--devices`` (default 8,
  the reference's fake CPU devices) ``gloo`` ranks, each a fresh
  interpreter on one thread with a file-store rendezvous in a temporary
  directory; a rank that fails, or a run longer than ``--timeout``
  seconds, fails the launch;
- ``--device cuda`` without ``torchrun`` runs a 1-rank ``nccl`` world on
  the card.

Rank 0 prints what the reference prints.  ``--ckpt-root`` must be on a
file system every rank shares: a resize goes through it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import smoke_config
from repro_torch.core.flowtime import hesrpt_total_flowtime
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sched.elastic import ElasticClusterDriver, ElasticJobConfig

SPAWN_DEVICES = 8  # the reference's default pool of fake CPU devices


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks in the chip pool (default: the world under torchrun, "
                         f"{SPAWN_DEVICES} spawned on the CPU, 1 on a card)")
    ap.add_argument("--policy", default="hesrpt")
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--sizes", type=int, nargs="*", default=[40, 24, 12, 6])
    ap.add_argument("--ckpt-root", default=os.path.join(tempfile.gettempdir(),
                                                        "repro_torch_cluster"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous of a multi-rank run (default env://, as torchrun sets)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the spawned CPU ranks may take")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    argv = sys.argv[1:] if argv is None else list(argv)
    return run_in_world(
        lambda device, n: _run(args, device, n), args.device, devices=args.devices,
        init_method=args.init_method, timeout=args.timeout,
        relaunch=[sys.executable, "-m", "repro_torch.launch.cluster_train", *argv],
    )


def run_in_world(run, device="cuda", *, devices: int | None = None,
                 init_method: str | None = None, timeout: float = 600.0, relaunch: list):
    """Start the chip pool's world and call ``run(device, n)`` on every rank
    of the pool of ``n`` ranks (the module doc's three ways); returns what
    ``run`` returns, or None where this process only spawned the ranks.

    ``relaunch`` is the command that runs this launcher again with the
    caller's arguments: each spawned CPU rank runs it with ``--devices n
    --init-method file://...`` appended and ``RANK`` set.
    """
    device = resolve_device(device)
    if "RANK" in os.environ:  # under torchrun, or a rank this launcher spawned
        world = int(os.environ["WORLD_SIZE"])
        n = world if devices is None else devices
        if not 1 <= n <= world:
            raise ValueError(f"--devices {n} over a world of {world} ranks")
        if device.type == "cuda" and n > torch.cuda.device_count():
            raise ValueError(f"--devices {n} over {torch.cuda.device_count()} visible cards")
        mesh_lib.start_group(device.type, init_method=init_method)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        try:
            return run(device, n)
        finally:
            dist.destroy_process_group()
    if device.type == "cpu":
        return _spawn(relaunch, SPAWN_DEVICES if devices is None else devices, timeout)
    n = 1 if devices is None else devices
    if n != 1:
        raise ValueError(f"--devices {n} on one card without torchrun: run it under torchrun")
    if device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        return run(torch.device("cuda", torch.cuda.current_device()), 1)
    finally:
        dist.destroy_process_group()


def _spawn(relaunch: list, n: int, timeout: float) -> None:
    """``n`` ``gloo`` ranks of ``relaunch`` (``mesh.spawn_ranks``); rank
    0's output is printed.  Raises if a rank fails or time runs out."""
    if n < 1:
        raise ValueError(f"--devices {n}")
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as d:
        cmd = [*relaunch, "--devices", str(n), "--init-method", f"file://{d}/store"]
        outs = mesh_lib.spawn_ranks(cmd, n, d, timeout=timeout, env={"PYTHONPATH": path})
    print(outs[0], end="", flush=True)


def _run(args, device: torch.device, n: int) -> dict:
    """The reference's run on the pool of ranks ``0..n-1``; rank 0 prints."""
    cfg = smoke_config(args.arch)
    jobs = [ElasticJobConfig(f"job{i}", cfg, total_steps=s, p=args.p, seed=i)
            for i, s in enumerate(args.sizes)]
    driver = ElasticClusterDriver(jobs, list(range(n)), policy=args.policy,
                                  ckpt_root=args.ckpt_root, device=device)
    res = driver.run()
    x_desc = torch.tensor(sorted((float(s) for s in args.sizes), reverse=True),
                          dtype=torch.float64, device=device)
    closed = float(hesrpt_total_flowtime(x_desc, args.p, float(n)))
    if dist.get_rank() == 0:
        print(f"policy={args.policy} devices={n} p={args.p}")
        print(f"  total flow time (achieved): {res['total_flow_time']:.3f}")
        print(f"  total flow time (heSRPT fluid optimum): {closed:.3f}")
        print(f"  resizes: {res['resizes']}")
        for jid, losses in res["losses"].items():
            print(f"  {jid}: loss {losses[0]:.3f} -> {losses[-1]:.3f} ({len(losses)} steps)")
        for a in res["allocations"]:
            print(f"  t={a['t']:.2f} alloc={a['alloc']}")
        sys.stdout.flush()
    return res


if __name__ == "__main__":
    main()
