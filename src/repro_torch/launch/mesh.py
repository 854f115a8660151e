"""Device meshes over a process group.  Port of ``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
whose dimension names are the reference's axis names:

  single-pod: (16, 16)    axes ("data", "model")
  multi-pod:  (2, 16, 16) axes ("pod", "data", "model")

A mesh needs a default process group that the caller started
(:func:`start_group`, or ``torch.distributed.init_process_group``
itself): no function here starts one on its own, and a mesh whose size is
not the group's world size raises.  Multi-rank code runs ``nccl`` on CUDA
and ``gloo`` on the CPU (:data:`BACKENDS`).
"""

from __future__ import annotations

import os
import subprocess
import time

import torch
import torch.distributed as dist

#: The process-group backend of each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def start_group(device_type: str = "cuda", *, init_method: str | None = None) -> None:
    """Start the default process group with the backend of ``device_type``,
    this rank ``RANK`` of ``WORLD_SIZE`` (as ``torchrun`` sets them).

    The rendezvous is ``init_method`` (``env://`` without one:
    ``MASTER_ADDR`` and ``MASTER_PORT``).  On CUDA the rank's card is
    ``LOCAL_RANK``'s, modulo the visible cards.  A group that fails to start
    raises."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, got {device_type!r}")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[device_type], init_method=init_method, rank=rank,
                            world_size=world)


def spawn_ranks(cmd: list, n: int, d, *, timeout: float, env: dict | None = None) -> list[str]:
    """Run ``cmd`` as ranks ``0..n-1`` of one world on the CPU: ``n``
    subprocesses on one thread each (``OMP_NUM_THREADS=1``), with ``RANK``,
    ``LOCAL_RANK`` and ``WORLD_SIZE`` set and ``env`` added, each writing to
    ``d/out{r}`` and ``d/err{r}``.  The rendezvous is the caller's (a file
    store under ``d`` needs no port).  Returns each rank's stdout.  A rank
    that fails ends the others; it, or ``timeout`` seconds passing, raises
    ``RuntimeError`` with the failed ranks' stderr tails."""
    procs = []
    try:
        for r in range(n):
            rank_env = {**os.environ, **(env or {}), "RANK": str(r), "LOCAL_RANK": str(r),
                        "WORLD_SIZE": str(n), "OMP_NUM_THREADS": "1"}
            with open(f"{d}/out{r}", "w") as out, open(f"{d}/err{r}", "w") as err:
                procs.append(subprocess.Popen(cmd, env=rank_env, stdout=out, stderr=err))
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs, bad = [], []
    for r, p in enumerate(procs):
        with open(f"{d}/out{r}") as out:
            outs.append(out.read())
        if p.returncode:
            with open(f"{d}/err{r}") as err:
                bad.append(f"rank {r} exited {p.returncode}:\n{err.read()[-4000:]}")
    if bad:
        raise RuntimeError(f"{len(bad)} of {n} ranks failed\n" + "\n".join(bad))
    return outs


def _require_group(n: int | None = None) -> None:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a default process group: start one first "
                           "(launch.mesh.start_group or torch.distributed.init_process_group)")
    if n is not None and n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks over a world of {dist.get_world_size()}")


def make_mesh(shape: tuple, axes: tuple, *, device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over every rank of the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    _require_group(n)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_job_mesh(ranks, *, model_parallel: int = 1, device_type: str = "cuda"):
    """Mesh over an explicit rank subset, laid out ``(n // model_parallel,
    model_parallel)`` as ``("data", "model")``: what the heSRPT cluster
    scheduler hands each elastic job.  ``len(ranks)`` must be divisible by
    ``model_parallel``.  Every rank of the default group calls it (its
    subgroups are made collectively)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = len(ranks)
    assert n % model_parallel == 0, (n, model_parallel)
    _require_group()
    arr = torch.tensor(list(ranks), dtype=torch.int64).reshape(n // model_parallel,
                                                               model_parallel)
    return DeviceMesh(device_type, arr, mesh_dim_names=("data", "model"))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any object whose
    ``shape`` is already such a mapping (the reference's meshes)."""
    shape = mesh.shape
    if hasattr(shape, "items"):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(axis_sizes(mesh))


def data_axes_of(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis_of(mesh) -> str:
    return "model"
