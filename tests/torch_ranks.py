"""Spawned ``gloo`` ranks for the port's multi-rank tests on the CPU.

Each rank is a fresh interpreter (as ``tests/test_distribution.py`` runs its
JAX bodies) on one thread, with the default process group started through a
file store under the test's directory (no port), a timeout of
``SPAWN_TIMEOUT`` seconds a spawn and a traceback dump 5 s before it.  A
rank that fails ends the others and fails the spawn; its stderr tail is in
the error's message, its whole output in ``out{r}`` / ``err{r}`` of the
directory.  The spawner is the port's (``launch/mesh.py::spawn_ranks``), as
``launch/cluster_train.py`` spawns its CPU ranks.  The rank's body sees
``RANK``, ``WORLD``, ``dist`` and ``D``, the directory.
"""

import sys
import textwrap
from pathlib import Path

from repro_torch.launch.mesh import spawn_ranks

SRC = Path(__file__).resolve().parent.parent / "src"
SPAWN_TIMEOUT = 120

_PRELUDE = """
import faulthandler, os, sys
faulthandler.dump_traceback_later({dump}, exit=True)
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
D = os.environ["RANKS_TEST_DIR"]
dist.init_process_group("gloo", init_method="file://" + D + "/store", rank=RANK,
                        world_size=WORLD)
"""


def run_ranks(body: str, n: int, d: Path) -> list[str]:
    """``body`` on ``n`` ranks (``repro_torch.launch.mesh.spawn_ranks``);
    returns each rank's stdout.  Every rank must exit 0 within
    ``SPAWN_TIMEOUT`` seconds; one that fails ends the others."""
    script = (textwrap.dedent(_PRELUDE).format(dump=SPAWN_TIMEOUT - 5, src=str(SRC))
              + textwrap.dedent(body))
    return spawn_ranks([sys.executable, "-c", script], n, d, timeout=SPAWN_TIMEOUT,
                       env={"RANKS_TEST_DIR": str(d), "PYTHONPATH": str(SRC)})
