"""The paper end to end on the PyTorch port: heSRPT schedules elastic
training jobs on a chip pool, resizing them at every departure epoch.

    PYTHONPATH=src python examples/train_cluster_elastic_torch.py   # one card
    PYTHONPATH=src python examples/train_cluster_elastic_torch.py --device cpu   # 8 ranks
    PYTHONPATH=src python examples/train_cluster_elastic_torch.py --policy equi  # compare

Four real training jobs with known sizes (total steps) share the pool. The
heSRPT allocation gives the smallest job the largest share (Theorem 7's
counter-intuitive split), departures trigger checkpoint -> remesh ->
restore resizes (``sched/elastic.py``), and the achieved total flow time is
compared against the paper's fluid-optimum closed form.  The pool's world
starts as ``launch/cluster_train.py`` starts it: ``--devices`` (default 8)
spawned ``gloo`` ranks with ``--device cpu``, a 1-rank ``nccl`` world on
one card, or the world under ``torchrun``.  Rank 0 prints the lines of
``examples/train_cluster_elastic.py``.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import hesrpt_total_flowtime  # noqa: E402
from repro_torch.launch.cluster_train import run_in_world  # noqa: E402
from repro_torch.sched import ElasticClusterDriver, ElasticJobConfig  # noqa: E402


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--policy", default="hesrpt", choices=["hesrpt", "equi", "srpt", "helrpt"])
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--sizes", type=int, nargs="*", default=[32, 16, 8, 4])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks in the pool (default: 8 spawned on the CPU, 1 on a card, "
                         "the world under torchrun)")
    ap.add_argument("--ckpt-root", default=os.path.join(tempfile.gettempdir(),
                                                        "repro_torch_elastic"),
                    help="on a file system every rank shares: a resize goes through it")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous of a multi-rank run (default env://, as torchrun sets)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the spawned CPU ranks may take")
    return ap


def run_pool(args, device: torch.device, n: int) -> dict:
    """The four jobs on the pool of ranks ``0..n-1``; rank 0 prints."""
    cfg = smoke_config("phi4-mini-3.8b")
    jobs = [ElasticJobConfig(f"job{i}", cfg, total_steps=s, p=args.p, seed=i)
            for i, s in enumerate(args.sizes)]
    driver = ElasticClusterDriver(jobs, list(range(n)), policy=args.policy,
                                  ckpt_root=args.ckpt_root, device=device)
    res = driver.run()
    x = torch.tensor(sorted(map(float, args.sizes), reverse=True), dtype=torch.float64,
                     device=device)
    res["closed"] = float(hesrpt_total_flowtime(x, args.p, float(n)))
    if dist.get_rank() == 0:
        print(f"\npolicy={args.policy}  p={args.p}  devices={n}")
        print(f"achieved total flow time : {res['total_flow_time']:.3f}")
        print(f"heSRPT fluid optimum     : {res['closed']:.3f}")
        print(f"resizes (ckpt->remesh->restore): {res['resizes']}")
        for jid, losses in res["losses"].items():
            print(f"  {jid}: loss {losses[0]:.3f} -> {losses[-1]:.3f} ({len(losses)} steps)")
        print("allocation trace:")
        for a in res["allocations"]:
            print(f"  t={a['t']:6.2f}  {a['alloc']}")
        sys.stdout.flush()
    return res


def main(argv=None):
    args = _parser().parse_args(argv)
    argv = sys.argv[1:] if argv is None else list(argv)
    return run_in_world(
        lambda device, n: run_pool(args, device, n), args.device, devices=args.devices,
        init_method=args.init_method, timeout=args.timeout,
        relaunch=[sys.executable, os.path.abspath(__file__), *argv],
    )


if __name__ == "__main__":
    main()
