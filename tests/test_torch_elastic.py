"""Elastic jobs under the heSRPT scheduler (``repro_torch.sched.elastic``,
``launch/cluster_train.py``) against the JAX package's
``tests/test_distribution.py::test_elastic_cluster_end_to_end`` instance.

One JAX subprocess with 8 fake devices runs the reference's driver on the
smoke phi4-mini (sizes 24, 12, 6; p 0.5; seeds 0-2; j1 int8) and dumps its
allocation log, the devices it hands each job at every epoch, the resizes,
the flows, the per-step losses and, before it trains, each job's first
parameters.  Then one spawn of 8 ``gloo`` ranks (``tests/torch_ranks.py``)
runs the port's driver from those parameters
(``models/convert.params_from_jax``).  Held: the chips and each job's ranks at every
epoch exactly, the epoch times and flows within 1e-12 relative, the
resizes, the losses of j0 and j2 within ``LOSS_REL`` = 1e-4 relative at
every step and j1's (int8) within ``INT8_LOSS_REL`` = 1e-3 (largest gaps
measured: 9.2e-8 for j0, 8.6e-8 for j2, 6.0e-5 for j1, where a gradient an
ulp apart can round a payload element to the next integer), and the first
rank's error state on every member after a resize.  The epoch times and
flows measured equal JAX's bit for bit.  Also the 1-device instance with no
process group, and the CLI on 8 spawned ranks.
"""

import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.flowtime import hesrpt_total_flowtime  # noqa: E402
from repro_torch.launch import cluster_train  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.sched import ElasticClusterDriver, ElasticJobConfig  # noqa: E402
from torch_ranks import SPAWN_TIMEOUT, SRC, run_ranks  # noqa: E402

ARCH, SIZES, P, N = "phi4-mini-3.8b", (24, 12, 6), 0.5, 8
FLOW_REL, LOSS_REL, INT8_LOSS_REL = 1e-12, 1e-4, 1e-3

_JAX = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.core import hesrpt_total_flowtime
from repro.sched import ElasticClusterDriver, ElasticJobConfig, elastic

D = sys.argv[1]
cfg = smoke_config({arch!r})
jobs = [ElasticJobConfig(f"j{{i}}", cfg, total_steps=s, p={p}, seed=i,
                         compression="int8" if i == 1 else None)
        for i, s in enumerate({sizes})]
calls = []
ensure = elastic.ElasticJob.ensure_devices

def spy(self, devices):
    calls.append((len(driver.allocation_log), self.cfg.job_id, [d.id for d in devices]))
    ensure(self, devices)

elastic.ElasticJob.ensure_devices = spy
driver = ElasticClusterDriver(jobs, jax.devices(), policy="hesrpt", ckpt_root=D + "/jax_ckpt")
init = {{jid: jax.tree.map(np.asarray, job.state["params"]) for jid, job in driver.jobs.items()}}
with open(D + "/params.pkl", "wb") as f:
    pickle.dump(init, f)
res = driver.run()
res["calls"] = calls
res["closed"] = float(hesrpt_total_flowtime(
    jnp.asarray(sorted(map(float, {sizes}), reverse=True)), {p}, float({n})))
with open(D + "/jax.pkl", "wb") as f:
    pickle.dump(res, f)
"""

_BODY = """
from repro_torch.configs import smoke_config
from repro_torch.sched import elastic
from repro_torch.train.tree import leaves

inp = torch.load(D + "/in.pt")
cfg = smoke_config(inp["arch"])
jobs = [elastic.ElasticJobConfig(f"j{i}", cfg, total_steps=s, p=inp["p"], seed=i,
                                 compression="int8" if i == 1 else None)
        for i, s in enumerate(inp["sizes"])]
snaps = []
ensure = elastic.ElasticJob.ensure_devices

def err_of(job):
    return torch.cat([t.reshape(-1) for t in leaves(job.state["err"])]).clone()

def spy(self, devices):
    old = self.devices
    resize = bool(old) and tuple(devices) != old
    if resize and RANK in old:
        snaps.append(("before", self.cfg.job_id, old, err_of(self)))
    ensure(self, devices)
    if resize and RANK in self.devices:
        snaps.append(("after", self.cfg.job_id, self.devices, err_of(self)))

elastic.ElasticJob.ensure_devices = spy
driver = elastic.ElasticClusterDriver(jobs, policy="hesrpt", ckpt_root=D + "/ckpt",
                                      params=inp["params"], device="cpu")
res = driver.run()
torch.save({"res": res, "snaps": snaps}, D + f"/out{RANK}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's 8-device run, then the port's 8 ranks from its first parameters
    (one after the other: each has the cores, and its own time limit)."""
    d = tmp_path_factory.mktemp("elastic")
    script = _JAX.format(n=N, src=str(SRC), arch=ARCH, p=P, sizes=list(SIZES))
    jax_run = subprocess.run([sys.executable, "-c", script, str(d)], capture_output=True,
                             text=True, timeout=SPAWN_TIMEOUT)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    with open(d / "params.pkl", "rb") as f:
        init = pickle.load(f)
    cfg = tconfigs.smoke_config(ARCH)
    params = {jid: params_from_jax(tree, cfg, device="cpu") for jid, tree in init.items()}
    torch.save({"arch": ARCH, "sizes": SIZES, "p": P, "params": params}, d / "in.pt")
    run_ranks(_BODY, N, d)
    with open(d / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    got = [torch.load(d / f"out{r}.pt") for r in range(N)]
    return want, got


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def test_every_rank_keeps_the_same_bookkeeping(runs):
    """All 8 ranks return the same log, flows, resizes and losses."""
    _, got = runs
    first = got[0]["res"]
    for out in got[1:]:
        assert out["res"] == first


def test_chips_and_ranks_at_every_epoch_equal_jax(runs):
    """The chips of every job at every epoch, exactly, and the ranks each
    job holds: the reference's devices, contiguous, largest allocation first."""
    want, got = runs
    log, want_log = got[0]["res"]["allocations"], want["allocations"]
    assert [a["alloc"] for a in log] == [a["alloc"] for a in want_log]
    assert [a["alloc"] for a in log] == [{"j0": 2, "j1": 2, "j2": 4}, {"j0": 2, "j1": 6},
                                         {"j0": 8}]
    want_ranks = [{} for _ in want_log]
    for epoch, jid, ids in want["calls"]:
        want_ranks[epoch][jid] = tuple(ids)
    assert [a["ranks"] for a in log] == want_ranks
    assert log[1]["ranks"] == {"j1": (0, 1, 2, 3, 4, 5), "j0": (6, 7)}


def test_epoch_times_flows_and_resizes_equal_jax(runs):
    want, got = runs
    res = got[0]["res"]
    for a, w in zip(res["allocations"], want["allocations"], strict=True):
        assert a["t"] == w["t"] or _rel(a["t"], w["t"]) <= FLOW_REL, (a["t"], w["t"])
    for key in ("total_flow_time", "mean_flow_time", "makespan"):
        assert _rel(res[key], want[key]) <= FLOW_REL, (key, res[key], want[key])
    assert res["resizes"] == want["resizes"] == {"j0": 2, "j1": 1, "j2": 0}


def test_losses_at_every_step_match_jax(runs):
    """j0 and j2 within ``LOSS_REL``, j1 (int8) within ``INT8_LOSS_REL``, at
    every step."""
    want, got = runs
    losses = got[0]["res"]["losses"]
    for jid, bar in (("j0", LOSS_REL), ("j1", INT8_LOSS_REL), ("j2", LOSS_REL)):
        assert len(losses[jid]) == len(want["losses"][jid]) == SIZES[int(jid[1])]
        gap = max(_rel(a, b) for a, b in zip(losses[jid], want["losses"][jid], strict=True))
        assert gap <= bar, (jid, gap)


def test_a_resize_hands_every_member_the_first_ranks_error(runs):
    """Before j1's resize its members (ranks 6 and 7) hold errors of their
    own; after it every new member (0-5) holds rank 6's, exactly; the
    uncompressed jobs' errors stay zero."""
    _, got = runs
    before = {r: s[3] for r, out in enumerate(got) for s in out["snaps"]
              if s[0] == "before" and s[1] == "j1"}
    after = {r: s[3] for r, out in enumerate(got) for s in out["snaps"]
             if s[0] == "after" and s[1] == "j1"}
    assert sorted(before) == [6, 7] and sorted(after) == [0, 1, 2, 3, 4, 5]
    assert before[6].abs().max() > 0 and not torch.equal(before[6], before[7])
    for r, e in after.items():
        assert torch.equal(e, before[6]), r
    for out in got:
        for s in out["snaps"]:
            if s[1] != "j1":
                assert not s[3].any(), s[:3]


def test_the_reference_tests_own_asserts(runs):
    """``test_elastic_cluster_end_to_end``'s: the gap to the closed form
    below 0.35, at least 2 resizes, every job's loss falls."""
    want, got = runs
    res = got[0]["res"]
    closed = float(hesrpt_total_flowtime(torch.tensor(sorted(map(float, SIZES), reverse=True),
                                                      dtype=torch.float64), P, float(N)))
    assert abs(closed - want["closed"]) <= 1e-6 * closed
    assert res["total_flow_time"] / closed - 1 < 0.35
    assert sum(res["resizes"].values()) >= 2
    for jid, losses in res["losses"].items():
        assert losses[-1] < losses[0], jid


def _jobs(compression=None):
    cfg = tconfigs.smoke_config(ARCH)
    return [ElasticJobConfig(f"j{i}", cfg, total_steps=s, p=P, seed=i,
                             compression=compression if i == 1 else None)
            for i, s in enumerate(SIZES)]


def test_one_device_without_a_group(tmp_path):
    """The table's 1-device instance in this process, no process group: one
    job at a time, shortest first (t 0, 6, 18), total flow 66, no resize.
    On one thread: the smoke model's ops are too small to share, and the
    suite's other workers hold the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = ElasticClusterDriver(_jobs("int8"), ckpt_root=str(tmp_path), device="cpu").run()
    finally:
        torch.set_num_threads(threads)
    assert [(a["t"], a["alloc"], a["ranks"]) for a in res["allocations"]] == [
        (0.0, {"j0": 0, "j1": 0, "j2": 1}, {"j2": (0,)}),
        (6.0, {"j0": 0, "j1": 1}, {"j1": (0,)}),
        (18.0, {"j0": 1}, {"j0": (0,)})]
    assert res["total_flow_time"] == 66.0 and res["makespan"] == 42.0
    assert res["resizes"] == {"j0": 0, "j1": 0, "j2": 0}
    for jid, losses in res["losses"].items():
        assert len(losses) == SIZES[int(jid[1])] and losses[-1] < losses[0], jid


def test_refusals(tmp_path, monkeypatch):
    """Ranks without a group, an unknown scheme and more devices than the
    world raise; nothing falls back."""
    with pytest.raises(ValueError, match="not ranks of a world of 1"):
        ElasticClusterDriver(_jobs(), [0, 1], ckpt_root=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="unknown compression scheme 'fp4'"):
        ElasticClusterDriver(_jobs("fp4"), ckpt_root=str(tmp_path), device="cpu").run()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--devices 3 over a world of 2"):
        cluster_train.main(["--device", "cpu", "--devices", "3"])


def test_cli_on_eight_spawned_ranks_prints_the_reference_log(runs, tmp_path):
    """``python -m repro_torch.launch.cluster_train --device cpu --devices 8
    --sizes 24 12 6 --p 0.5`` prints JAX's 8-device allocation log, its
    resizes and the closed form."""
    want, _ = runs
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster_train", "--device", "cpu",
         "--devices", str(N), "--sizes", *map(str, SIZES), "--p", str(P),
         "--ckpt-root", str(tmp_path), "--timeout", str(SPAWN_TIMEOUT)],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT + 30)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    rename = {f"j{i}": f"job{i}" for i in range(len(SIZES))}
    log = [f"  t={a['t']:.2f} alloc={ {rename[j]: int(c) for j, c in a['alloc'].items()} }"
           for a in want["allocations"]]
    assert lines[-len(log):] == log
    assert f"  total flow time (achieved): {want['total_flow_time']:.3f}" in lines
    assert f"  total flow time (heSRPT fluid optimum): {want['closed']:.3f}" in lines
    assert "  resizes: {'job0': 2, 'job1': 1, 'job2': 0}" in lines
    assert lines[0] == f"policy=hesrpt devices={N} p={P}"
