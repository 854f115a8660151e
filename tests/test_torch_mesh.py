"""The port's mesh paths on the CPU, over ``gloo``: the sharded train step,
checkpoints across mesh shapes, the mesh MoE dispatches, sweep sharding and
``launch/train.py`` on two ranks.

Each rank is a subprocess (as ``tests/test_distribution.py`` runs its JAX
bodies), with one thread, a rendezvous through a file store under the
test's temporary directory (no port), a timeout of at most 120 s a spawn and
a traceback dump just before it; a rank that fails fails the spawn.  The
checks are grouped into five spawns, each a module fixture whose results
the tests below read: A, 8 ranks on ``(4, 2)`` (the train step, a
checkpoint save); M, 8 ranks on ``(4, 2)`` (the MoE dispatches); B, 8 ranks
on ``(2, 2, 2)`` (the smoke mixtral's step); C, 2 ranks (the restore onto
``(2, 1)``, sweeps, the training CLI); D, 4 ranks (sweeps, job meshes).
The references run before their spawn, so the ranks have the cores.  The ranks import no JAX: the main
process draws the JAX package's parameters and runs its references.

Bars: the train steps are held as ``tests/test_torch_train.py``'s
``test_train_step_matches_jax`` holds one step (loss 1e-5, grad norm, ``m``
and every parameter leaf 1e-4 relative, the zero-initialized leaves
together as one vector: ROADMAP.md Queue C), against the port's
single-process step and JAX's single-device step; the MoE dispatches
within 2e-4 of ``dense`` (the JAX test's bar) and ``ragged``'s ``aux``
within 1e-6 of JAX's ``ragged`` ``aux`` from its own 8-fake-device run;
the checkpoint and the sweeps bit for bit; the CLI's printed losses within
1e-5.
"""

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import sweeps as js  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.moe import moe_init as jax_moe_init  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer, train_step  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402
from torch_ranks import SPAWN_TIMEOUT, run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
STEP_REL, GRAD_REL, MOE_TOL, AUX_TOL, CLI_TOL = 1e-5, 1e-4, 2e-4, 1e-6, 1e-5
SCALE = dict(d_model=64, d_ff=128, n_heads=4, n_kv_heads=2, head_dim=16)  # the JAX test's
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SWEEP_RATES = (1.0, 4.0, 8.0)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _hold_params(got: dict, want: dict, start: dict) -> None:
    """Every leaf within ``GRAD_REL``, the leaves that start at zero held
    together as one vector (ROADMAP.md Queue C)."""
    zero = {k for k, v in start.items() if not v.any()}
    gaps = {k: _rel(got[k], want[k]) for k in want}
    assert set(got) == set(want)
    assert max(g for k, g in gaps.items() if k not in zero) <= GRAD_REL, max(gaps, key=gaps.get)
    if zero:
        assert _rel(torch.cat([got[k].flatten() for k in sorted(zero)]),
                    torch.cat([want[k].flatten() for k in sorted(zero)])) <= GRAD_REL


# ------------------------------------------------------------ spawn A
_BODY_A = """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as lm, sharding as sh
from repro_torch.launch.train import shard_batch, shard_state
from repro_torch.models.common import ModelOptions, ParallelConfig
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, checkpoint, make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.tree import leaves_with_paths, tree_map

mesh = lm.make_mesh((4, 2), ("data", "model"), device_type="cpu")
par = ParallelConfig(mesh, ("data",), "model")
inp = torch.load(D + "/a_in.pt")
out = {}

# the train step, 2 steps, microbatches 2, remat
cfg = smoke_config("qwen2.5-14b").scaled(**inp["scale"])
model = build_model(cfg, ModelOptions(attn_impl="chunked", activation_dtype="float32",
                                      remat="full", parallel=par), device="cpu")
fresh = lambda: tree_map(torch.clone, inp["params"])  # distribute may keep their storage
params, opt = shard_state(fresh(), init_opt_state(inp["params"]), cfg, mesh)
batch = shard_batch(inp["batch"], mesh)
step = make_train_step(model, TrainConfig(microbatches=2,
                                          optimizer=OptimizerConfig(**inp["ocfg"])),
                       donate=True)
out["hist"], out["gate"] = [], []
for _ in range(2):
    params, opt, m = step(params, opt, batch)
    out["hist"].append((m["loss"].item(), m["grad_norm"].item()))
    g = params["stack"]["blocks"][0]["sub0"]["mlp"]["gate"]
    gm = opt["m"]["stack"]["blocks"][0]["sub0"]["mlp"]["gate"]
    out["gate"].append((tuple(g.shape), tuple(g.to_local().shape), tuple(gm.to_local().shape),
                        [(type(p).__name__, p.dim) for p in g.placements],
                        [(type(p).__name__, p.dim) for p in gm.placements]))
out["params"] = dict(leaves_with_paths(tree_map(lambda t: t.full_tensor(), params)))

# sequence parallelism: the loss with the block inputs' seq over the model axis
seq = build_model(cfg, ModelOptions(attn_impl="chunked", activation_dtype="float32",
                                    remat="full", parallel=par, seq_shard=True), device="cpu")
p0, _ = shard_state(fresh(), init_opt_state(inp["params"]), cfg, mesh)
with implicit_replication():
    out["seq_shard_loss"] = seq.loss_fn(p0, batch)[0].full_tensor().item()

# a checkpoint of a (4, 2)-placed tree
tree = sh.distribute({"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
                      "b": torch.ones(4)}, {"w": ("data", "model"), "b": ()}, mesh)
out["w_local"] = tuple(tree["w"].to_local().shape)
checkpoint.save(D + "/ckpt", tree, step=7)
if RANK == 0:
    torch.save(out, D + "/a_out.pt")
dist.destroy_process_group()
"""

# ------------------------------------------------------------ spawn M
_BODY_M = """
from torch.distributed.tensor import Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as lm, sharding as sh
from repro_torch.models import moe
from repro_torch.models.common import ParallelConfig
from repro_torch.train.tree import tree_map

mesh = lm.make_mesh((4, 2), ("data", "model"), device_type="cpu")
par = ParallelConfig(mesh, ("data",), "model")
inp = torch.load(D + "/m_in.pt")
out = {}
mcfg = smoke_config("qwen3-moe-235b-a22b")
p, x, r = inp["moe_params"], inp["moe_x"], inp["moe_r"]
spec = sh.param_specs({"stack": {"blocks": [{"sub0": {"mlp": p}}]}}, mesh,
                      mcfg)["stack"]["blocks"][0]["sub0"]["mlp"]
x_pl = par.placements(Shard(0))

def mesh_run(impl, with_aux):
    dp = tree_map(lambda t: t.detach().requires_grad_(True), sh.distribute(p, spec, mesh))
    dx = distribute_tensor(x, mesh, x_pl).detach().requires_grad_(True)
    with implicit_replication():
        y, aux = moe.moe_apply(dp, dx, mcfg, impl=impl, parallel=par)
        loss = (y * distribute_tensor(r, mesh, x_pl)).sum() + (aux if with_aux else 0)
    loss.backward()
    grads = {k: v.grad.full_tensor() for k, v in dp.items()}
    grads["x"] = dx.grad.full_tensor()
    return y.full_tensor().detach(), aux.full_tensor().detach(), grads

for impl in ("ragged", "dense_ep", "dense"):
    out["moe_" + impl] = mesh_run(impl, with_aux=impl == "dense")
if RANK == 0:
    torch.save(out, D + "/m_out.pt")
dist.destroy_process_group()
"""

_JAX_MOE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.models.common import ParallelConfig, use_mesh
from repro.models.moe import moe_apply, moe_init

mesh = jax.make_mesh((4, 2), ("data", "model"))
cfg = smoke_config("qwen3-moe-235b-a22b")
par = ParallelConfig(mesh, ("data",), "model")
p = moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
x = jnp.asarray(np.random.default_rng(1).standard_normal((8, 16, cfg.d_model)), jnp.float32)
with use_mesh(mesh):
    y_r, aux_r = jax.jit(lambda p, x: moe_apply(p, x, cfg, impl="ragged", parallel=par))(p, x)
print("AUX", repr(float(aux_r)))
"""


def _moe_inputs():
    """The JAX test's MoE layer (``moe_init`` at key 0) in the port's layout,
    x from numpy seed 1 and the cotangent from seed 2."""
    cfg = jconfigs.smoke_config("qwen3-moe-235b-a22b")
    pj = jax_moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    p = {k: torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(v), -1, -2)))
         for k, v in pj.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 16, cfg.d_model)).astype(np.float32))
    return p, x, r


def _train_inputs():
    """The JAX test's model and batch: the smoke qwen2.5-14b scaled as
    ``tests/test_distribution.py`` scales it, JAX's parameters at key 0."""
    jcfg = jconfigs.smoke_config("qwen2.5-14b").scaled(**SCALE)
    jm = jax_build_model(jcfg, JaxOptions(attn_impl="chunked", activation_dtype="float32",
                                          remat="full"))
    params_j = jm.init(jax.random.PRNGKey(0))
    tcfg = tconfigs.smoke_config("qwen2.5-14b").scaled(**SCALE)
    params = params_from_jax(jax.tree.map(np.asarray, params_j), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, 256, (8, 32)).astype(np.int32)}
    return jm, params_j, tcfg, params, batch


@pytest.fixture(scope="module")
def spawn_a(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_a")
    jm, params_j, tcfg, params, batch = _train_inputs()
    torch.save({"scale": SCALE, "params": params, "ocfg": OCFG,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}, d / "a_in.pt")
    out = _train_refs(jm, params_j, tcfg, params, batch)  # before: the ranks get the cores
    run_ranks(_BODY_A, 8, d)
    out.update(torch.load(d / "a_out.pt"))
    out["dir"] = d
    return out


@pytest.fixture(scope="module")
def spawn_m(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_m")
    p, x, r = _moe_inputs()
    torch.save({"moe_params": p, "moe_x": x, "moe_r": r}, d / "m_in.pt")
    jax_run = subprocess.run([sys.executable, "-c", _JAX_MOE.format(src=str(SRC))],
                             capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    run_ranks(_BODY_M, 8, d)
    out = torch.load(d / "m_out.pt")
    out["jax_aux"] = float(jax_run.stdout.split("AUX")[-1].strip())
    return out


def _train_refs(jm, params_j, tcfg, params, batch) -> dict:
    """JAX's single-device steps and the port's single-process ones."""
    out = {}
    jstep = jtrain.make_train_step(jm, jtrain.TrainConfig(
        microbatches=2, optimizer=jopt.OptimizerConfig(**OCFG)))
    pj, sj = params_j, jopt.init_opt_state(params_j)
    out["jax_hist"] = []
    for _ in range(2):
        pj, sj, mj = jstep(pj, sj, {k: jnp.asarray(v) for k, v in batch.items()})
        out["jax_hist"].append((float(mj["loss"]), float(mj["grad_norm"])))
    out["jax_params"] = dict(leaves_with_paths(
        params_from_jax(jax.tree.map(np.asarray, pj), tcfg, device="cpu")))
    tm = build_model(tcfg, ModelOptions(attn_impl="chunked", activation_dtype="float32",
                                        remat="full"), device="cpu")
    tstep = train_step.make_train_step(tm, train_step.TrainConfig(
        microbatches=2, optimizer=optimizer.OptimizerConfig(**OCFG)))
    pt, st = params, optimizer.init_opt_state(params)
    out["port_hist"] = []
    for _ in range(2):
        pt, st, mt = tstep(pt, st, batch)
        out["port_hist"].append((mt["loss"].item(), mt["grad_norm"].item()))
    out["port_params"] = dict(leaves_with_paths(pt))
    out["start"] = dict(leaves_with_paths(params))
    out["port_loss0"] = tm.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}
                                   )[0].item()
    return out


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_train_step_on_a_4x2_mesh_matches_one_device(spawn_a, ref):
    """Two steps of the JAX test's model on ``(4, 2)``, microbatches 2 and
    remat, against the port's single-process steps and JAX's single-device
    ones."""
    hist, want = spawn_a["hist"], spawn_a[f"{ref}_hist"]
    for (loss, gnorm), (loss_w, gnorm_w) in zip(hist, want, strict=True):
        assert abs(loss - loss_w) <= STEP_REL * abs(loss_w)
        assert abs(gnorm - gnorm_w) <= GRAD_REL * abs(gnorm_w)
    _hold_params(spawn_a["params"], spawn_a[f"{ref}_params"], spawn_a["start"])


def test_sequence_sharded_loss_matches_one_device(spawn_a):
    """``seq_shard=True``: each block's input is sharded over the model axis
    on the seq dim (``constrain_seq``); the loss is the one-device loss."""
    assert abs(spawn_a["seq_shard_loss"] - spawn_a["port_loss0"]) <= STEP_REL * abs(
        spawn_a["port_loss0"])


def test_sharded_leaves_keep_their_placements_every_step(spawn_a):
    """``mlp/gate`` ``[d_ff, d]`` = ``[128, 64]`` is d_ff over model and d
    over data: each rank holds half its d_ff (the JAX test's device-set
    check), and its moment the same shard, after each step."""
    for whole, local, m_local, placements, m_placements in spawn_a["gate"]:
        assert whole == (128, 64)
        assert local == m_local == (64, 16)
        assert placements == m_placements == [("Shard", 1), ("Shard", 0)]


@pytest.mark.parametrize("impl", ["ragged", "dense_ep", "dense"])
def test_mesh_moe_dispatches_match_dense(spawn_m, impl):
    """``ragged`` (local_map, d_ff over model, one all_reduce), ``dense_ep``
    (expert-sharded intermediates) and ``dense`` under the mesh against the
    plain ``dense`` on one process: the output and the gradients of
    ``sum(y r)`` (plus ``aux`` for ``dense``, whose ``aux`` is the plain
    one) with respect to x and every weight."""
    from repro_torch.models import moe

    p, x, r = _moe_inputs()
    cfg = tconfigs.smoke_config("qwen3-moe-235b-a22b")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x.requires_grad_(True)
    y, aux = moe.moe_apply(p, x, cfg, impl="dense")
    ((y * r).sum() + (aux if impl == "dense" else 0)).backward()
    y_m, aux_m, grads = spawn_m["moe_" + impl]
    np.testing.assert_allclose(_np(y_m), _np(y), rtol=MOE_TOL, atol=MOE_TOL)
    for k in ("router", "gate", "up", "down"):
        np.testing.assert_allclose(_np(grads[k]), _np(p[k].grad), rtol=MOE_TOL, atol=MOE_TOL)
    np.testing.assert_allclose(_np(grads["x"]), _np(x.grad), rtol=MOE_TOL, atol=MOE_TOL)
    if impl != "ragged":  # ragged's aux is the mean of the shards' own (the reference's)
        assert abs(aux_m.item() - aux.item()) <= AUX_TOL


def test_ragged_aux_matches_jax_ragged(spawn_m):
    """``ragged``'s ``aux`` (each shard's, averaged over both axes) against
    JAX's ``ragged`` on 8 fake devices, same parameters and x."""
    assert abs(spawn_m["moe_ragged"][1].item() - spawn_m["jax_aux"]) <= AUX_TOL


# ------------------------------------------------------------ spawn B
_BODY_B = """
import numpy as np
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as lm
from repro_torch.launch.train import shard_batch, shard_state
from repro_torch.models.common import ModelOptions, ParallelConfig
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.tree import leaves_with_paths, tree_map

mesh = lm.make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
par = ParallelConfig(mesh, ("pod", "data"), "model")
inp = torch.load(D + "/b_in.pt")
cfg = smoke_config("mixtral-8x7b")
model = build_model(cfg, ModelOptions(attn_impl="chunked", activation_dtype="float32",
                                      remat="full", parallel=par), device="cpu")
params, opt = shard_state(inp["params"], init_opt_state(inp["params"]), cfg, mesh)
step = make_train_step(model, TrainConfig(microbatches=2,
                                          optimizer=OptimizerConfig(**inp["ocfg"])))
params, opt, m = step(params, opt, shard_batch(inp["batch"], mesh))
out = {"hist": [(m["loss"].item(), m["grad_norm"].item())],
       "params": dict(leaves_with_paths(tree_map(lambda t: t.full_tensor(), params)))}
if RANK == 0:
    torch.save(out, D + "/b_out.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def spawn_b(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_b")
    cfg = tconfigs.smoke_config("mixtral-8x7b")
    opts = ModelOptions(attn_impl="chunked", activation_dtype="float32", remat="full")
    tm = build_model(cfg, opts, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    torch.save({"params": params, "batch": batch, "ocfg": OCFG}, d / "b_in.pt")
    step = train_step.make_train_step(tm, train_step.TrainConfig(
        microbatches=2, optimizer=optimizer.OptimizerConfig(**OCFG)))
    pt, _, m = step(params, optimizer.init_opt_state(params), batch)
    run_ranks(_BODY_B, 8, d)
    out = torch.load(d / "b_out.pt")
    out["want_hist"] = [(m["loss"].item(), m["grad_norm"].item())]
    out["want_params"] = dict(leaves_with_paths(pt))
    out["start"] = dict(leaves_with_paths(params))
    return out


def test_train_step_on_a_pod_data_model_mesh(spawn_b):
    """One step of the smoke mixtral (its MoE layers dense) on ``(2, 2, 2)``
    ``("pod", "data", "model")``, the batch over pod and data, against the
    single-process step."""
    (loss, gnorm), = spawn_b["hist"]
    (loss_w, gnorm_w), = spawn_b["want_hist"]
    assert abs(loss - loss_w) <= STEP_REL * abs(loss_w)
    assert abs(gnorm - gnorm_w) <= GRAD_REL * abs(gnorm_w)
    _hold_params(spawn_b["params"], spawn_b["want_params"], spawn_b["start"])


# ------------------------------------------------------------ spawn F
# The mixer families' mesh paths: the SSD and RG-LRU scans rank by rank
# (heads split over the model axis where they divide, whole where they do not:
# "mamba2-odd" has 3 heads), the encoder-decoder's batch constraints, and
# decode_fn's rank-by-rank attention over caches that prefill_fn placed.
# "whisper-mha" has as many K/V heads as query heads, as whisper-base has:
# its K and V, whole over the model axis, are split into heads there.
FAMILY_TRAIN = {"mamba2-130m": ("mamba2-130m", {}),
                "mamba2-odd": ("mamba2-130m", {"d_model": 48, "ssm_head_dim": 32}),
                "recurrentgemma-9b": ("recurrentgemma-9b", {}),
                "whisper-base": ("whisper-base", {}),
                "whisper-mha": ("whisper-base", {"n_kv_heads": 4})}
FAMILY_DECODE = ("phi4-mini-3.8b", "mamba2-130m", "recurrentgemma-9b", "whisper-base")
DECODE_PROMPT, DECODE_STEPS = 16, 2

_BODY_F = """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as lm
from repro_torch.launch.train import shard_batch, shard_state
from repro_torch.models.common import ModelOptions, ParallelConfig
from repro_torch.models.model import build_model
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.tree import leaves_with_paths, tree_map

mesh = lm.make_mesh((2, 2), ("data", "model"), device_type="cpu")
par = ParallelConfig(mesh, ("data",), "model")
inp = torch.load(D + "/f_in.pt")
opts = ModelOptions(attn_impl="chunked", mixer_impl="chunked", activation_dtype="float32",
                    remat="full", parallel=par)
out = {}
for name, (arch, scale, params, batch) in inp["train"].items():
    cfg = smoke_config(arch).scaled(**scale)
    model = build_model(cfg, opts, device="cpu")
    p, o = shard_state(params, init_opt_state(params), cfg, mesh)
    step = make_train_step(model, TrainConfig(microbatches=2,
                                              optimizer=OptimizerConfig(**inp["ocfg"])))
    p, o, m = step(p, o, shard_batch(batch, mesh))
    out[name] = {"hist": [(m["loss"].item(), m["grad_norm"].item())],
                 "params": dict(leaves_with_paths(tree_map(lambda t: t.full_tensor(), p)))}
for arch, (params, batch, tokens) in inp["decode"].items():
    cfg = smoke_config(arch)
    model = build_model(cfg, opts, device="cpu")
    p = shard_state(params, init_opt_state(params), cfg, mesh)[0]
    with implicit_replication():
        logits, caches = model.prefill_fn(p, shard_batch(batch, mesh))
        got = [logits.full_tensor()]
        for t in range(tokens.shape[1]):
            tok = shard_batch({"tokens": tokens[:, t:t + 1]}, mesh)["tokens"]
            logits, caches = model.decode_fn(p, tok, caches, inp["prompt"] + t)
            got.append(logits.full_tensor())
    out["decode/" + arch] = got
if RANK == 0:
    torch.save(out, D + "/f_out.pt")
dist.destroy_process_group()
"""


def _family_batch(cfg, rng, rows, seq, labels=True) -> dict:
    keys = ("tokens", "labels") if labels else ("tokens",)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))
             for k in keys}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return batch


@pytest.fixture(scope="module")
def spawn_f(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_f")
    opts = ModelOptions(attn_impl="chunked", mixer_impl="chunked", activation_dtype="float32",
                        remat="full")
    rng = np.random.default_rng(0)
    inp, want = {"train": {}, "decode": {}, "ocfg": OCFG, "prompt": DECODE_PROMPT}, {}
    for name, (arch, scale) in FAMILY_TRAIN.items():
        cfg = tconfigs.smoke_config(arch).scaled(**scale)
        tm = build_model(cfg, opts, device="cpu")
        params = tm.init(torch.Generator().manual_seed(0))
        batch = _family_batch(cfg, rng, 8, 32)
        inp["train"][name] = (arch, scale, params, batch)
        step = train_step.make_train_step(tm, train_step.TrainConfig(
            microbatches=2, optimizer=optimizer.OptimizerConfig(**OCFG)))
        pt, _, m = step(params, optimizer.init_opt_state(params), batch)
        want[name] = {"hist": [(m["loss"].item(), m["grad_norm"].item())],
                      "params": dict(leaves_with_paths(pt)),
                      "start": dict(leaves_with_paths(params))}
    for arch in FAMILY_DECODE:
        cfg = tconfigs.smoke_config(arch)
        tm = build_model(cfg, opts, device="cpu")
        params = tm.init(torch.Generator().manual_seed(1))
        batch = _family_batch(cfg, rng, 4, DECODE_PROMPT, labels=False)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (4, DECODE_STEPS)).astype(np.int32))
        inp["decode"][arch] = (params, batch, tokens)
        logits, caches = tm.prefill_fn(params, batch)
        got = [logits]
        for t in range(DECODE_STEPS):
            logits, caches = tm.decode_fn(params, tokens[:, t:t + 1], caches, DECODE_PROMPT + t)
            got.append(logits)
        want["decode/" + arch] = got
    torch.save(inp, d / "f_in.pt")
    run_ranks(_BODY_F, 4, d)
    return torch.load(d / "f_out.pt"), want


@pytest.mark.parametrize("name", list(FAMILY_TRAIN))
def test_family_train_step_on_a_2x2_mesh_matches_one_device(spawn_f, name):
    """One step of each mixer family's smoke model (microbatches 2, remat)
    on ``(2, 2)`` against the single-process step, held as spawn B's."""
    got, want = spawn_f[0][name], spawn_f[1][name]
    (loss, gnorm), = got["hist"]
    (loss_w, gnorm_w), = want["hist"]
    assert abs(loss - loss_w) <= STEP_REL * abs(loss_w)
    assert abs(gnorm - gnorm_w) <= GRAD_REL * abs(gnorm_w)
    _hold_params(got["params"], want["params"], want["start"])


@pytest.mark.parametrize("arch", FAMILY_DECODE)
def test_decode_on_a_2x2_mesh_matches_one_device(spawn_f, arch):
    """``prefill_fn`` and ``DECODE_STEPS`` ``decode_fn`` steps on ``(2, 2)``,
    the caches as the mesh prefill placed them, against one process: every
    step's logits within ``STEP_REL`` (relative norm)."""
    got, want = spawn_f[0]["decode/" + arch], spawn_f[1]["decode/" + arch]
    assert len(got) == len(want) == DECODE_STEPS + 1
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        assert _rel(g, w) <= STEP_REL, _rel(g, w)


# ------------------------------------------------------------ spawns C, D
def _sweep_specs():
    """The smoke quantized lanes (unfused, fused) with 5 seeds, and with
    3 rates."""
    specs = {}
    for label in ("quantized", "quantized-fused"):
        spec = dict(lanes.lane_specs(smoke=True))[label]
        specs[f"{label}/seeds"] = spec._replace(n_seeds=5)
        specs[f"{label}/rates"] = spec._replace(rates=SWEEP_RATES)
    return specs


_SWEEPS = """
from repro_torch import lanes
from repro_torch.core import sweeps
SWEEP_RATES = {rates!r}
results = {{}}
for label in ("quantized", "quantized-fused"):
    spec = dict(lanes.lane_specs(smoke=True))[label]
    seeds, rates = spec._replace(n_seeds=5), spec._replace(rates=SWEEP_RATES)
    for chunk in (None, 2):
        res = sweeps.run_sweep(seeds, shard=True, chunk_seeds=chunk, device="cpu")
        results[f"{{label}}/seeds/{{chunk}}"] = (res.stats, res.sharded, res.record()["sharded"])
    if WORLD == 2:
        for chunk in (None, 2):
            res = sweeps.run_sweep(rates, shard=True, shard_axis="rates", chunk_seeds=chunk,
                                   device="cpu")
            results[f"{{label}}/rates/{{chunk}}"] = (res.stats, res.sharded,
                                                   res.record()["sharded"])
torch.save(results, f"{{D}}/sweeps{{WORLD}}_{{RANK}}.pt")
"""

_BODY_C = """
from repro_torch.launch import mesh as lm, sharding as sh
from repro_torch.train import checkpoint

mesh = lm.make_mesh((2, 1), ("data", "model"), device_type="cpu")
target = sh.distribute({"w": torch.zeros(8, 8), "b": torch.zeros(4)},
                       {"w": ("model", "data"), "b": ()}, mesh)
ckpt = os.environ["CKPT"]
restored = checkpoint.restore(ckpt, target)
out = {"w": restored["w"].full_tensor(), "b": restored["b"].full_tensor(),
       "w_local": tuple(restored["w"].to_local().shape), "same": restored["w"] is target["w"],
       "step": checkpoint.load_manifest(ckpt)["step"]}
torch.save(out, f"{D}/c_{RANK}.pt")
""" + _SWEEPS.format(rates=SWEEP_RATES) + """
dist.destroy_process_group()
from repro_torch.launch import train
train.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu", "--steps", "4",
            "--seq-len", "32", "--global-batch", "4", "--log-every", "1", "--ckpt-every", "2",
            "--fail-at", "3", "--ckpt-dir", D + "/train_ckpt",
            "--init-method", "file://" + D + "/store2"])
"""

_BODY_D = _SWEEPS.format(rates=SWEEP_RATES) + """
from repro_torch.launch import mesh as lm
job = lm.make_job_mesh([0, 1, 2, 3], model_parallel=2, device_type="cpu")
sub = lm.make_job_mesh([2, 3], device_type="cpu")
try:
    lm.make_production_mesh(device_type="cpu")
    refused = None
except ValueError as e:
    refused = str(e)
torch.save({"job": (lm.axis_sizes(job), job.get_coordinate()),
            "sub": (lm.axis_sizes(sub), sub.get_coordinate()), "refused": refused,
            "axes": (lm.data_axes_of(job), lm.model_axis_of(job))}, f"{D}/meshes_{RANK}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def spawn_c(spawn_a, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_c")
    os.environ["CKPT"] = str(spawn_a["dir"] / "ckpt")
    try:
        outs = run_ranks(_BODY_C, 2, d)
    finally:
        del os.environ["CKPT"]
    return d, outs


@pytest.fixture(scope="module")
def spawn_d(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_d")
    run_ranks(_BODY_D, 4, d)
    return d


def test_checkpoint_restores_across_mesh_shapes(spawn_a, spawn_c):
    """Saved from 8 ranks on ``(4, 2)`` with ``w`` placed ("data",
    "model"), restored in place on 2 ranks on ``(2, 1)`` with ("model",
    "data"): bit for bit, and the manifest's step is 7 (JAX's
    ``test_checkpoint_restore_across_mesh_shapes``)."""
    assert spawn_a["w_local"] == (2, 4)
    d, _ = spawn_c
    for r in range(2):
        out = torch.load(d / f"c_{r}.pt")
        assert torch.equal(out["w"], torch.arange(64, dtype=torch.float32).reshape(8, 8))
        assert torch.equal(out["b"], torch.ones(4))
        assert out["w_local"] == (8, 4) and out["same"]
        assert out["step"] == 7


@functools.lru_cache(maxsize=None)
def _unsharded(key):
    return tsw.run_sweep(_sweep_specs()[key], device="cpu").stats


def _hold_sweeps(path_of, n, keys):
    for r in range(n):
        results = torch.load(path_of(r), weights_only=False)
        assert set(results) == {f"{k}/{c}" for k in keys for c in (None, 2)}
        for name, (stats, sharded, logged) in results.items():
            want = _unsharded(name.rsplit("/", 1)[0])
            assert sharded and logged
            for policy in want:
                for m in want[policy]:
                    assert np.array_equal(stats[policy][m], want[policy][m]), (name, m)


def test_sweep_sharded_over_two_ranks_equals_unsharded(spawn_c):
    """5 seeds over 2 ranks (one seed of padding) and 3 rates over 2 ranks
    (one rate of padding), fused and unfused, unchunked and in chunks of 2
    seeds: every rank's result equals the unsharded run bit for bit."""
    d, _ = spawn_c
    _hold_sweeps(lambda r: d / f"sweeps2_{r}.pt", 2, list(_sweep_specs()))


def test_sweep_sharded_over_four_ranks_equals_unsharded(spawn_d):
    """5 seeds over 4 ranks (three seeds of padding), fused and unfused,
    unchunked and in chunks of 2: bit for bit on every rank."""
    _hold_sweeps(lambda r: spawn_d / f"sweeps4_{r}.pt", 4,
                 [k for k in _sweep_specs() if k.endswith("/seeds")])


def test_job_meshes_and_the_production_mesh_refusal(spawn_d):
    """``make_job_mesh`` lays a rank subset out as ``(n // mp, mp)``
    (``("data", "model")``; a rank outside the subset has no coordinate),
    and a production mesh of 256 ranks over a world of 4 raises."""
    for r in range(4):
        out = torch.load(spawn_d / f"meshes_{r}.pt")
        assert out["job"] == ({"data": 2, "model": 2}, (r // 2, r % 2))
        assert out["sub"] == ({"data": 2, "model": 1}, (r - 2, 0) if r >= 2 else None)
        assert out["refused"] == "a mesh of 256 ranks over a world of 4"
        assert out["axes"] == (("data",), "model")


def test_a_mesh_needs_a_started_group():
    """Nothing starts a process group on its own: a mesh without one raises,
    and so does a device type with no backend."""
    from repro_torch.launch import mesh as lm

    with pytest.raises(RuntimeError, match="process group"):
        lm.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        lm.make_job_mesh([0], device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        lm.start_group("tpu")
    import types

    stand_in = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
    assert lm.axis_sizes(stand_in) == {"pod": 2, "data": 16, "model": 16}
    assert lm.data_axes_of(stand_in) == ("pod", "data") and lm.model_axis_of(stand_in) == "model"


@pytest.mark.parametrize("failing,timeout", [(1, 60.0), (None, 1.0)])
def test_spawn_ranks_ends_every_rank_when_one_fails(tmp_path, failing, timeout):
    """``spawn_ranks`` hands each rank its ``RANK``, ``WORLD_SIZE`` and one
    thread and returns their stdout; a rank that fails, or a timeout, ends
    the others at once and raises with the failed ranks' stderr tails."""
    from repro_torch.launch import mesh as lm

    ok = "import os; print(*(os.environ[k] for k in ('RANK', 'WORLD_SIZE', 'OMP_NUM_THREADS')))"
    assert lm.spawn_ranks([sys.executable, "-c", ok], 3, tmp_path, timeout=60.0) == [
        f"{r} 3 1\n" for r in range(3)]
    hang = ("import os, sys, time\n"
            f"if os.environ['RANK'] == '{failing}': sys.exit('rank gave up')\n"
            "time.sleep(600)")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        lm.spawn_ranks([sys.executable, "-c", hang], 3, tmp_path, timeout=timeout)
    assert time.monotonic() - t0 < 30
    if failing is None:
        assert "3 of 3 ranks failed" in str(e.value)
    else:
        assert "rank 1 exited 1:\nrank gave up" in str(e.value)
        assert "rank 0 exited -9" in str(e.value) and "rank 2 exited -9" in str(e.value)


def _cli_losses(text: str) -> list[float]:
    return [float(line.split()[3]) for line in text.splitlines() if line.startswith("step ")]


def test_train_cli_on_two_ranks_matches_one(spawn_c, tmp_path, capsys):
    """``launch/train.py --smoke --device cpu`` on 2 ranks (the group from
    ``--init-method``, the ``(2, 1)`` mesh, the state and batches
    distributed, rank 0 printing) against the same run on one process, a
    failure at step 3 restoring the sharded state in place from the
    checkpoint at 2: the printed losses within 1e-5, step 2 replayed."""
    _, outs = spawn_c
    tlaunch.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu", "--steps", "4",
                  "--seq-len", "32", "--global-batch", "4", "--log-every", "1",
                  "--ckpt-every", "2", "--fail-at", "3", "--ckpt-dir", str(tmp_path / "ckpt")])
    want = _cli_losses(capsys.readouterr().out)
    got = _cli_losses(outs[0])
    assert len(want) == len(got) == 5  # steps 0, 1, 2, then 2 again and 3
    np.testing.assert_allclose(got, want, rtol=0, atol=CLI_TOL)
    assert got[2] == got[3]
    assert _cli_losses(outs[1]) == []  # rank 0 prints
    assert "done: 5 steps" in outs[0] and "recoveries 1" in outs[0]


# ------------------------------------------------------------ one process
def test_shard_axis_is_checked_before_anything_runs():
    spec = _sweep_specs()["quantized/seeds"]
    with pytest.raises(ValueError, match="shard_axis"):
        tsw.run_sweep(spec, shard=True, shard_axis="policies", device="cpu")
    with pytest.raises(ValueError, match="shard_axis"):
        tsw.shard_plan(spec, None, shard_axis="cells")


@pytest.mark.parametrize("axis", ["seeds", "rates"])
def test_shard_without_a_group_is_the_one_device_run(axis):
    """With no process group, ``shard=True`` runs on one device and equals
    the unsharded run (JAX's ``test_rate_axis_shard_validation_and_single_
    device_noop``); the record says it was asked to shard."""
    key = f"quantized-fused/{axis}"
    res = tsw.run_sweep(_sweep_specs()[key], shard=True, shard_axis=axis, chunk_seeds=2,
                        device="cpu")
    want = _unsharded(key)
    assert res.sharded and res.record()["sharded"]
    assert all(np.array_equal(res.stats["hesrpt"][m], want["hesrpt"][m]) for m in want["hesrpt"])


_ROW_SPECS = {
    "poisson noisy": dict(scenario="poisson", scenario_kw={"sigma_size": 0.3, "sigma_p": 0.1}),
    "drift_poisson": dict(scenario="drift_poisson"),
    "drift_multiclass": dict(scenario="drift_multiclass", policies=("hesrpt_pc",),
                             classes=((0.3, 1.0), (0.7, 1.0)), scenario_kw={"p1": (0.15, 0.45)}),
}


@pytest.mark.parametrize("kind", list(_ROW_SPECS))
def test_rate_parts_take_the_whole_draws_rows(kind):
    """Each rank's rate part runs on its rows of the draw at every rate
    (estimation noise, scalar drift regimes, per-job drift rows and class
    marks alike); joined, the parts are the unsharded run bit for bit."""
    kw = dict(_ROW_SPECS[kind])
    spec = tsw.Sweep.create(kw.pop("policies", ("hesrpt",)), SWEEP_RATES, n_jobs=30, n_seeds=2,
                            seed=3, **kw)
    want = tsw.run_sweep(spec, device="cpu").stats
    parts = []
    for rank in range(2):
        plan = tsw.shard_plan(spec, None, rank=rank, n=2, shard_axis="rates")
        parts.append(tsw._run_part(spec, plan, torch.device("cpu")))
    got = tsw.merge_parts(spec, parts, plan.axis)
    for name in want:
        for m in want[name]:
            assert np.array_equal(got[name][m], want[name][m]), (name, m)


def _jax_tapes(spec):
    """The tapes the JAX sweep draws: one key per seed, shared by the rates."""
    from repro.core.scenarios import make_scenario

    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p)
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]
    x0 = np.asarray([[np.asarray(c.x0) for c in row] for row in cells])
    arr = np.asarray([[np.asarray(c.arrival_times) for c in row] for row in cells])
    return x0, arr


@pytest.mark.parametrize("n, axis", [(2, "seeds"), (4, "seeds"), (2, "rates")])
def test_sharded_plan_on_jax_tapes_matches_jax(n, axis):
    """Each of ``n`` ranks' parts (``shard_plan``: padding, the contiguous
    split) run on JAX's tapes and joined by ``merge_parts`` against JAX's
    single-device ``run_sweep`` at 1e-12 relative (JAX's own four shard
    tests fail on jax 0.9.0: ROADMAP.md Queue C)."""
    spec = _sweep_specs()[f"quantized-fused/{axis}"]
    jspec = js.Sweep.create(spec.policies, spec.rates, n_jobs=spec.n_jobs, n_seeds=spec.n_seeds,
                            p=spec.p, n_servers=spec.n_servers, n_chips=spec.n_chips,
                            fused=True, seed=spec.seed)
    want = js.run_sweep(jspec, log=False).stats
    x0, arr = _jax_tapes(jspec)
    parts = []
    for rank in range(n):
        plan = tsw.shard_plan(spec, 2, rank=rank, n=n, shard_axis=axis)
        idx = np.ix_(plan.rates, plan.seeds)
        parts.append(tsw.simulate_cells(plan.spec, x0[idx], arr[idx], device="cpu"))
    got = tsw.merge_parts(spec, parts, plan.axis)
    for m in spec.metrics:
        assert got["hesrpt"][m].shape == (len(spec.rates), spec.n_seeds)
        np.testing.assert_allclose(got["hesrpt"][m], want["hesrpt"][m], rtol=1e-12, atol=0)
