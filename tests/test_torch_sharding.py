"""The port's logical-axis sharding rules (``repro_torch.launch.sharding``)
against the reference's (``repro.launch.sharding``), leaf for leaf, in one
process with no ranks.

The reference's ``spec_for`` reads only ``mesh.shape``, so both sides take a
stand-in mesh, an object whose ``shape`` maps axis names to sizes: the
production meshes ``{"data": 16, "model": 16}`` and ``{"pod": 2, "data":
16, "model": 16}`` and the test meshes ``{"data": 4, "model": 2}`` and
``{"data": 8, "model": 1}``.  Every config of the registry is taken at its
published widths from shapes only: the JAX tree from ``jax.eval_shape`` of
its ``init``, the port's from its own ``init`` under ``FakeTensorMode`` (no
storage).  The reference's spec of each JAX leaf is mapped through the
converter's layout (``models/convert.py``: the stacked block dim dropped,
the last two dims of a transposed linear swapped) and must equal the
port's spec of its counterpart, whose shape must be the mapped JAX shape.
The caches are the smoke configs' prefill caches (the port's run on the
CPU, the reference's from ``jax.eval_shape`` of its prefill).
"""

import functools
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "8x1": {"data": 8, "model": 1},
}
ARCHS = tconfigs.ARCH_IDS
_STACKED = re.compile(r"(^|/)(blocks|enc_blocks|dec_blocks)/\d+(/|$)")
# the converter's transposed linears
_LINEAR = frozenset(sum(convert._LINEAR.values(), ()) + convert._MLP_LINEAR)


def _mesh(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _jax_key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _jax_leaves(tree, specs) -> dict:
    """``{path: (shape, spec as a tuple)}`` of a JAX tree and its spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_flat = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_jax_key(p): (tuple(leaf.shape), tuple(s))
            for (p, leaf), s in zip(flat, spec_flat, strict=True)}


def _ref_key(path: str) -> str:
    """The reference's path of a port leaf: no block index."""
    return _STACKED.sub(lambda m: f"{m.group(1)}{m.group(2)}{m.group(3)}", path)


def _expected(path: str, port_shape: tuple, ref: dict, linear: bool) -> tuple:
    """The reference's spec of the port leaf's counterpart, in the port's
    layout; the counterpart's shape mapped the same way must be the port's."""
    stacked = _STACKED.search(path)
    key = _ref_key(path)
    shape, spec = ref[key]
    full = list(spec) + [None] * (len(shape) - len(spec))
    if stacked:
        shape, full = shape[1:], full[1:]
    if linear and len(shape) >= 2 and path.rsplit("/", 1)[-1] in _LINEAR:
        shape = shape[:-2] + (shape[-1], shape[-2])
        full[-2], full[-1] = full[-1], full[-2]
    assert tuple(shape) == tuple(port_shape), (path, shape, port_shape)
    while full and full[-1] is None:
        full.pop()
    return tuple(full)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jconfigs.get_config(arch)
    return jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    model = build_model(tconfigs.get_config(arch), device="cpu")
    with FakeTensorMode():
        return model.init(torch.Generator())


def _check_tree(port_tree, port_specs, ref: dict, linear: bool) -> None:
    """Every port leaf's spec is its counterpart's, mapped; every reference
    leaf has a counterpart."""
    seen = set()
    flat = leaves_with_paths(port_tree)
    for (path, leaf), spec in zip(flat, _spec_leaves(port_specs, port_tree), strict=True):
        assert spec == _expected(path, tuple(leaf.shape), ref, linear), path
        seen.add(_ref_key(path))
    assert seen == set(ref)


def _spec_leaves(specs, like) -> list:
    """The spec tree's leaves (tuples) in the order of ``like``'s leaves."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _spec_leaves(specs[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [s for i in range(len(like)) for s in _spec_leaves(specs[i], like[i])]
    return [specs]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_the_reference(arch, mesh):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams, tparams = _jax_params(arch), _port_params(arch)
    m = _mesh(mesh)
    ref = _jax_leaves(jparams, jsh.param_specs(jparams, m, jcfg))
    _check_tree(tparams, sh.param_specs(tparams, m, tcfg), ref, linear=True)
    jopt = jsh.opt_state_specs(jparams, m, jcfg)
    topt = sh.opt_state_specs(tparams, m, tcfg)
    assert set(topt) == set(jopt) == {"m", "v", "step"}
    for name in ("m", "v"):
        ref = _jax_leaves(jparams, jopt[name])
        _check_tree(tparams, topt[name], ref, linear=True)
    assert topt["step"] == tuple(jopt["step"]) == ()
    assert "master" in sh.opt_state_specs(tparams, m, tcfg, keep_master=True)


def test_recurrentgemma_tail_keeps_the_reference_shifted_specs():
    """The reference's rules assume a leading stacked dim, which the
    hybrid's tail layers lack: there every rule shifts by one dim (ROADMAP.md
    Queue C).  The port keeps the reference's placements."""
    arch = "recurrentgemma-9b"
    specs = sh.param_specs(_port_params(arch), _mesh("16x16"), tconfigs.get_config(arch))
    tail, block = specs["stack"]["tail"]["sub0"], specs["stack"]["blocks"][0]["sub0"]
    # port [d_ff, d]: the reference's P(None, "data") on [4096, 12288] is d_ff over data
    assert tail["mlp"]["gate"] == ("data",)
    assert tail["mix"]["w_out"] == ("model",)  # the reference's P(None, "model"), transposed
    assert block["mlp"]["gate"] == ("model", "data")  # (None, "data", "model") unstacked


def _batches(family, b=32, s=64):
    cfg = tconfigs.smoke_config({"dense": "phi4-mini-3.8b", "vlm": "internvl2-1b",
                                 "audio": "whisper-base"}[family])
    out = {"tokens": np.zeros((b, s), np.int32), "labels": np.zeros((b, s), np.int32)}
    if family == "vlm":
        out["patch_embeds"] = np.zeros((b, cfg.n_patches, cfg.d_model), np.float32)
    if family == "audio":
        out["frames"] = np.zeros((b, cfg.encoder_seq, cfg.d_model), np.float32)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_batch_specs_match_the_reference(family, mesh):
    batch = _batches(family)
    m = _mesh(mesh)
    ref = _jax_leaves(batch, jsh.batch_specs(batch, m))
    port = {k: torch.from_numpy(v) for k, v in batch.items()}
    _check_tree(port, sh.batch_specs(port, m), ref, linear=False)


@functools.lru_cache(maxsize=None)
def _prefill_caches(arch, b=16, s=8):
    """The smoke config's prefill caches: the port's, run on the CPU, and
    the reference's from ``jax.eval_shape`` of its prefill."""
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (b, s)).astype(np.int32)}
    if tcfg.family == "vlm":
        batch["patch_embeds"] = np.zeros((b, tcfg.n_patches, tcfg.d_model), np.float32)
    if tcfg.family == "audio":
        batch["frames"] = np.zeros((b, tcfg.encoder_seq, tcfg.d_model), np.float32)
    jm = jax_build_model(jcfg, JaxOptions(activation_dtype="float32"))
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    _, jcaches = jax.eval_shape(jm.prefill_fn, jparams,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    tm = build_model(tcfg, ModelOptions(activation_dtype="float32"), device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        _, tcaches = tm.prefill_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return jcaches, tcaches


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh):
    jcaches, tcaches = _prefill_caches(arch)
    m = _mesh(mesh)
    ref = _jax_leaves(jcaches, jsh.cache_specs_tree(jcaches, m))
    _check_tree(tcaches, sh.cache_specs_tree(tcaches, m), ref, linear=False)


def test_to_placements_and_the_joint_batch_axis():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                 mesh_dim_names=("pod", "data", "model"))
    spec = sh.spec_for((64, 32, 4096), ("batch", "seq", "embed"), mesh)
    assert spec == (("pod", "data"),)  # embed's only candidate, data, is taken
    assert sh.to_placements(spec, mesh) == (Shard(0), Shard(0), Replicate())
    assert sh.to_placements(("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    assert sh.to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.to_placements((("data", "pod"),), mesh)
