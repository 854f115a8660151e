"""The moe, vlm and audio families' training path at the sizes ``chip_smoke.py``
phase 35 trains them on the card, and the MoE train path under
``ragged_local``, on the CPU.

- The smoke mixtral-8x7b and qwen3-moe-235b-a22b under
  ``moe_impl="ragged_local"``: the loss, the cross entropy, ``aux`` and every
  gradient leaf against ``jax.value_and_grad`` of the JAX model's
  ``ragged_local`` (``lax.ragged_dot``), at ``tests/test_torch_train.py``'s
  ``LOSS_REL`` and ``GRAD_REL``, on the parameters JAX's ``init`` drew.
- ``ragged_local``'s backward twice on the same inputs
  (``tests/torch_moe_twice.py``): bit for bit.  Its backward gathers and
  scatters by unique indices only (``models/moe.py::_GatherRepeated``), so
  no gradient is added with float atomics on the card either
  (``tests/test_torch_kernels_cuda.py`` runs the same check there, phase 35
  (c) at the true expert counts).
- Each phase-35 config (``chip_smoke.FAMILY_TRAIN``) reckoned on fake
  tensors (meta storage, no data): the parameters the model holds equal
  ``configs.base``'s count plus ``uncounted_params``; 16 B a parameter
  (float32 masters, gradients and two moments) is under 80 GB; and one
  train step as phase 35 runs it (bf16 activations, remat, the chunked
  attention, ``dense`` MoE, donated), traced by ``launch/trace_analysis.py``,
  holds its arguments and its own peak in under 80 GB
  (``tools/family_train_reckon.py`` prints the same figures).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.tree import leaves_with_paths, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke  # noqa: E402
import family_train_reckon  # noqa: E402
from torch_moe_twice import ragged_local_twice  # noqa: E402

MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
LOSS_REL, GRAD_REL = 1e-5, 1e-4  # tests/test_torch_train.py's bars
HBM_BYTES = 80e9


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(
        jnp.asarray(got, jnp.float32), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _batch(cfg, seed=1, b=4, s=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _grads(tm, params, batch):
    alias = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = tm.loss_fn(alias, batch)
    loss.backward()
    return loss.detach(), metrics, tree_map(lambda p: p.grad, alias)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ragged_local_loss_and_gradient_match_jax(arch):
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    jm = jax_build_model(jcfg, JaxOptions(attn_impl="chunked", mixer_impl="chunked",
                                          activation_dtype="float32", remat="none",
                                          moe_impl="ragged_local"))
    params_j = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, ModelOptions(attn_impl="chunked", activation_dtype="float32",
                                        remat="none", moe_impl="ragged_local"), device="cpu")
    batch = _batch(tcfg)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, params_j), tcfg, device="cpu")
    loss, metrics, grads = _grads(tm, params, batch)
    assert _rel(loss, loss_j) <= LOSS_REL
    assert _rel(metrics["ce"], metrics_j["ce"]) <= LOSS_REL
    assert float(metrics_j["aux_loss"]) > 0
    assert _rel(metrics["aux_loss"], metrics_j["aux_loss"]) <= LOSS_REL
    want = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), grads_j), tcfg,
                           device="cpu")
    gaps = {k: _rel(g, w.numpy()) for (k, g), (_, w) in zip(
        leaves_with_paths(grads), leaves_with_paths(want), strict=True)}
    assert any("router" in k for k in gaps) and any("gate" in k for k in gaps)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_REL, (worst, gaps[worst])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ragged_local_backward_twice_is_bit_for_bit(arch):
    runs = ragged_local_twice(tconfigs.smoke_config(arch), "cpu")
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)
    assert all(float(g.abs().max()) > 0 for g in runs[0][1:])


@pytest.mark.parametrize("row", chip_smoke.FAMILY_TRAIN, ids=lambda r: r[0])
def test_phase35_config_fits_one_card(row):
    rec = family_train_reckon.reckon(row)
    cfg = rec["cfg"]
    assert rec["params"] == cfg.param_count() + tconfigs.base.uncounted_params(cfg)
    assert rec["state_bytes"] == 16 * rec["params"] < HBM_BYTES
    assert rec["trace_flops"] > 0
    assert rec["argument_bytes"] + rec["temp_bytes"] < HBM_BYTES, rec
    # the arguments are the state less the gradients, and the batch
    assert rec["argument_bytes"] >= 12 * rec["params"]


def test_phase35_configs_are_the_published_widths():
    """Depth is the only cut: every other field is the registry's."""
    for arch, layers, batch, seq in chip_smoke.FAMILY_TRAIN:
        full = tconfigs.get_config(arch)
        cfg = chip_smoke._family_cfg(arch, layers)[1]
        assert cfg == (full.scaled(n_layers=layers) if layers else full)
        assert batch >= 1 and seq >= 1
    assert [r[0] for r in chip_smoke.FAMILY_TRAIN] == [
        "internvl2-1b", "whisper-base", "mixtral-8x7b", "qwen3-moe-235b-a22b"]
