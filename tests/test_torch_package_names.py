"""The port's package-level names against the reference's, on the CPU.

``repro_torch.core`` and ``repro_torch.models`` export what ``repro.core``
and ``repro.models`` export (``__all__``), so that code written against the
reference (its ``examples/*.py`` import ``from repro.models import
ModelOptions, build_model``) reads the same against the port.  Two names
are renamed, since they name the JAX implementation: ``quantize_allocation_jax``
and ``snap_to_slices_jax`` are the port's ``quantize_allocation`` and
``snap_to_slices``.  Each name is of the reference's kind (a module, a
class, a function, a table of names equal to the reference's); the renamed
two and ``size_ranks_desc`` give the reference's values.
"""

import importlib
import inspect
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import policies as jpolicies  # noqa: E402

RENAMED = {"quantize_allocation_jax": "quantize_allocation",
           "snap_to_slices_jax": "snap_to_slices"}


def _kind(v) -> str:
    if isinstance(v, types.ModuleType):
        return "module"
    if inspect.isclass(v):
        return "class"
    if callable(v):
        return "function"
    return type(v).__name__


@pytest.mark.parametrize("pkg", ["core", "models"])
def test_package_exports_the_reference_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert set(port.__all__) == {RENAMED.get(n, n) for n in ref.__all__}
    assert len(port.__all__) == len(ref.__all__)
    for name in ref.__all__:
        want, got = getattr(ref, name), getattr(port, RENAMED.get(name, name))
        assert _kind(got) == _kind(want), name
        if isinstance(want, (tuple, list)) and all(isinstance(x, str) for x in want):
            assert tuple(got) == tuple(want), name
    assert set(dir(port)) >= set(port.__all__)
    with pytest.raises(AttributeError):
        port.not_a_name  # noqa: B018


def test_the_examples_import_of_the_model_entry_point():
    from repro_torch.configs import smoke_config
    from repro_torch.models import ModelOptions, build_model

    model = build_model(smoke_config("phi4-mini-3.8b"), ModelOptions(activation_dtype="float32"),
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(loss)


def test_renamed_and_added_names_give_the_reference_values():
    from repro_torch import core

    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (6, 9)).astype(np.float64)  # departed jobs and exact ties
    got = core.size_ranks_desc(torch.from_numpy(x)).numpy()  # row by row over [6, 9]
    for row in range(6):  # the reference's take one row
        np.testing.assert_array_equal(got[row],
                                      np.asarray(jpolicies.size_ranks_desc(jnp.asarray(x[row]))))
    for _ in range(5):
        theta = rng.random(7) * (rng.random(7) < 0.8)
        theta /= theta.sum()
        chips = core.quantize_allocation(torch.from_numpy(theta), 16, min_chips=2)
        want = jengine.quantize_allocation_jax(jnp.asarray(theta), 16, min_chips=2)
        np.testing.assert_array_equal(chips.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            core.snap_to_slices(chips, 16).numpy(),
            np.asarray(jengine.snap_to_slices_jax(jnp.asarray(chips.numpy()), 16)))
