"""The port's MoE layer and the moe family against the JAX package, on the
CPU.

The layer's weights are drawn by the JAX package's ``moe_init`` and carried
over with the port's ``[out, in]`` transposes (``convert.py``); activations
come from a numpy seed.  The whole smoke mixtral-8x7b and
qwen3-moe-235b-a22b (4 experts, top-2) are built in both packages on the
same parameters.

Routing is compared before anything it feeds: each side records the top-k
ids of every MoE layer (the port by ``moe.recording_routes``, the JAX model
through a ``jax.debug.callback`` on its ``_route``), the ids must agree
exactly, and the smallest top-k margin (k-th router probability less the
(k+1)-th) is recorded beside them.  A near-tie would move a token to
another expert on one side only: a jump, not a drift, and no tolerance
would be loosened for it.

Tolerances: float32 outputs and logits 2e-4 absolute and relative (the
bar of ``tests/test_models.py``'s prefill check); ``ragged_local`` against
``dense`` 1e-4, the JAX package's own bar (``tests/test_models.py``'s
``test_moe_ragged_local_matches_dense``); ``aux`` 1e-5 relative; bf16
outputs 5e-2; ids exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-235b-a22b")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or TOL))


def _layer(arch, seed=3, dtype=jnp.float32):
    """(cfg, JAX weights, the port's weights) of one MoE layer."""
    cfg = tconfigs.smoke_config(arch)
    pj = jmoe.moe_init(jax.random.PRNGKey(seed), jconfigs.smoke_config(arch), dtype)
    pt = {k: torch.from_numpy(np.swapaxes(np.asarray(v, np.float32), -1, -2).copy())
          for k, v in pj.items()}
    return cfg, pj, pt


def _x(cfg, b=2, s=8, seed=4):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


@pytest.fixture
def jax_routes(monkeypatch):
    """The top-k ids of every routing the JAX package runs, in order."""
    seen = []
    route = jmoe._route

    def recording(p, x, cfg):
        w, ids, aux = route(p, x, cfg)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), ids, ordered=True)
        return w, ids, aux

    monkeypatch.setattr(jmoe, "_route", recording)
    return seen


# ------------------------------------------------------------------ the layer
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("impl", ["dense", "ragged_local"])
def test_moe_apply_matches_jax(arch, impl, jax_routes):
    cfg, pj, pt = _layer(arch)
    x = _x(cfg)
    want, aux_j = jmoe.moe_apply(pj, jnp.asarray(x), jconfigs.smoke_config(arch), impl=impl)
    with moe.recording_routes() as routes:
        got, aux = moe.moe_apply(pt, torch.from_numpy(x), cfg, impl=impl)
    (ids, margin), = routes
    np.testing.assert_array_equal(ids.numpy(), jax_routes[0])
    assert float(margin.min()) > 0  # no exact tie on this input
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    assert abs(aux.item() - float(aux_j)) <= 1e-5 * abs(float(aux_j))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ragged_local_equals_dense_at_the_jax_bar(arch):
    cfg, _, pt = _layer(arch, seed=5)
    x = torch.from_numpy(_x(cfg, b=3, s=11, seed=6))
    dense, aux_d = moe.moe_apply(pt, x, cfg, impl="dense")
    ragged, aux_r = moe.moe_apply(pt, x, cfg, impl="ragged_local")
    torch.testing.assert_close(ragged, dense, rtol=1e-4, atol=1e-4)
    assert abs(aux_r.item() - aux_d.item()) <= 1e-5 * abs(aux_d.item())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_jax_ids_weights_and_aux(arch):
    cfg, pj, pt = _layer(arch, seed=7)
    x = _x(cfg, b=2, s=16, seed=8)
    wj, idsj, auxj = jmoe._route(pj, jnp.asarray(x), jconfigs.smoke_config(arch))
    w, ids, aux = moe._route(pt, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(idsj))
    _close(w, wj, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert abs(aux.item() - float(auxj)) <= 1e-5 * abs(float(auxj))


def test_exact_ties_go_to_the_lower_expert_as_lax_top_k():
    """Three router columns equal: experts 1, 2 and 3 tie exactly on every
    token, so the second choice always ties with the third; both packages
    take the lower indices ((1, 2) or (0, 1), never 3)."""
    arch = "qwen3-moe-235b-a22b"
    cfg, pj, pt = _layer(arch, seed=9)
    router = np.asarray(pj["router"]).copy()  # [d, E]
    router[:, 2] = router[:, 3] = router[:, 1]
    pj = {**pj, "router": jnp.asarray(router)}
    pt = {**pt, "router": torch.from_numpy(router.T.copy())}
    x = _x(cfg, b=2, s=16, seed=10)
    _, idsj, _ = jmoe._route(pj, jnp.asarray(x), jconfigs.smoke_config(arch))
    with moe.recording_routes() as routes:
        _, ids, _ = moe._route(pt, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(idsj))
    assert {tuple(r) for r in ids.reshape(-1, 2).tolist()} <= {(1, 2), (0, 1)}
    assert float(routes[0][1].abs().max()) == 0.0  # the k-th and (k+1)-th tie everywhere


def test_aux_carries_no_gradient_through_the_assignment_shares():
    """d aux / d router flows only through the mean probabilities p_e: the
    gradient equals that of E * sum(stop_grad(f_e) * p_e)."""
    cfg, _, pt = _layer("mixtral-8x7b", seed=11)
    x = torch.from_numpy(_x(cfg, seed=12))
    router = pt["router"].clone().requires_grad_(True)
    _, ids, aux = moe._route({"router": router}, x, cfg)
    (g,) = torch.autograd.grad(aux, router)
    probs = torch.softmax(torch.nn.functional.linear(x, router), -1)
    f_e = torch.nn.functional.one_hot(ids, cfg.n_experts).float().sum(-2).mean((0, 1)) / 2
    (want,) = torch.autograd.grad(cfg.n_experts * (f_e * probs.mean((0, 1))).sum(), router)
    torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["dense", "ragged_local"])
def test_bf16_moe_matches_jax(impl):
    """bf16 activations: the combine weights are cast to bf16 and SiLU runs
    in float32 before the cast back, on both sides."""
    arch = "mixtral-8x7b"
    cfg, pj, pt = _layer(arch, seed=13)
    x = _x(cfg, seed=14)
    want, _ = jmoe.moe_apply(pj, jnp.asarray(x, jnp.bfloat16), jconfigs.smoke_config(arch),
                             impl=impl)
    got, _ = moe.moe_apply(pt, torch.from_numpy(x).to(torch.bfloat16), cfg, impl=impl)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), rtol=5e-2, atol=5e-2)


def test_moe_refuses_mesh_impls_and_unknown_ones():
    """Without a mesh the mesh dispatches raise (the reference quietly takes
    dense); their mesh runs are held in tests/test_torch_mesh.py."""
    cfg, _, pt = _layer("mixtral-8x7b")
    x = torch.from_numpy(_x(cfg))
    for impl in ("ragged", "dense_ep"):
        with pytest.raises(NotImplementedError, match="needs a device mesh"):
            moe.moe_apply(pt, x, cfg, impl=impl)
    with pytest.raises(ValueError, match="moe impl"):
        moe.moe_apply(pt, x, cfg, impl="sparse")
    with pytest.raises(ValueError, match="moe_impl"):
        ModelOptions(moe_impl="sparse")
    assert ModelOptions().moe_impl == "dense"


# ------------------------------------------------------------- whole model
def _models(arch, moe_impl="dense"):
    cfg_j = jconfigs.smoke_config(arch)
    jm = jax_build_model(cfg_j, JaxOptions(activation_dtype="float32", remat="none",
                                           attn_impl="ref", moe_impl=moe_impl))
    params_j = jm.init(jax.random.PRNGKey(0))
    cfg_t = tconfigs.smoke_config(arch)
    tm = build_model(cfg_t, ModelOptions(activation_dtype="float32", moe_impl=moe_impl),
                     device="cpu")
    return jm, params_j, tm, params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                                             device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("moe_impl", ["dense", "ragged_local"])
def test_prefill_routing_and_logits_match_jax(arch, moe_impl, jax_routes):
    """Every layer's ids equal the JAX model's (the smallest margin is
    printed), then the last logits within 2e-4; ``ragged_local`` against the
    JAX model's own ``ragged_local``."""
    jm, params_j, tm, params_t = _models(arch, moe_impl)
    toks = np.random.default_rng(15).integers(0, tm.cfg.vocab_size, (3, 24)).astype(np.int32)
    want, _ = jm.prefill_fn(params_j, {"tokens": jnp.asarray(toks)})
    with moe.recording_routes() as routes:
        got, _ = tm.prefill_fn(params_t, {"tokens": torch.from_numpy(toks)})
    assert len(routes) == len(jax_routes) == tm.cfg.n_layers
    flips = sum(int((ids.numpy() != j).any(-1).sum()) for (ids, _), j in zip(routes, jax_routes))
    margin = min(float(m.min()) for _, m in routes)
    print(f"{arch} {moe_impl}: {flips} tokens routed apart, smallest top-k margin {margin:.3e}")
    assert flips == 0
    _close(got, want)


def test_decode_through_moe_layers_matches_prefill():
    """Teacher-forced decode past the prefill, token by token through the
    ring cache of the window, gives the logits of a full-prefix prefill."""
    _, _, tm, params = _models("mixtral-8x7b")
    toks = torch.from_numpy(np.random.default_rng(16).integers(0, 256, (2, 24)))
    logits, caches = tm.prefill_fn(params, {"tokens": toks[:, :18]}, max_len=24)
    assert caches["blocks"][0]["sub0"]["k"].shape[2] == tm.cfg.window
    for t in range(18, 24):
        logits, caches = tm.decode_fn(params, toks[:, t:t + 1], caches, t)
        want, _ = tm.prefill_fn(params, {"tokens": toks[:, :t + 1]})
        torch.testing.assert_close(logits[:, 0], want, **TOL)


def test_recording_routes_nests_and_is_off_by_default():
    cfg, _, pt = _layer("mixtral-8x7b")
    x = torch.from_numpy(_x(cfg))
    moe.moe_apply(pt, x, cfg)
    assert moe._ROUTES is None
    with moe.recording_routes() as outer:
        moe.moe_apply(pt, x, cfg)
        with moe.recording_routes() as inner:
            moe.moe_apply(pt, x, cfg, impl="ragged_local")
        assert len(inner) == 1
    assert len(outer) == 1 and moe._ROUTES is None
    torch.testing.assert_close(outer[0][0], inner[0][0], rtol=0, atol=0)
