"""Gradient compression (``repro_torch.train.compression``) against the JAX
package's ``repro.train.compression``.

JAX's ``compress_psum_int8``, ``compress_psum_topk`` and ``plain_psum`` run
under ``jax.vmap(..., axis_name="i")`` over k = 1, 2 and 4 shards, each
with its own gradients and error state from a numpy seed, for three
chained steps (the error carried).  One spawn of four ``gloo`` ranks
(``tests/torch_ranks.py``) runs the port's reducers on the same shards over
groups of k ranks, and over no group at k = 1.  The int8 payloads (recorded
inside the reducer) equal JAX's ``_quant_int8`` of the same inputs exactly;
the mean gradients and the new errors are held within ``REL`` = 1e-6 of the
largest magnitude of the leaf (the largest differences measured are 1.7e-7
for the plain mean at k = 4 and 1.3e-7 and 1.0e-7 for int8 at k = 2 and 4,
ulps of the sums taken in another order than XLA's; at k = 1 every scheme
is bit for bit).  On one device: the instances of ``tests/test_sched.py``'s
two compression tests, a tie at the top-k threshold, the jitted reference's
int8 arithmetic, and float32 and bfloat16 gradients against JAX's with the
reducers writing into their inputs, as the elastic step has them do.  The
reducers overwrite their inputs, so every call here passes clones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import compression as jc  # noqa: E402
from repro_torch.train import compression as tc  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

SHAPES = {"a": (64,), "b": (8, 16), "c": (3, 5, 7)}
KS, STEPS, K_FRAC, REL = (1, 2, 4), 3, 0.1, 1e-6
SCHEMES = ("int8", "topk", "none")


def _shards(k: int, seed: int) -> tuple:
    """``STEPS`` gradient trees and one error tree, each leaf ``[k, ...]``:
    unit normals, the error 0.01 of that."""
    rng = np.random.default_rng(seed)
    grads = [{n: rng.standard_normal((k, *s)).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(STEPS)]
    err = {n: (rng.standard_normal((k, *s)) * 0.01).astype(np.float32)
           for n, s in SHAPES.items()}
    return grads, err


_jit_payloads = jax.jit(jax.vmap(lambda t: jax.tree.map(lambda x: jc._quant_int8(x)[0], t)))


def _jax_run(scheme: str, k: int, grads, err) -> dict:
    """JAX's reducer under vmap over k shards, the error carried; each step's
    mean gradients, new errors and (int8) the payloads of its inputs."""
    red = jc.make_grad_reducer(scheme, "i", k_frac=K_FRAC)
    step = jax.jit(jax.vmap(red, axis_name="i"))
    e = {n: jnp.asarray(v) for n, v in err.items()}
    out = []
    for g in grads:
        g = {n: jnp.asarray(v) for n, v in g.items()}
        q = _jit_payloads(jax.tree.map(lambda a, b: a.astype(jnp.float32) + b, g, e))
        mean, e = step(g, e)
        out.append({"mean": jax.tree.map(np.asarray, mean), "err": jax.tree.map(np.asarray, e),
                    "q": jax.tree.map(np.asarray, q)})
    return out


_BODY = """
from repro_torch.train import compression as tc
inp = torch.load(D + "/in.pt")
payloads = []
quant = tc._quant_int8

def spy(g):
    q, s = quant(g)
    payloads.append(q.clone())
    return q, s

tc._quant_int8 = spy
out = {}
for k in inp["ks"]:
    group = dist.new_group(list(range(k)))  # every rank makes every group
    ways = {"group": group, "none": None} if k == 1 else {"group": group}
    if RANK >= k:
        continue
    for scheme in inp["schemes"]:
        for way, g_ in ways.items():
            grads, err = inp["shards"][k]
            e = {n: v[RANK].clone() for n, v in err.items()}
            red = tc.make_grad_reducer(scheme, g_, k_frac=inp["k_frac"])
            steps = []
            for g in grads:
                del payloads[:]
                mean, e = red({n: v[RANK].clone() for n, v in g.items()}, e)
                steps.append({"mean": mean, "err": {n: v.clone() for n, v in e.items()},
                              "q": list(payloads)})
            out[(scheme, k, way)] = steps
torch.save(out, D + f"/out{RANK}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    shards = {k: _shards(k, seed=10 + k) for k in KS}
    want = {(s, k): _jax_run(s, k, *shards[k]) for s in SCHEMES for k in KS}
    torch.save({"ks": KS, "schemes": SCHEMES, "k_frac": K_FRAC,
                "shards": {k: ([{n: torch.from_numpy(v) for n, v in g.items()} for g in gs],
                               {n: torch.from_numpy(v) for n, v in e.items()})
                           for k, (gs, e) in shards.items()}}, d / "in.pt")
    run_ranks(_BODY, max(KS), d)
    got = [torch.load(d / f"out{r}.pt") for r in range(max(KS))]
    return want, got


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den else 1.0))


CASES = [(s, k, way) for s in SCHEMES for k in KS for way in (("group", "none") if k == 1
                                                               else ("group",))]


@pytest.mark.parametrize("scheme,k,way", CASES)
def test_reducers_over_ranks_match_jax(runs, scheme, k, way):
    """Every rank's mean gradients and new errors within ``REL`` of JAX's
    shard at every step; the int8 payloads equal JAX's exactly; the plain
    reduction hands the error back unchanged."""
    want, got = runs
    worst = 0.0
    for r in range(k):
        for t, (w, g) in enumerate(zip(want[(scheme, k)], got[r][(scheme, k, way)],
                                       strict=True)):
            for n in SHAPES:
                worst = max(worst, _rel(g["mean"][n].numpy(), w["mean"][n][r]),
                            _rel(g["err"][n].numpy(), w["err"][n][r]))
            if scheme == "int8":
                assert len(g["q"]) == len(SHAPES)
                for n, q in zip(sorted(SHAPES), g["q"], strict=True):
                    assert q.dtype == torch.int8
                    np.testing.assert_array_equal(q.numpy(), w["q"][n][r], err_msg=f"{n} {t}")
    assert worst <= REL, worst


def test_int8_error_feedback_converges_as_the_reference_test():
    """``tests/test_sched.py``'s int8 instance on one device: the time
    average of 50 compressed gradients within 1e-3 of the true one, and
    every step's output and error equal to JAX's bit for bit."""
    g_np = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    g_true = {"w": torch.from_numpy(g_np)}
    err = tc.init_error_state(g_true)
    assert err["w"].dtype == torch.float32 and not err["w"].any()
    f = jax.jit(lambda e: jax.vmap(lambda _, e: jc.compress_psum_int8({"w": jnp.asarray(g_np)},
                                                                      e, "i"),
                                   in_axes=(0, None), axis_name="i")(jnp.arange(1), e))
    err_j = jc.init_error_state({"w": jnp.asarray(g_np)})
    acc = torch.zeros(64, dtype=torch.float32)
    for _ in range(50):
        out, err = tc.compress_psum_int8({"w": g_true["w"].clone()}, err)
        out_j, err_j = f(err_j)
        out_j, err_j = jax.tree.map(lambda x: x[0], out_j), jax.tree.map(lambda x: x[0], err_j)
        np.testing.assert_array_equal(out["w"].numpy(), np.asarray(out_j["w"]))
        np.testing.assert_array_equal(err["w"].numpy(), np.asarray(err_j["w"]))
        acc += out["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g_np, atol=1e-3)


@pytest.mark.parametrize("values,k_frac,kept", [
    ([0.1, -5.0, 0.2, 4.0, 0.0, 0.05], 0.34, 2),  # tests/test_sched.py's instance
    ([3.0, -3.0, 1.0, 3.0, 0.5, 2.0], 0.34, 3),  # a tie at the threshold: all kept
])
def test_topk_keeps_the_largest_as_jax(values, k_frac, kept):
    """k = int(6 k_frac) = 2 largest magnitudes kept, every entry tied with
    the k-th kept too; the dropped mass is the error; equal to JAX's."""
    g = {"w": torch.tensor(values, dtype=torch.float32)}
    out, new_err = tc.compress_psum_topk(g, tc.init_error_state(g), k_frac=k_frac)
    gj = {"w": jnp.asarray(values, jnp.float32)}
    out_j, err_j = jax.vmap(lambda _: jc.compress_psum_topk(gj, jc.init_error_state(gj), "i",
                                                            k_frac=k_frac),
                            axis_name="i")(jnp.arange(1))
    w = out["w"].numpy()
    assert np.count_nonzero(w) == kept
    assert w[1] != 0 and np.abs(w).max() == np.abs(values).max()
    np.testing.assert_array_equal(w, np.asarray(out_j["w"][0]))
    np.testing.assert_array_equal(new_err["w"].numpy(), np.asarray(err_j["w"][0]))
    np.testing.assert_array_equal(new_err["w"].numpy() + w, np.asarray(values, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_reducers_write_into_their_inputs_as_jax_reduces(scheme, dtype):
    """On one device every reducer equals JAX's jitted one bit for bit, on
    float32 and on bfloat16 gradients (reduced as ``float32(g) + e``).  The
    mean is written into a float32 gradient leaf and the new error into the
    error leaf; a bfloat16 gradient stays as it was under int8 and topk (its
    mean is a float32 copy); the plain reduction hands the error back."""
    grads, err = _shards(1, seed=3)
    g = {n: torch.from_numpy(v[0]).to(getattr(torch, dtype), copy=True)
         for n, v in grads[0].items()}
    e = {n: torch.from_numpy(v[0]).clone() for n, v in err.items()}
    g_in, e_in = ({n: v.clone() for n, v in t.items()} for t in (g, e))
    mean, new_e = tc.make_grad_reducer(scheme, k_frac=K_FRAC)(g, e)
    red = jax.jit(jax.vmap(jc.make_grad_reducer(scheme, "i", k_frac=K_FRAC), axis_name="i"))
    mean_j, err_j = red({n: jnp.asarray(v.float().numpy())[None].astype(dtype)
                         for n, v in g_in.items()},
                        {n: jnp.asarray(v.numpy())[None] for n, v in e_in.items()})
    for n in SHAPES:
        assert str(mean[n].dtype) == f"torch.{mean_j[n].dtype}"
        np.testing.assert_array_equal(mean[n].float().numpy(),
                                      np.asarray(mean_j[n][0], np.float32), err_msg=n)
        np.testing.assert_array_equal(new_e[n].numpy(), np.asarray(err_j[n][0]), err_msg=n)
        assert new_e[n] is e[n]
        if scheme == "none":
            assert torch.equal(new_e[n], e_in[n])
        if dtype == "float32" or scheme == "none":
            assert mean[n] is g[n]
        else:
            assert torch.equal(g[n], g_in[n])


def test_int8_follows_the_jitted_reference():
    """Jitted XLA computes ``/ 127`` as ``* float32(1 / 127)`` and the
    residual as one fused multiply-add; eager JAX as written.  At this leaf
    the two scales differ by an ulp: the port's is the jitted one, and so
    are its payload, output and error (ROADMAP.md Queue C)."""
    g = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    q_t, s_t = tc._quant_int8(torch.from_numpy(g))
    q_j, s_j = jax.jit(jc._quant_int8)(jnp.asarray(g))
    assert s_t.item() == float(s_j) != float(jc._quant_int8(jnp.asarray(g))[1])
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(tc._dequant_int8(q_t, s_t).numpy(),
                                  np.asarray(jc._dequant_int8(q_j, s_j)))
    e = (np.random.default_rng(1).standard_normal(64) * 0.01).astype(np.float32)
    f = jax.jit(jax.vmap(lambda g, e: jc.compress_psum_int8({"w": g}, {"w": e}, "i"),
                         axis_name="i"))
    out_j, err_j = f(jnp.asarray(g)[None], jnp.asarray(e)[None])
    out, err = tc.compress_psum_int8({"w": torch.tensor(g)}, {"w": torch.tensor(e)})
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(out_j["w"][0]))
    np.testing.assert_array_equal(err["w"].numpy(), np.asarray(err_j["w"][0]))
    # one rounding: the exact residual of g + e, rounded once
    x = torch.from_numpy(g) + torch.from_numpy(e)
    q, s = tc._quant_int8(x)
    assert torch.equal(err["w"], (x.double() - q.double() * s.double()).float())


@pytest.mark.parametrize("magnitude", [1e-30, 1e-3, 1.0, 3e30])
def test_int8_residual_is_rounded_once(magnitude):
    """``g - q * scale`` rounded once from its exact value (computed in
    float64, where it is exact), at every element of 65,537 normals of this
    magnitude with zeros among them, as a fused multiply-add rounds it."""
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(65537).astype(np.float32)
                         * np.float32(magnitude))
    g[::97] = 0.0
    q, s = tc._quant_int8(g)
    out = tc._residual_int8(torch.empty_like(g), g, q, s)
    assert torch.equal(out, (g.double() - q.double() * s.double()).float())


def test_unknown_scheme_raises_as_the_reference():
    with pytest.raises(ValueError, match="unknown compression scheme 'fp4'"):
        tc.make_grad_reducer("fp4")
    with pytest.raises(ValueError, match="unknown compression scheme 'fp4'"):
        jc.make_grad_reducer("fp4", "i")
