"""The port's mamba2 (``ssm`` family) against the JAX package, at the smoke size.

The smoke-size ``mamba2-130m`` (2 layers, width 64, d_inner 128, 8 SSM
heads of dim 16, state 16, conv 4, vocab 256, tied embeddings, no MLP) is
built in both packages on the same parameters: the JAX model's ``init``
draws them, ``convert.params_from_jax`` carries them over.  The JAX model
runs with ``mixer_impl="chunked"`` and with ``"interpret"`` (its Pallas SSD
kernel executed in Python); the port runs on the CPU, where the SSD takes
its chunked plain version and decode the recurrence.  Tokens come from a
numpy seed.

Tolerance: ``TOL`` = 2e-4 absolute and relative on logits and caches, the
bar of ``tests/test_models.py``'s prefill/decode check.  Both sides compute
in float32 and differ only in summation order and in the ulps of
``exp``/``softplus``/``rsqrt`` between XLA-CPU and PyTorch; a missed
transpose, a flipped or two-sided conv, or a conv cache taken after the
conv moves the logits by far more.

Also here: the configs and parameter counts against the JAX package's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import uncounted_params  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "mamba2-130m"
B, S, GEN = 2, 20, 4  # prompt S; decode GEN steps past it


@functools.lru_cache(maxsize=None)
def _models(mixer_impl):
    cfg_j = jconfigs.smoke_config(ARCH)
    jm = jax_build_model(cfg_j, JaxOptions(activation_dtype="float32", remat="none",
                                           mixer_impl=mixer_impl))
    params_j = jm.init(jax.random.PRNGKey(0))
    cfg_t = tconfigs.smoke_config(ARCH)
    tm = build_model(cfg_t, ModelOptions(activation_dtype="float32"), device="cpu")
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t, device="cpu")
    return jm, params_j, tm, params_t


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **TOL)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=torch.is_tensor)


# ------------------------------------------------------------------ configs
def test_mamba2_config_and_counts_match_the_jax_package():
    """The published widths; ``param_count`` is the JAX formula as it
    stands, which leaves out ``conv_b`` and ``dt_bias`` (ROADMAP.md Queue
    C): the models of both packages hold that many more."""
    cfg = tconfigs.get_config(ARCH)
    jcfg = jconfigs.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_conv, cfg.vocab_size, cfg.tie_embeddings, cfg.d_ff) == (
        24, 768, 1536, 24, 64, 128, 4, 50280, True, 0)
    assert (cfg.d_inner, cfg.n_ssm_heads) == (jcfg.d_inner, jcfg.n_ssm_heads)
    assert cfg.param_count() == jcfg.param_count() == 128_939_904
    assert cfg.param_count() + uncounted_params(cfg) == 128_983_488
    small = tconfigs.smoke_config(ARCH)
    assert small.param_count() == jconfigs.smoke_config(ARCH).param_count() == 72_416
    exact = small.param_count() + uncounted_params(small)
    assert exact == 72_752
    _, params_j, tm, _ = _models("chunked")
    assert sum(a.size for a in jax.tree.leaves(params_j)) == exact
    params = tm.init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in _leaves(params)) == exact
    assert uncounted_params(tconfigs.get_config("phi4-mini-3.8b")) == 0


def test_init_draws_the_jax_distributions():
    """a_log = log(linspace(1, 16, H)), dt_bias in U(-4.6, -2.2), conv_w
    U(-1, 1) * sqrt(3 / K) (fan-in K of the [K, C] layout), zero conv_b,
    unit d_skip and gnorm; the weights laid out [out, in]."""
    cfg = tconfigs.get_config(ARCH).scaled(n_layers=1)
    p = tssm.ssm_init(torch.Generator().manual_seed(0), cfg)
    pj = jssm.ssm_init(jax.random.PRNGKey(0), jconfigs.get_config(ARCH), jnp.float32)
    for name in ("a_log", "d_skip", "gnorm", "conv_b"):
        _close(p[name], pj[name])
    for name in ("in_proj", "out_proj", "conv_w"):
        assert p[name].shape == (pj[name].shape if name == "conv_w" else pj[name].shape[::-1])
    bound = (3.0 / cfg.ssm_conv) ** 0.5
    assert p["conv_w"].abs().max().item() <= bound
    assert abs(p["conv_w"].std().item() - bound / 3 ** 0.5) < 0.02 * bound
    assert p["dt_bias"].min().item() >= -4.6 and p["dt_bias"].max().item() <= -2.2


def test_causal_conv_matches_the_jax_package():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    got = tssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    want = jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b)))
    _close(got, want)
    # causal: step t sees nothing after t
    x2 = x.copy()
    x2[:, 5:] += 1.0
    got2 = tssm._causal_conv(*(torch.from_numpy(a) for a in (x2, w, b)))
    torch.testing.assert_close(got2[:, :5], got[:, :5], rtol=0, atol=0)


# ------------------------------------------------------------- whole model
@pytest.mark.parametrize("mixer_impl", ["chunked", "interpret"])
@pytest.mark.parametrize("prompt", [S, 2])  # 2 < K - 1: the conv cache is left-padded
def test_prefill_logits_and_caches_match_the_jax_model(mixer_impl, prompt):
    jm, params_j, tm, params_t = _models(mixer_impl)
    cfg = tm.cfg
    toks = _tokens(cfg, B, prompt)
    lj, cj = jm.prefill_fn(params_j, {"tokens": jnp.asarray(toks)}, max_len=prompt + GEN)
    lt, ct = tm.prefill_fn(params_t, {"tokens": torch.from_numpy(toks)}, max_len=prompt + GEN)
    assert lt.shape == (B, cfg.vocab_size)
    _close(lt, lj)
    for i, block in enumerate(ct["blocks"]):
        c = block["sub0"]
        assert c["conv"].shape == (B, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
        assert c["ssm"].shape == (B, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        assert c["ssm"].dtype == torch.float32
        for name in ("conv", "ssm"):
            _close(c[name], cj["blocks"]["sub0"][name][i])


@pytest.mark.parametrize("mixer_impl", ["chunked", "interpret"])
@pytest.mark.parametrize("p0", [S - 3, 1])
def test_teacher_forced_decode_matches_the_jax_model(mixer_impl, p0):
    """Prefill ``p0`` tokens, then decode the following given tokens past
    the prompt: the logits and caches of every step agree."""
    jm, params_j, tm, params_t = _models(mixer_impl)
    toks = _tokens(tm.cfg, B, S + GEN, seed=2)
    lj, cj = jm.prefill_fn(params_j, {"tokens": jnp.asarray(toks[:, :p0])}, max_len=S + GEN)
    lt, ct = tm.prefill_fn(params_t, {"tokens": torch.from_numpy(toks[:, :p0])},
                           max_len=S + GEN)
    _close(lt, lj)
    decode_j = jax.jit(jm.decode_fn)
    for t in range(p0, S + GEN):
        lj, cj = decode_j(params_j, jnp.asarray(toks[:, t : t + 1]), cj, jnp.int32(t))
        lt, ct = tm.decode_fn(params_t, torch.from_numpy(toks[:, t : t + 1]), ct, t)
        assert lt.shape == (B, 1, tm.cfg.vocab_size)
        _close(lt, lj)
    for i, block in enumerate(ct["blocks"]):
        for name in ("conv", "ssm"):
            _close(block["sub0"][name], cj["blocks"]["sub0"][name][i])


def test_generate_gives_the_jax_models_greedy_ids():
    jm, params_j, tm, params_t = _models("chunked")
    toks = _tokens(tm.cfg, B, S, seed=3)
    want = jax_generate(jm, params_j, {"tokens": jnp.asarray(toks)}, gen_len=6)
    got = tserve.generate(tm, params_t, {"tokens": torch.from_numpy(toks)}, gen_len=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_continues_the_prefill():
    """On the port alone: a prefill of t + 1 tokens and a prefill of t
    tokens plus one decode step give the same logits (the recurrence
    continues the chunked form's state and the pre-conv cache)."""
    _, _, tm, params_t = _models("chunked")
    toks = torch.from_numpy(_tokens(tm.cfg, B, 12, seed=4))
    for t in (1, 2, 3, 11):
        _, caches = tm.prefill_fn(params_t, {"tokens": toks[:, :t]})
        got, _ = tm.decode_fn(params_t, toks[:, t : t + 1], caches, t)
        want, _ = tm.prefill_fn(params_t, {"tokens": toks[:, : t + 1]})
        _close(got[:, 0], want)


def test_serve_main_runs_mamba2_on_the_cpu(capsys):
    ids = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "12", "--gen-len", "3"])
    assert ids.shape == (2, 3)
    assert "mamba2-130m on cpu: generated (2, 3)" in capsys.readouterr().out
